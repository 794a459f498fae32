from .ekf import EKFResult, run_ekf_dense, run_ekf_dense_batched
from .pf import PFConfig, PFResult, run_pf_localization
from .rbpf import RBPFConfig, RBPFResult, reconstruct_trajectories, run_rbpf
from .rbps import RBPSConfig, RBPSResult, run_rbps
from .rbps_info import run_rbps_information_form

__all__ = [
    "EKFResult", "run_ekf_dense", "run_ekf_dense_batched",
    "PFConfig", "PFResult", "run_pf_localization",
    "RBPFConfig", "RBPFResult", "reconstruct_trajectories", "run_rbpf",
    "RBPSConfig", "RBPSResult", "run_rbps", "run_rbps_information_form",
]
