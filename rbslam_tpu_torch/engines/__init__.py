from .rbpf import RBPFConfig, RBPFResult, reconstruct_trajectories, run_rbpf

__all__ = ["RBPFConfig", "RBPFResult", "reconstruct_trajectories", "run_rbpf"]
