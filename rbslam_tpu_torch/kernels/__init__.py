"""Hand-written CUDA kernels of the filters' and smoothers' hot paths,
with their plain PyTorch versions (port of rbslam_tpu/kernels/).

K1 mag3d_jacobian_rows  (replaces basis_eval.py:_jac3d_rows_kernel)
K2 gather_cp            (replaces kf_update.py:_kernel_gather_cp)
K3 kf_rebase            (replaces kf_update.py:_kernel_rebase)
K4 grad_basis           (replaces basis_eval.py:_grad_kernel)
K5 kf_update_block_gather (replaces kf_update.py:_kernel_block_gather)
K6 phi_basis            (replaces basis_eval.py:_phi_kernel)
K7 mag3d_jacobian       (replaces basis_eval.py:_jac3d_kernel)
K12 gp_predictive       (replaces none: the exact terrain weight's GP
                         predictive, which the JAX package leaves to XLA)

and the kernel-part probes (replace the profiling kernels of scripts/):

K8  probe_gather_cp      (profile_gather_cp.py:_kernel_gcp)
K9  probe_rebase_parts   (profile_rebase_parts.py:make_kernel)
K10 probe_gather         (profile_gather_kernel.py:_gather_kernel)
K11 probe_block_products (profile_block_mxu.py:_kernel)
"""

from ._lib import launch_counts, reset_launch_counts
from .basis_eval import (
    BasisConstants,
    grad_basis,
    grad_basis_plain,
    mag3d_jacobian,
    mag3d_jacobian_plain,
    mag3d_jacobian_rows,
    mag3d_jacobian_rows_plain,
    pack_basis_constants,
    phi_basis,
    phi_basis_plain,
)
from .kf_update import (
    block_gather_plain,
    gather_cp,
    gather_cp_plain,
    kf_rebase,
    kf_update_block_gather,
    kf_update_lowrank,
    rebase_plain,
    spd_inv_logdet_plain,
)
from .predictive import (
    PredictiveConstants,
    gp_predictive,
    gp_predictive_plain,
    pack_predictive,
)
from .probes import (
    probe_block_products,
    probe_block_products_plain,
    probe_gather,
    probe_gather_cp,
    probe_gather_cp_plain,
    probe_gather_plain,
    probe_rebase_parts,
    probe_rebase_parts_plain,
)

__all__ = [
    "launch_counts", "reset_launch_counts",
    "BasisConstants", "pack_basis_constants",
    "grad_basis", "grad_basis_plain",
    "mag3d_jacobian_rows", "mag3d_jacobian_rows_plain",
    "phi_basis", "phi_basis_plain",
    "mag3d_jacobian", "mag3d_jacobian_plain",
    "gather_cp", "gather_cp_plain", "kf_rebase", "rebase_plain",
    "kf_update_lowrank",
    "kf_update_block_gather", "block_gather_plain", "spd_inv_logdet_plain",
    "probe_gather_cp", "probe_gather_cp_plain",
    "probe_rebase_parts", "probe_rebase_parts_plain",
    "probe_gather", "probe_gather_plain",
    "probe_block_products", "probe_block_products_plain",
    "PredictiveConstants", "pack_predictive",
    "gp_predictive", "gp_predictive_plain",
]
