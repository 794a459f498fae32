from .linalg import ess_from_logw, logsumexp_normalize, symmetrize
from .quaternions import expq, qinv, qmul, quat_to_rmat, rmat_to_quat

__all__ = [
    "ess_from_logw", "logsumexp_normalize", "symmetrize",
    "expq", "qinv", "qmul", "quat_to_rmat", "rmat_to_quat",
]
