from .linalg import (
    ess_from_logw,
    gaussian_logpdf_chol,
    half_logdet,
    logsumexp_normalize,
    psd_cholesky,
    solve_psd,
    symmetrize,
    tril_solve,
)
from .procrustes import ProcrustesTransform, procrustes, procrustes_transform
from .quaternions import (
    expq,
    logq,
    mcross,
    qinv,
    qleft,
    qmul,
    qright,
    quat_to_euler,
    quat_to_rmat,
    rmat_to_quat,
)

__all__ = [
    "ess_from_logw", "gaussian_logpdf_chol", "half_logdet",
    "logsumexp_normalize", "psd_cholesky", "solve_psd", "symmetrize",
    "tril_solve",
    "ProcrustesTransform", "procrustes", "procrustes_transform",
    "expq", "logq", "mcross", "qinv", "qleft", "qmul", "qright",
    "quat_to_euler", "quat_to_rmat", "rmat_to_quat",
]
