"""Log-weight utilities and symmetrization (port of rbslam_tpu/math/linalg.py).

Only the pieces the lowrank filter path needs are ported here; the
general PSD-safe Cholesky with its Gershgorin repair serves the ``xla``
engine path and the smoothers, which come with later slices.
"""

from __future__ import annotations

import torch


def symmetrize(A: torch.Tensor) -> torch.Tensor:
    """0.5*(A + A^T) over the trailing two axes (as ekf_dense.m:92)."""
    return 0.5 * (A + A.transpose(-1, -2))


def logsumexp_normalize(logw: torch.Tensor):
    """Log-sum-exp normalize (src/particleFilter.m:153-156).

    Returns ``(w, logw_normalized, logZ)``.
    """
    logZ = torch.logsumexp(logw, dim=-1, keepdim=True)
    logw_n = logw - logZ
    return torch.exp(logw_n), logw_n, logZ[..., 0]


def ess_from_logw(logw: torch.Tensor) -> torch.Tensor:
    """Effective sample size from (unnormalized) log weights."""
    _, logw_n, _ = logsumexp_normalize(logw)
    return torch.exp(-torch.logsumexp(2.0 * logw_n, dim=-1))
