"""PSD-safe Cholesky, Gaussian log-densities, log-weight utilities (port
of rbslam_tpu/math/linalg.py).

The reference retries a failed ``chol`` once with a fixed diagonal jitter
(src/particleFilter.m:145-148 with 1e-3, src/particleSmoother.m:70 with
1e-2). :func:`psd_cholesky` reproduces the retry without a branch on the
host: ``torch.linalg.cholesky_ex`` reports failure in ``info`` instead of
raising, the jitter and Gershgorin stages are factored for the whole
batch and selected per element with ``torch.where``.
"""

from __future__ import annotations

import math

import torch

_LOG2PI = math.log(2.0 * math.pi)


def symmetrize(A: torch.Tensor) -> torch.Tensor:
    """0.5*(A + A^T) over the trailing two axes (as ekf_dense.m:92)."""
    return 0.5 * (A + A.transpose(-1, -2))


def _chol_flagged(A: torch.Tensor):
    """Lower Cholesky and a per-element failure flag. A failed element's
    factor holds unspecified values; the flag (``info`` > 0 or non-finite
    input) decides, as NaN does in the reference implementation."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0) | ~torch.isfinite(L).all(dim=-1).all(dim=-1)
    return L, bad


def psd_cholesky(A: torch.Tensor, jitter: float):
    """Lower Cholesky with a fixed-jitter retry and a guaranteed repair.

    Returns ``(L, retried)``; ``retried`` (bool per batch element) is True
    where a repaired factorization was used. Stage 1 refactors A + jitter
    I; stage 2, for matrices too indefinite for the fixed jitter, shifts
    by the Gershgorin lower bound on the smallest eigenvalue, which makes
    the factorization finite for any symmetric input. The stages run for
    the whole batch only when some element needs them (one flag read by
    the host per stage), and are selected per element.
    """
    L, bad = _chol_flagged(A)
    if not bool(bad.any()):
        return L, bad
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    L_j, still_bad = _chol_flagged(A + jitter * eye)
    if bool(still_bad.any()):
        # lambda_min >= min_i (A_ii - sum_{j != i} |A_ij|)
        diag = torch.diagonal(A, dim1=-2, dim2=-1)
        offsum = torch.sum(torch.abs(A), dim=-1) - torch.abs(diag)
        gmin = torch.min(diag - offsum, dim=-1).values
        shift = jitter + torch.clamp(-gmin, min=0.0)
        L_g, _ = _chol_flagged(A + shift[..., None, None] * eye)
        L_j = torch.where(still_bad[..., None, None], L_g, L_j)
    return torch.where(bad[..., None, None], L_j, L), bad


def tril_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b for lower-triangular L; b is [..., n] or [..., n, k]."""
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b[..., None]
    x = torch.linalg.solve_triangular(L, b, upper=False)
    return x[..., 0] if vec else x


def solve_psd(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky L of A (two triangular solves)."""
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x


def half_logdet(L: torch.Tensor) -> torch.Tensor:
    """0.5*log|A| = sum(log diag L) for A = L L^T."""
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def gaussian_logpdf_chol(e: torch.Tensor, L: torch.Tensor, n_obs=None):
    """log N(e; 0, S) given lower Cholesky L of S
    (``-sum(log diag cS) - .5*v'v - .5*numel(e)*log(2*pi)``,
    src/particleFilter.m:149-150). ``n_obs`` overrides the dimension
    count for masked (padded) observations."""
    v = tril_solve(L, e)
    if n_obs is None:
        n_obs = e.shape[-1]
    return (-half_logdet(L) - 0.5 * torch.sum(v * v, dim=-1)
            - 0.5 * n_obs * _LOG2PI)


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
