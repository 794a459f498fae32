"""Resampling schemes for the particle ensemble (port of
rbslam_tpu/ops/resampling.py).

All schemes consume *normalized* weights and the uniforms they need, and
return int64 ancestor indices. The uniforms come from the caller
(a ``torch.Generator`` draw, or injected draws in the tests), so the same
inputs give the same ancestors in both packages.
"""

from __future__ import annotations

import torch


def _inverse_cdf(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Map uniforms u in [0,1) to categorical indices via the CDF of w."""
    cdf = torch.cumsum(w, dim=0)
    cdf = cdf / cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, 0, w.shape[0] - 1)


def sample_categorical(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One index ~ Categorical(w) from one uniform u (0-d)
    (tools/sample.m:30-33)."""
    return _inverse_cdf(w, u)


def _cumsum_1d(x: torch.Tensor) -> torch.Tensor:
    """1-D inclusive cumsum, blocked as [rows, 128] row-cumsums plus
    row offsets for large power-of-two-ish lengths — the summation order
    of the reference's systematic resampler, so the CDF rounds the same
    way at the headline ensemble sizes."""
    n = x.shape[0]
    if n < 4096 or n % 128:
        return torch.cumsum(x, dim=0)
    within = torch.cumsum(x.reshape(n // 128, 128), dim=1)
    offsets = torch.cumsum(within[:, -1], dim=0) - within[:, -1]
    return (within + offsets[:, None]).reshape(n)


def systematic_resample(u0: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic (single-offset comb) resampling: u_i = (i + u0)/n.

    Histogram form: ancestor ai[j] = #{i : cdf_i <= (j + u0)/n}, i.e.
    bucket b_i = ceil(n cdf_i - u0) and a cumulative histogram — O(n)
    with no search. Equal to the searchsorted form up to f32 knife-edge
    rounding where n cdf_i - u0 lies within an ulp of an integer. The
    histogram is a scatter-add into n + 1 zeroed counters, the first n
    kept, as the reference's (``torch.bincount`` would read its length
    on the host: a device sync).
    """
    cdf = _cumsum_1d(w)
    cdf = cdf / cdf[-1]
    b = torch.clamp(torch.ceil(n * cdf - u0).to(torch.int64), 0, n)
    hist = torch.zeros(n + 1, dtype=torch.int64, device=b.device) \
        .scatter_add_(0, b, torch.ones_like(b))[:n]
    ai = _cumsum_1d(hist)
    return torch.clamp(ai, 0, w.shape[0] - 1)


def multinomial_resample(u: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """n iid Categorical(w) draws from n uniforms (tools/sample.m:30-33)."""
    return _inverse_cdf(w, u[:n])


def stratified_resample(u: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """Stratified resampling: u_i = (i + u_i')/n from n uniforms u_i'."""
    grid = torch.arange(n, dtype=w.dtype, device=w.device)
    return _inverse_cdf(w, (grid + u[:n]) / n)


_SCHEMES = {
    "multinomial": multinomial_resample,
    "systematic": systematic_resample,
    "stratified": stratified_resample,
}


def resample_indices(u: torch.Tensor, w: torch.Tensor, n: int,
                     scheme: str = "multinomial") -> torch.Tensor:
    """Dispatch by scheme name. ``u`` is one uniform (0-d) for
    systematic, ``n`` uniforms for multinomial and stratified."""
    try:
        fn = _SCHEMES[scheme]
    except KeyError:
        raise ValueError(
            f"unknown resampling scheme {scheme!r}; options: {sorted(_SCHEMES)}"
        ) from None
    return fn(u, w, n)
