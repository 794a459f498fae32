"""Resampling schemes for the particle ensemble (port of
rbslam_tpu/ops/resampling.py).

All schemes consume *normalized* weights and the uniforms they need, and
return int64 ancestor indices. The uniforms come from the caller
(a ``torch.Generator`` draw, or injected draws in the tests), so the same
inputs give the same ancestors in both packages. Every CDF here, and in
parallel/resampling.py, is summed by :func:`_cumsum_1d`, whose order
is fixed by the length alone, so two calls on the card give the same
ancestors.
"""

from __future__ import annotations

import torch


def _inverse_cdf(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Map uniforms u in [0,1) to categorical indices via the CDF of w."""
    cdf = _cumsum_1d(w)
    cdf = cdf / cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, 0, w.shape[0] - 1)


def sample_categorical(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One index ~ Categorical(w) from one uniform u (0-d)
    (tools/sample.m:30-33)."""
    return _inverse_cdf(w, u)


def _cumsum_1d(x: torch.Tensor) -> torch.Tensor:
    """1-D inclusive cumsum whose summation order depends on the length
    alone, on every device and every call.

    Below 4096 entries it is ``torch.cumsum``, whose rounding on the CPU
    the tests hold bit for bit against JAX's ``jnp.cumsum``; on the card
    a scan of a few tiles, whose bits do not move from call to call
    (chip_smoke.py phase 18c checks them). From 4096 on it is the
    blocked form of the reference's systematic resampler
    (rbslam_tpu/ops/resampling.py:_cumsum_1d): row cumsums of [rows, 128]
    (zero-padded to a whole row) plus each row's offset, the exclusive
    cumsum of the row sums, itself taken by this function. A plain 1-D
    ``torch.cumsum`` of many tiles on the card adds the tiles' prefixes
    in whatever order they finish, so its rounding, and the ancestors at
    the CDF's knife edges, change from call to call; a row cumsum of a
    2-D tensor does not. Equal to the reference's order up to 2^19
    entries; above that its offsets are blocked too. Integer sums are
    exact in any order, so an integer ``x`` takes ``torch.cumsum``.
    """
    n = x.shape[0]
    if n < 4096 or not x.is_floating_point():
        return torch.cumsum(x, dim=0)
    if n % 128:
        x = torch.nn.functional.pad(x, (0, -n % 128))
    within = torch.cumsum(x.reshape(-1, 128), dim=1)
    ends = within[:, -1]
    offsets = _cumsum_1d(ends) - ends
    return (within + offsets[:, None]).reshape(-1)[:n]


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
