"""Distributed resampling: ancestor selection on a particle-sharded ensemble
(port of rbslam_tpu/parallel/resampling.py).

The reference resamples with inverse-CDF draws over the whole weight
vector (tools/sample.m:30-33, src/particleFilter.m:104-113), a global
operation. The split: the index computation moves weights (one float a
particle), never states; the caller's ancestor gather moves the states.

Every rank passes the same global uniforms (one ``u0`` for systematic, N
for stratified and multinomial; the engines draw them from identically
seeded generators or take them injected) and its block w [N/S] of the
normalized weights, and gets the global ancestor indices (int32) of its
own children. Modes:

- ``replicated_cdf`` (default): all-gather the weights and run the
  single-device resampler (ops/resampling.py) on the whole vector; each
  rank keeps its children. Index for index the port's unsharded run.
- ``prefix``: all-gather the S shard sums only; every rank holds the
  same segment bounds, so the shard that owns each comb position is
  decided by one search against them (exactly one owner a query). The
  owner answers with its local inverse CDF in global coordinates, and one
  reduce-scatter delivers each rank its children's answers. Equal to the
  single-device resampler up to float32 knife edges (its CDF is summed
  in another order).
- :func:`sharded_resample_local`, the island form: no collective; each
  shard resamples its children from its own particles and they carry the
  shard's weight (log W_o - log n_local) instead of the uniform reset.
  Unbiased, not draw for draw equal to the global resampler.
"""

from __future__ import annotations

import math

import torch

from ..ops.resampling import _cumsum_1d, resample_indices
from .mesh import all_gather, mesh_axes, reduce_scatter


def _comb(u: torch.Tensor, n: int, scheme: str, dtype) -> torch.Tensor:
    """Global inverse-CDF query positions in [0, 1) from the uniforms ``u``
    (sorted for systematic and stratified)."""
    if scheme == "systematic":
        return (torch.arange(n, dtype=dtype, device=u.device) + u) / n
    if scheme == "stratified":
        return (torch.arange(n, dtype=dtype, device=u.device) + u[:n]) / n
    if scheme == "multinomial":
        return u[:n]
    raise ValueError(f"unknown resampling scheme {scheme!r}")


def sharded_resample_indices(u, w, mesh, scheme: str = "systematic",
                             mode: str = "replicated_cdf") -> torch.Tensor:
    """Global ancestor indices (int32) of this rank's children.

    u: the global uniforms (0-d for systematic, [N] otherwise), the same on
    every rank; w: this rank's block [N/S] of the normalized weights.
    """
    ax = mesh_axes(mesh)
    n_local = w.shape[0]
    n = n_local * ax.n_part
    start = ax.part_rank * n_local
    if mode == "replicated_cdf":
        w_all = all_gather(w, ax.part_group)
        ai = resample_indices(u, w_all, n, scheme)
        return ai[start:start + n_local].to(torch.int32)
    if mode != "prefix":
        raise ValueError(f"unknown distributed resampling mode {mode!r}")
    sums = all_gather(torch.sum(w).reshape(1), ax.part_group)     # [S]
    # the same bounds on every rank, so ownership by search is unique: no
    # float gaps or overlaps between the shards' own interval tests
    bounds = _cumsum_1d(sums)
    off = torch.cat([torch.zeros_like(sums[:1]), bounds[:-1]])[ax.part_rank]
    q = _comb(u, n, scheme, w.dtype) * torch.sum(sums)             # [N]
    owner = torch.clamp(torch.searchsorted(bounds, q, right=True), 0,
                        ax.n_part - 1)
    # within-segment inverse CDF in global coordinates
    cdf_seg = off + _cumsum_1d(w)
    local_ai = torch.clamp(torch.searchsorted(cdf_seg, q, right=True), 0,
                           n_local - 1)
    ai = torch.where(owner == ax.part_rank, start + local_ai,
                     torch.zeros_like(local_ai)).to(torch.int32)
    # exactly one rank answers each query: the sum delivers each rank its
    # own children's answers
    return torch.clamp(reduce_scatter(ai, ax.part_group), 0, n - 1)


def sharded_resample_local(u, w, mesh, scheme: str = "systematic"):
    """Island resampling: no collective, no crossing particle.

    Each shard draws its n_local children from its own particles by a
    local inverse-CDF comb, and they inherit the shard's weight: logw' =
    log W_o - log n_local. Unbiased: E[#children of i] * child weight =
    n_local (w_i / W_o) (W_o / n_local) = w_i. A shard whose region loses
    mass decays, so watch the ESS and resample globally when it skews.

    u: one uniform a shard for systematic ([S]) or n_local a shard for
    stratified and multinomial ([S, n_local] or [N]), the same global
    tensor on every rank; w: this rank's block of the normalized weights.
    Returns (ai [n_local] int32 global indices, all on this shard;
    logw_prev [n_local] the log-weights the children restart from).
    """
    ax = mesh_axes(mesh)
    n_local = w.shape[0]
    u_mine = u.reshape(ax.n_part, -1)[ax.part_rank]
    if scheme == "systematic":
        u_mine = u_mine[0]
    W = torch.clamp(torch.sum(w), min=1e-38)
    cdf = _cumsum_1d(w)
    q = _comb(u_mine, n_local, scheme, w.dtype) * W
    local_ai = torch.clamp(torch.searchsorted(cdf, q, right=True), 0,
                           n_local - 1)
    ai = (ax.part_rank * n_local + local_ai).to(torch.int32)
    logw_prev = torch.zeros(n_local, dtype=w.dtype, device=w.device) \
        + (torch.log(W) - math.log(n_local))
    return ai, logw_prev
