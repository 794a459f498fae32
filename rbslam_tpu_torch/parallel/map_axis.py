"""Map-axis (basis-block) model parallelism for the per-particle [nl, nl]
matrices (port of rbslam_tpu/parallel/map_axis.py).

Why: at n_lin ~ 1000 each particle's covariance P and the information-form
smoother's W = (Imat + ImatAdd)^-1 take ~4 MB in float32, so an ensemble of
1000 particles needs ~4 GB per matrix. The ``map`` mesh axis keeps a ROW
block of every such matrix on each rank of the ``map`` group, so the
memory per rank falls as 1/S_map (reference semantics:
src/particleSmootherInformationForm.m:224-236).

:class:`MapAxis` holds a rank's row block and the collectives the
algebra needs; the engines pass it to the dense and masked Kalman updates
(ops/kalman.py), the Woodbury transition and the quadratic forms. The two
public builders keep the JAX package's names, layout (row blocks) and
collectives:

- Woodbury: one all-reduce of Bpos [N, ny, ny] and one all-gather of the
  thin factor G [N, nl, ny] (O(N nl ny), a factor nl/ny below the
  [N, nl, nl] matrices, which stay put);
- quadratic form: one all-reduce of [N], a scalar per particle.

Both equal the unsharded forms (engines/rbps_info.py) element for element
up to the order of the partial sums; with one rank on ``map`` they are
the same operations.
"""

from __future__ import annotations

import torch

from .mesh import all_gather, all_reduce, all_to_all, mesh_axes


class MapAxis:
    """This rank's row block ``rows`` of [..., nl, nl] matrices over the
    mesh's ``map`` group (nl must divide over its ranks)."""

    def __init__(self, mesh, nl: int):
        ax = mesh_axes(mesh)
        if nl % ax.n_map:
            raise ValueError(f"n_lin={nl} does not divide over {ax.n_map} "
                             "'map' ranks")
        self.n = ax.n_map
        self.nl = nl
        self.block = nl // ax.n_map
        self.rows = slice(ax.map_rank * self.block,
                          (ax.map_rank + 1) * self.block)
        self.group = ax.map_group

    def gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Every rank's block of ``axis`` concatenated: the whole axis."""
        return all_gather(x, self.group, axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Complete a sum whose terms are split over the row blocks."""
        return all_reduce(x, self.group)

    def transpose(self, A: torch.Tensor) -> torch.Tensor:
        """The row block of M^T from the row block A [n, b, nl] of M: one
        all-to-all of [n, b, b] tiles (rank s gets the tile of its
        columns), no all-gather of M."""
        n, b, S = A.shape[0], self.block, self.n
        tiles = all_to_all(A.reshape(n, b, S, b).permute(2, 0, 1, 3), self.group)
        # tiles[s] = M[:, rows_s, rows_me]; (M^T)[:, rows_me, rows_s] is its
        # transpose
        return tiles.permute(1, 3, 0, 2).reshape(n, b, S * b)

    def symmetrize(self, A: torch.Tensor) -> torch.Tensor:
        """Row block of 0.5 (M + M^T) (ekf_dense.m:92)."""
        return 0.5 * (A + self.transpose(A))


def quad_partial(v: torch.Tensor, W: torch.Tensor, axis) -> torch.Tensor:
    """This rank's term of v' M v per particle: v [N, nl], W [N, b, nl] the
    row block of M (the whole M where ``axis`` is None); float32."""
    rows = slice(None) if axis is None else axis.rows
    Wv = torch.einsum("pij,pj->pi", W.to(torch.float32), v)
    return torch.sum(v[:, rows] * Wv, dim=-1)


def woodbury_rank_ny_rowsharded(mesh):
    """Build the row-sharded Woodbury rank-ny transition.

    Returns ``f(W, hldM, U, sign, jitter=1e-9) -> (W', hldM', retried)``
    where W [N_loc, nl/S_map, nl] is this rank's block (particles, map
    rows), U [N_loc, nl, ny] and hldM [N_loc] its particles' whole rows:

        W' = W - sign G Bpos^-1 G',  G = W U,  Bpos = I + sign U' G,
        hldM' = hldM + 0.5 log|Bpos|

    exactly engines/rbps_info._woodbury_rank_ny, with the row blocks of W
    never leaving their rank.
    """
    from ..engines.rbps_info import _woodbury_rank_ny

    def f(W, hldM, U, sign, jitter=1e-9):
        return _woodbury_rank_ny(W, hldM, U, sign, jitter,
                                 MapAxis(mesh, W.shape[-1]))

    return f


def quad_form_rowsharded(mesh):
    """Build ``q(v, W) -> v' W v`` per particle with W row-sharded as in
    :func:`woodbury_rank_ny_rowsharded`: each rank adds v[rows]' (W_blk v)
    and one all-reduce of [N_loc] completes it (the ancestor-weight
    quadratic of src/particleSmootherInformationForm.m:224-236)."""

    def q(v, W):
        axis = MapAxis(mesh, W.shape[-1])
        return axis.reduce(quad_partial(v, W, axis))

    return q
