"""Sharded RBPF stepping: the particle ensemble over a (particles, map) mesh
(port of rbslam_tpu/parallel/sharded.py).

Each rank holds a contiguous block of the ensemble's particles and, for
the [nl, nl] covariances, a row block over the ``map`` axis
(parallel/mesh.py). :class:`ShardedEnsemble` gives the engines
(engines/rbpf.py, engines/rbps_info.py) the particle-axis operations of
their single-process :class:`~rbslam_tpu_torch.engines.rbpf.Ensemble`
with explicit collectives, where the JAX package lets GSPMD insert them
from sharding annotations:

- normalization: one all-gather of the [N] log-weights, then the
  single-process log-sum-exp on the whole vector (the ESS, the argmax and
  the resampling CDF then come from the same vector on every rank, equal
  to the unsharded run's);
- the ancestor gather: one all-gather of the operand along ``particles``
  (the map blocks stay put), then a local index, as the JAX engine's
  explicit gather (rbslam_tpu/engines/rbpf.py:310-336): during the gather
  every particle rank holds the whole operand;
- sums over particles (weighted means, the row of the best particle, the
  retry count): one all-reduce.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..engines.rbpf import Ensemble
from ..math.linalg import ess_from_logw, logsumexp_normalize
from .map_axis import MapAxis
from .mesh import (
    all_gather,
    all_reduce,
    mesh_axes,
    particle_map_sharding,
    particle_sharding,
)
from .resampling import sharded_resample_indices, sharded_resample_local


class ShardedEnsemble(Ensemble):
    """The particle axis of a rank's block of N particles over ``mesh``,
    with the map axis of n_lin-row matrices; ``mode`` is the
    distributed resampling mode (``RBPFConfig.dist_resampling``)."""

    def __init__(self, n_particles: int, mesh, n_lin: int,
                 mode: str = "replicated_cdf"):
        ax = mesh_axes(mesh)
        if n_particles % ax.n_part:
            raise ValueError(f"{n_particles} particles do not divide over "
                             f"{ax.n_part} 'particles' ranks")
        self.n = n_particles
        self.n_local = n_particles // ax.n_part
        self.start = ax.part_rank * self.n_local
        self.mesh, self.ax, self.mode = mesh, ax, mode
        self.map = MapAxis(mesh, n_lin)
        self.map_rows = self.map.rows

    def local(self, x, axis=0):
        return x.narrow(axis, self.start, self.n_local)

    def whole(self, x, axis=0):
        return all_gather(x, self.ax.part_group, axis)

    def whole_rows(self, x, axis):
        return self.map.gather(x, axis)

    def sum(self, x):
        return all_reduce(x, self.ax.part_group)

    def normalize(self, logw):
        w, logw_n, logz = logsumexp_normalize(self.whole(logw))
        return self.local(w), self.local(logw_n), logz, logw_n

    def take(self, x, ai):
        return self.whole(x)[ai]

    def _mine(self, x, idx):
        """x's rows of the global particles idx (1-D) where this rank
        holds them, else zeros."""
        j = idx - self.start
        r = x.index_select(0, j.clamp(0, self.n_local - 1))
        inside = (j >= 0) & (j < self.n_local)
        return torch.where(inside.reshape((-1,) + (1,) * (x.dim() - 1)), r,
                           torch.zeros_like(r))

    def rows_at(self, x, idx):
        return self.sum(self._mine(x, idx))

    def top_and_mean(self, x, w, logw_all):
        top = self._mine(x, torch.argmax(logw_all).reshape(1))[0]
        out = self.sum(torch.stack([top, torch.sum(x * w[:, None], dim=0)]))
        return out[0], out[1]

    def u_shape(self, scheme: str) -> tuple:
        """The island resampler takes one systematic offset a particle
        shard."""
        if scheme == "systematic" and self.mode == "local":
            return (self.ax.n_part,)
        return super().u_shape(scheme)

    def resample(self, u, w, scheme):
        if self.mode == "local":
            return sharded_resample_local(u, w, self.mesh, scheme)
        return (sharded_resample_indices(u, w, self.mesh, scheme, self.mode),
                None)


class ShardedParticleState(NamedTuple):
    xn: torch.Tensor     # [N/S_p, n_nonlin]
    xl: torch.Tensor     # [N/S_p, n_lin]
    P: torch.Tensor      # [N/S_p, n_lin/S_map, n_lin] (rows over map)
    logw: torch.Tensor   # [N/S_p] normalized log-weights


def shard_rbpf_state(state: ShardedParticleState, mesh,
                     shard_map_axis: bool = True) -> ShardedParticleState:
    """This rank's block of a global ensemble state: particles over
    ``particles``; P's rows over ``map`` too, or whole with
    ``shard_map_axis=False``."""
    P_sh = (particle_map_sharding(mesh, 3, 1) if shard_map_axis
            else particle_sharding(mesh, 3))
    part = particle_sharding(mesh, 2)
    return ShardedParticleState(
        xn=part.local(state.xn), xl=part.local(state.xl),
        P=P_sh.local(state.P), logw=part.local(state.logw))


def sharded_step_fn(model, mesh, R, jitter: float = 1e-3,
                    resampling: str = "systematic",
                    shard_map_axis: bool = True):
    """Build one sharded filter step.

    Returns ``step(state, y_t, mask_t, u, Q_t, dt_t, *, generator=None,
    noise=None) -> (state', ess)``: resample (``replicated_cdf``, equal
    to the global resampler), gather the ancestors, propagate, run the
    measurement update (with the map axis unless ``shard_map_axis`` is
    False, when every map rank updates whole matrices) and normalize.
    ``noise = (u_res, w)``: the global uniforms (0-d for systematic, [N]
    otherwise) and the global [N, n_noise] normals, or draws of those
    shapes from ``generator``; ``ess`` is the whole ensemble's.
    """
    from ..engines.rbpf import _dynamics_batch, _jacobian_batch, _pad_last
    from ..models.base import SparseModel
    from ..ops.kalman import (
        kalman_update_dense_batched,
        kalman_update_masked_batched,
    )

    def step(state: ShardedParticleState, y_t, mask_t, u, Q_t, dt_t, *,
             generator: Optional[torch.Generator] = None, noise=None):
        n_p = state.logw.shape[0] * mesh_axes(mesh).n_part
        ens = ShardedEnsemble(n_p, mesh, state.xl.shape[-1])
        axis = ens.map if shard_map_axis else None
        if noise is None:
            dev = state.logw.device
            u_res = torch.rand(ens.u_shape(resampling), generator=generator,
                               device=dev)
            w = torch.randn((n_p, model.n_noise), generator=generator,
                            device=dev)
        else:
            u_res, w = noise
        ai, _ = ens.resample(u_res, torch.exp(state.logw), resampling)
        xn = _dynamics_batch(model, ens.local(w), ens.take(state.xn, ai), u,
                             dt_t, Q_t)
        xl, P = ens.take(state.xl, ai), ens.take(state.P, ai)
        if isinstance(model, SparseModel):
            yhat, H = model.measure(xn, xl)
            xl, P, logw, _ = kalman_update_masked_batched(
                yhat, H, P, xl, y_t, R, mask_t, jitter, axis)
        else:
            xl, P, logw, _ = kalman_update_dense_batched(
                _pad_last(_jacobian_batch(model, xn), P.shape[-1]), P, xl,
                y_t, R, jitter, axis=axis)
        _, logw_n, _, logw_all = ens.normalize(logw)
        return (ShardedParticleState(xn=xn, xl=xl, P=P, logw=logw_n),
                ess_from_logw(logw_all))

    return step


# axes of the per-particle fields of RBPFResult and ShardedParticleState
_PARTICLE_AXIS = {"xn": 0, "xl": 0, "logw": 0, "P": 0, "ancestors": 1,
                  "xn_hist": 1, "xn_traj": 1}


def gather_particles(result, mesh):
    """``result`` (RBPFResult or ShardedParticleState of this rank) with
    every per-particle field gathered whole: the particles of all ranks in
    order, and P's map rows. Every rank calls it (collectives)."""
    ax = mesh_axes(mesh)
    out = {}
    for field, axis in _PARTICLE_AXIS.items():
        x = getattr(result, field, None)
        if x is None or x.dim() <= axis:
            continue
        if field == "P":
            x = all_gather(x, ax.map_group, 1)
        out[field] = all_gather(x, ax.part_group, axis)
    return result._replace(**out)
