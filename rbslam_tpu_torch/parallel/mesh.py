"""Device mesh and collectives for the particle x map-block sharding (port of
rbslam_tpu/parallel/mesh.py).

The domain's two parallel axes:

- ``particles``, the data-parallel axis: every per-particle tensor (xn,
  xl, P, logw) holds a contiguous block of the ensemble's leading axis on
  each rank, in rank order (src/particleFilter.m:104-204's loops).
- ``map``, the model-parallel axis: each [nl, nl] covariance or
  information matrix holds a ROW block (axis -2) on each rank of the
  ``map`` group. For a symmetric matrix that is the transpose of the JAX
  engine's column blocks (its GSPMD annotation shards axis 2) and the
  layout of its explicit map-axis functions (parallel/map_axis.py).

The JAX package is one process over a ``jax.sharding.Mesh`` and lets GSPMD
insert most collectives. Here every rank is its own process
(``torch.distributed``), the mesh is a ``DeviceMesh`` with dims
``("particles", "map")``, and every collective is written out. Each one
goes through a wrapper below that adds one to its count
(:func:`collective_counts`), as the kernels' wrappers count launches, so
a run can show how many collectives of each kind a step made. A group of
one rank runs the same calls.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

PARTICLES, MAP = "particles", "map"
COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
_calls = dict.fromkeys(COLLECTIVES, 0)

# torch >= 2.8 names the tensor forms *_single; older releases only have
# the *_into_tensor / *_tensor names
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def collective_counts() -> dict:
    """Collectives called in this process since the last reset, by kind."""
    return dict(_calls)


def reset_collective_counts() -> None:
    for k in _calls:
        _calls[k] = 0


def _memory_order(x: torch.Tensor):
    """x's dims from outermost to innermost in memory (by stride), and the
    permutation back. The collectives hand a tensor over in this order and
    return it in x's layout: a product on the card rounds a transposed
    operand otherwise than a contiguous one, so a layout that changed
    where the unsharded run keeps it would change the run's bits."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    return order, [order.index(d) for d in range(x.dim())]


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (or max) of ``x`` over ``group``: a new tensor in x's layout."""
    order, back = _memory_order(x)
    out = x.permute(order).contiguous().clone()
    _calls["all_reduce"] += 1
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return out.permute(back)


def all_gather(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``axis`` in rank
    order, in x's layout (the rank blocks outermost)."""
    n = dist.get_world_size(group)
    if x.dim() == 0:
        x = x.reshape(1)
    axis %= x.dim()
    order, back = _memory_order(x)
    y = x.permute(order).contiguous()
    out = torch.empty((n * y.shape[0],) + tuple(y.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _calls["all_gather"] += 1
    _all_gather(out, y, group=group)
    a = order.index(axis)
    out = out.reshape((n,) + tuple(y.shape)).movedim(0, a).flatten(a, a + 1)
    return out.permute(back)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, of which each rank keeps its block
    of the leading axis (the ``psum_scatter`` of the JAX package)."""
    n = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _calls["reduce_scatter"] += 1
    _reduce_scatter(out, x.contiguous(), group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [S, ...]: row s goes to rank s; returns [S, ...] whose row s
    came from rank s."""
    x = x.contiguous()
    out = torch.empty_like(x)
    _calls["all_to_all"] += 1
    dist.all_to_all_single(out, x, group=group)
    return out


class MeshAxes(NamedTuple):
    """A rank's place in a (particles, map) mesh."""

    n_part: int         # ranks along ``particles``
    n_map: int          # ranks along ``map``
    part_rank: int
    map_rank: int
    part_group: object
    map_group: object


def mesh_axes(mesh) -> MeshAxes:
    """The sizes, this rank's coordinates and the two groups of ``mesh``,
    which must be a DeviceMesh with dims ("particles", "map")."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names != (PARTICLES, MAP):
        raise ValueError(
            "mesh must be a torch DeviceMesh with dims ('particles', 'map') "
            f"(parallel.make_mesh); got {type(mesh).__name__} with dims "
            f"{names}")
    return MeshAxes(
        n_part=mesh.size(0), n_map=mesh.size(1),
        part_rank=mesh.get_local_rank(PARTICLES),
        map_rank=mesh.get_local_rank(MAP),
        part_group=mesh.get_group(PARTICLES), map_group=mesh.get_group(MAP))


def make_mesh(n_particle_shards: Optional[int] = None, n_map_shards: int = 1,
              device_type: str = "cuda"):
    """A (particles, map) DeviceMesh over every rank of the default process
    group (``initialize_distributed`` or ``init_process_group`` first).
    Ranks fill the mesh row-major: rank = particle shard * n_map + map
    shard."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialized default process "
                         "group (parallel.initialize_distributed)")
    n = dist.get_world_size()
    if n_particle_shards is None:
        n_particle_shards = n // n_map_shards
    if n_particle_shards * n_map_shards != n:
        raise ValueError(f"{n_particle_shards} x {n_map_shards} != {n} ranks")
    return init_device_mesh(device_type, (n_particle_shards, n_map_shards),
                            mesh_dim_names=(PARTICLES, MAP))


class Sharding(NamedTuple):
    """Which block of a global tensor a rank holds: ``axes`` maps a tensor
    axis to the mesh dim ("particles" or "map") it is split over, in
    contiguous equal blocks in rank order; other axes are whole."""

    mesh: object
    axes: dict

    def _place(self, axis: int):
        """(shards, this rank's shard, group) of the mesh dim of ``axis``."""
        ax = mesh_axes(self.mesh)
        if self.axes[axis] == PARTICLES:
            return ax.n_part, ax.part_rank, ax.part_group
        return ax.n_map, ax.map_rank, ax.map_group

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``x`` (a view)."""
        for axis in self.axes:
            n, r, _ = self._place(axis)
            if x.shape[axis] % n:
                raise ValueError(
                    f"axis {axis} of size {x.shape[axis]} does not divide "
                    f"over {n} '{self.axes[axis]}' ranks")
            x = x.narrow(axis, r * (x.shape[axis] // n), x.shape[axis] // n)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block ``x`` (one all-gather
        per sharded axis)."""
        for axis in self.axes:
            x = all_gather(x, self._place(axis)[2], axis)
        return x


def particle_sharding(mesh, ndim: int) -> Sharding:
    """Leading (particle) axis over ``particles``; the rest whole."""
    del ndim
    return Sharding(mesh, {0: PARTICLES})


def map_sharding(mesh, ndim: int, axis: int) -> Sharding:
    """One basis-block axis over ``map``."""
    return Sharding(mesh, {axis % ndim: MAP})


def particle_map_sharding(mesh, ndim: int, map_axis: int) -> Sharding:
    """Leading axis over ``particles``, one later axis over ``map`` (the
    port's matrices: ``map_axis`` = 1, the row axis of [N, nl, nl])."""
    return Sharding(mesh, {0: PARTICLES, map_axis % ndim: MAP})
