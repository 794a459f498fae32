"""Process-group bootstrap and the hybrid (hosts x cards) mesh (port of
rbslam_tpu/parallel/distributed.py).

The JAX package runs one process per host over all its devices
(``jax.distributed.initialize``). Here every card is its own process:
``torchrun --nproc-per-node=<cards>`` starts them and sets MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK, and
:func:`initialize_distributed` joins them into one process group, NCCL
on ``cuda:LOCAL_RANK`` by default, gloo on the CPU when the caller asks
for it.

Axis layout: the ``particles`` axis carries the ancestor gather, the one
large exchange of the filter, while the weight collectives are O(N)
floats. :func:`make_hybrid_mesh` puts the hosts outermost on
``particles`` (a host's ranks are contiguous particle shards, so most
systematic-resampling crossings stay on the host) and keeps every ``map``
group (the per-particle matrix products' partners) within one host.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import make_mesh


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device: str = "cuda") -> bool:
    """Join the process group of a multi-process launch (idempotent).

    Arguments left None come from torchrun's environment (WORLD_SIZE,
    RANK; the rendezvous from MASTER_ADDR and MASTER_PORT, ``env://``).
    ``device="cuda"`` uses NCCL and makes ``cuda:LOCAL_RANK`` this
    process's current card; ``device="cpu"`` uses gloo. Returns True
    when a process group is active after the call, False, having done
    nothing, for a single-process launch (no world size given or in the
    environment): every engine then runs without a mesh.
    """
    if dist.is_initialized():
        return True
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None:
        return False
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def make_hybrid_mesh(n_map_shards: int = 1, device_type: str = "cuda"):
    """(particles, map) mesh over all ranks with the hosts outermost.

    torchrun numbers ranks host by host (rank = node rank x
    LOCAL_WORLD_SIZE + local rank), so the row-major mesh of
    :func:`make_mesh` puts each host's ranks on contiguous particle shards;
    ``n_map_shards`` must divide the ranks of one host (LOCAL_WORLD_SIZE,
    all ranks when it is not set), so that no ``map`` group spans hosts.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % n_map_shards:
        raise ValueError(f"{n} ranks not divisible by map={n_map_shards}")
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n_map_shards > per_host or per_host % n_map_shards:
        raise ValueError(
            f"map={n_map_shards} must divide the {per_host} ranks of one "
            "host (the map axis must stay within a host)")
    return make_mesh(n // n_map_shards, n_map_shards, device_type)
