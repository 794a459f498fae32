"""Particle and map-block sharding on torch.distributed (port of
rbslam_tpu/parallel): one process per card, a DeviceMesh with dims
("particles", "map"), explicit collectives counted by kind."""

from .distributed import initialize_distributed, make_hybrid_mesh
from .map_axis import quad_form_rowsharded, woodbury_rank_ny_rowsharded
from .mesh import (
    collective_counts,
    make_mesh,
    map_sharding,
    particle_map_sharding,
    particle_sharding,
    reset_collective_counts,
)
from .resampling import sharded_resample_indices, sharded_resample_local
from .sharded import (
    ShardedParticleState,
    gather_particles,
    shard_rbpf_state,
    sharded_step_fn,
)

__all__ = [
    "initialize_distributed", "make_hybrid_mesh",
    "make_mesh", "particle_sharding", "map_sharding",
    "quad_form_rowsharded", "woodbury_rank_ny_rowsharded",
    "sharded_resample_indices", "sharded_resample_local",
    "shard_rbpf_state", "sharded_step_fn",
    "particle_map_sharding", "ShardedParticleState", "gather_particles",
    "collective_counts", "reset_collective_counts",
]
