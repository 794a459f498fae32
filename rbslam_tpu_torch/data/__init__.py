from .fields import (
    PotentialFieldDraw,
    ScalarFieldDraw,
    draw_scalar_field,
    draw_scalar_potential_field,
)
from .simulate import DenseDataset, simulate_dense_dataset
from .sparse_visual import (
    SparseVisualData,
    SparseVisualDraws,
    load_sparse_visual,
)
from .trajectories import TRAJECTORY_TYPES, Trajectory, generate_trajectory

__all__ = [
    "PotentialFieldDraw", "ScalarFieldDraw", "draw_scalar_field",
    "draw_scalar_potential_field",
    "DenseDataset", "simulate_dense_dataset",
    "SparseVisualData", "SparseVisualDraws", "load_sparse_visual",
    "TRAJECTORY_TYPES", "Trajectory", "generate_trajectory",
]
