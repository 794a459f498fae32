"""Offline figures and animations from a run's arrays (NumPy and
matplotlib; matplotlib is imported at first use, so this package imports
without it)."""

from .homography import apply_homography, estimate_homography
from .plots import (
    plot_degeneracy,
    plot_dense_map,
    plot_landmark_map,
    plot_trajectories,
    require_matplotlib,
)

__all__ = [
    "plot_dense_map", "plot_trajectories", "plot_landmark_map",
    "plot_degeneracy", "estimate_homography", "apply_homography",
    "require_matplotlib",
]
