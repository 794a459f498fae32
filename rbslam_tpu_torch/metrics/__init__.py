from .rmse import (
    aligned_position_rmse,
    map_and_path_rmse,
    orientation_rmse_deg,
    rms,
)

__all__ = ["aligned_position_rmse", "map_and_path_rmse",
           "orientation_rmse_deg", "rms"]
