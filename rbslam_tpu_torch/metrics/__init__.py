from .rmse import aligned_position_rmse, orientation_rmse_deg, rms

__all__ = ["aligned_position_rmse", "orientation_rmse_deg", "rms"]
