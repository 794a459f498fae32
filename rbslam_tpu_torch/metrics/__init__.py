from .rmse import aligned_position_rmse, rms

__all__ = ["aligned_position_rmse", "rms"]
