from .base import DenseModel
from .mag3d import dynamics_with_increment, make_mag3d_model

__all__ = ["DenseModel", "dynamics_with_increment", "make_mag3d_model"]
