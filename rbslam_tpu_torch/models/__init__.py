from .base import DenseModel
from .mag3d import dynamics_with_increment, make_mag3d_model
from .radio2d import make_radio2d_model

__all__ = ["DenseModel", "dynamics_with_increment", "make_mag3d_model",
           "make_radio2d_model"]
