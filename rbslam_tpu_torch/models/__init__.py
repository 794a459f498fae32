from .base import DenseModel, SparseModel
from .mag3d import dynamics_with_increment, make_mag3d_model
from .pinhole2d import PinholeCamera, make_pinhole2d_model
from .radio2d import make_radio2d_model
from .terrain import (
    TerrainModel,
    gridify_gp,
    make_gridded_terrain_model,
    make_terrain_model,
)

__all__ = ["DenseModel", "SparseModel", "dynamics_with_increment",
           "make_mag3d_model", "PinholeCamera", "make_pinhole2d_model",
           "make_radio2d_model", "TerrainModel", "gridify_gp",
           "make_gridded_terrain_model", "make_terrain_model"]
