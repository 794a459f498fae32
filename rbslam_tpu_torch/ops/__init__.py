from .kalman import kalman_update_dense_batched
from .resampling import (
    multinomial_resample,
    resample_indices,
    stratified_resample,
    systematic_resample,
)

__all__ = [
    "kalman_update_dense_batched",
    "multinomial_resample", "resample_indices", "stratified_resample",
    "systematic_resample",
]
