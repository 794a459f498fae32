from .kalman import (
    dense_log_weights,
    kalman_update_dense,
    kalman_update_dense_batched,
    kalman_update_dense_batched_hld,
    kalman_update_masked,
    kalman_update_masked_batched,
    masked_log_weights,
)
from .resampling import (
    multinomial_resample,
    resample_indices,
    sample_categorical,
    stratified_resample,
    systematic_resample,
)

__all__ = [
    "dense_log_weights", "kalman_update_dense",
    "kalman_update_dense_batched", "kalman_update_dense_batched_hld",
    "kalman_update_masked", "kalman_update_masked_batched",
    "masked_log_weights",
    "multinomial_resample", "resample_indices", "sample_categorical",
    "stratified_resample", "systematic_resample",
]
