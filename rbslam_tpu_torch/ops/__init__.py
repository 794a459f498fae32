from .kalman import (
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
    "kalman_update_dense_batched", "kalman_update_dense_batched_hld",
    "kalman_update_masked", "kalman_update_masked_batched",
    "masked_log_weights",
    "multinomial_resample", "resample_indices", "sample_categorical",
    "stratified_resample", "systematic_resample",
]
