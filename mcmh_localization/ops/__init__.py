from mcmh_localization.ops.resampling import (
    softmax_weights,
    effective_sample_size,
    systematic_resample_indices,
    multinomial_resample_indices,
    kld_resample,
)

__all__ = [
    "softmax_weights",
    "effective_sample_size",
    "systematic_resample_indices",
    "multinomial_resample_indices",
    "kld_resample",
]
