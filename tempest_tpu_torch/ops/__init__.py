from .tools import (
    compute_ess,
    effective_sample_size,
    ess_from_logw,
    increment_logz,
    logsumexp,
    multinomial_resample,
    systematic_resample,
    trim_weights_mask,
    volume_variation,
)

__all__ = [
    "compute_ess",
    "effective_sample_size",
    "ess_from_logw",
    "increment_logz",
    "logsumexp",
    "multinomial_resample",
    "systematic_resample",
    "trim_weights_mask",
    "volume_variation",
]
