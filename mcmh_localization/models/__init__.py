from mcmh_localization.models.motion import (
    compute_motion,
    invert_delta,
    sample_motion,
    motion_density,
)
from mcmh_localization.models.sensor import (
    log_likelihood_field,
    likelihood_field_scores,
    raycast,
    raycast_beam_scores,
)

__all__ = [
    "compute_motion",
    "invert_delta",
    "sample_motion",
    "motion_density",
    "log_likelihood_field",
    "likelihood_field_scores",
    "raycast",
    "raycast_beam_scores",
]
