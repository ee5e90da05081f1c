from mcmh_localization.filter.state import FilterState
from mcmh_localization.filter.mh import symmetric_mh, asymmetric_mh
from mcmh_localization.filter.init import init_uniform, init_gaussian
from mcmh_localization.filter.estimate import estimate_pose, PoseEstimate
from mcmh_localization.filter.step import (
    make_step,
    make_run,
    make_model,
    FilterModel,
    StepInfo,
    state_size,
)

__all__ = [
    "FilterState",
    "symmetric_mh",
    "asymmetric_mh",
    "init_uniform",
    "init_gaussian",
    "estimate_pose",
    "PoseEstimate",
    "make_step",
    "make_run",
    "make_model",
    "FilterModel",
    "StepInfo",
    "state_size",
]
