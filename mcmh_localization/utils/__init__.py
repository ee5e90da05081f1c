from mcmh_localization.utils.angles import (
    normalize_angle,
    normalize_angle_about,
    yaw_from_quaternion,
    quaternion_from_yaw,
)

__all__ = [
    "normalize_angle",
    "normalize_angle_about",
    "yaw_from_quaternion",
    "quaternion_from_yaw",
]
