from mcmh_localization.io.pgm import read_pgm, write_pgm, load_map_yaml
from mcmh_localization.io.rosbag import read_rosbag, write_rosbag
from mcmh_localization.io.rosbag2 import read_rosbag2, write_rosbag2

__all__ = [
    "read_pgm",
    "write_pgm",
    "load_map_yaml",
    "read_rosbag",
    "write_rosbag",
    "read_rosbag2",
    "write_rosbag2",
]
