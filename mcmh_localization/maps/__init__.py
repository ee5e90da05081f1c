from mcmh_localization.maps.grid_map import GridMap, load_map, build_grid_map
from mcmh_localization.maps.edt import distance_transform_edt_device
from mcmh_localization.maps.voxel_map import (
    VoxelMap,
    build_voxel_map,
    load_voxel_map,
    nav_slice,
    raycast3d,
    save_voxel_map,
)

__all__ = [
    "GridMap",
    "load_map",
    "build_grid_map",
    "distance_transform_edt_device",
    "VoxelMap",
    "build_voxel_map",
    "nav_slice",
    "raycast3d",
    "save_voxel_map",
    "load_voxel_map",
]
