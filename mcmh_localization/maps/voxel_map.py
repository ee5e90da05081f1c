"""3-D voxel occupancy map — the BASELINE stretch config #5 substrate.

The reference is strictly 2-D (occupancy-grid PGM maps,
``amcmh_localizer.py:124-177``); this extends the same design to a
(D, H, W) voxel grid for 3-D lidar sensing: trinary occupancy, a
precomputed 3-D Euclidean distance transform (the likelihood-field
trick in one more dimension), and world<->voxel transforms.  Pose space
stays SE(2) (planar robot) — the sensor is what becomes 3-D.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.utils import pytree as struct


@struct.dataclass
class VoxelMap:
    occupancy: jnp.ndarray          # (D, H, W) int8: -1 unknown, 0 free, 100 occ
    distance: jnp.ndarray           # (D, H, W) float32 meters to nearest occ
    resolution: float = struct.field(pytree_node=False)
    # world coords of voxel (0, 0, 0)'s min corner: (x, y, z)
    origin: Tuple[float, float, float] = struct.field(pytree_node=False)
    # EDT cap applied at build time (None = uncapped); recorded so
    # save/load round-trips reproduce the same distance volume
    max_distance: float | None = struct.field(pytree_node=False, default=None)

    @property
    def depth(self) -> int:
        return self.occupancy.shape[0]

    @property
    def height(self) -> int:
        return self.occupancy.shape[1]

    @property
    def width(self) -> int:
        return self.occupancy.shape[2]

    def world_to_voxel(self, x, y, z):
        inv = 1.0 / self.resolution
        vx = jnp.floor((x - self.origin[0]) * inv).astype(jnp.int32)
        vy = jnp.floor((y - self.origin[1]) * inv).astype(jnp.int32)
        vz = jnp.floor((z - self.origin[2]) * inv).astype(jnp.int32)
        return vx, vy, vz

    def in_bounds(self, vx, vy, vz):
        return (
            (vx >= 0) & (vx < self.width)
            & (vy >= 0) & (vy < self.height)
            & (vz >= 0) & (vz < self.depth)
        )

    def is_free_world(self, x, y, z) -> jnp.ndarray:
        vx, vy, vz = self.world_to_voxel(x, y, z)
        inb = self.in_bounds(vx, vy, vz)
        occ = self.occupancy[
            jnp.clip(vz, 0, self.depth - 1),
            jnp.clip(vy, 0, self.height - 1),
            jnp.clip(vx, 0, self.width - 1),
        ]
        return inb & (occ == 0)


def build_voxel_map(
    occupancy: np.ndarray,
    resolution: float,
    origin: Tuple[float, float, float],
    max_distance: float | None = None,
) -> VoxelMap:
    """Build a VoxelMap with its 3-D EDT (host-side precompute, once per
    map — mirrors the 2-D design decision documented at
    maps/grid_map.py::_compute_edt; the reference's own EDT was a host
    scipy call, amcmh_localizer.py:156)."""
    occ = np.asarray(occupancy, dtype=np.int8)
    occupied = occ > 50
    if occupied.any():
        from scipy.ndimage import distance_transform_edt

        dist = distance_transform_edt(~occupied, sampling=resolution)
    else:
        dist = np.full(occ.shape, 1e6, dtype=np.float64)
    if max_distance is not None:
        dist = np.minimum(dist, max_distance)
    return VoxelMap(
        occupancy=jnp.asarray(occ),
        distance=jnp.asarray(dist.astype(np.float32)),
        resolution=float(resolution),
        origin=(float(origin[0]), float(origin[1]), float(origin[2])),
        max_distance=None if max_distance is None else float(max_distance),
    )


def raycast3d(
    pose_xyz: jnp.ndarray,      # (3,) ray origin in world coords
    azimuth: jnp.ndarray,       # (M,) world-frame azimuth per ray
    elevation: jnp.ndarray,     # (M,) elevation per ray
    vmap_: VoxelMap,
    max_range: float,
    step: float = 0.1,
) -> jnp.ndarray:
    """Fixed-step DDA in 3-D (simulator/golden path; the scorer never
    raycasts — it uses the distance volume).  Same event semantics as the
    2-D ``models/sensor.py::raycast``: first occupied voxel -> i*step,
    leaving the volume -> max_range."""
    n_steps = int(max_range / step)
    d = jnp.arange(1, n_steps + 1, dtype=jnp.float32) * step  # (S,)
    ce = jnp.cos(elevation)
    dx = ce * jnp.cos(azimuth)
    dy = ce * jnp.sin(azimuth)
    dz = jnp.sin(elevation)
    px = pose_xyz[0] + d[None, :] * dx[:, None]   # (M, S)
    py = pose_xyz[1] + d[None, :] * dy[:, None]
    pz = pose_xyz[2] + d[None, :] * dz[:, None]
    vx, vy, vz = vmap_.world_to_voxel(px, py, pz)
    inb = vmap_.in_bounds(vx, vy, vz)
    occ = vmap_.occupancy[
        jnp.clip(vz, 0, vmap_.depth - 1),
        jnp.clip(vy, 0, vmap_.height - 1),
        jnp.clip(vx, 0, vmap_.width - 1),
    ]
    event = (~inb) | (occ > 50)
    hit = inb & (occ > 50)
    first = jnp.argmax(event, axis=1)                     # (M,)
    any_event = jnp.any(event, axis=1)
    first_hit = jnp.take_along_axis(hit, first[:, None], 1)[:, 0]
    r = jnp.where(
        any_event & first_hit, d[first], jnp.float32(max_range)
    )
    return r


def nav_slice(voxel_map: VoxelMap, z: float = 0.0, edt_impl: str = "scipy"):
    """2-D navigation GridMap extracted from the voxel layer at height z.

    The planar motion model, validity checks, and free-space injection all
    operate on the robot's navigation plane; only the SENSOR is 3-D.  The
    returned GridMap shares the voxel map's resolution and x/y origin.
    """
    import numpy as np

    from mcmh_localization.maps.grid_map import build_grid_map

    k = int(np.clip(
        np.floor((z - voxel_map.origin[2]) / voxel_map.resolution),
        0, voxel_map.depth - 1,
    ))
    occ2d = np.asarray(voxel_map.occupancy)[k]
    return build_grid_map(
        occ2d, voxel_map.resolution,
        (voxel_map.origin[0], voxel_map.origin[1]),
        edt_impl=edt_impl,
    )


def save_voxel_map(path: str, voxel_map: VoxelMap) -> None:
    """NPZ persistence (occupancy + metadata; the EDT rebuilds on load —
    it is derived data, and storing it would triple the file)."""
    np.savez_compressed(
        path,
        occupancy=np.asarray(voxel_map.occupancy),
        resolution=np.float64(voxel_map.resolution),
        origin=np.asarray(voxel_map.origin, dtype=np.float64),
        max_distance=np.float64(
            np.nan if voxel_map.max_distance is None
            else voxel_map.max_distance
        ),
    )


def load_voxel_map(path: str) -> VoxelMap:
    with np.load(path) as z:
        md = float(z["max_distance"]) if "max_distance" in z else np.nan
        return build_voxel_map(
            z["occupancy"], float(z["resolution"]),
            tuple(z["origin"]),
            max_distance=None if np.isnan(md) else md,
        )
