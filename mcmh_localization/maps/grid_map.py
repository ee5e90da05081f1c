"""Occupancy-grid map as an immutable pytree.

Replaces the reference's ``load_map`` + scattered map members
(``amcmh_localizer.py:124-177``): occupancy array, precomputed EDT distance
map, origin/resolution, world<->grid transforms, and free-cell validity tests
(``parallel_utils.py:369-413``).  Everything lives on device as static-shape
arrays; origin/resolution are dynamic leaves so one compiled filter serves any
map of the same shape.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from mcmh_localization.io.pgm import load_map_yaml
from mcmh_localization.utils import pytree as struct


@struct.dataclass
class GridMap:
    """ROS-convention occupancy grid + derived fields.

    occupancy: (H, W) int8 — 0 free, 100 occupied, -1 unknown; row 0 is the
        bottom (origin corner) row, matching OccupancyGrid row-major layout
        consumed at amcmh_localizer.py:136.
    distance:  (H, W) float32 — meters to the nearest non-free cell
        (amcmh_localizer.py:153-157: unknown counts as an obstacle).
    origin:    (2,) float32 — world coords of the (0, 0) cell corner.
    resolution: () float32 — meters per cell.
    """

    occupancy: jnp.ndarray
    distance: jnp.ndarray
    origin: jnp.ndarray
    resolution: jnp.ndarray
    # (F, 2) float32 world coords of free-cell centers
    # (amcmh_localizer.py:161-165); used for exact uniform free-space
    # sampling without the reference's 50x oversample-and-reject
    # (parallel_utils.py:450-465).
    free_xy: jnp.ndarray
    # (H, W) float32 cached 0/1 free mask — is_free_world's gather table,
    # precomputed so per-step validity checks don't re-materialize the
    # occupancy conversion (it is NOT constant-folded when the map is a
    # traced argument, e.g. under vmap multi-map batching)
    free_mask: jnp.ndarray

    @property
    def height(self) -> int:
        return self.occupancy.shape[0]

    @property
    def width(self) -> int:
        return self.occupancy.shape[1]

    @property
    def limits(self) -> jnp.ndarray:
        """[x_min, x_max, y_min, y_max] (amcmh_localizer.py:168-173)."""
        ox, oy = self.origin[0], self.origin[1]
        return jnp.stack(
            [
                ox,
                ox + self.width * self.resolution,
                oy,
                oy + self.height * self.resolution,
            ]
        )

    # ---- transforms --------------------------------------------------------

    def world_to_grid(self, x, y) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(mx, my) cell indices; truncation toward zero like the reference's
        ``int((x - origin) / res)`` (parallel_utils.py:377-378)."""
        mx = ((x - self.origin[0]) / self.resolution).astype(jnp.int32)
        my = ((y - self.origin[1]) / self.resolution).astype(jnp.int32)
        return mx, my

    def grid_to_world(self, mx, my) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """World coords of cell centers (amcmh_localizer.py:163-164)."""
        x = self.origin[0] + (mx.astype(jnp.float32) + 0.5) * self.resolution
        y = self.origin[1] + (my.astype(jnp.float32) + 0.5) * self.resolution
        return x, y

    def in_bounds(self, mx, my) -> jnp.ndarray:
        return (mx >= 0) & (mx < self.width) & (my >= 0) & (my < self.height)

    # ---- queries (all safe out-of-bounds: clamp + mask) --------------------

    def occupancy_at(self, mx, my, fill: int = 100) -> jnp.ndarray:
        ok = self.in_bounds(mx, my)
        mxc = jnp.clip(mx, 0, self.width - 1)
        myc = jnp.clip(my, 0, self.height - 1)
        vals = self.occupancy[myc, mxc]
        return jnp.where(ok, vals, jnp.int8(fill))

    def distance_at(self, mx, my, fill: float = 0.0) -> jnp.ndarray:
        ok = self.in_bounds(mx, my)
        mxc = jnp.clip(mx, 0, self.width - 1)
        myc = jnp.clip(my, 0, self.height - 1)
        vals = self.distance[myc, mxc]
        return jnp.where(ok, vals, jnp.float32(fill))

    def is_free_world(self, x, y) -> jnp.ndarray:
        """Free-cell test for world coords; False out of bounds.
        Reference: parallel_utils.py:389-396 (is_valid_position)."""
        mx, my = self.world_to_grid(x, y)
        ok = self.in_bounds(mx, my)
        mxc = jnp.clip(mx, 0, self.width - 1)
        myc = jnp.clip(my, 0, self.height - 1)
        return ok & (self.free_mask[myc, mxc] > 0.5)

    def valid_mask(self, particles: jnp.ndarray) -> jnp.ndarray:
        """(N,) bool for (N, 3) particle poses.
        Reference: parallel_utils.py:398-413 (compute_valid_mask)."""
        return self.is_free_world(particles[..., 0], particles[..., 1])


def build_grid_map(
    occupancy: np.ndarray,
    resolution: float,
    origin: Tuple[float, float] = (0.0, 0.0),
    distance: np.ndarray | None = None,
    edt_impl: str = "auto",
) -> GridMap:
    """Build a GridMap, computing the EDT distance map if not given.

    edt_impl: "auto" (native C++ if built, else device), "native", "device",
    or "scipy".  All are exact and agree; the precompute is one-time per map
    (the reference's host scipy call at amcmh_localizer.py:156).
    """
    occupancy = np.asarray(occupancy, dtype=np.int8)
    occupied = occupancy != 0  # unknown (-1) counts as obstacle (:153)
    if distance is None:
        distance = _compute_edt(occupied, resolution, edt_impl)
    rows, cols = np.nonzero(occupancy == 0)
    if rows.size == 0:  # degenerate all-occupied map: keep one dummy cell
        rows, cols = np.array([0]), np.array([0])
    free_xy = np.stack(
        [
            origin[0] + (cols + 0.5) * resolution,
            origin[1] + (rows + 0.5) * resolution,
        ],
        axis=1,
    ).astype(np.float32)
    return GridMap(
        occupancy=jnp.asarray(occupancy),
        distance=jnp.asarray(distance, dtype=jnp.float32),
        origin=jnp.asarray(origin[:2], dtype=jnp.float32),
        resolution=jnp.asarray(resolution, dtype=jnp.float32),
        free_xy=jnp.asarray(free_xy),
        free_mask=jnp.asarray(occupancy == 0, dtype=jnp.float32),
    )


def _compute_edt(occupied: np.ndarray, resolution: float, impl: str) -> np.ndarray:
    if impl in ("auto", "native"):
        try:
            from mcmh_localization.native import edt as native_edt

            return native_edt(occupied) * resolution
        except Exception:
            if impl == "native":
                raise
    if impl == "scipy":
        from scipy.ndimage import distance_transform_edt

        return distance_transform_edt(~occupied) * resolution
    from mcmh_localization.maps.edt import distance_transform_edt_device

    return np.asarray(distance_transform_edt_device(jnp.asarray(occupied), resolution))


def load_map(yaml_path: str, edt_impl: str = "auto") -> GridMap:
    """Load a ROS map YAML+PGM pair (e.g. the reference's app/maps/*.yaml)."""
    occ, meta = load_map_yaml(yaml_path)
    return build_grid_map(
        occ, meta["resolution"], meta["origin"][:2], edt_impl=edt_impl
    )
