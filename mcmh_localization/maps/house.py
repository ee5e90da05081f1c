"""Seeded house-scale occupancy map, generated in the repository.

The reference's ``map_house`` (SURVEY.md §2.3: 384x384 PGM at 0.05 m/px,
origin (-10, -10), trinary occupancy) is a furnished multi-room house.
``house_occupancy`` draws a map of the same shape from a seed: an unknown
border around the house footprint, three-cell outer walls, interior walls
splitting the house into rooms joined by 1 m doors, and furniture blocks
that break the rooms' symmetry.  The cell at world (0, 0) always has at
least 1.2 m of clearance, so fixed-start workloads (the benchmark's
tracking circle) run on every seed.
"""

from __future__ import annotations

import numpy as np

SIZE = 384            # cells per side
RESOLUTION = 0.05     # m per cell
ORIGIN = (-10.0, -10.0)

_FREE, _OCC, _UNKNOWN = 0, 100, -1
_LO, _HI = 40, 344    # house footprint [lo, hi) in cells, both axes
_WALL = 3             # wall thickness in cells
_DOOR = 20            # door width in cells (1 m)
_CLEAR = 24           # clearance radius around world (0, 0) in cells


def house_occupancy(seed: int = 0) -> np.ndarray:
    """(384, 384) int8 trinary grid: 0 free, 100 occupied, -1 unknown.
    Row 0 is the bottom row (ROS OccupancyGrid layout)."""
    rng = np.random.default_rng(seed)
    occ = np.full((SIZE, SIZE), _UNKNOWN, dtype=np.int8)
    occ[_LO:_HI, _LO:_HI] = _FREE
    occ[_LO:_LO + _WALL, _LO:_HI] = _OCC
    occ[_HI - _WALL:_HI, _LO:_HI] = _OCC
    occ[_LO:_HI, _LO:_LO + _WALL] = _OCC
    occ[_LO:_HI, _HI - _WALL:_HI] = _OCC

    center = (round(-ORIGIN[1] / RESOLUTION), round(-ORIGIN[0] / RESOLUTION))
    doors = []

    def wall(axis, at, lo, hi):
        """A wall along ``axis`` (0: horizontal row ``at``, 1: vertical
        column ``at``) over [lo, hi), with one seeded door."""
        d0 = int(rng.integers(lo + _WALL + 4, hi - _DOOR - _WALL - 4))
        if axis == 0:
            occ[at:at + _WALL, lo:hi] = _OCC
            occ[at:at + _WALL, d0:d0 + _DOOR] = _FREE
            doors.append((at + 1, d0 + _DOOR // 2))
        else:
            occ[lo:hi, at:at + _WALL] = _OCC
            occ[d0:d0 + _DOOR, at:at + _WALL] = _FREE
            doors.append((d0 + _DOOR // 2, at + 1))

    # vertical walls at x = -2.5 m and x = 3.5 m, horizontal walls closing
    # rooms on the west and east sides: six rooms and a central hall
    c_west, c_east = 150, 270
    wall(1, c_west, _LO, _HI)
    wall(1, c_east, _LO, _HI)
    wall(0, 140, _LO, c_west)
    wall(0, 260, _LO, c_west)
    wall(0, 120, c_east, _HI)
    wall(0, 230, c_east, _HI)

    # furniture: axis-aligned blocks away from doors and the start pose
    placed = 0
    while placed < 14:
        h, w = (int(v) for v in rng.integers(8, 32, size=2))
        r0 = int(rng.integers(_LO + _WALL + 6, _HI - _WALL - 6 - h))
        c0 = int(rng.integers(_LO + _WALL + 6, _HI - _WALL - 6 - w))
        rr = np.clip(center[0], r0, r0 + h - 1) - center[0]
        cc = np.clip(center[1], c0, c0 + w - 1) - center[1]
        if rr * rr + cc * cc < _CLEAR * _CLEAR:
            continue
        if any(
            abs(np.clip(dr, r0, r0 + h) - dr) < 14
            and abs(np.clip(dc, c0, c0 + w) - dc) < 14
            for dr, dc in doors
        ):
            continue
        occ[r0:r0 + h, c0:c0 + w] = _OCC
        placed += 1
    return occ


def make_house_map(seed: int = 0, edt_impl: str = "auto"):
    """The seeded house as a GridMap (384x384 at 0.05 m, origin (-10, -10))."""
    from mcmh_localization.maps.grid_map import build_grid_map

    return build_grid_map(
        house_occupancy(seed), RESOLUTION, ORIGIN, edt_impl=edt_impl
    )
