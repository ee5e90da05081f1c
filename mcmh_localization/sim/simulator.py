"""Synthetic scan/odometry simulator — the replacement for `rosbag play`.

Generates what the reference consumed from its (missing) evaluation bags
(`/scan` + `/odom` + Gazebo ground truth, test_algs.launch:9-46): ray-cast
LDS-style scans from the ground-truth trajectory plus drift-noised odometry,
packaged as a Bag.  Scans are produced by the same fixed-step DDA raycaster
the framework ships (models/sensor.py) with unknown-as-obstacle semantics so
scans are consistent with the likelihood field's EDT.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.models.motion import compute_motion
from mcmh_localization.models.sensor import raycast
from mcmh_localization.utils.angles import normalize_angle


class Bag(NamedTuple):
    """A recorded run: everything the filter + evaluator consume."""

    ranges: np.ndarray   # (T, M) float32 scan ranges
    angles: np.ndarray   # (M,) beam angles in the sensor frame
    odom: np.ndarray     # (T, 3) odometry poses (drift-noised ground truth)
    gt: np.ndarray       # (T, 3) ground-truth poses
    times: np.ndarray    # (T,) seconds
    max_range: float
    meta: dict


def odometry_deltas(odom: np.ndarray) -> np.ndarray:
    """(T, 3) per-step (rot1, trans, rot2) from consecutive odometry poses;
    row 0 is zeros (no motion before the first scan).  Mirrors the odometry
    decomposition at amcmh_localizer.py:410-421."""
    prev = jnp.asarray(odom[:-1])
    curr = jnp.asarray(odom[1:])
    deltas = jax.vmap(compute_motion)(prev, curr)
    return np.concatenate(
        [np.zeros((1, 3), dtype=np.float32), np.asarray(deltas, dtype=np.float32)]
    )


def _noisy_odometry(key, gt: np.ndarray, alpha: Tuple[float, float, float, float]):
    """Integrate ground-truth per-step motion with alpha-scaled noise to
    produce a drifting odometry track (the real-world gap between /odom and
    Gazebo ground truth that the evaluator measures)."""
    a1, a2, a3, a4 = alpha
    rng = np.random.default_rng(np.asarray(jax.random.key_data(key)).ravel()[-1])
    odom = np.zeros_like(gt)
    odom[0] = gt[0]
    for t in range(1, len(gt)):
        d = np.asarray(compute_motion(jnp.asarray(gt[t - 1]), jnp.asarray(gt[t])))
        r1, tr, r2 = d
        r1 += rng.normal(0, a1 * abs(r1) + a2 * abs(tr))
        tr += rng.normal(0, a3 * abs(tr) + a4 * (abs(r1) + abs(r2)))
        r2 += rng.normal(0, a1 * abs(r2) + a2 * abs(tr))
        x, y, th = odom[t - 1]
        odom[t] = [
            x + tr * np.cos(th + r1),
            y + tr * np.sin(th + r1),
            float(normalize_angle(th + r1 + r2)),
        ]
    return odom.astype(np.float32)


def simulate_bag(
    key: jax.Array,
    grid_map,
    gt_poses: np.ndarray,
    n_beams: int = 360,
    max_range: float = 5.0,
    rate: float = 5.0,
    ray_step: float = 0.02,
    odom_alpha: Tuple[float, float, float, float] = (0.002, 0.002, 0.01, 0.002),
    range_noise: float = 0.0,
    name: str = "sim",
) -> Bag:
    """Simulate a full run along ``gt_poses`` ((T, 3), theta wrapped).

    ``range_noise`` adds Gaussian noise to the simulated ranges; the default
    LDS angle layout matches get_lidar_angles (amcmh_localizer.py:346-348)
    with [-pi, pi] coverage.
    """
    gt_poses = np.asarray(gt_poses, dtype=np.float32)
    t_steps = len(gt_poses)
    angles = jnp.linspace(-np.pi, np.pi, n_beams, dtype=jnp.float32)

    k_odom, k_noise = jax.random.split(key)

    @jax.jit
    def scan_at(pose):
        return raycast(
            pose[:2], pose[2] + angles, grid_map, max_range,
            step=ray_step, hit_unknown=True,
        )

    scans = np.stack(
        [np.asarray(scan_at(jnp.asarray(p))) for p in gt_poses]
    ).astype(np.float32)
    if range_noise > 0:
        noise = np.asarray(
            jax.random.normal(k_noise, scans.shape) * range_noise, dtype=np.float32
        )
        hit = scans < max_range  # only returned beams carry sensor noise
        scans = np.where(hit, np.clip(scans + noise, 0.01, max_range), scans)

    odom = _noisy_odometry(k_odom, gt_poses, odom_alpha)
    times = (np.arange(t_steps) / rate).astype(np.float32)
    return Bag(
        ranges=scans,
        angles=np.asarray(angles),
        odom=odom,
        gt=gt_poses,
        times=times,
        max_range=float(max_range),
        meta={"name": name, "n_beams": n_beams, "rate": rate},
    )


def drive_bag(
    key: jax.Array,
    grid_map,
    commands,
    duration: float | None = None,
    rate: float = 5.0,
    start_pose=(0.0, 0.0, 0.0),
    clearance: float = 0.15,
    name: str = "drive",
    **sim_kwargs,
) -> Bag:
    """Interactive (v, omega) command-stream driving — the library
    equivalent of the reference's Gazebo + keyboard-teleop live sim
    (mcmh_localization.launch:8-46, where /cmd_vel drives the robot and
    the localizer consumes the resulting /scan + /odom).

    ``commands`` is either an (T, 2) array of per-tick (v, omega) — an
    open-loop recorded teleop stream — or a callable
    ``controller(t_seconds, pose3) -> (v, omega)`` for closed-loop
    driving (``duration`` required then).  Unicycle integration at
    ``rate`` Hz with wall collision: a commanded translation into a cell
    closer than ``clearance`` to an obstacle is dropped for that tick
    (the robot 'bumps and stops', rotation still applies), matching how
    a teleoped TurtleBot cannot drive through walls.  The resulting
    ground-truth trajectory feeds :func:`simulate_bag` (scans + noisy
    odometry), so every downstream consumer (filter, evaluator, bag
    save/replay) works unchanged."""
    pose = np.asarray(start_pose, dtype=np.float32).copy()
    dt = 1.0 / rate
    if callable(commands):
        if duration is None:
            raise ValueError("duration is required with a controller callable")
        t_steps = int(round(duration * rate))
        get = lambda t: commands(t * dt, pose.copy())  # noqa: E731
    else:
        commands = np.asarray(commands, dtype=np.float32)
        t_steps = len(commands)
        get = lambda t: commands[t]  # noqa: E731

    def _clear(x, y):
        mx = int((x - float(grid_map.origin[0])) / float(grid_map.resolution))
        my = int((y - float(grid_map.origin[1])) / float(grid_map.resolution))
        h, w = grid_map.distance.shape
        if not (0 <= mx < w and 0 <= my < h):
            return 0.0
        return float(grid_map.distance[my, mx])

    poses = [pose.copy()]
    for t in range(t_steps - 1):
        v, w = get(t)
        th = pose[2] + 0.5 * w * dt  # midpoint heading for the arc
        nx = pose[0] + v * dt * np.cos(th)
        ny = pose[1] + v * dt * np.sin(th)
        if _clear(nx, ny) >= clearance:
            pose[0], pose[1] = nx, ny
        pose[2] = float(normalize_angle(np.float32(pose[2] + w * dt)))
        poses.append(pose.copy())
    return simulate_bag(
        key, grid_map, np.asarray(poses), rate=rate, name=name, **sim_kwargs
    )
