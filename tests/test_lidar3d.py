"""3-D voxel-map lidar sensing (BASELINE stretch config #5):
voxel map + 3-D EDT, raycast3d golden checks, scorer loop-golden,
and filter-level tracking with a multi-ring scanner."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmh_localization.config import FilterConfig
from mcmh_localization.maps.voxel_map import (
    build_voxel_map,
    nav_slice,
    raycast3d,
)
from mcmh_localization.models.sensor3d import (
    lidar3d_scores,
    simulate_scan3d,
)


@pytest.fixture(scope="module")
def room3d():
    """10 x 10 x 3 m room at 0.1 m voxels: walls, a 1 m-tall 'table' block
    (invisible to a 2-D scanner at z > 1 m), and a hanging 'shelf' slab
    that only exists at height — genuinely 3-D structure."""
    d, h, w = 30, 100, 100
    occ = np.zeros((d, h, w), dtype=np.int8)
    occ[:, 0, :] = occ[:, -1, :] = 100
    occ[:, :, 0] = occ[:, :, -1] = 100
    occ[0, :, :] = 100           # floor
    occ[0:10, 40:60, 60:80] = 100   # table block (z < 1 m)
    occ[20:25, 20:40, 20:40] = 100  # hanging shelf (2.0-2.5 m)
    return build_voxel_map(occ, 0.1, (-5.0, -5.0, 0.0))


def test_voxel_edt_and_transforms(room3d):
    # distance at the room center, away from all structure
    vx, vy, vz = room3d.world_to_voxel(
        jnp.float32(0.0), jnp.float32(-3.0), jnp.float32(1.5)
    )
    assert bool(room3d.in_bounds(vx, vy, vz))
    dcenter = float(room3d.distance[vz, vy, vx])
    assert dcenter > 0.5
    # free/occupied checks
    assert bool(room3d.is_free_world(
        jnp.float32(0.0), jnp.float32(-3.0), jnp.float32(1.5)))
    assert not bool(room3d.is_free_world(
        jnp.float32(2.0), jnp.float32(0.0), jnp.float32(0.5)))  # table


def test_raycast3d_wall_distance(room3d):
    # from the center at z=1.5, a horizontal +x ray hits the wall at ~4.9 m
    r = raycast3d(
        jnp.asarray([0.0, 0.0, 1.5]),
        jnp.asarray([0.0]), jnp.asarray([0.0]), room3d, 8.0,
    )
    assert abs(float(r[0]) - 4.9) < 0.15
    # a steep upward ray exits through the (open) ceiling -> max_range
    r_up = raycast3d(
        jnp.asarray([0.0, 0.0, 1.5]),
        jnp.asarray([0.0]), jnp.asarray([1.2]), room3d, 8.0,
    )
    assert float(r_up[0]) == 8.0
    # a ray toward the hanging shelf at its height hits it; the same
    # azimuth at low elevation passes underneath
    az = np.arctan2(-2.0, -2.0)  # toward shelf center (-2, -2)
    r_shelf = raycast3d(
        jnp.asarray([0.0, 0.0, 1.0]),
        jnp.asarray([az, az]), jnp.asarray([0.45, 0.0]), room3d, 8.0,
    )
    assert float(r_shelf[0]) < float(r_shelf[1]) - 0.5


def test_lidar3d_scores_match_numpy_loop(room3d):
    """Vectorized scorer == straightforward numpy loop (golden)."""
    rng = np.random.default_rng(0)
    n, m = 24, 40
    particles = np.stack([
        rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
        rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    el = rng.uniform(-0.3, 0.3, m).astype(np.float32)
    ranges = rng.uniform(0.5, 4.5, m).astype(np.float32)
    ranges[::7] = np.inf  # invalid beams
    cfg = FilterConfig(max_range=5.0, sigma_hit=0.2, step=1)

    s = np.asarray(lidar3d_scores(
        jnp.asarray(particles), jnp.asarray(ranges),
        jnp.stack([jnp.asarray(az), jnp.asarray(el)], 1),
        room3d, cfg, sensor_z=1.0,
    ))

    dist = np.asarray(room3d.distance)
    res, org = 0.1, (-5.0, -5.0, 0.0)
    ref = np.zeros(n)
    for i in range(n):
        x, y, th = particles[i]
        acc, cnt = 0.0, 0
        for j in range(m):
            r = ranges[j]
            if not (np.isfinite(r) and r < cfg.max_range):
                continue
            cnt += 1
            ex = x + r * np.cos(el[j]) * np.cos(th + az[j])
            ey = y + r * np.cos(el[j]) * np.sin(th + az[j])
            ez = 1.0 + r * np.sin(el[j])
            vx = int(np.floor((ex - org[0]) / res))
            vy = int(np.floor((ey - org[1]) / res))
            vz = int(np.floor((ez - org[2]) / res))
            if not (0 <= vx < 100 and 0 <= vy < 100 and 0 <= vz < 30):
                continue
            d = dist[vz, vy, vx]
            ph = np.exp(-0.5 * (d / 0.2) ** 2) / np.sqrt(2 * np.pi * 0.2**2)
            acc += np.log(max(0.75 * ph + 0.25 / 5.0, 1e-6))
        ref[i] = acc / max(cnt, 1) if cnt else -50.0
    np.testing.assert_allclose(s, ref, rtol=2e-4, atol=2e-4)


def test_lidar3d_filter_tracks(room3d):
    """Full filter with the 3-D sensor: a 32-azimuth x 3-ring scanner
    localizes in the room (MCL, initialized tracking)."""
    from mcmh_localization.filter.step import make_model

    nav = nav_slice(room3d, z=0.1)
    azimuths = np.linspace(-np.pi, np.pi, 32, endpoint=False)
    rings = np.asarray([-0.15, 0.0, 0.2])
    directions = jnp.asarray(
        np.stack([np.repeat(azimuths, 3), np.tile(rings, 32)], 1),
        jnp.float32,
    )
    cfg = FilterConfig(
        mode="MCL", num_particles=400, initialized=True,
        initial_pose=(0.0, -3.0, 0.0), max_range=6.0,
        sensor_model="lidar3d", lidar3d_sensor_z=1.0, sigma_hit=0.2,
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    model = make_model(cfg, nav, voxel_map=room3d)
    state = model.init(jax.random.PRNGKey(0))

    # square-ish trajectory through the room
    key = jax.random.PRNGKey(1)
    poses = [np.array([0.0, -3.0, 0.0])]
    for t in range(40):
        p = poses[-1].copy()
        p[2] += 0.08
        p[0] += 0.08 * np.cos(p[2])
        p[1] += 0.08 * np.sin(p[2])
        poses.append(p)
    poses = np.asarray(poses)

    scans = []
    for t, p in enumerate(poses):
        k = jax.random.fold_in(key, t)
        scans.append(simulate_scan3d(
            k, jnp.asarray(p, jnp.float32), directions, room3d,
            cfg.max_range, sensor_z=1.0, noise=0.01,
        ))
    scans = jnp.stack(scans)

    from mcmh_localization.sim.simulator import odometry_deltas

    deltas = odometry_deltas(poses.astype(np.float32))
    state, infos = model.run(state, scans, directions, jnp.asarray(deltas))
    est = np.asarray(infos.estimate.mean)
    err = np.hypot(est[-1, 0] - poses[-1, 0], est[-1, 1] - poses[-1, 1])
    assert err < 0.3, err


def test_voxel_map_roundtrip(room3d, tmp_path):
    from mcmh_localization.maps.voxel_map import (
        load_voxel_map, save_voxel_map,
    )

    p = str(tmp_path / "room.npz")
    save_voxel_map(p, room3d)
    back = load_voxel_map(p)
    np.testing.assert_array_equal(
        np.asarray(back.occupancy), np.asarray(room3d.occupancy))
    np.testing.assert_allclose(
        np.asarray(back.distance), np.asarray(room3d.distance))
    assert back.resolution == room3d.resolution
    assert back.origin == room3d.origin
