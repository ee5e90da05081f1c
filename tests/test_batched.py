"""Multi-robot batched filtering tests."""

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.config import FilterConfig
from mcmh_localization.parallel.batched import make_batched_model


def test_batched_three_robots_track(house_map):
    from tests.test_filter import _simulate, _square_trajectory, _wrap

    cfg = FilterConfig(
        mode="MHMCL", num_particles=128, initialized=True, max_range=5.0,
        initial_pose=(1.0, -1.0, np.pi / 2),
    )
    # three robots on phase-shifted square loops
    trajs = []
    for shift in (0, 2, 4):
        poses = _square_trajectory(12 + shift)[shift:]
        trajs.append(poses[:12])
    scans_all, deltas_all = [], []
    for poses in trajs:
        scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
        scans_all.append(scans)
        deltas_all.append(deltas)
    ranges_seq = jnp.stack(scans_all, axis=1)   # (T, B, M)
    deltas_seq = jnp.stack(deltas_all, axis=1)  # (T, B, 3)

    model = make_batched_model(cfg, house_map, batch=3)
    starts = [jnp.asarray(_wrap(t[0])) for t in trajs]
    states = model.init(jax.random.PRNGKey(0), initial_poses=starts)
    assert states.particles.shape == (3, 128, 3)

    states, infos = model.run(states, ranges_seq, angles, deltas_seq)
    est = np.asarray(infos.estimate.mean)  # (T, B, 3)
    assert est.shape == (12, 3, 3)
    for b, poses in enumerate(trajs):
        true = _wrap(poses[-1])
        err = np.hypot(est[-1, b, 0] - true[0], est[-1, b, 1] - true[1])
        assert err < 0.35, (b, est[-1, b], true)


def test_batched_matches_individual(house_map):
    from tests.test_filter import _simulate, _square_trajectory

    cfg = FilterConfig(
        mode="MCL", num_particles=64, initialized=True, max_range=5.0,
        initial_pose=(1.0, -1.0, np.pi / 2),
    )
    poses = _square_trajectory(4)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)

    from mcmh_localization.filter.step import make_model

    base = make_model(cfg, house_map)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)

    # individual runs
    outs = []
    for k in keys:
        s = base.init(k)
        for t in range(scans.shape[0]):
            s, info = base.step(s, scans[t], angles, deltas[t])
        outs.append(np.asarray(info.estimate.mean))

    # batched run with the same per-robot keys
    model = make_batched_model(cfg, house_map, batch=2)
    states = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[base.init(k) for k in keys]
    )
    ranges_seq = jnp.broadcast_to(scans[:, None], (scans.shape[0], 2, scans.shape[1]))
    deltas_seq = jnp.broadcast_to(deltas[:, None], (deltas.shape[0], 2, 3))
    states, infos = model.run(states, ranges_seq, angles, deltas_seq)
    est = np.asarray(infos.estimate.mean)
    for b in range(2):
        np.testing.assert_allclose(est[-1, b], outs[b], rtol=1e-4, atol=1e-5)


def test_multimap_two_robots_two_maps(house_map, house_occupancy):
    """Two robots on two DIFFERENT maps in one batched filter."""
    from mcmh_localization.maps.grid_map import build_grid_map
    from mcmh_localization.parallel.batched import make_multimap_model
    from tests.test_filter import _simulate, _square_trajectory, _wrap

    # second map: the house with an extra wall -> genuinely different
    occ2 = house_occupancy.copy()
    occ2[100:160, 60] = 100
    map2 = build_grid_map(occ2, 0.05, (-4.8, -4.8), edt_impl="scipy")
    from mcmh_localization.parallel.batched import stack_maps

    maps = stack_maps([house_map, map2])

    poses = _square_trajectory(8)
    scans1, angles, deltas1 = _simulate(house_map, poses, max_range=5.0)
    scans2, _, deltas2 = _simulate(map2, poses, max_range=5.0)
    ranges_seq = jnp.stack([scans1, scans2], axis=1)
    deltas_seq = jnp.stack([deltas1, deltas2], axis=1)

    cfg = FilterConfig(
        mode="MHMCL", num_particles=128, initialized=True, max_range=5.0,
        initial_pose=(1.0, -1.0, np.pi / 2),
    )
    model = make_multimap_model(cfg, maps, batch=2)
    states = model.init(jax.random.PRNGKey(0))
    states, infos = model.run(states, ranges_seq, angles, deltas_seq)
    est = np.asarray(infos.estimate.mean)
    true = _wrap(poses[-1])
    for b in range(2):
        err = np.hypot(est[-1, b, 0] - true[0], est[-1, b, 1] - true[1])
        assert err < 0.35, (b, est[-1, b], true)
