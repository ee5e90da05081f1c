"""End-to-end filter tests: all six modes track a simulated trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmh_localization.config import FilterConfig, MODES
from mcmh_localization.filter.step import make_model, state_size
from mcmh_localization.models.motion import compute_motion
from mcmh_localization.models.sensor import raycast

N_BEAMS = 90


def _wrap(pose):
    """Wrap theta like quaternion-derived odometry yaw would be."""
    p = np.asarray(pose, dtype=np.float32).copy()
    p[2] = (p[2] + np.pi) % (2 * np.pi) - np.pi
    return p


def _simulate(grid_map, poses, max_range, key=None):
    """Scans + odometry deltas along a pose sequence (perfect odometry)."""
    angles = jnp.linspace(-np.pi, np.pi, N_BEAMS).astype(jnp.float32)
    scans = []
    deltas = [jnp.zeros(3)]
    for t, pose in enumerate(poses):
        p = jnp.asarray(_wrap(pose))
        scans.append(raycast(p[:2], p[2] + angles, grid_map, max_range, hit_unknown=True))
        if t > 0:
            deltas.append(
                compute_motion(jnp.asarray(_wrap(poses[t - 1])), p)
            )
    return jnp.stack(scans), angles, jnp.stack(deltas)


def _square_trajectory(t_steps=24):
    """Forward-and-turn square loop inside the house fixture map."""
    poses = []
    pose = np.array([1.0, -1.0, np.pi / 2])
    for t in range(t_steps):
        if t % 6 == 5:
            pose = pose + [0, 0, np.pi / 2]
        else:
            pose = pose + [0.3 * np.cos(pose[2]), 0.3 * np.sin(pose[2]), 0.0]
        poses.append(pose.copy())
    return poses


@pytest.fixture(scope="module")
def trajectory_data(house_map):
    poses = _square_trajectory()
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    return poses, scans, angles, deltas


@pytest.mark.parametrize("mode", MODES)
def test_all_modes_track(house_map, trajectory_data, mode):
    poses, scans, angles, deltas = trajectory_data
    cfg = FilterConfig(
        mode=mode,
        num_particles=400,
        min_particles=64,
        max_particles=600,
        initialized=True,
        initial_pose=(1.0, -1.0, np.pi / 2),
        max_range=5.0,
        # quiet odometry matching the perfect simulated deltas
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    model = make_model(cfg, house_map)
    state = model.init(jax.random.PRNGKey(0))
    errors = []
    for t in range(len(poses)):
        state, info = model.step(state, scans[t], angles, deltas[t])
        est = np.asarray(info.estimate.mean)
        errors.append(np.hypot(est[0] - poses[t][0], est[1] - poses[t][1]))
    # converged tracking: final stretch below 25 cm
    tail = np.mean(errors[-6:])
    assert tail < 0.25, (mode, errors)
    # state invariants
    assert int(state.count) >= cfg.min_particles
    assert int(state.count) <= state_size(cfg)
    w = np.asarray(state.weights)
    assert abs(w.sum() - 1.0) < 1e-4 or not cfg.use_adaptive
    assert (w[np.asarray(state.active_mask) == 0] == 0).all()


def test_run_scan_matches_python_loop(house_map, trajectory_data):
    """lax.scan runner == step-by-step python loop (same keys, same result)."""
    poses, scans, angles, deltas = trajectory_data
    cfg = FilterConfig(
        mode="MHAMCL", num_particles=200, min_particles=32, max_particles=300,
        initialized=True, initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
    )
    model = make_model(cfg, house_map)
    s0 = model.init(jax.random.PRNGKey(1))

    s_loop = s0
    means = []
    for t in range(len(poses)):
        s_loop, info = model.step(s_loop, scans[t], angles, deltas[t])
        means.append(np.asarray(info.estimate.mean))
    s_scan, infos = model.run(s0, scans, angles, deltas)
    np.testing.assert_allclose(
        np.stack(means), np.asarray(infos.estimate.mean), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s_loop.particles), np.asarray(s_scan.particles), atol=1e-5
    )
    assert int(s_loop.count) == int(s_scan.count)


def test_global_localization_converges(house_map):
    """Uniform init (kidnapped robot): MCL should localize over four loops."""
    poses = _square_trajectory(t_steps=96)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    cfg = FilterConfig(
        mode="MCL", num_particles=2000, initialized=False, max_range=5.0,
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    model = make_model(cfg, house_map)
    state = model.init(jax.random.PRNGKey(2))
    _, infos = model.run(state, scans, angles, deltas)
    est = np.asarray(infos.estimate.mean)
    errs = np.hypot(
        est[:, 0] - np.asarray(poses)[:, 0], est[:, 1] - np.asarray(poses)[:, 1]
    )
    assert np.mean(errs[-6:]) < 0.3, errs[-10:]


def test_adaptive_count_shrinks_when_converged(house_map, trajectory_data):
    poses, scans, angles, deltas = trajectory_data
    cfg = FilterConfig(
        mode="AMCL", num_particles=600, min_particles=64, max_particles=600,
        initialized=True, initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
        kld_epsilon=0.15,
    )
    model = make_model(cfg, house_map)
    state = model.init(jax.random.PRNGKey(3))
    state, infos = model.run(state, scans, angles, deltas)
    counts = np.asarray(infos.count)
    # KLD should shrink the particle count once the cloud concentrates
    assert counts[-1] < 600
    assert counts[-1] >= 64


def test_injection_refill_regrows_count(house_map, trajectory_data):
    """config.injection_refill: a fitness collapse regrows the KLD count
    toward capacity via a capacity-scaled fresh-uniform block; without
    the flag the systematic-KLD count is monotone non-increasing (the
    documented deviation from the reference's unbounded KLD draws,
    parallel_utils.py:529-591)."""
    poses, scans, angles, deltas = trajectory_data
    base = FilterConfig(
        mode="AMCL", num_particles=600, min_particles=64, max_particles=600,
        initialized=True, initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
        kld_epsilon=0.15, alpha_slow=0.05, alpha_fast=0.7,
    )
    for refill in (False, True):
        cfg = base.replace(injection_refill=refill)
        model = make_model(cfg, house_map)
        state = model.init(jax.random.PRNGKey(3))
        # converge + shrink
        state, infos = model.run(state, scans[:12], angles, deltas[:12])
        n_shrunk = int(np.asarray(infos.count)[-1])
        assert n_shrunk < 600
        # fake a kidnap: the step refreshes w_fast toward the live w_avg
        # (alpha_fast=0.7) before resampling, so inflate the sticky
        # w_slow instead to collapse the w_fast/w_slow ratio
        state = state.replace(w_slow=10.0 * state.w_slow,
                              w_fast=jnp.zeros_like(state.w_fast))
        state, info = model.step(state, scans[12], angles, deltas[12])
        assert float(info.p_random) > 0.5
        if refill:
            # randoms block scaled with capacity -> count regrows
            assert int(info.count) > n_shrunk, int(info.count)
        else:
            # reference-parity monotone count
            assert int(info.count) <= n_shrunk, int(info.count)


def test_step_info_fields(house_map, trajectory_data):
    poses, scans, angles, deltas = trajectory_data
    cfg = FilterConfig(
        mode="MHMCL", num_particles=128, initialized=True,
        initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
    )
    model = make_model(cfg, house_map)
    state = model.init(jax.random.PRNGKey(4))
    state, info = model.step(state, scans[0], angles, deltas[0])
    assert 0.0 <= float(info.accept_rate) <= 1.0
    assert 1.0 <= float(info.ess) <= 128.0
    assert info.estimate.cov.shape == (3, 3)
    assert int(info.count) == 128


def test_step_deterministic(house_map, trajectory_data):
    """The reference's callbacks race on shared arrays (SURVEY.md §3); our
    pure step is bitwise deterministic — same state + inputs -> same outputs,
    no matter how many times or in what order it runs."""
    poses, scans, angles, deltas = trajectory_data
    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=128, min_particles=32, max_particles=160,
        initialized=True, initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
    )
    model = make_model(cfg, house_map)
    s0 = model.init(jax.random.PRNGKey(0))
    parts0 = np.asarray(s0.particles).copy()
    w0 = np.asarray(s0.weights).copy()
    a1, i1 = model.step(s0, scans[0], angles, deltas[0])
    # interleave unrelated work, then repeat the identical call
    _ = model.step(a1, scans[1], angles, deltas[1])
    a2, i2 = model.step(s0, scans[0], angles, deltas[0])
    # aliasing/donation guard (SURVEY.md §5 race row): the step never
    # mutates or invalidates its input buffers — s0 is still readable and
    # bit-identical after two steps consumed it
    np.testing.assert_array_equal(np.asarray(s0.particles), parts0)
    np.testing.assert_array_equal(np.asarray(s0.weights), w0)
    np.testing.assert_array_equal(np.asarray(a1.particles), np.asarray(a2.particles))
    np.testing.assert_array_equal(np.asarray(a1.weights), np.asarray(a2.weights))
    np.testing.assert_array_equal(
        np.asarray(i1.estimate.mean), np.asarray(i2.estimate.mean)
    )
