"""Checkpoint, metrics, profiling, and viz/TF-parity tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.config import FilterConfig
from mcmh_localization.filter.step import make_model
from mcmh_localization.utils.checkpoint import load_state, save_state
from mcmh_localization.utils.metrics import MetricsLogger, read_metrics, summarize
from mcmh_localization.utils.profiling import PhaseTimer
from mcmh_localization.viz import (
    latched_initial_pose,
    map_to_odom_transform,
    particle_markers,
    plot_particles,
)


def _model_and_inputs(house_map):
    from tests.test_filter import _simulate, _square_trajectory

    cfg = FilterConfig(
        mode="MHAMCL", num_particles=128, min_particles=32, max_particles=128,
        initialized=True, initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
    )
    model = make_model(cfg, house_map)
    poses = _square_trajectory(6)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    return model, scans, angles, deltas


def test_checkpoint_bit_exact_resume(tmp_path, house_map):
    model, scans, angles, deltas = _model_and_inputs(house_map)
    s = model.init(jax.random.PRNGKey(0))
    s, _ = model.step(s, scans[0], angles, deltas[0])

    path = str(tmp_path / "ckpt.npz")
    save_state(path, s)
    s2 = load_state(path)

    # resumed run must be bit-exact vs continuing the original
    a, _ = model.step(s, scans[1], angles, deltas[1])
    b, _ = model.step(s2, scans[1], angles, deltas[1])
    np.testing.assert_array_equal(np.asarray(a.particles), np.asarray(b.particles))
    np.testing.assert_array_equal(np.asarray(a.weights), np.asarray(b.weights))
    assert int(a.count) == int(b.count)


def test_metrics_logger(tmp_path, house_map):
    model, scans, angles, deltas = _model_and_inputs(house_map)
    s = model.init(jax.random.PRNGKey(1))
    path = str(tmp_path / "metrics.jsonl")
    with MetricsLogger(path) as log:
        for t in range(3):
            s, info = model.step(s, scans[t], angles, deltas[t])
            log.log_step(info, wall_ms=1.5)
    recs = read_metrics(path)
    assert len(recs) == 3
    assert {"step", "est", "ess", "accept_rate", "count", "ms"} <= set(recs[0])
    summ = summarize(path)
    assert summ["steps"] == 3
    assert summ["count_mean"] == 128


def test_metrics_log_run(tmp_path, house_map):
    model, scans, angles, deltas = _model_and_inputs(house_map)
    s = model.init(jax.random.PRNGKey(2))
    s, infos = model.run(s, scans, angles, deltas)
    path = str(tmp_path / "run.jsonl")
    with MetricsLogger(path) as log:
        log.log_run(infos, times=np.arange(scans.shape[0]) * 0.2)
    recs = read_metrics(path)
    assert len(recs) == scans.shape[0]
    assert recs[-1]["t"] == 0.2 * (scans.shape[0] - 1)


def test_phase_timer():
    pt = PhaseTimer()
    x = jnp.ones((64, 64))
    with pt.phase("matmul", block_on=x):
        y = x @ x
    s = pt.summary()
    assert s["matmul"]["count"] == 1
    assert s["matmul"]["total_s"] >= 0


def test_particle_markers_filtering(house_map):
    particles = np.array(
        [[1.0, 1.0, 0.5], [99.0, 99.0, 0.0], [1.2, 1.0, -0.5]], dtype=np.float32
    )
    weights = np.array([0.6, 0.3, 0.1])
    m = particle_markers(particles, weights, house_map)
    assert len(m.positions) == 2  # out-of-map particle dropped
    assert m.colors.shape == (2, 3)
    # highest weight -> red channel 1
    assert m.colors[0, 0] > 0.99 and m.colors[0, 2] < 0.01
    np.testing.assert_allclose(np.linalg.norm(m.quaternions, axis=1), 1.0, atol=1e-6)


def test_plot_particles(tmp_path, house_map):
    rng = np.random.default_rng(0)
    particles = np.stack(
        [rng.uniform(-3, 3, 50), rng.uniform(-3, 3, 50), rng.uniform(-3, 3, 50)],
        axis=1,
    ).astype(np.float32)
    weights = np.full(50, 0.02)
    out = plot_particles(
        house_map, particles, weights, estimate=(0.0, 0.0, 0.0),
        path=str(tmp_path / "p.png"),
    )
    assert os.path.exists(out)


def test_map_to_odom_roundtrip():
    # composing map->odom with odom->base must give back the estimated pose
    est = (2.0, -1.0, 0.7)
    odom_to_base = (0.5, 0.3, -0.2)
    trans, quat = map_to_odom_transform(est, odom_to_base)
    yaw = 2 * np.arctan2(quat[2], quat[3])
    c, s = np.cos(yaw), np.sin(yaw)
    # apply T_map_odom to odom->base pose
    x = trans[0] + c * odom_to_base[0] - s * odom_to_base[1]
    y = trans[1] + s * odom_to_base[0] + c * odom_to_base[1]
    th = yaw + odom_to_base[2]
    np.testing.assert_allclose([x, y], est[:2], atol=1e-9)
    assert abs((th - est[2] + np.pi) % (2 * np.pi) - np.pi) < 1e-9
    assert quat[3] >= 0


def test_latched_initial_pose():
    msg = latched_initial_pose(-2.0, -0.5, 0.3)
    assert msg["position"][:2] == (-2.0, -0.5)
    assert msg["covariance"][0] == 0.25 and msg["covariance"][35] == 0.0685
    qz, qw = msg["orientation"][2], msg["orientation"][3]
    assert abs(2 * np.arctan2(qz, qw) - 0.3) < 1e-6
