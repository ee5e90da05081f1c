"""Motion model tests: decomposition, sampling moments, validity fallback,
density vs golden loop implementation."""

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.models.motion import (
    compute_motion,
    invert_delta,
    motion_density,
    sample_motion,
)
from tests.reference_impl import ref_motion_density


def test_compute_motion_straight():
    d = np.asarray(compute_motion(jnp.array([0.0, 0.0, 0.0]), jnp.array([1.0, 0.0, 0.0])))
    np.testing.assert_allclose(d, [0.0, 1.0, 0.0], atol=1e-6)


def test_compute_motion_arc():
    # drive forward 1m along +y while facing +y: rot1 = 0 relative to heading
    d = np.asarray(
        compute_motion(jnp.array([0.0, 0.0, np.pi / 2]), jnp.array([0.0, 1.0, np.pi / 2]))
    )
    np.testing.assert_allclose(d, [0.0, 1.0, 0.0], atol=1e-6)


def test_invert_delta_roundtrip():
    # applying delta then its inverse returns to the start pose
    def apply(pose, d):
        r1, t, r2 = d
        x, y, th = pose
        x = x + t * np.cos(th + r1)
        y = y + t * np.sin(th + r1)
        th = th + r1 + r2
        return np.array([x, y, th])

    rng = np.random.default_rng(1)
    for _ in range(10):
        pose = rng.normal(size=3)
        d = rng.normal(scale=[0.4, 1.0, 0.4], size=3)
        fwd = apply(pose, d)
        inv = np.asarray(invert_delta(jnp.asarray(d)))
        back = apply(fwd, inv)
        np.testing.assert_allclose(back[:2], pose[:2], atol=1e-6)
        assert abs(((back[2] - pose[2]) + np.pi) % (2 * np.pi) - np.pi) < 1e-6


def test_sample_motion_moments(house_map):
    # In open space with plenty of retries, sampled (rot1, trans, rot2)
    # should match the configured noise model's mean/std.
    n = 4000
    particles = jnp.tile(jnp.array([[1.0, 1.0, 0.3]]), (n, 1))
    delta = jnp.array([0.1, 0.2, -0.05])
    alpha = (0.05, 0.05, 0.05, 0.05)
    out = sample_motion(jax.random.PRNGKey(0), particles, delta, alpha, house_map)
    out = np.asarray(out)
    # recover per-particle trans (start pose identical for all)
    dx = out[:, 0] - 1.0
    dy = out[:, 1] - 1.0
    trans = np.hypot(dx, dy)
    s_trans = 0.05 * 0.2 + 0.05 * (0.1 + 0.05)
    assert abs(trans.mean() - 0.2) < 4 * s_trans / np.sqrt(n) + 1e-3
    assert abs(trans.std() - s_trans) < 0.2 * s_trans + 1e-3
    heading = np.arctan2(dy, dx) - 0.3  # = r1_hat
    s_rot1 = 0.05 * 0.1 + 0.05 * 0.2
    assert abs(heading.mean() - 0.1) < 4 * s_rot1 / np.sqrt(n) + 1e-3


def test_sample_motion_zero_delta(house_map):
    # no motion, no noise: particles must stay exactly put
    particles = jnp.array([[1.0, 1.0, 0.5], [-1.0, 2.0, -0.5]])
    out = sample_motion(
        jax.random.PRNGKey(1), particles, jnp.zeros(3), (0.1, 0.1, 0.1, 0.1), house_map
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(particles), atol=1e-7)


def test_sample_motion_invalid_fallback(house_map):
    # a particle driven straight into a wall with tiny noise keeps its pose
    # (reference fallback, parallel_utils.py:360-361)
    particles = jnp.array([[1.0, 1.0, 0.0]])
    # huge translation that always exits the map
    delta = jnp.array([0.0, 100.0, 0.0])
    out = sample_motion(
        jax.random.PRNGKey(2), particles, delta, (0.0, 0.0, 1e-6, 1e-6), house_map
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(particles), atol=1e-6)


def test_motion_density_matches_golden():
    rng = np.random.default_rng(3)
    n = 64
    prev = rng.normal(scale=[1, 1, 1], size=(n, 3))
    delta = np.array([0.1, 0.5, -0.2])
    # curr = noisy application of delta
    curr = prev + rng.normal(scale=0.1, size=(n, 3))
    alpha = (0.1, 0.05, 0.08, 0.02)
    ref = ref_motion_density(prev, curr, delta, alpha)
    got = np.asarray(
        motion_density(jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(delta), alpha)
    )
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-8)
    np.testing.assert_allclose(got.sum(), 1.0, atol=1e-5)


def test_motion_density_peaks_at_exact_motion():
    # the particle that moved exactly by delta gets the highest probability
    prev = np.zeros((3, 3))
    delta = np.array([0.2, 1.0, 0.1])

    def apply(pose, d):
        x, y, th = pose
        return np.array(
            [x + d[1] * np.cos(th + d[0]), y + d[1] * np.sin(th + d[0]), th + d[0] + d[2]]
        )

    exact = apply(prev[0], delta)
    curr = np.stack([exact, exact + [0.3, 0.0, 0.0], exact + [0.0, 0.2, 0.3]])
    p = np.asarray(
        motion_density(jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(delta),
                       (0.1, 0.1, 0.1, 0.1))
    )
    assert p.argmax() == 0
