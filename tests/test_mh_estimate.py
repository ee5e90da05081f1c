"""MH accept/reject and pose-estimate tests."""

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.filter.estimate import covariance_6x6, estimate_pose
from mcmh_localization.filter.mh import asymmetric_mh, symmetric_mh


def _sets(n, rng):
    prev = rng.normal(size=(n, 3)).astype(np.float32)
    prop = prev + rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    return jnp.asarray(prev), jnp.asarray(prop)


def test_symmetric_mh_always_accept_when_better():
    prev, prop = _sets(100, np.random.default_rng(0))
    w_pre = jnp.full(100, 0.001)
    w_post = jnp.full(100, 0.01)  # 10x better -> alpha = 1
    p, w, _acc = symmetric_mh(jax.random.PRNGKey(0), prev, prop, w_post, w_pre)
    np.testing.assert_array_equal(np.asarray(p), np.asarray(prop))
    np.testing.assert_array_equal(np.asarray(w), np.asarray(w_post))


def test_symmetric_mh_acceptance_rate():
    # w_post/w_pre = 0.3 -> acceptance probability 0.3
    n = 20000
    prev, prop = _sets(n, np.random.default_rng(1))
    w_pre = jnp.full(n, 0.01)
    w_post = jnp.full(n, 0.003)
    p, _, acc_mask = symmetric_mh(jax.random.PRNGKey(1), prev, prop, w_post, w_pre)
    acc = float(jnp.mean(jnp.all(p == prop, axis=1)))
    assert abs(acc - 0.3) < 0.02
    # the returned mask is the authoritative record and must agree
    assert acc == float(jnp.mean(acc_mask))


def test_symmetric_mh_stationary_accept_mask():
    # stationary robot: proposal == previous pose, so pose comparison cannot
    # distinguish accept from reject — the returned mask must still report
    # the true ~30% acceptance (ADVICE.md accept_rate finding).
    n = 20000
    prev, _ = _sets(n, np.random.default_rng(7))
    prop = prev
    w_pre = jnp.full(n, 0.01)
    w_post = jnp.full(n, 0.003)
    _, _, acc_mask = symmetric_mh(jax.random.PRNGKey(7), prev, prop, w_post, w_pre)
    assert abs(float(jnp.mean(acc_mask)) - 0.3) < 0.02


def test_symmetric_mh_zero_prior_accepts():
    prev, prop = _sets(8, np.random.default_rng(2))
    w_pre = jnp.zeros(8)
    w_post = jnp.full(8, 1e-9)
    p, _, _ = symmetric_mh(jax.random.PRNGKey(2), prev, prop, w_post, w_pre)
    np.testing.assert_array_equal(np.asarray(p), np.asarray(prop))


def test_asymmetric_mh_ratio():
    # alpha = (w_post * q_back) / (w_pre * q_fwd) = (4*1)/(8*1) = 0.5
    n = 20000
    prev, prop = _sets(n, np.random.default_rng(3))
    p, _, _ = asymmetric_mh(
        jax.random.PRNGKey(3), prev, prop,
        jnp.full(n, 4e-3), jnp.full(n, 8e-3),
        jnp.full(n, 0.1), jnp.full(n, 0.1),
    )
    acc = float(jnp.mean(jnp.all(p == prop, axis=1)))
    assert abs(acc - 0.5) < 0.02


def test_asymmetric_mh_ref_compat_guard_always_accepts():
    # with the reference guard, log_den <= 0 -> alpha forced to 1
    n = 100
    prev, prop = _sets(n, np.random.default_rng(4))
    p, _, _ = asymmetric_mh(
        jax.random.PRNGKey(4), prev, prop,
        jnp.full(n, 1e-6), jnp.full(n, 0.9),
        jnp.full(n, 0.9), jnp.full(n, 1e-6),
        ref_compat_guard=True,
    )
    np.testing.assert_array_equal(np.asarray(p), np.asarray(prop))


def test_estimate_weighted_mean_and_cov():
    rng = np.random.default_rng(5)
    n = 5000
    pts = rng.normal(loc=[2.0, -1.0, 0.3], scale=[0.5, 0.2, 0.1], size=(n, 3))
    w = rng.random(n)
    w /= w.sum()
    est = estimate_pose(jnp.asarray(pts, dtype=jnp.float32), jnp.asarray(w, dtype=jnp.float32))
    mean = np.asarray(est.mean)
    np.testing.assert_allclose(mean[:2], np.average(pts[:, :2], axis=0, weights=w), atol=1e-3)
    # covariance vs np.cov aweights (the reference's exact call, :597)
    diffs = pts.copy()
    diffs[:, 0] -= mean[0]
    diffs[:, 1] -= mean[1]
    diffs[:, 2] = (pts[:, 2] - mean[2] + np.pi) % (2 * np.pi) - np.pi
    ref_cov = np.cov(diffs.T, aweights=w)
    np.testing.assert_allclose(np.asarray(est.cov), ref_cov, rtol=2e-2, atol=1e-4)


def test_estimate_circular_mean_wraps():
    # particles clustered around +/- pi: linear mean would be ~0, circular ~pi
    pts = jnp.array([[0, 0, np.pi - 0.1], [0, 0, -np.pi + 0.1]], dtype=jnp.float32)
    w = jnp.array([0.5, 0.5])
    est = estimate_pose(pts, w)
    assert abs(abs(float(est.mean[2])) - np.pi) < 1e-5


def test_estimate_masked_padding():
    pts = jnp.array(
        [[1.0, 2.0, 0.1], [1.2, 2.2, 0.2], [99.0, 99.0, 3.0]], dtype=jnp.float32
    )
    w = jnp.array([0.5, 0.5, 0.0])
    mask = jnp.array([True, True, False])
    est = estimate_pose(pts, w, mask)
    np.testing.assert_allclose(np.asarray(est.mean[:2]), [1.1, 2.1], atol=1e-6)


def test_covariance_6x6_layout():
    c = jnp.arange(9, dtype=jnp.float32).reshape(3, 3)
    flat = np.asarray(covariance_6x6(c))
    assert flat[0] == 0 and flat[1] == 1 and flat[5] == 2
    assert flat[6] == 3 and flat[7] == 4 and flat[11] == 5
    assert flat[30] == 6 and flat[31] == 7 and flat[35] == 8
    assert flat[[2, 3, 4, 8, 14, 21, 28]].sum() == 0


def test_estimate_cluster_picks_heavy_mode():
    from mcmh_localization.filter.estimate import estimate_pose_cluster

    rng = np.random.default_rng(11)
    a = rng.normal([2.0, 1.0, 0.3], [0.05, 0.05, 0.02], size=(700, 3))
    b = rng.normal([-2.0, -2.0, 1.2], [0.05, 0.05, 0.02], size=(300, 3))
    pts = jnp.asarray(np.concatenate([a, b]).astype(np.float32))
    w = jnp.concatenate([jnp.full(700, 1.0), jnp.full(300, 0.9)])
    w = w / jnp.sum(w)
    est_mean = estimate_pose(pts, w)
    est_cluster = estimate_pose_cluster(pts, w, radius_xy=0.5)
    # global mean sits between the modes; cluster estimate at the heavy mode
    assert abs(float(est_mean.mean[0]) - 2.0) > 0.5
    np.testing.assert_allclose(
        np.asarray(est_cluster.mean), [2.0, 1.0, 0.3], atol=0.05
    )
