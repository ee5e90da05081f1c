"""motion_validity="score": validity folded into the sensor score.

Replaces the reference's motion-model rejection sampling
(parallel_utils.py:339-361) with an INVALID_SCORE penalty on non-free poses
— zero validity lookups on the corr path (see config.py).
"""

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.config import FilterConfig
from mcmh_localization.filter.step import make_model
from mcmh_localization.models.corr_field import correlation_field_scores
from mcmh_localization.models.sensor import INVALID_SCORE

from tests.test_filter import _simulate, _square_trajectory, _wrap


def _scan_at(grid_map, pose, m=90, max_range=5.0):
    from mcmh_localization.models.sensor import raycast

    angles = jnp.linspace(-np.pi, np.pi, m).astype(jnp.float32)
    ranges = raycast(pose[:2], pose[2] + angles, grid_map, max_range,
                     hit_unknown=True)
    return ranges, angles


def test_invalid_poses_scored_invalid(house_map):
    """Corr scorer with score-validity: occupied/unknown/out-of-map poses get
    the INVALID_SCORE penalty, free poses keep their real score."""
    cfg = FilterConfig(
        likelihood_impl="corr", max_range=5.0, motion_validity="score",
        corr_window_cells=64, corr_theta_window_bins=16,
        corr_coarse_factor=4, corr_coarse_n_theta=12,
    )
    pose = jnp.array([1.0, -1.0, 0.5])
    ranges, angles = _scan_at(house_map, pose)
    res = float(np.asarray(house_map.resolution))
    # window centered on the true pose
    half = cfg.corr_window_cells // 2
    ox0 = int((1.0 - float(house_map.origin[0])) / res) - half
    oy0 = int((-1.0 - float(house_map.origin[1])) / res) - half
    kmid = int((0.5 + np.pi) * cfg.corr_n_theta / (2 * np.pi))
    wo = (oy0, ox0, kmid - cfg.corr_theta_window_bins // 2)

    ox, oy = float(house_map.origin[0]), float(house_map.origin[1])
    # inner-wall cell (96, 76) — inside the 64-cell window around the pose
    wall = jnp.array([ox + 96.5 * res, oy + 76.5 * res, 0.5])
    unknown = jnp.array([ox + 2 * res, oy + 2 * res, 0.5])    # unknown band
    outside = jnp.array([ox - 1.0, oy - 1.0, 0.5])            # out of map
    particles = jnp.stack(
        [jnp.array([1.0, -1.0, 0.5]), wall, unknown, outside]
    )
    s = np.asarray(
        correlation_field_scores(
            particles, ranges, angles, house_map, cfg,
            n_theta=cfg.corr_n_theta, window_origin=wo,
        )
    )
    assert s[0] > INVALID_SCORE / 2           # real pose: normal score
    assert s[1] <= INVALID_SCORE / 2, s       # wall
    assert s[2] <= INVALID_SCORE / 2, s       # unknown
    assert s[3] <= INVALID_SCORE / 2, s       # out of map
    # without score-validity the wall pose is NOT penalized
    s_ref = np.asarray(
        correlation_field_scores(
            particles, ranges, angles, house_map,
            cfg.replace(motion_validity="reject"),
            n_theta=cfg.corr_n_theta, window_origin=wo,
        )
    )
    assert s_ref[1] > INVALID_SCORE / 2


def test_score_mode_tracks_like_reject(house_map):
    """Flagship-style config (corr window + coarse + score-validity +
    injection threshold) tracks as well as the reference-semantics config."""
    poses = _square_trajectory(18)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    base = dict(
        mode="AMHAMCL", num_particles=400, min_particles=400,
        max_particles=400, initialized=True,
        initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
        likelihood_impl="corr", corr_n_theta=120,
        corr_window_cells=64, corr_theta_window_bins=24,
        corr_coarse_factor=4, corr_coarse_n_theta=12,
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    errs = {}
    for name, extra in (
        ("reject", {}),
        ("score", dict(motion_validity="score", min_injection_prob=0.02)),
    ):
        cfg = FilterConfig(**base, **extra)
        model = make_model(cfg, house_map)
        state = model.init(jax.random.PRNGKey(0))
        state, infos = model.run(state, scans, angles, deltas)
        est = np.asarray(infos.estimate.mean)
        true = _wrap(poses[-1])
        errs[name] = float(np.hypot(est[-1, 0] - true[0], est[-1, 1] - true[1]))
    assert errs["score"] < 0.3, errs
    assert errs["score"] < errs["reject"] + 0.15, errs


def test_score_mode_exact_path(house_map):
    """Non-corr scorers get the penalty via the valid_mask wrap in _correct."""
    poses = _square_trajectory(12)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    cfg = FilterConfig(
        mode="MCL", num_particles=300, initialized=True,
        initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
        likelihood_impl="jnp", motion_validity="score",
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    model = make_model(cfg, house_map)
    state = model.init(jax.random.PRNGKey(0))
    state, infos = model.run(state, scans, angles, deltas)
    est = np.asarray(infos.estimate.mean)
    true = _wrap(poses[-1])
    assert np.hypot(est[-1, 0] - true[0], est[-1, 1] - true[1]) < 0.3


def test_min_injection_prob_gates_small_p_random(house_map):
    """p_random below the threshold is forced to zero (no injection work)."""
    poses = _square_trajectory(6)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    base = dict(
        mode="AMHAMCL", num_particles=200, min_particles=200,
        max_particles=200, initialized=True,
        initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
    )
    for thresh, expect_zero in ((0.9, True), (0.0, False)):
        cfg = FilterConfig(**base, min_injection_prob=thresh)
        model = make_model(cfg, house_map)
        state = model.init(jax.random.PRNGKey(0))
        # force a degraded w_fast so raw p_random lands in (0, 0.9) even
        # after this scan's w_slow/w_fast EMA update
        state = state.replace(
            w_slow=jnp.float32(1.0), w_fast=jnp.float32(0.5)
        )
        _, info = model.step(state, scans[0], angles, deltas[0])
        p = float(info.p_random)
        if expect_zero:
            assert p == 0.0
        else:
            assert p > 0.0
