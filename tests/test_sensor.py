"""Sensor model tests: likelihood field vs golden loop, raycast geometry,
beam-model semantics."""

import jax.numpy as jnp
import numpy as np

from mcmh_localization.config import FilterConfig
from mcmh_localization.models.sensor import (
    BLIND_SCORE,
    likelihood_field_scores,
    log_likelihood_field,
    raycast,
    raycast_beam_scores,
)
from tests.reference_impl import ref_likelihood_field_scores, ref_raycast


def _random_particles(m, n, rng):
    # uniform over free interior
    xs = rng.uniform(-3.5, 3.5, size=n)
    ys = rng.uniform(-3.5, 3.5, size=n)
    th = rng.uniform(-np.pi, np.pi, size=n)
    return np.stack([xs, ys, th], axis=1).astype(np.float32)


def _scan(m_beams, rng, max_range=5.0):
    angles = np.linspace(-np.pi, np.pi, m_beams).astype(np.float32)
    ranges = rng.uniform(0.2, 6.0, size=m_beams).astype(np.float32)
    ranges[rng.random(m_beams) < 0.1] = np.inf  # dropouts
    return ranges, angles


def test_likelihood_field_matches_golden(house_map, default_config):
    rng = np.random.default_rng(0)
    particles = _random_particles(house_map, 32, rng)
    ranges, angles = _scan(90, rng)
    cfg = default_config
    got = np.asarray(
        likelihood_field_scores(
            jnp.asarray(particles), jnp.asarray(ranges), jnp.asarray(angles),
            house_map, cfg,
        )
    )
    ref = ref_likelihood_field_scores(
        particles, ranges, angles,
        np.asarray(house_map.distance), float(house_map.resolution),
        np.asarray(house_map.origin), house_map.width, house_map.height,
        cfg.sigma_hit, cfg.z_hit, cfg.z_rand, cfg.max_range, cfg.step,
    )
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_likelihood_field_step_subsampling(house_map, default_config):
    rng = np.random.default_rng(1)
    particles = _random_particles(house_map, 8, rng)
    ranges, angles = _scan(60, rng)
    cfg = default_config.replace(step=3)
    got = np.asarray(
        likelihood_field_scores(
            jnp.asarray(particles), jnp.asarray(ranges), jnp.asarray(angles),
            house_map, cfg,
        )
    )
    ref = ref_likelihood_field_scores(
        particles, ranges, angles,
        np.asarray(house_map.distance), float(house_map.resolution),
        np.asarray(house_map.origin), house_map.width, house_map.height,
        cfg.sigma_hit, cfg.z_hit, cfg.z_rand, cfg.max_range, 3,
    )
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_likelihood_blind_particle(house_map, default_config):
    # all beams invalid (inf or >= max_range) -> -50 penalty
    particles = jnp.zeros((2, 3))
    ranges = jnp.array([np.inf, 10.0, 7.5])
    angles = jnp.zeros(3)
    got = np.asarray(
        likelihood_field_scores(particles, ranges, angles, house_map, default_config)
    )
    np.testing.assert_allclose(got, [-50.0, -50.0])


def test_likelihood_prefers_true_pose(house_map, default_config):
    # simulate a scan from a known pose with the raycaster; that pose should
    # outscore a displaced one
    pose = jnp.array([1.0, 1.0, 0.5])
    angles = jnp.linspace(-np.pi, np.pi, 120)
    r = raycast(pose[:2], pose[2] + angles, house_map, max_range=4.9)
    particles = jnp.stack(
        [pose, pose + jnp.array([0.8, -0.6, 0.4]), pose + jnp.array([-1.5, 0.3, 0.0])]
    )
    s = np.asarray(
        likelihood_field_scores(particles, r, angles, house_map, default_config)
    )
    assert s.argmax() == 0


def test_log_field_shape_and_range(house_map, default_config):
    L = log_likelihood_field(house_map, default_config)
    assert L.shape == (house_map.height, house_map.width)
    # on an obstacle cell distance=0 -> near max value; everywhere >= log floor
    assert float(jnp.min(L)) >= np.log(1e-6) - 1e-5
    sigma = default_config.sigma_hit
    pmax = default_config.z_hit / np.sqrt(2 * np.pi * sigma**2) + \
        default_config.z_rand / default_config.max_range
    assert float(jnp.max(L)) <= np.log(pmax) + 1e-5


def test_raycast_matches_golden(house_map):
    rng = np.random.default_rng(2)
    occ = np.asarray(house_map.occupancy)
    origin = np.asarray(house_map.origin)
    res = float(house_map.resolution)
    pose = np.array([1.0, 1.0])
    angles = rng.uniform(-np.pi, np.pi, size=40).astype(np.float32)
    got = np.asarray(raycast(jnp.asarray(pose), jnp.asarray(angles), house_map, 5.0))
    for k, a in enumerate(angles):
        expect = ref_raycast(pose, a, occ, res, origin, 5.0)
        assert abs(got[k] - expect) < 1e-5, (k, a, got[k], expect)


def test_raycast_hits_pillar(house_map):
    # from (2.95, 1.0) facing +y: the 10-cell pillar spans y in [2.7, 3.2) at
    # x in [2.7, 3.2); first 0.1 m step landing inside is y = 2.7 -> d = 1.7.
    # (NB the 0.1 m fixed step can hop over 1-cell walls — inherent to the
    # reference's DDA with step > cell size, parallel_utils.py:10; so we test
    # against a thick obstacle.)
    d = float(raycast(jnp.array([2.95, 1.0]), jnp.array([np.pi / 2]), house_map, 10.0)[0])
    assert abs(d - 1.7) < 1e-6


def test_raycast_max_range_when_clear(house_map):
    d = float(raycast(jnp.array([1.0, 1.0]), jnp.array([0.0]), house_map, 2.0)[0])
    assert d == 2.0


def test_beam_scores_prefer_true_pose(house_map):
    pose = jnp.array([1.0, 1.0, 0.0])
    angles = jnp.linspace(-np.pi, np.pi, 60)
    r = raycast(pose[:2], pose[2] + angles, house_map, max_range=9.9)
    particles = jnp.stack([pose, pose + jnp.array([0.7, 0.7, 0.2])])
    s = np.asarray(raycast_beam_scores(particles, r, angles, house_map))
    assert np.isfinite(s).all()
    assert s.argmax() == 0


def test_beam_scores_blind():
    cfg = FilterConfig()
    import mcmh_localization.maps.grid_map as gm
    import numpy as np_

    occ = np_.zeros((16, 16), dtype=np_.int8)
    m = gm.build_grid_map(occ, 0.1, (0.0, 0.0), edt_impl="scipy")
    s = np.asarray(
        raycast_beam_scores(
            jnp.zeros((1, 3)), jnp.array([np.inf, 11.0]), jnp.zeros(2), m
        )
    )
    # finite blind penalty (not the reference's -inf, which poisons softmax)
    assert s[0] == BLIND_SCORE
