"""Multi-chip sharding tests on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmh_localization.config import FilterConfig
from mcmh_localization.filter.step import make_model
from mcmh_localization.parallel.sharding import (
    make_mesh,
    make_sharded_model,
    shard_state,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return make_mesh()


def _inputs(house_map, t=4, m=60):
    from tests.test_filter import _simulate, _square_trajectory

    poses = _square_trajectory(t_steps=t)
    return _simulate(house_map, poses, max_range=5.0)


def test_sharded_step_matches_single_device(house_map, mesh):
    scans, angles, deltas = _inputs(house_map)
    cfg = FilterConfig(
        mode="MHAMCL", num_particles=256, min_particles=32, max_particles=256,
        initialized=True, initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
    )
    single = make_model(cfg, house_map)
    sharded = make_sharded_model(cfg, house_map, mesh)
    assert sharded.config.max_particles % 8 == 0

    s_single = single.init(jax.random.PRNGKey(0))
    s_shard = shard_state(s_single, mesh)

    for t in range(scans.shape[0]):
        s_single, info_a = single.step(s_single, scans[t], angles, deltas[t])
        s_shard, info_b = sharded.step(s_shard, scans[t], angles, deltas[t])
    np.testing.assert_allclose(
        np.asarray(s_single.particles), np.asarray(s_shard.particles),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(info_a.estimate.mean), np.asarray(info_b.estimate.mean),
        rtol=1e-4, atol=1e-5,
    )
    assert int(s_single.count) == int(s_shard.count)


def test_sharded_particles_actually_sharded(house_map, mesh):
    cfg = FilterConfig(
        mode="MCL", num_particles=256, initialized=True,
        initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
    )
    sharded = make_sharded_model(cfg, house_map, mesh)
    state = sharded.init(jax.random.PRNGKey(1))
    # particle array is split over 8 devices along axis 0
    shards = state.particles.addressable_shards
    assert len(shards) == 8
    assert shards[0].data.shape == (256 // 8, 3)
    # scalars replicated
    assert state.count.sharding.is_fully_replicated


def test_sharded_run_scan(house_map, mesh):
    scans, angles, deltas = _inputs(house_map, t=5)
    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=240, min_particles=32, max_particles=320,
        initialized=True, initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
    )
    sharded = make_sharded_model(cfg, house_map, mesh)
    state = sharded.init(jax.random.PRNGKey(2))
    state, infos = sharded.run(state, scans, angles, deltas)
    est = np.asarray(infos.estimate.mean)
    assert est.shape == (5, 3)
    assert np.isfinite(est).all()
    # padded to multiple of 8
    assert sharded.config.max_particles % 8 == 0


def test_adaptive_padding(house_map, mesh):
    cfg = FilterConfig(mode="AMCL", num_particles=100, min_particles=10,
                       max_particles=501, max_range=5.0)
    sharded = make_sharded_model(cfg, house_map, mesh)
    assert sharded.config.max_particles == 504


def test_sharded_corr_impl(house_map, mesh):
    """Correlation-field scorer under particle-axis sharding (field is
    replicated, lookups local)."""
    scans, angles, deltas = _inputs(house_map, t=3)
    cfg = FilterConfig(
        mode="MCL", num_particles=256, initialized=True,
        initial_pose=(1.0, -1.0, np.pi / 2), max_range=5.0,
        likelihood_impl="corr", corr_n_theta=60,
    )
    sharded = make_sharded_model(cfg, house_map, mesh)
    state = sharded.init(jax.random.PRNGKey(0))
    for t in range(scans.shape[0]):
        state, info = sharded.step(state, scans[t], angles, deltas[t])
    est = np.asarray(info.estimate.mean)
    assert np.isfinite(est).all()
    # still sharded after stepping
    assert len(state.particles.addressable_shards) == 8
