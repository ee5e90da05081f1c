"""Independent full-filter baseline control.

The reference repo could launch stock ROS ``amcl`` in the same scenario as
an external control (``app/launch/amcl.launch:15-19``) — a baseline the
framework under test cannot bias.  Here the control is
``reference_impl.ref_mcl_run``: a sequential plain-numpy MCL built only
from this test package's loop mirrors (no framework code on its hot path).
Both filters run on the SAME simulated bag; a systematic framework-wide
bias (wrong scorer scale, broken resampler, motion-model sign error...)
would show up as our RMSE diverging from the oracle's.
"""

import jax
import numpy as np
import pytest

from mcmh_localization.config import FilterConfig
from mcmh_localization.eval.runner import run_filter_on_bag
from mcmh_localization.sim.simulator import simulate_bag
from mcmh_localization.sim.trajectory import SCENARIOS

from tests.reference_impl import ref_mcl_run

ALPHA = (0.002, 0.03, 0.08, 0.002)
SIGMA_HIT, Z_HIT, Z_RAND, MAX_RANGE = 0.3, 0.75, 0.25, 5.0
N_PARTICLES = 400
BEAM_STEP = 2


@pytest.fixture(scope="module")
def oracle_bag(house_map):
    gt = SCENARIOS["square"](duration=10.0, rate=5.0)
    return simulate_bag(
        jax.random.PRNGKey(7), house_map, gt,
        n_beams=60, max_range=MAX_RANGE, range_noise=0.01, name="square",
    )


def _pos_rmse(est, gt):
    return float(np.sqrt(np.mean(np.sum((est[:, :2] - gt[:, :2]) ** 2, -1))))


def test_filter_matches_independent_oracle(house_map, oracle_bag):
    gt = np.asarray(oracle_bag.gt)

    est_oracle = ref_mcl_run(
        3, oracle_bag, house_map, N_PARTICLES, ALPHA,
        SIGMA_HIT, Z_HIT, Z_RAND, MAX_RANGE,
        beam_step=BEAM_STEP, initial_pose=gt[0],
    )
    rmse_oracle = _pos_rmse(est_oracle, gt)

    config = FilterConfig(
        mode="MCL",
        num_particles=N_PARTICLES,
        min_particles=N_PARTICLES,
        max_particles=N_PARTICLES,
        alpha1=ALPHA[0], alpha2=ALPHA[1], alpha3=ALPHA[2], alpha4=ALPHA[3],
        sigma_hit=SIGMA_HIT, z_hit=Z_HIT, z_rand=Z_RAND,
        max_range=MAX_RANGE, step=BEAM_STEP,
        likelihood_impl="jnp",
        initialized=True,
        initial_pose=tuple(float(v) for v in gt[0]),
    )
    est_ours, _infos, _wall = run_filter_on_bag(
        oracle_bag, config, house_map, jax.random.PRNGKey(3)
    )
    rmse_ours = _pos_rmse(np.asarray(est_ours), gt)

    # the oracle itself must track (otherwise the comparison is vacuous)
    assert rmse_oracle < 0.30, f"oracle diverged: {rmse_oracle:.3f} m"
    # and our filter must match it — generous slack for MC noise, but far
    # below any systematic-bias failure (divergence is meters-scale)
    assert rmse_ours < 0.30, f"filter diverged: {rmse_ours:.3f} m"
    assert rmse_ours <= rmse_oracle * 2.0 + 0.05, (
        f"ours {rmse_ours:.3f} vs oracle {rmse_oracle:.3f}"
    )


def test_oracle_heading_agreement(house_map, oracle_bag):
    """Heading estimates of oracle and filter agree with ground truth."""
    gt = np.asarray(oracle_bag.gt)
    est_oracle = ref_mcl_run(
        5, oracle_bag, house_map, 200, ALPHA,
        SIGMA_HIT, Z_HIT, Z_RAND, MAX_RANGE,
        beam_step=3, initial_pose=gt[0],
    )

    def wrap(a):
        return (a + np.pi) % (2 * np.pi) - np.pi

    th_err = np.abs(wrap(est_oracle[:, 2] - gt[:, 2]))
    assert float(np.sqrt(np.mean(th_err**2))) < 0.15
