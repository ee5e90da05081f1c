"""Accuracy gate for the beam-row margin levers (microbench30's twin).

Square-scenario RMSE x 3 seeds at the bench beam operating point
(sensor_model="beam", beam_impl="field", 96 table bins, window 64), for
resample_ess_threshold in {None, 0.9, 0.8, 0.7} and theta window 16 —
the same protocol as RESULTS.md "Benchmark-config accuracy".  A chip
ms/scan win (microbench30) only moves the bench row if its variant
holds RMSE parity here.  Round-4 negative: thr <= 0.5 concentrates on
historically-lucky particles (~0.7 m post-kidnap stall); 0.7-0.8 are
the unmeasured middle.

Run: JAX_PLATFORMS=cpu python scripts/beam_gate_rmse.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import numpy as np


def main():
    jax.config.update("jax_platforms", "cpu")
    from mcmh_localization.config import FilterConfig
    from mcmh_localization.eval.evaluator import evaluate_run
    from mcmh_localization.eval.runner import run_filter_on_bag
    from mcmh_localization.maps.house import make_house_map
    from mcmh_localization.sim.simulator import simulate_bag
    from mcmh_localization.sim.trajectory import (
        SCENARIOS,
        fit_trajectory_to_map,
    )

    grid_map = make_house_map()
    gt = SCENARIOS["square"](duration=20.0, rate=5.0)
    gt = fit_trajectory_to_map(grid_map, gt, min_clearance=0.15)
    base = dict(
        mode="AMHAMCL", num_particles=4000, min_particles=400,
        max_particles=4000, initialized=True,
        initial_pose=tuple(map(float, gt[0])),
        sensor_model="beam", beam_impl="field", beam_table_n_theta=96,
        corr_window_cells=64, corr_coarse_n_theta=24,
        motion_validity="score", min_injection_prob=0.02,
    )
    variants = {
        "plain_t24": dict(corr_theta_window_bins=24),
        "gate09_t24": dict(corr_theta_window_bins=24,
                           resample_ess_threshold=0.9),
        "gate08_t24": dict(corr_theta_window_bins=24,
                           resample_ess_threshold=0.8),
        "gate07_t24": dict(corr_theta_window_bins=24,
                           resample_ess_threshold=0.7),
        "gate08_t16": dict(corr_theta_window_bins=16,
                           resample_ess_threshold=0.8),
    }
    bags = {
        s: simulate_bag(jax.random.PRNGKey(100 + s), grid_map, gt,
                        n_beams=180, max_range=5.0, rate=5.0, name="square")
        for s in (0, 1, 2)
    }
    for name, kw in variants.items():
        cfg = FilterConfig(**base, **kw)
        rmses = []
        for s, bag in bags.items():
            est, _i, _w = run_filter_on_bag(bag, cfg, grid_map,
                                            jax.random.PRNGKey(s))
            rmses.append(round(
                evaluate_run(bag.times, est, np.asarray(bag.gt)).rmse, 3))
        print(json.dumps({"variant": name, "rmse": rmses}), flush=True)


if __name__ == "__main__":
    main()
