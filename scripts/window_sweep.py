"""Accuracy sweep over corr_window_cells (tracking phase) — the spatial
twin of scripts/theta_sweep.py.

Motivation: the corr field build's region volume is
(window + 2*max_range_cells)^2 * theta_bins and the field the particles
look up scales with window^2 * theta_bins (models/corr_field.py), so
shrinking the tracking window cuts both the per-scan field build and the
per-particle scoring footprint.  During converged tracking the cloud spans
centimeters while the flagship's 128-cell (6.4 m) window is sized for
recovery headroom; out-of-window particles fall to the OPTIMISTIC
coarse fallback, which weakens selection — this script measures whether
that costs accuracy at tracking-realistic windows.

Run with JAX_PLATFORMS=cpu python scripts/window_sweep.py (CPU only).
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
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    seeds = (0, 1, 2)
    out = {}
    for scenario in ("square", "straight_line_spin"):
        gt = SCENARIOS[scenario](duration=20.0, rate=5.0)
        gt = fit_trajectory_to_map(grid_map, gt, min_clearance=0.15)
        bags = [
            simulate_bag(jax.random.PRNGKey(100 + s), grid_map, gt,
                         n_beams=180, max_range=5.0, rate=5.0,
                         name=scenario)
            for s in seeds
        ]
        for win in (128, 96, 64, 48, 32):
            cfg = FilterConfig(
                mode="AMHAMCL", num_particles=n, min_particles=n,
                max_particles=n, initialized=True,
                initial_pose=tuple(map(float, gt[0])),
                likelihood_impl="corr", corr_window_cells=win,
                corr_theta_window_bins=32,
                motion_validity="score", min_injection_prob=0.02,
            )
            rmses = []
            for s, bag in zip(seeds, bags):
                est, _infos, _wall = run_filter_on_bag(
                    bag, cfg, grid_map, jax.random.PRNGKey(s))
                res = evaluate_run(bag.times, est, np.asarray(bag.gt))
                rmses.append(res.rmse)
            out[f"{scenario}_win{win}"] = {
                "mean": round(float(np.mean(rmses)), 4),
                "max": round(float(np.max(rmses)), 4),
            }
            print(json.dumps({f"{scenario}_win{win}":
                              out[f"{scenario}_win{win}"]}), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
