"""Cross-scenario validation of ESS-gated staged tracking (round-5 #3).

Before promoting essgate+staged beyond its current opt-in scope, measure
RMSE on all four reference scenarios x 3 seeds, staged runner with
tracking_ess_threshold=0.9 vs the single-program flagship twin on the
SAME bags.  CPU-scale (4000-capacity KLD, 1024 tracking capacity) — the
chip-scale behavioral evidence is scripts/global_loc_1m.py and
scripts/kidnap_1m.py (RESULTS.md).

Run: JAX_PLATFORMS=cpu python scripts/essgate_sweep.py
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
    from mcmh_localization.filter.staged import (
        make_staged_model,
        run_staged,
    )
    from mcmh_localization.maps.house import make_house_map
    from mcmh_localization.sim.simulator import (
        odometry_deltas,
        simulate_bag,
    )
    from mcmh_localization.sim.trajectory import (
        SCENARIOS,
        fit_trajectory_to_map,
    )

    grid_map = make_house_map()
    seeds = (0, 1, 2)
    out = {}
    for scenario in ("static", "straight_line_spin", "square", "L_rest"):
        gt = SCENARIOS[scenario](duration=20.0, rate=5.0)
        gt = fit_trajectory_to_map(grid_map, gt, min_clearance=0.15)
        cfg = FilterConfig(
            mode="AMHAMCL", num_particles=4000, min_particles=400,
            max_particles=4000, initialized=True,
            initial_pose=tuple(map(float, gt[0])),
            likelihood_impl="corr", corr_window_cells=128,
            corr_theta_window_bins=32, motion_validity="score",
            min_injection_prob=0.02,
        )
        for s in seeds:
            bag = simulate_bag(jax.random.PRNGKey(100 + s), grid_map, gt,
                               n_beams=180, max_range=5.0, rate=5.0,
                               name=scenario)
            est, _i, _w = run_filter_on_bag(bag, cfg, grid_map,
                                            jax.random.PRNGKey(s))
            rmse_single = evaluate_run(bag.times, est,
                                       np.asarray(bag.gt)).rmse

            staged = make_staged_model(cfg, grid_map,
                                       tracking_ess_threshold=0.9)
            state = staged.init(jax.random.PRNGKey(s))
            o = run_staged(staged, state, np.asarray(bag.ranges),
                           np.asarray(bag.angles),
                           odometry_deltas(bag.odom))
            est_s = np.asarray(o.infos.estimate.mean)
            rmse_staged = evaluate_run(bag.times, est_s,
                                       np.asarray(bag.gt)).rmse
            small_frac = float((o.modes == 1).mean())
            row = {
                "rmse_single": round(rmse_single, 4),
                "rmse_staged_essgate": round(rmse_staged, 4),
                "small_frac": round(small_frac, 3),
            }
            out[f"{scenario}_s{s}"] = row
            print(json.dumps({f"{scenario}_s{s}": row}), flush=True)
    worst = max(v["rmse_staged_essgate"] for v in out.values())
    print(json.dumps({"worst_staged_rmse": worst}), flush=True)


if __name__ == "__main__":
    main()
