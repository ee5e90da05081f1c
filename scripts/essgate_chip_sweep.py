"""Chip-scale accuracy validation for promoting staged+essgate to the
bench flagship (VERDICT r4 item 2 / next-round #2).

The round-4 parity sweep (scripts/essgate_sweep.py) ran at 4000-capacity
CPU scale; the bench flagship operates at 1M capacity / min 100k, whose
SMALL tracking program is ~131k particles (1.3x min rounded to 1024).
This script runs the REAL operating point on the chip: 4 reference
scenarios x 3 seeds, staged runner (full-field 1M BIG, windowed ~131k
SMALL with tracking_ess_threshold=0.9 and the priced tracking knobs) vs
the EXACT-gather scorer at the same tracking scale on the same bags —
the gold accuracy reference (RESULTS.md "Benchmark-config accuracy"
protocol, reference model parallel_utils.py:85-149).

Usage: python scripts/essgate_chip_sweep.py [theta_bins] [window_cells]
Prints one JSON line per run + a summary line for RESULTS.md.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

from mcmh_localization.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import numpy as np


def main():
    theta = int(sys.argv[1]) if len(sys.argv) > 1 else None
    window = int(sys.argv[2]) if len(sys.argv) > 2 else None

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.eval.evaluator import evaluate_run
    from mcmh_localization.eval.runner import run_filter_on_bag
    from mcmh_localization.filter.staged import (
        make_staged_model,
        run_staged,
        warmup_staged,
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
            mode="AMHAMCL", num_particles=1_000_000, min_particles=100_000,
            max_particles=1_000_000, initialized=True,
            initial_pose=tuple(map(float, gt[0])),
            likelihood_impl="corr", corr_window_cells=128,
            corr_theta_window_bins=32, motion_validity="score",
            min_injection_prob=0.02,
        )
        # exact-scorer reference at the SMALL tracking scale (131k exact
        # at 1M capacity would OOM the one-hot volume; the tracking-scale
        # exact run is the accuracy gold standard for the same bags)
        cfg_exact = cfg.replace(
            num_particles=131_072, max_particles=131_072,
            min_particles=13_107, likelihood_impl="jnp",
        )
        for s in seeds:
            bag = simulate_bag(jax.random.PRNGKey(100 + s), grid_map, gt,
                               n_beams=360, max_range=5.0, rate=5.0,
                               name=scenario)
            deltas = odometry_deltas(bag.odom)

            staged = make_staged_model(
                cfg, grid_map, tracking_ess_threshold=0.9,
                tracking_theta_bins=theta, tracking_window_cells=window,
            )
            state = staged.init(jax.random.PRNGKey(s))
            warmup_staged(staged, state, np.asarray(bag.ranges),
                          np.asarray(bag.angles), deltas)
            o = run_staged(staged, state, np.asarray(bag.ranges),
                           np.asarray(bag.angles), deltas)
            rmse_staged = evaluate_run(
                bag.times, np.asarray(o.infos.estimate.mean),
                np.asarray(bag.gt)).rmse
            small_frac = float((o.modes == 1).mean())

            est_e, _i, _w = run_filter_on_bag(bag, cfg_exact, grid_map,
                                              jax.random.PRNGKey(s))
            rmse_exact = evaluate_run(bag.times, est_e,
                                      np.asarray(bag.gt)).rmse
            row = {
                "rmse_staged_essgate_1m": round(rmse_staged, 4),
                "rmse_exact_131k": round(rmse_exact, 4),
                "small_frac": round(small_frac, 3),
            }
            out[f"{scenario}_s{s}"] = row
            print(json.dumps({f"{scenario}_s{s}": row}), flush=True)
    print(json.dumps({
        "worst_staged": max(v["rmse_staged_essgate_1m"] for v in out.values()),
        "worst_exact": max(v["rmse_exact_131k"] for v in out.values()),
        "tracking_theta_bins": theta, "tracking_window_cells": window,
    }), flush=True)


if __name__ == "__main__":
    main()
