"""Global (uninitialized) localization AT SCALE on a house-scale map:
1M-particle AMHAMCL, uniform init over the house's free space, judged on
the published CLUSTER estimate (round-2 verdict #9 made measurable).

The reference's own estimate is the weighted mean over a (long-)multimodal
cloud (amcmh_localizer.py:584-597), so its global-localization RMSE stays
meters-high on this near-symmetric house; `estimate_mode="cluster"` is the
framework's mode-finding extension.  This script records time-to-localize
(first scan whose cluster estimate stays within 0.5 m of ground truth
through the end) and the final error, on the real chip.

win=0 runs the round-3 single-program full-map configuration.  win>0 runs
the WINDOWED flagship config through the STAGED runner (filter/staged.py,
round-4): the global phase executes the full-map program (fair fine
scoring for every mode — a window locked on one mode of a multimodal
cloud leaves the others on the max-pooled-optimistic coarse fallback,
where a symmetric decoy can neither die nor be confirmed; measured,
scripts/diag_window_global.py), then hands off to the windowed
small-capacity tracking program once one mode dominates, escalating back
on injection / dominance decay.

Usage: python scripts/global_loc_1m.py [n_particles] [duration_s] [seed] [win]
                                        [map_seed] [tracking_theta] [tracking_ess]
                                        [tracking_win]
``map_seed`` (default 0) picks the seeded house map (maps/house.py).
``tracking_theta`` / ``tracking_ess`` / ``tracking_win`` (win>0 only)
forward to the staged runner's tracking-program knobs
(tracking_theta_bins / tracking_ess_threshold / tracking_window_cells;
0 = off).
Prints one JSON line for RESULTS.md.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

from mcmh_localization.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    duration = float(sys.argv[2]) if len(sys.argv) > 2 else 40.0
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    win = int(sys.argv[4]) if len(sys.argv) > 4 else 0
    map_seed = int(sys.argv[5]) if len(sys.argv) > 5 else 0
    tracking_theta = int(sys.argv[6]) if len(sys.argv) > 6 else 0
    tracking_ess = float(sys.argv[7]) if len(sys.argv) > 7 else 0.0
    tracking_win = int(sys.argv[8]) if len(sys.argv) > 8 else 0

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.eval.runner import run_filter_on_bag
    from mcmh_localization.maps.house import make_house_map
    from mcmh_localization.sim.simulator import simulate_bag
    from mcmh_localization.sim.trajectory import (
        SCENARIOS,
        fit_trajectory_to_map,
    )

    from mcmh_localization.sim.trajectory import square_trajectory

    grid_map = make_house_map(map_seed)
    # a LARGE square tour (4 m side, 0.3 m/s): the default 1.5 m square
    # placed in one corner room never breaks map_house's near-symmetry
    # under 5 m scans — the cluster estimate locks a wrong mode ~5 m off
    # (measured, seed 0).  Touring the central area visits distinguishing
    # geometry
    gt = square_trajectory(duration=duration, rate=5.0, side=4.0, speed=0.3)
    gt = fit_trajectory_to_map(grid_map, gt, min_clearance=0.18)
    bag = simulate_bag(
        jax.random.PRNGKey(seed), grid_map, gt, n_beams=360, max_range=5.0,
        rate=5.0, range_noise=0.01, name=f"global_square_house{map_seed}",
    )

    cfg = FilterConfig(
        mode="AMHAMCL",
        num_particles=n, min_particles=max(n // 10, 1000), max_particles=n,
        initialized=False,                     # uniform over free space
        max_range=5.0,
        likelihood_impl="corr", corr_window_cells=win,
        corr_theta_window_bins=(32 if win else 0),
        estimate_mode="cluster",
        motion_validity="score", min_injection_prob=0.02,
    )
    t0 = time.perf_counter()
    modes = None
    if win:
        from mcmh_localization.filter.staged import (
            make_staged_model,
            run_staged,
        )
        from mcmh_localization.sim.simulator import odometry_deltas

        staged = make_staged_model(
            cfg, grid_map,
            tracking_theta_bins=tracking_theta or None,
            tracking_ess_threshold=tracking_ess or None,
            tracking_window_cells=tracking_win or None,
        )
        state = staged.init(jax.random.PRNGKey(seed + 100))
        t1 = time.perf_counter()
        out = run_staged(
            staged, state, np.asarray(bag.ranges), np.asarray(bag.angles),
            odometry_deltas(bag.odom),
        )
        wall = time.perf_counter() - t1
        infos = out.infos
        modes = out.modes
        est = np.asarray(infos.estimate.mean)
    else:
        est, infos, wall = run_filter_on_bag(
            bag, cfg, grid_map, jax.random.PRNGKey(seed + 100)
        )
    total = time.perf_counter() - t0
    errs = np.hypot(est[:, 0] - bag.gt[:, 0], est[:, 1] - bag.gt[:, 1])
    ok = errs < 0.5
    stays = np.logical_and.accumulate(ok[::-1])[::-1]
    t_loc = int(np.argmax(stays)) if stays.any() else -1
    counts = np.asarray(infos.count)
    print(json.dumps({
        "n_particles": n,
        "scans": int(len(errs)),
        "time_to_localize_scans": t_loc,
        "time_to_localize_s": round(t_loc / 5.0, 1) if t_loc >= 0 else -1,
        "final_err_m": round(float(errs[-1]), 4),
        "tail_mean_err_m": round(float(errs[-6:].mean()), 4),
        "final_active_count": int(counts[-1]),
        "filter_wall_s": round(wall, 2),
        "total_wall_s": round(total, 2),
        "seed": seed,
        "win": win,
        "map": f"house seed {map_seed}",
        "tracking_scans": int((modes == 1).sum()) if modes is not None else None,
    }), flush=True)
    print("err trace (every 5th):",
          np.round(errs[::5], 2).tolist(), file=sys.stderr)
    if modes is not None:
        print("modes (every 5th):", modes[::5].tolist(), file=sys.stderr)


if __name__ == "__main__":
    main()
