"""Round-4 diagnostic: which factor breaks windowed global localization at
scale — the theta window, the real map's symmetry, or N?  Runs the global
demo config at a chosen (n, win, tw, duration, seed) and prints the err
trace + anchor trace every scan (stderr) and one JSON line (stdout).

Usage: python scripts/diag_window_global.py n duration seed win tw
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
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    duration = float(sys.argv[2]) if len(sys.argv) > 2 else 60.0
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    win = int(sys.argv[4]) if len(sys.argv) > 4 else 128
    tw = int(sys.argv[5]) if len(sys.argv) > 5 else 32

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.filter.step import make_model
    from mcmh_localization.maps.house import make_house_map
    from mcmh_localization.sim.simulator import simulate_bag
    from mcmh_localization.sim.trajectory import (
        fit_trajectory_to_map,
        square_trajectory,
    )

    grid_map = make_house_map()
    gt = square_trajectory(duration=duration, rate=5.0, side=4.0, speed=0.3)
    gt = fit_trajectory_to_map(grid_map, gt, min_clearance=0.18)
    bag = simulate_bag(
        jax.random.PRNGKey(seed), grid_map, gt, n_beams=360, max_range=5.0,
        rate=5.0, range_noise=0.01, name="diag",
    )
    cfg = FilterConfig(
        mode="AMHAMCL",
        num_particles=n, min_particles=max(n // 10, 1000), max_particles=n,
        initialized=False, max_range=5.0,
        likelihood_impl="corr", corr_window_cells=win,
        corr_theta_window_bins=tw,
        estimate_mode="cluster",
        motion_validity="score", min_injection_prob=0.02,
    )
    from mcmh_localization.sim.simulator import odometry_deltas

    model = make_model(cfg, grid_map)
    state = model.init(jax.random.PRNGKey(seed + 100))
    deltas = odometry_deltas(bag.odom)
    t0 = time.perf_counter()
    fstate, infos = jax.block_until_ready(
        model.run(state, np.asarray(bag.ranges), np.asarray(bag.angles),
                  deltas)
    )
    wall = time.perf_counter() - t0
    est = np.asarray(infos.estimate.mean)
    errs = np.hypot(est[:, 0] - bag.gt[:, 0], est[:, 1] - bag.gt[:, 1])
    ok = errs < 0.5
    stays = np.logical_and.accumulate(ok[::-1])[::-1]
    t_loc = int(np.argmax(stays)) if stays.any() else -1
    print(json.dumps({
        "n": n, "win": win, "tw": tw, "seed": seed,
        "scans": len(errs),
        "t_loc_scans": t_loc,
        "final_err": round(float(errs[-1]), 3),
        "tail_err": round(float(errs[-6:].mean()), 3),
        "count_final": int(np.asarray(infos.count)[-1]),
        "wall_s": round(wall, 1),
    }), flush=True)
    print("errs[::5]:", np.round(errs[::5], 2).tolist(), file=sys.stderr)
    print("p_rand[::5]:",
          np.round(np.asarray(infos.p_random)[::5], 2).tolist(),
          file=sys.stderr)
    print("count[::5]:", np.asarray(infos.count)[::5].tolist(),
          file=sys.stderr)


if __name__ == "__main__":
    main()
