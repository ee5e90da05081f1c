"""Experiment drivers + CLI — the replacement for the reference's shell
harness (run_all_modes.sh, run_particle_sweep.sh) and roslaunch pipeline
(test_algs.launch).

Where the reference spawns a roslaunch per {bag x mode x repeat} with a
watchdog (run_all_modes.sh:51-76), here each run is one jit-compiled
``lax.scan`` over the whole trajectory — the sweep loops are plain python
around on-device runs, with compilation shared across repeats.

CLI:
  python -m mcmh_localization.eval.runner single --mode AMHAMCL ...
  python -m mcmh_localization.eval.runner all-modes [--repeats 10] ...
  python -m mcmh_localization.eval.runner particle-sweep ...
"""

from __future__ import annotations

import argparse
import os
import time

import jax
import numpy as np

from mcmh_localization.config import MODES, FilterConfig
from mcmh_localization.eval.evaluator import evaluate_run, save_results
from mcmh_localization.filter.step import make_model
from mcmh_localization.maps.grid_map import load_map
from mcmh_localization.sim.bag import load_bag, save_bag
from mcmh_localization.sim.simulator import Bag, odometry_deltas, simulate_bag
from mcmh_localization.sim.trajectory import SCENARIOS, fit_trajectory_to_map

# Matches the reference's sweep grids (run_particle_sweep.sh:8-9,13)
SWEEP_PARTICLE_COUNTS = (250, 500, 1000, 2000, 4000)
SWEEP_MODES = ("MCL", "MHMCL", "AMCL", "MHAMCL")



def _load_grid_map(args):
    """``--map`` YAML when given, else the seeded in-repo house map."""
    if args.map:
        return load_map(args.map)
    from mcmh_localization.maps.house import make_house_map

    return make_house_map()


def run_filter_on_bag(bag: Bag, config: FilterConfig, grid_map, key,
                      warmup: bool = True):
    """One full localization run; returns (est (T,3), infos, wall_seconds).

    ``warmup`` AOT-compiles ``model.run`` for the exact input shapes
    (jit .lower().compile()) before the timer starts, so the wall time
    (and the ms/scan the CLI prints from it) measures execution, not XLA
    compilation (a cold compile takes seconds to minutes)."""
    model = make_model(config, grid_map)
    state = model.init(key)
    deltas = odometry_deltas(bag.odom)
    ranges = np.asarray(bag.ranges)
    angles = np.asarray(bag.angles)
    run = model.run
    if warmup:
        run = model.run.lower(state, ranges, angles, deltas).compile()
    t0 = time.perf_counter()
    state, infos = run(state, ranges, angles, deltas)
    est = np.asarray(infos.estimate.mean)
    wall = time.perf_counter() - t0
    return est, infos, wall


def _get_bag(args, scenario: str, key, grid_map=None) -> Bag:
    if args.bag:
        if args.bag.endswith(".bag"):  # real ROS1 bag (test_algs.launch:40-44)
            from mcmh_localization.io.rosbag import read_rosbag

            return read_rosbag(args.bag)
        if args.bag.endswith(".db3") or os.path.isdir(args.bag):
            # rosbag2 sqlite3 storage (file or bag directory)
            from mcmh_localization.io.rosbag2 import read_rosbag2

            return read_rosbag2(args.bag)
        return load_bag(args.bag)
    if grid_map is None:
        grid_map = _load_grid_map(args)
    gt = SCENARIOS[scenario](duration=args.duration, rate=args.rate)
    gt = fit_trajectory_to_map(grid_map, gt, min_clearance=args.clearance)
    return simulate_bag(
        key, grid_map, gt,
        n_beams=args.beams,
        max_range=(args.max_range if args.max_range is not None
                   else _base_config(args).max_range),
        rate=args.rate,
        range_noise=args.range_noise, name=scenario,
    )


def _base_config(args) -> FilterConfig:
    if args.params:
        cfg = FilterConfig.from_yaml(args.params)
    else:
        cfg = FilterConfig()
    if args.max_range is not None:
        cfg = cfg.replace(max_range=args.max_range)
    if getattr(args, "sensor_model", None):
        cfg = cfg.replace(sensor_model=args.sensor_model)
    return cfg


def _with_init(cfg: FilterConfig, args, bag: Bag) -> FilterConfig:
    """--initialized mirrors initial_pose_pub.py feeding /initial_pose: the
    filter gets a Gaussian init around the run's start pose."""
    if not args.initialized:
        return cfg.replace(initialized=False)
    return cfg.replace(initialized=True, initial_pose=tuple(float(v) for v in bag.gt[0]))


def _run_with_frames(bag: Bag, config: FilterConfig, grid_map, key, args):
    """Step-by-step run with live visualization frames — the library
    equivalent of watching the run in RViz (the MarkerArray stream,
    amcmh_localizer.py:538-581): per-scan particle cloud + estimate trail
    + ground truth, written to --save-frames/frame_*.png and assembled
    into run.gif.  Slower than the scanned run (one dispatch per scan +
    host-side rendering) — a viewing mode, not a benchmark.

    With --staged the loop runs through OnlineLocalizer's staged mode
    (per-scan program switching + the frame hook), so the recorded
    animation shows the BIG<->SMALL hand-offs live."""
    import time as _time

    from mcmh_localization.viz import FrameRecorder

    rec = FrameRecorder(
        grid_map, args.save_frames, every=args.frame_every, gt=bag.gt
    )
    est = np.zeros((len(bag.times), 3), np.float32)
    infos = []
    angles = np.asarray(bag.angles)
    if getattr(args, "staged", False):
        from mcmh_localization.filter.online import OnlineLocalizer

        loc = OnlineLocalizer(
            config, grid_map, seed=int(jax.random.key_data(key)[-1]),
            tracking_ess_threshold=getattr(args, "tracking_ess", None),
            tracking_theta_bins=getattr(args, "tracking_theta_bins", None),
            tracking_window_cells=getattr(args, "tracking_window", None),
            staged=True, frame_recorder=rec,
        )
        odom = np.asarray(bag.odom)
        t0 = _time.perf_counter()
        for t in range(len(bag.times)):
            loc.on_odom(*odom[t])
            loc.on_scan(np.asarray(bag.ranges[t]), angles=angles)
            est[t] = np.asarray(loc.last_info.estimate.mean)
            infos.append(loc.last_info)
        wall = _time.perf_counter() - t0
    else:
        model = make_model(config, grid_map)
        state = model.init(key)
        deltas = odometry_deltas(bag.odom)
        t0 = _time.perf_counter()
        for t in range(len(bag.times)):
            state, info = model.step(
                state, np.asarray(bag.ranges[t]), angles, deltas[t]
            )
            mean = np.asarray(info.estimate.mean)
            est[t] = mean
            infos.append(info)
            rec.update(state.particles, state.weights, estimate=mean,
                       count=int(state.count))
        wall = _time.perf_counter() - t0
    gif = rec.to_gif()
    print(f"frames: {len(rec.frames)} -> {args.save_frames}"
          + (f" (animation: {gif})" if gif else ""))
    import jax as _jax

    stacked = _jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *infos
    )
    return est, stacked, wall


def _run_staged_bag(bag, cfg, grid_map, key, args):
    """Two-program execution (filter/staged.py) over one bag: full-field
    global / windowed tracking with host hand-off.  Returns
    (est, infos, wall) like run_filter_on_bag."""
    from mcmh_localization.filter.staged import (
        make_staged_model,
        run_staged,
        warmup_staged,
    )

    staged = make_staged_model(
        cfg, grid_map,
        tracking_ess_threshold=getattr(args, "tracking_ess", None),
        tracking_theta_bins=getattr(args, "tracking_theta_bins", None),
        tracking_window_cells=getattr(args, "tracking_window", None),
    )
    state = staged.init(key)
    deltas = odometry_deltas(bag.odom)
    # compile both programs for every chunk length before the timer
    # (same rationale as run_filter_on_bag's AOT warmup)
    warmup_staged(staged, state, np.asarray(bag.ranges),
                  np.asarray(bag.angles), deltas)
    t0 = time.perf_counter()
    out = run_staged(staged, state, np.asarray(bag.ranges),
                     np.asarray(bag.angles), deltas)
    wall = time.perf_counter() - t0
    est = np.asarray(out.infos.estimate.mean)
    print(f"staged: {int((out.modes == 1).sum())}/{len(out.modes)} "
          f"scans in the tracking program, {out.switches} switches")
    return est, out.infos, wall


def _run_bag(bag, cfg, grid_map, key, args):
    """Dispatch one run: the staged runner when --staged and the mode is
    adaptive (staging needs changing counts), else the single-program
    lax.scan runner."""
    if getattr(args, "staged", False) and cfg.use_adaptive:
        try:
            return _run_staged_bag(bag, cfg, grid_map, key, args)
        except ValueError as e:
            # e.g. sweep points too small for a distinct tracking
            # capacity (cap >= max_particles) — run single-program
            print(f"staged fallback ({e}); running single-program")
    return run_filter_on_bag(bag, cfg, grid_map, key)


def cmd_single(args):
    grid_map = _load_grid_map(args)
    key = jax.random.PRNGKey(args.seed)
    k_bag, k_run = jax.random.split(key)
    bag = _get_bag(args, args.scenario, k_bag, grid_map)
    cfg = _base_config(args).replace(
        mode=args.mode,
        num_particles=args.particles,
    )
    cfg = _with_init(cfg, args, bag)
    if getattr(args, "save_frames", None):
        est, infos, wall = _run_with_frames(bag, cfg, grid_map, k_run, args)
    elif getattr(args, "staged", False):
        est, infos, wall = _run_staged_bag(bag, cfg, grid_map, k_run, args)
    else:
        est, infos, wall = run_filter_on_bag(bag, cfg, grid_map, k_run)
    result = evaluate_run(bag.times, est, bag.gt)
    name = args.result_name or f"{args.scenario}_{args.mode}_run0"
    path = save_results(result, name, args.results_dir)
    if args.metrics:
        from mcmh_localization.utils.metrics import MetricsLogger

        with MetricsLogger(os.path.join(args.results_dir, f"{name}.jsonl")) as log:
            log.log_run(infos, times=bag.times)
    print(
        f"{name}: RMSE {result.rmse:.4f} m | {len(bag.times)} scans in "
        f"{wall:.2f}s ({1e3 * wall / len(bag.times):.2f} ms/scan) -> {path}"
    )
    return result


def cmd_all_modes(args):
    """bag x mode x repeat sweep (run_all_modes.sh:51-76)."""
    grid_map = _load_grid_map(args)
    scenarios = args.scenarios.split(",")
    for scenario in scenarios:
        bag = _get_bag(args, scenario, jax.random.PRNGKey(args.seed), grid_map)
        if args.save_bags:
            save_bag(os.path.join(args.results_dir, f"bag_{scenario}.npz"), bag)
        for mode in MODES:
            cfg = _base_config(args).replace(
                mode=mode,
                num_particles=args.particles,
            )
            cfg = _with_init(cfg, args, bag)
            for rep in range(args.repeats):
                mode_salt = sum(ord(c) for c in mode)  # stable across processes
                key = jax.random.PRNGKey(args.seed + 1000 * rep + mode_salt)
                est, infos, wall = _run_bag(bag, cfg, grid_map, key, args)
                result = evaluate_run(bag.times, est, bag.gt)
                name = f"{scenario}_{mode}_run{rep}"
                save_results(result, name, args.results_dir)
                print(f"{name}: RMSE {result.rmse:.4f} ({wall:.2f}s)")


def cmd_particle_sweep(args):
    """particle-count sweep (run_particle_sweep.sh:44-70): counts x 4 modes
    x repeats with max_particles=2P, min_particles=P/10."""
    grid_map = _load_grid_map(args)
    scenarios = args.scenarios.split(",")
    for scenario in scenarios:
        bag = _get_bag(args, scenario, jax.random.PRNGKey(args.seed), grid_map)
        for p in SWEEP_PARTICLE_COUNTS:
            for mode in SWEEP_MODES:
                cfg = _base_config(args).replace(
                    mode=mode,
                    num_particles=p,
                    max_particles=2 * p,
                    min_particles=max(p // 10, 1),
                )
                cfg = _with_init(cfg, args, bag)
                for rep in range(args.repeats):
                    key = jax.random.PRNGKey(args.seed + 7919 * rep + p)
                    est, infos, wall = _run_bag(bag, cfg, grid_map, key, args)
                    result = evaluate_run(bag.times, est, bag.gt)
                    name = f"{scenario}_{mode}_{p}p_run{rep}"
                    save_results(result, name, args.results_dir)
                    print(f"{name}: RMSE {result.rmse:.4f} ({wall:.2f}s)")


def build_parser():
    p = argparse.ArgumentParser(prog="mcmh-eval", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument(
            "--map", default=None,
            help="ROS map YAML; default: the seeded in-repo house map",
        )
        sp.add_argument(
            "--params", default=None,
            help="reference-format params YAML; default: FilterConfig "
                 "defaults (the reference's amhmcl.yaml values)",
        )
        sp.add_argument("--results-dir", default="results")
        sp.add_argument("--bag", default=None, help="replay a recorded .npz bag")
        sp.add_argument("--duration", type=float, default=30.0)
        sp.add_argument("--rate", type=float, default=5.0)
        sp.add_argument("--beams", type=int, default=360)
        sp.add_argument(
            "--max-range", type=float, default=None,
            help="sensor max range; default: the --params YAML value",
        )
        sp.add_argument("--range-noise", type=float, default=0.01)
        sp.add_argument("--clearance", type=float, default=0.2,
                        help="min obstacle clearance when placing scenarios")
        sp.add_argument("--particles", type=int, default=1500)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--initialized", action="store_true")
        sp.add_argument(
            "--sensor-model", dest="sensor_model", default=None,
            choices=["likelihood_field", "beam"],
            help="override the sensor model (lidar3d needs the python API "
                 "with a VoxelMap)",
        )
        sp.add_argument("--repeats", type=int, default=1)
        # staged two-program execution works for every command (the
        # sweeps silently fall back to the single-program runner on
        # non-adaptive modes, whose counts never change)
        sp.add_argument("--staged", action="store_true",
                        help="two-program execution (filter/staged.py): "
                             "full-field global / windowed tracking; "
                             "applies to adaptive modes")
        sp.add_argument("--tracking-ess", type=float, default=None,
                        help="with --staged: ESS-gated resampling "
                             "threshold for the tracking program (e.g. 0.9)")
        sp.add_argument("--tracking-theta-bins", type=int, default=None,
                        help="with --staged: narrower corr/beam theta "
                             "window for the tracking program")
        sp.add_argument("--tracking-window", type=int, default=None,
                        help="with --staged: narrower spatial corr/beam "
                             "window (cells) for the tracking program")

    s = sub.add_parser("single", help="one bag x one mode")
    common(s)
    s.add_argument("--mode", default="AMHAMCL", choices=MODES)
    s.add_argument("--scenario", default="square", choices=sorted(SCENARIOS))
    s.add_argument("--result-name", default=None)
    s.add_argument("--save-frames", default=None, metavar="DIR",
                   help="live view: write per-scan particle frames + GIF "
                        "(the RViz MarkerArray stream equivalent)")
    s.add_argument("--frame-every", type=int, default=1,
                   help="render every N-th scan with --save-frames")
    s.add_argument("--metrics", action="store_true",
                   help="write per-step JSONL metrics next to the results")
    s.set_defaults(fn=cmd_single)

    a = sub.add_parser("all-modes", help="all 6 modes x scenarios x repeats")
    common(a)
    a.add_argument("--scenarios", default="static,straight_line_spin,square,L_rest")
    a.add_argument("--save-bags", action="store_true")
    a.set_defaults(fn=cmd_all_modes)

    w = sub.add_parser("particle-sweep", help="particle-count sweep")
    common(w)
    w.add_argument("--scenarios", default="square")
    w.set_defaults(fn=cmd_particle_sweep)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
