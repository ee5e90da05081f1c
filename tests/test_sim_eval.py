"""Simulator, bag persistence, evaluator-format, and plotting tests."""

import os

import jax
import numpy as np
import pytest

from mcmh_localization.config import FilterConfig
from mcmh_localization.eval.evaluator import (
    evaluate_run,
    parse_poses_file,
    parse_results_file,
    save_results,
)
from mcmh_localization.eval.runner import run_filter_on_bag
from mcmh_localization.sim.bag import load_bag, save_bag
from mcmh_localization.sim.simulator import odometry_deltas, simulate_bag
from mcmh_localization.sim.trajectory import SCENARIOS


def test_trajectories_shapes_and_wrap():
    for name, gen in SCENARIOS.items():
        poses = gen(duration=10.0, rate=5.0)
        assert poses.shape[1] == 3
        assert len(poses) >= 50
        assert (np.abs(poses[:, 2]) <= np.pi + 1e-6).all(), name


def test_static_trajectory_is_static():
    poses = SCENARIOS["static"](duration=5.0, rate=5.0)
    assert np.allclose(poses, poses[0])


def test_second_placement_kidnap_legs(house_map):
    """The kidnap-scenario constructor: leg B is a rigid translate of leg
    A, every pose free with clearance, anchored >= min_dist away."""
    from mcmh_localization.sim.trajectory import (
        fit_trajectory_to_map,
        second_placement,
    )

    gt_a = fit_trajectory_to_map(
        house_map, SCENARIOS["square"](duration=10.0, rate=5.0),
        min_clearance=0.15,
    )
    gt_b = second_placement(house_map, gt_a, min_clearance=0.15,
                            min_dist=2.0)
    # rigid translation: same shape, same headings
    shift = gt_b[:, :2] - gt_a[:, :2]
    assert np.allclose(shift, shift[0], atol=1e-5)
    assert np.allclose(gt_b[:, 2], gt_a[:, 2])
    assert np.hypot(*shift[0]) >= 2.0
    # every leg-B pose is free with clearance
    occ = np.asarray(house_map.occupancy)
    dist = np.asarray(house_map.distance)
    res = float(house_map.resolution)
    origin = np.asarray(house_map.origin)
    cx = ((gt_b[:, 0] - origin[0]) / res).astype(int)
    cy = ((gt_b[:, 1] - origin[1]) / res).astype(int)
    assert (occ[cy, cx] == 0).all()
    assert (dist[cy, cx] >= 0.15).all()
    # impossible distance raises
    with pytest.raises(ValueError):
        second_placement(house_map, gt_a, min_clearance=0.15,
                         min_dist=1e6)


@pytest.fixture(scope="module")
def small_bag(house_map):
    gt = SCENARIOS["square"](duration=10.0, rate=5.0)
    return simulate_bag(
        jax.random.PRNGKey(0), house_map, gt,
        n_beams=90, max_range=5.0, range_noise=0.01, name="square",
    )


def test_simulate_bag_shapes(small_bag):
    t, m = small_bag.ranges.shape
    assert m == 90
    assert small_bag.odom.shape == (t, 3)
    assert small_bag.gt.shape == (t, 3)
    assert small_bag.times.shape == (t,)
    assert np.all(small_bag.ranges <= 5.0 + 1e-5)
    assert np.all(small_bag.ranges > 0)


def test_odometry_drifts_but_tracks(small_bag):
    err = np.hypot(*(small_bag.odom[:, :2] - small_bag.gt[:, :2]).T)
    assert err[0] == 0
    assert err.max() < 0.5  # drifty but sane
    assert err[-1] > 0  # noise actually applied


def test_odometry_deltas_first_zero(small_bag):
    d = odometry_deltas(small_bag.odom)
    assert d.shape == (len(small_bag.times), 3)
    assert np.all(d[0] == 0)


def test_bag_roundtrip(tmp_path, small_bag):
    path = str(tmp_path / "bag.npz")
    save_bag(path, small_bag)
    back = load_bag(path)
    np.testing.assert_array_equal(back.ranges, small_bag.ranges)
    np.testing.assert_array_equal(back.odom, small_bag.odom)
    np.testing.assert_array_equal(back.gt, small_bag.gt)
    assert back.max_range == small_bag.max_range
    assert back.meta["name"] == "square"


def test_full_run_on_bag(house_map, small_bag):
    cfg = FilterConfig(
        mode="MHAMCL", num_particles=300, min_particles=50, max_particles=400,
        initialized=True, initial_pose=tuple(small_bag.gt[0]), max_range=5.0,
    )
    est, infos, wall = run_filter_on_bag(
        small_bag, cfg, house_map, jax.random.PRNGKey(1)
    )
    result = evaluate_run(small_bag.times, est, small_bag.gt)
    assert result.rmse < 0.5
    assert len(result.errors) == len(small_bag.times)


def test_results_file_format(tmp_path):
    times = np.array([0.0, 0.2, 0.4])
    est = np.array([[0, 0, 0], [1, 1, 0.5], [2, 2, 1.0]], dtype=float)
    gt = est + 0.1
    r = evaluate_run(times, est, gt)
    path = save_results(r, "square_MCL_run0", str(tmp_path))
    text = open(path).read()
    # byte-format parity with evaluate_localization.py:120-125
    assert text.startswith("time,error\n")
    assert f"\nRMSE final: {r.rmse:.4f}\n" in text
    lines = text.splitlines()
    assert lines[1] == "0.000,0.1414"
    # poses file
    t2, est2, gt2 = parse_poses_file(str(tmp_path / "poses_square_MCL_run0.txt"))
    np.testing.assert_allclose(est2, est, atol=1e-4)
    np.testing.assert_allclose(gt2, gt, atol=1e-4)
    # summary append-log
    summary = open(tmp_path / "summary_results.txt").read()
    assert summary == f"square_MCL_run0.txt,{r.rmse:.4f}\n"
    # roundtrip
    t3, e3, rmse3 = parse_results_file(path)
    np.testing.assert_allclose(e3, r.errors, atol=1e-4)
    assert abs(rmse3 - r.rmse) < 1e-4


def test_plots_report(tmp_path):
    # synthesize a few result files following the naming conventions
    rng = np.random.default_rng(0)
    times = np.arange(20) * 0.2
    for algo in ("MCL", "AMHAMCL"):
        for run in range(2):
            est = np.cumsum(rng.normal(0, 0.05, size=(20, 3)), axis=0)
            gt = est + rng.normal(0, 0.05, size=(20, 3))
            r = evaluate_run(times, est, gt)
            save_results(r, f"square_{algo}_run{run}", str(tmp_path))
            save_results(r, f"square_{algo}_{250 * (run + 1)}p_run0", str(tmp_path))
    from mcmh_localization.eval.plots import (
        collect_runs,
        collect_sweep,
        plot_rmse_report,
        plot_sweep_report,
    )

    runs = collect_runs(str(tmp_path))
    assert set(runs) == {("square", "MCL"), ("square", "AMHAMCL")}
    assert all(len(v) == 2 for v in runs.values())
    sweep = collect_sweep(str(tmp_path))
    assert ("square", "MCL", 250) in sweep and ("square", "AMHAMCL", 500) in sweep

    # a live-run animation anywhere under results_dir is embedded in the
    # report (runner --save-frames / FrameRecorder.to_gif output)
    from PIL import Image

    os.makedirs(tmp_path / "frames", exist_ok=True)
    Image.new("RGB", (8, 8)).save(tmp_path / "frames" / "run.gif")

    html = plot_rmse_report(str(tmp_path))
    assert os.path.exists(html)
    assert os.path.exists(tmp_path / "plots" / "square_error_vs_time.png")
    text = open(html).read()
    assert "run.gif" in text and "live run" in text
    html2 = plot_sweep_report(str(tmp_path))
    assert os.path.exists(html2)


def test_drive_bag_command_stream(house_map):
    """(v, omega) command-stream driving (drive_bag) — the teleop/Gazebo
    live-sim equivalent (mcmh_localization.launch:8-46): closed-loop
    controller moves the robot, walls stop translation, and the bag feeds
    the filter unchanged."""
    from mcmh_localization.sim.simulator import drive_bag

    def ctrl(t, pose):
        return (0.25, 0.6 if (t % 3) < 1.0 else 0.0)

    bag = drive_bag(jax.random.PRNGKey(0), house_map, ctrl, duration=6.0,
                    rate=5.0, start_pose=(1.0, -1.0, 0.0), n_beams=90)
    assert bag.ranges.shape == (30, 90)
    assert np.ptp(bag.gt[:, 0]) > 0.2  # it actually drove
    # wall collision: full-throttle into the wall stops at the wall
    cmds = np.tile([[1.0, 0.0]], (40, 1))
    bag_wall = drive_bag(jax.random.PRNGKey(1), house_map, cmds,
                         start_pose=(1.0, -1.0, 0.0), n_beams=30)
    assert np.all(np.isfinite(bag_wall.gt))
    from mcmh_localization.maps.grid_map import GridMap  # noqa: F401
    d = np.asarray(house_map.distance)
    res = float(house_map.resolution)
    for x, y, _ in bag_wall.gt:
        mx = int((x - float(house_map.origin[0])) / res)
        my = int((y - float(house_map.origin[1])) / res)
        assert d[my, mx] >= 0.15 - 1e-6  # never inside the clearance band

    # open-loop array form + filter consumption
    cfg = FilterConfig(mode="MCL", num_particles=300, initialized=True,
                       initial_pose=(1.0, -1.0, 0.0), max_range=5.0)
    est, infos, wall = run_filter_on_bag(bag, cfg, house_map,
                                         jax.random.PRNGKey(2))
    errs = np.hypot(est[:, 0] - bag.gt[:, 0], est[:, 1] - bag.gt[:, 1])
    assert errs[-1] < 0.4, errs[-5:]


def test_frame_recorder_live_view(house_map, small_bag, tmp_path):
    """FrameRecorder (live RViz-equivalent view): frames every N scans +
    GIF assembly, via the runner's --save-frames path."""
    import argparse

    from mcmh_localization.eval.runner import _run_with_frames

    cfg = FilterConfig(mode="MCL", num_particles=200, initialized=True,
                       initial_pose=tuple(map(float, small_bag.gt[0])),
                       max_range=small_bag.max_range)
    args = argparse.Namespace(save_frames=str(tmp_path / "frames"),
                              frame_every=3)
    est, infos, wall = _run_with_frames(
        small_bag, cfg, house_map, jax.random.PRNGKey(0), args)
    frames = sorted(os.listdir(tmp_path / "frames"))
    pngs = [f for f in frames if f.endswith(".png")]
    assert len(pngs) == -(-len(small_bag.times) // 3)
    assert "run.gif" in frames
    assert est.shape == (len(small_bag.times), 3)


def test_frame_recorder_staged(house_map, small_bag, tmp_path):
    """--save-frames + --staged combined: the live view runs through
    OnlineLocalizer's staged mode (program hand-offs visible in the
    animation) and still produces frames + GIF."""
    import argparse

    from mcmh_localization.eval.runner import _run_with_frames

    cfg = FilterConfig(mode="AMHAMCL", num_particles=2048,
                       min_particles=100, max_particles=2048,
                       initialized=True,
                       initial_pose=tuple(map(float, small_bag.gt[0])),
                       max_range=small_bag.max_range,
                       likelihood_impl="corr", corr_window_cells=48,
                       estimate_mode="cluster")
    args = argparse.Namespace(save_frames=str(tmp_path / "frames"),
                              frame_every=4, staged=True,
                              tracking_ess=0.9, tracking_theta_bins=None,
                              tracking_window=40)
    est, infos, wall = _run_with_frames(
        small_bag, cfg, house_map, jax.random.PRNGKey(0), args)
    frames = sorted(os.listdir(tmp_path / "frames"))
    pngs = [f for f in frames if f.endswith(".png")]
    assert len(pngs) == -(-len(small_bag.times) // 4)
    assert "run.gif" in frames
    assert est.shape == (len(small_bag.times), 3)
    assert np.all(np.isfinite(est))


def test_runner_cli_single_staged(tmp_path, capsys):
    """`eval.runner single --staged` end-to-end through the argparse
    surface: the staged two-program path runs, reports the tracking-
    program share, and writes the reference-format results file."""
    from mcmh_localization.eval.runner import main

    res = main([
        "single", "--staged", "--initialized",
        "--mode", "AMHAMCL", "--scenario", "square",
        "--particles", "600", "--duration", "8.0", "--beams", "90",
        "--results-dir", str(tmp_path), "--result-name", "staged_cli",
        "--seed", "0",
    ])
    out = capsys.readouterr().out
    assert "scans in the tracking program" in out
    assert res.rmse < 0.5, out
    txt = (tmp_path / "staged_cli.txt").read_text()
    assert "RMSE final:" in txt


def test_runner_staged_dispatch(house_map, capsys):
    """--staged now applies to the sweep commands too (VERDICT r4 item
    2): _run_bag dispatches adaptive modes to the staged runner and
    falls back (with a note) for non-adaptive modes and for sweep
    points too small to stage."""
    import argparse

    import jax

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.eval.runner import _run_bag
    from mcmh_localization.sim.simulator import simulate_bag
    from mcmh_localization.sim.trajectory import (
        SCENARIOS,
        fit_trajectory_to_map,
    )

    gt = fit_trajectory_to_map(
        house_map, SCENARIOS["static"](duration=3.0, rate=5.0))
    bag = simulate_bag(jax.random.PRNGKey(0), house_map, gt, n_beams=60,
                      max_range=5.0, rate=5.0, name="static")
    args = argparse.Namespace(staged=True, tracking_ess=None,
                              tracking_theta_bins=None, tracking_window=None)
    base = dict(
        num_particles=900, min_particles=128, max_particles=3000,
        initialized=True, initial_pose=tuple(map(float, bag.gt[0])),
        max_range=5.0,
    )
    # adaptive -> staged (the tracking-program report prints)
    _run_bag(bag, FilterConfig(mode="AMHAMCL", **base), house_map,
             jax.random.PRNGKey(1), args)
    out = capsys.readouterr().out
    assert "scans in the tracking program" in out
    # non-adaptive -> single program silently
    _run_bag(bag, FilterConfig(mode="MHMCL", **base), house_map,
             jax.random.PRNGKey(1), args)
    out = capsys.readouterr().out
    assert "tracking program" not in out
    # adaptive but too small to stage -> printed fallback
    tiny = dict(base, num_particles=250, max_particles=500,
                min_particles=400)
    _run_bag(bag, FilterConfig(mode="AMCL", **tiny), house_map,
             jax.random.PRNGKey(1), args)
    out = capsys.readouterr().out
    assert "staged fallback" in out
