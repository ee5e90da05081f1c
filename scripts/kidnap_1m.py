"""Chip-scale kidnapped-robot demo through the STAGED runner: 1M-capacity
AMHAMCL tracking on map_house, mid-run teleport, full phase cycle
measured (tracking -> kidnap -> escalate to the 1M full-field program ->
re-localize -> shrink back to windowed tracking).

The CPU-scale twin runs in CI (tests/test_staged.py::
test_staged_escalates_on_kidnap); this script validates the stage-switch
policy at the real 1M operating point on the chip and records the
numbers for RESULTS.md.  Kidnap construction mirrors the reference's
evaluation scenario class (SURVEY.md section 4; augmented-MCL injection,
amcmh_localizer.py:447-467): leg B is leg A's square tour rigidly
translated to another room, scans switch to leg B at the teleport scan
while odometry stays continuous (blind to the teleport).

Usage: python scripts/kidnap_1m.py [n_particles] [seed] [plot.png]
Prints one JSON line for RESULTS.md; the optional third argument saves an
error-vs-time plot with program-mode shading (the full staged cycle in
one picture).
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
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0

    from mcmh_localization.config import FilterConfig
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
        fit_trajectory_to_map,
        second_placement,
        square_trajectory,
    )

    grid_map = make_house_map()
    # 130 s square tour at 5 Hz = ~650 scans; teleport at scan 150 (30 s in).
    # Leg assignment matters on this near-symmetric house: tracking (leg A)
    # works in any room, but RE-localization needs distinguishing geometry
    # (RESULTS.md global runs localize only where the tour breaks the
    # symmetry), so the robot is kidnapped INTO the max-clearance central
    # placement (fit_trajectory_to_map's canonical choice) FROM a distant
    # room placement — a 10 m teleport whose destination is resolvable.
    # Post-kidnap re-localization takes ~50 s (matches the RESULTS.md
    # global-localization time on this map), so the tour leaves ~50 s of
    # post-relocalization budget for the shrink-back-to-tracking phase.
    sq = square_trajectory(duration=130.0, rate=5.0, side=1.5, speed=0.3)
    gt_b = fit_trajectory_to_map(grid_map, sq, min_clearance=0.18)
    gt_a = second_placement(grid_map, gt_b, min_clearance=0.18, min_dist=3.0)
    k = 150
    jump = float(np.hypot(*(gt_b[k, :2] - gt_a[k, :2])))

    key = jax.random.PRNGKey(seed)
    bag_a = simulate_bag(key, grid_map, gt_a, n_beams=360, max_range=5.0,
                         rate=5.0, range_noise=0.01, name="kidnap_a")
    bag_b = simulate_bag(jax.random.PRNGKey(seed + 1), grid_map, gt_b,
                         n_beams=360, max_range=5.0, rate=5.0,
                         range_noise=0.01, name="kidnap_b")
    ranges = np.concatenate(
        [np.asarray(bag_a.ranges[:k]), np.asarray(bag_b.ranges[k:])])
    deltas = odometry_deltas(bag_a.odom)  # continuous — blind to the jump
    gt = np.concatenate([gt_a[:k], gt_b[k:]])

    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=n,
        min_particles=max(n // 10, 1000), max_particles=n,
        initialized=True, initial_pose=tuple(map(float, gt_a[0])),
        max_range=5.0, likelihood_impl="corr", corr_window_cells=128,
        corr_theta_window_bins=32,
        # the post-kidnap injection storm seeds mass by BASIN AREA:
        # congruent-fit decoy regions collect ~95% of it while the truth
        # cluster (whose every particle outscores every decoy particle —
        # measured via the /tmp/kidnap_cloud.npz snapshot protocol)
        # holds ~5% and wins the mass race only after ~100 full-field
        # scans at the ~4%/scan mean-aggregation resampling edge.
        # Commit the anchor with 2x mass hysteresis, publish the
        # committed mode's cluster mean, and VETO mass-dominant but
        # evidence-inferior migrations (anchor_score_margin — half the
        # measured 0.038 truth-vs-decoy mean-log gap).
        estimate_mode="anchor", anchor_hysteresis=2.0,
        anchor_score_margin=0.02,
        motion_validity="score", min_injection_prob=0.02,
        alpha_slow=0.05, alpha_fast=0.7,
    )
    staged = make_staged_model(cfg, grid_map, tracking_ess_threshold=0.9)
    state = staged.init(jax.random.PRNGKey(seed + 100))
    t0 = time.perf_counter()
    out = run_staged(staged, state, ranges, np.asarray(bag_a.angles), deltas)
    wall = time.perf_counter() - t0

    est = np.asarray(out.infos.estimate.mean)
    errs = np.hypot(est[:, 0] - gt[:, 0], est[:, 1] - gt[:, 1])
    modes = out.modes
    # escalation latency: first big-program scan at/after the kidnap,
    # counted from a small-program pre-kidnap state.  Only meaningful if
    # the filter actually WAS in the small program when kidnapped — a
    # slow-converging seed still in the BIG program at scan k would
    # otherwise report a spurious instant (0-scan) escalation.
    post = modes[k:]
    if modes[k - 1] != 1:
        esc = None  # no escalation event: still in the big program
    else:
        esc = int(np.argmax(post == 0)) if (post == 0).any() else -1
    # re-localization: first post-kidnap scan whose error stays < 0.5 m
    ok = errs[k:] < 0.5
    stays = np.logical_and.accumulate(ok[::-1])[::-1]
    t_reloc = int(np.argmax(stays)) if stays.any() else -1
    print(json.dumps({
        "n_particles": n,
        "seed": seed,
        "scans": int(len(errs)),
        "kidnap_scan": k,
        "teleport_m": round(jump, 2),
        "pre_kidnap_err_m": round(float(errs[k - 10:k].mean()), 4),
        "pre_kidnap_small_scans": int((modes[:k] == 1).sum()),
        "escalate_latency_scans": esc,
        "relocalize_scans": t_reloc,
        "relocalize_s": round(t_reloc / 5.0, 1) if t_reloc >= 0 else -1,
        "final_err_m": round(float(errs[-1]), 4),
        "tail_mean_err_m": round(float(errs[-10:].mean()), 4),
        "final_mode_small": bool(modes[-1] == 1),
        "switches": int(out.switches),
        "filter_wall_s": round(wall, 2),
    }), flush=True)
    print("err (every 5th):", np.round(errs[::5], 2).tolist(),
          file=sys.stderr)
    print("modes (every 5th):", modes[::5].tolist(), file=sys.stderr)
    # mode-competition diagnostics: why/when the committed anchor loses
    print("anchor_mass (every 5th):",
          np.round(np.asarray(out.infos.anchor_mass)[::5], 3).tolist(),
          file=sys.stderr)
    print("p_random (every 5th):",
          np.round(np.asarray(out.infos.p_random)[::5], 3).tolist(),
          file=sys.stderr)
    print("count (every 5th):",
          np.asarray(out.infos.count)[::5].tolist(), file=sys.stderr)
    print("ess_frac (every 5th):",
          np.round(np.asarray(out.infos.ess)[::5]
                   / np.maximum(np.asarray(out.infos.count)[::5], 1),
                   3).tolist(),
          file=sys.stderr)
    # final-cloud snapshot (downsampled): where does the winning mode sit?
    n_keep = int(np.asarray(out.state.count))
    step_ds = max(n_keep // 20000, 1)
    np.savez(
        "/tmp/kidnap_cloud.npz",
        particles=np.asarray(out.state.particles[:n_keep:step_ds]),
        weights=np.asarray(out.state.weights[:n_keep:step_ds]),
        est=est, gt=gt, modes=modes,
    )
    print("cloud snapshot -> /tmp/kidnap_cloud.npz", file=sys.stderr)

    if len(sys.argv) > 3:
        plot_cycle(sys.argv[3], errs, modes, k, jump, n)


def plot_cycle(path, errs, modes, k, jump, n):
    """Position error vs scan, BIG-program spans shaded, teleport marked."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.arange(len(errs)) / 5.0
    fig, ax = plt.subplots(figsize=(9, 3.2), dpi=120)
    big = modes == 0
    # contiguous BIG spans as shaded regions
    edges = np.flatnonzero(np.diff(np.concatenate([[0], big, [0]])))
    for lo, hi in edges.reshape(-1, 2):
        ax.axvspan(t[lo], t[min(hi, len(t) - 1)], color="#d33",
                   alpha=0.12, lw=0)
    ax.axvline(t[k], color="#d33", ls="--", lw=1,
               label=f"kidnap ({jump:.1f} m teleport)")
    ax.semilogy(t, np.maximum(errs, 1e-3), lw=1.2, color="#247",
                label="position error")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("error (m)")
    label = f"{n // 1000}k" if n < 1_000_000 else f"{n // 1_000_000}M"
    ax.set_title(
        f"{label} staged kidnap cycle — shaded = full-field BIG program"
    )
    ax.legend(loc="upper right", fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path)
    print(f"plot -> {path}", file=sys.stderr)


if __name__ == "__main__":
    main()
