"""Result plotting — parity with plot_rmse_results.py / plot_particle_sweep_results.py.

Parses the same filename conventions the reference's plotters use
(`<test>_<ALGO>_run<i>.txt`, plot_rmse_results.py:77-91;
`<bag>_<ALGO>_<P>p_run<i>.txt`, plot_particle_sweep_results.py:8-27) and
produces per-test error-vs-time plots, trajectory-vs-GT plots, mean+/-std
RMSE bar charts, RMSE-vs-particle-count errorbars, and an HTML report.
Matplotlib is imported lazily so headless/numeric-only installs don't pay
for it.

CLI:
  python -m mcmh_localization.eval.plots rmse   --results-dir results
  python -m mcmh_localization.eval.plots sweep  --results-dir results
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from collections import defaultdict

import numpy as np

from mcmh_localization.config import MODES
from mcmh_localization.eval.evaluator import parse_poses_file, parse_results_file

# one fixed color per algorithm, like plot_rmse_results.py's per-algo palette
ALGO_COLORS = {
    "MCL": "#1f77b4",
    "AMCL": "#ff7f0e",
    "MHMCL": "#2ca02c",
    "MHAMCL": "#d62728",
    "AMHMCL": "#9467bd",
    "AMHAMCL": "#8c564b",
}

_RUN_RE = re.compile(
    r"^(?P<test>.+?)_(?P<algo>" + "|".join(sorted(MODES, key=len, reverse=True)) +
    r")_run(?P<run>\d+)\.txt$"
)
_SWEEP_RE = re.compile(
    r"^(?P<test>.+?)_(?P<algo>" + "|".join(sorted(MODES, key=len, reverse=True)) +
    r")_(?P<particles>\d+)p_run(?P<run>\d+)\.txt$"
)


def collect_runs(results_dir: str):
    """{(test, algo): [(run_idx, path)]} for plain mode-comparison runs."""
    runs = defaultdict(list)
    for fname in sorted(os.listdir(results_dir)):
        if fname.startswith("poses_") or fname == "summary_results.txt":
            continue
        m = _RUN_RE.match(fname)
        if m and not _SWEEP_RE.match(fname):
            runs[(m["test"], m["algo"])].append(
                (int(m["run"]), os.path.join(results_dir, fname))
            )
    return runs


def collect_sweep(results_dir: str):
    """{(test, algo, particles): [paths]} for particle-sweep runs."""
    runs = defaultdict(list)
    for fname in sorted(os.listdir(results_dir)):
        if fname.startswith("poses_") or fname == "summary_results.txt":
            continue
        m = _SWEEP_RE.match(fname)
        if m:
            runs[(m["test"], m["algo"], int(m["particles"]))].append(
                os.path.join(results_dir, fname)
            )
    return runs


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_rmse_report(results_dir: str, out_dir: str | None = None) -> str:
    """Per-test best-run error-vs-time, trajectory-vs-GT, and RMSE bar chart
    + an HTML index (plot_rmse_results.py:139-237,239-306)."""
    plt = _plt()
    out_dir = out_dir or os.path.join(results_dir, "plots")
    os.makedirs(out_dir, exist_ok=True)
    runs = collect_runs(results_dir)
    tests = sorted({t for t, _ in runs})
    html_rows = []
    images = []

    for test in tests:
        # error-vs-time: best (lowest-RMSE) run per algorithm
        fig, ax = plt.subplots(figsize=(8, 4.5))
        best_paths = {}
        for algo in MODES:
            paths = runs.get((test, algo))
            if not paths:
                continue
            parsed = [(parse_results_file(p), p) for _, p in paths]
            (times, errors, rmse), path = min(parsed, key=lambda x: x[0][2])
            best_paths[algo] = path
            ax.plot(times, errors, label=f"{algo} (RMSE {rmse:.3f})",
                    color=ALGO_COLORS[algo], lw=1.2)
        ax.set_xlabel("time [s]")
        ax.set_ylabel("position error [m]")
        ax.set_title(f"{test}: error vs time (best run)")
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
        p1 = os.path.join(out_dir, f"{test}_error_vs_time.png")
        fig.savefig(p1, dpi=110, bbox_inches="tight")
        plt.close(fig)
        images.append(p1)

        # trajectories vs ground truth
        fig, ax = plt.subplots(figsize=(6, 6))
        drew_gt = False
        for algo, path in best_paths.items():
            poses_path = os.path.join(
                os.path.dirname(path), "poses_" + os.path.basename(path)
            )
            if not os.path.exists(poses_path):
                continue
            _, est, gt = parse_poses_file(poses_path)
            if not drew_gt:
                ax.plot(gt[:, 0], gt[:, 1], "k--", lw=2, label="ground truth")
                drew_gt = True
            ax.plot(est[:, 0], est[:, 1], color=ALGO_COLORS[algo], lw=1, label=algo)
        ax.set_aspect("equal")
        ax.set_title(f"{test}: trajectories")
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
        p2 = os.path.join(out_dir, f"{test}_trajectories.png")
        fig.savefig(p2, dpi=110, bbox_inches="tight")
        plt.close(fig)
        images.append(p2)

        # RMSE bar chart mean +/- std over runs
        fig, ax = plt.subplots(figsize=(7, 4))
        labels, means, stds, colors = [], [], [], []
        for algo in MODES:
            paths = runs.get((test, algo))
            if not paths:
                continue
            rmses = [parse_results_file(p)[2] for _, p in paths]
            labels.append(algo)
            means.append(np.mean(rmses))
            stds.append(np.std(rmses))
            colors.append(ALGO_COLORS[algo])
            html_rows.append(
                f"<tr><td>{test}</td><td>{algo}</td>"
                f"<td>{np.mean(rmses):.4f}</td><td>{np.std(rmses):.4f}</td>"
                f"<td>{len(rmses)}</td></tr>"
            )
        ax.bar(labels, means, yerr=stds, color=colors, capsize=4)
        ax.set_ylabel("RMSE [m]")
        ax.set_title(f"{test}: RMSE by algorithm (mean ± std)")
        ax.grid(axis="y", alpha=0.3)
        p3 = os.path.join(out_dir, f"{test}_rmse_bars.png")
        fig.savefig(p3, dpi=110, bbox_inches="tight")
        plt.close(fig)
        images.append(p3)

    # live-run animations (runner --save-frames / FrameRecorder.to_gif):
    # any .gif under results_dir is embedded in the report — the replay
    # equivalent of watching the run in RViz
    gifs = sorted(
        glob.glob(os.path.join(results_dir, "**", "*.gif"), recursive=True)
    )

    html_path = os.path.join(out_dir, "report.html")
    with open(html_path, "w") as f:
        f.write("<html><head><title>MCMH localization results</title></head><body>")
        f.write("<h1>Localization results</h1><table border=1 cellpadding=4>")
        f.write("<tr><th>test</th><th>algorithm</th><th>RMSE mean</th>"
                "<th>RMSE std</th><th>runs</th></tr>")
        f.writelines(html_rows)
        f.write("</table>")
        for img in images:
            f.write(f'<div><img src="{os.path.basename(img)}" width="760"></div>')
        for gif in gifs:
            rel = os.path.relpath(gif, out_dir)
            label = os.path.relpath(gif, results_dir)
            f.write(
                f'<div><h3>live run: {label}</h3>'
                f'<img src="{rel}" width="540"></div>'
            )
        f.write("</body></html>")
    return html_path


def plot_sweep_report(results_dir: str, out_dir: str | None = None) -> str:
    """RMSE vs particle count, mean +/- std errorbars per algorithm
    (plot_particle_sweep_results.py:29-91) + HTML table."""
    plt = _plt()
    out_dir = out_dir or os.path.join(results_dir, "plots")
    os.makedirs(out_dir, exist_ok=True)
    sweep = collect_sweep(results_dir)
    tests = sorted({t for t, _, _ in sweep})
    html_rows = []
    images = []
    for test in tests:
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for algo in MODES:
            pts = sorted(
                (p, [parse_results_file(f)[2] for f in paths])
                for (t, a, p), paths in sweep.items()
                if t == test and a == algo
            )
            if not pts:
                continue
            xs = [p for p, _ in pts]
            means = [np.mean(r) for _, r in pts]
            stds = [np.std(r) for _, r in pts]
            ax.errorbar(xs, means, yerr=stds, label=algo,
                        color=ALGO_COLORS[algo], marker="o", capsize=3)
            for x, mu, sd in zip(xs, means, stds):
                html_rows.append(
                    f"<tr><td>{test}</td><td>{algo}</td><td>{x}</td>"
                    f"<td>{mu:.4f}</td><td>{sd:.4f}</td></tr>"
                )
        ax.set_xscale("log")
        ax.set_xlabel("particle count")
        ax.set_ylabel("RMSE [m]")
        ax.set_title(f"{test}: RMSE vs particle count")
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
        p1 = os.path.join(out_dir, f"{test}_particle_sweep.png")
        fig.savefig(p1, dpi=110, bbox_inches="tight")
        plt.close(fig)
        images.append(p1)

    html_path = os.path.join(out_dir, "sweep_report.html")
    with open(html_path, "w") as f:
        f.write("<html><body><h1>Particle sweep</h1><table border=1 cellpadding=4>")
        f.write("<tr><th>test</th><th>algorithm</th><th>particles</th>"
                "<th>RMSE mean</th><th>RMSE std</th></tr>")
        f.writelines(html_rows)
        f.write("</table>")
        for img in images:
            f.write(f'<div><img src="{os.path.basename(img)}" width="760"></div>')
        f.write("</body></html>")
    return html_path


def main(argv=None):
    p = argparse.ArgumentParser(prog="mcmh-plots")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("rmse", plot_rmse_report), ("sweep", plot_sweep_report)):
        sp = sub.add_parser(name)
        sp.add_argument("--results-dir", default="results")
        sp.add_argument("--out-dir", default=None)
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    out = args.fn(args.results_dir, args.out_dir)
    print(f"report: {out}")


if __name__ == "__main__":
    main()
