"""Chip smoke test: drive the localizer's main paths once on NVIDIA GPUs.

    python chip_smoke.py            # one GPU: every single-card phase
    python chip_smoke.py --mesh4    # four GPUs: the mesh paths only

Every phase runs at the widths its users run — 360-beam scans on the seeded
384x384, 0.05 m house map (maps/house.py), 1,500 to 1M particles — checks
its output, and prints one line.  Paths that replace a former hand-written
kernel are compared with plain float64 NumPy references (tests/
reference_impl.py).  The script runs in one process and exits non-zero,
printing no result, when JAX finds no GPU or any phase fails.  The last
line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class Sizes(NamedTuple):
    """Problem sizes of the phases; the defaults are the real widths."""

    beams: int = 360
    bag_seconds: float = 30.0
    exact_n: tuple = (1_500, 100_000)
    resample_n: int = 1 << 20
    kld_n: int = 100_000
    flagship_n: tuple = (100_000, 1_000_000)
    staged_n: int = 1_000_000
    beam_n: int = 100_000
    online_scans: int = 25
    corr_window: int = 128
    corr_bins: int = 32
    mesh_devices: int = 4
    gspmd_n: int = 100_000
    island_n: int = 1_000_000
    staged_mesh_n: int = 1_000_000


# -- device ----------------------------------------------------------------

def require_gpus(count: int):
    """The first ``count`` GPU devices; exits non-zero without them."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform "
                 f"{devices[0].platform!r}); nothing was run")
    if len(devices) < count:
        sys.exit(f"chip_smoke: {count} GPUs needed, JAX found "
                 f"{len(devices)}")
    return devices[:count]


def result_line(devices) -> str:
    """The final JSON line: platform, kind and count of the devices used."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def _require(ok, message):
    """Fail the phase with ``message`` unless ``ok`` (not an assert: the
    checks must hold under ``python -O`` too)."""
    if not ok:
        raise RuntimeError(message)


def _reference_impl():
    """tests/reference_impl.py, the plain NumPy references, by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "reference_impl", os.path.join(ROOT, "tests", "reference_impl.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# -- shared inputs ---------------------------------------------------------

class Ctx:
    """Inputs shared by the phases: map, simulated bag, beam angles."""

    def __init__(self, sizes: Sizes, seed: int):
        import jax

        from mcmh_localization.maps.house import make_house_map
        from mcmh_localization.sim.simulator import simulate_bag
        from mcmh_localization.sim.trajectory import (
            SCENARIOS,
            fit_trajectory_to_map,
        )

        self.sizes, self.seed = sizes, seed
        self.grid_map = make_house_map(seed)
        gt = fit_trajectory_to_map(
            self.grid_map,
            SCENARIOS["square"](duration=sizes.bag_seconds, rate=5.0),
            min_clearance=0.2,
        )
        self.bag = simulate_bag(
            jax.random.PRNGKey(seed), self.grid_map, gt,
            n_beams=sizes.beams, max_range=5.0, rate=5.0,
            range_noise=0.01, name="square",
        )
        self.angles = np.asarray(self.bag.angles)

    def start_pose(self):
        return tuple(float(v) for v in self.bag.gt[0])


def _circle_inputs(ctx, config):
    """The benchmark's closed tracking circle around world (0, 0):
    (SCAN_LEN, M) scans, (M,) angles and (SCAN_LEN, 3) odometry deltas."""
    import jax.numpy as jnp

    import bench

    angles = jnp.asarray(ctx.angles)
    rot = np.pi / bench.SCAN_LEN
    delta = jnp.asarray([rot, 0.05, rot], jnp.float32)
    scans = bench._tracking_scans(
        ctx.grid_map, config, angles, delta, (0.0, 0.0, 0.3)
    )
    return scans, angles, jnp.tile(delta, (bench.SCAN_LEN, 1))


def _tracking_config(n, **kw):
    from mcmh_localization.config import FilterConfig

    return FilterConfig(
        mode="AMHAMCL", num_particles=n, min_particles=n, max_particles=n,
        initialized=True, initial_pose=(0.0, 0.0, 0.3), **kw,
    )


def _cloud_offset(state) -> float:
    """Distance of the active cloud's mean from the circle's start."""
    n = int(state.count)
    mean = np.asarray(state.particles[:n, :2]).mean(axis=0)
    return float(np.hypot(mean[0], mean[1]))


def _run_circle(ctx, config, memory=False):
    """16 chained steps on the tracking circle; returns (offset, ms, extra)."""
    import jax

    from mcmh_localization.filter.step import make_model

    model = make_model(config, ctx.grid_map)
    state = model.init(jax.random.PRNGKey(ctx.seed))
    scans, angles, deltas = _circle_inputs(ctx, config)
    run = model.run.lower(state, scans, angles, deltas).compile()
    extra = ""
    if memory:
        mem = model.step.lower(state, scans[0], angles, deltas[0]).compile()
        extra = f" | step memory_analysis: {mem.memory_analysis()}"
    state, _ = run(state, scans, angles, deltas)  # settle
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state, _ = run(state, scans, angles, deltas)
    jax.block_until_ready(state)
    ms = (time.perf_counter() - t0) * 1e3 / scans.shape[0]
    return _cloud_offset(state), ms, extra


# -- single-card phases ----------------------------------------------------

def phase_reference_point(ctx):
    """AMHAMCL at the reference's parameters over the square bag."""
    import jax

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.eval.evaluator import evaluate_run
    from mcmh_localization.eval.runner import run_filter_on_bag

    cfg = FilterConfig(initialized=True, initial_pose=ctx.start_pose())
    est, _, wall = run_filter_on_bag(
        ctx.bag, cfg, ctx.grid_map, jax.random.PRNGKey(ctx.seed + 1)
    )
    rmse = evaluate_run(ctx.bag.times, est, ctx.bag.gt).rmse
    _require(rmse <= 0.10, f"tracking RMSE {rmse:.4f} m > 0.10 m")
    return (f"{cfg.num_particles} particles (KLD {cfg.min_particles}-"
            f"{cfg.max_particles}), {len(ctx.bag.times)} scans: RMSE "
            f"{rmse:.4f} m <= 0.10 m, run {wall:.3f} s")


def check_exact_scorer(ctx, n):
    """Exact scorer vs the float64 reference; returns (share, max_dev,
    one_beam).  Endpoint cells may flip where float32 and float64 trig
    differ by an ulp; each flip moves a score by at most one beam's share
    of the log-likelihood range."""
    import jax
    import jax.numpy as jnp

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.models.sensor import likelihood_field_scores
    ref_impl = _reference_impl()

    gm, cfg = ctx.grid_map, FilterConfig()
    t = len(ctx.bag.times) // 2
    ranges = np.asarray(ctx.bag.ranges[t])
    rng = np.random.default_rng(ctx.seed)
    parts = (np.asarray(ctx.bag.gt[t], np.float64)
             + rng.normal(size=(n, 3)) * (0.3, 0.3, 0.2)).astype(np.float32)
    dev = np.asarray(jax.jit(
        lambda p: likelihood_field_scores(
            p, jnp.asarray(ranges), jnp.asarray(ctx.angles), gm, cfg)
    )(jnp.asarray(parts)))
    args = (ranges.astype(np.float64), ctx.angles.astype(np.float64),
            np.asarray(gm.distance, np.float64), float(gm.resolution),
            tuple(map(float, gm.origin)), gm.width, gm.height,
            cfg.sigma_hit, cfg.z_hit, cfg.z_rand, cfg.max_range, cfg.step)
    parts64 = parts.astype(np.float64)
    ref = ref_impl.ref_likelihood_field_scores_np(parts64, *args)
    k = min(n, 200)  # tie the array reference to the loop form
    loop = ref_impl.ref_likelihood_field_scores(parts64[:k], *args)
    _require(np.abs(loop - ref[:k]).max() < 1e-9,
             "array reference != loop reference")
    n_valid = int(np.sum(np.isfinite(ranges) & (ranges < cfg.max_range)))
    floor, top = math.log(1e-6), math.log(
        cfg.z_hit / math.sqrt(2 * math.pi * cfg.sigma_hit ** 2)
        + cfg.z_rand / cfg.max_range)
    one_beam = (top - floor) / max(n_valid, 1)
    dev_abs = np.abs(dev - ref)
    share = float(np.mean(dev_abs > 1e-4))
    return share, float(dev_abs.max()), one_beam


def check_systematic(ctx, n):
    """Systematic resampling indices vs float64 searchsorted.  Returns
    (share of differing slots, largest slot shift of a segment boundary).
    A float32 CDF resolves 2^-24 of the total weight: at 1M slots a
    boundary sits within ~0.06 slot of its float64 value, so a boundary
    may move by one slot, never more."""
    import jax
    import jax.numpy as jnp

    from mcmh_localization.ops.resampling import (
        systematic_resample_indices,
    )

    rng = np.random.default_rng(ctx.seed)
    w = rng.exponential(size=n).astype(np.float32)
    w /= w.sum()
    key = jax.random.PRNGKey(ctx.seed + 7)
    idx = np.asarray(jax.jit(
        lambda k, w: systematic_resample_indices(k, w, n)
    )(key, jnp.asarray(w)))
    r = float(jax.random.uniform(key, (), minval=0.0, maxval=1.0))
    ref = _reference_impl().ref_systematic_indices(w, n, r)
    bounds = np.arange(n)
    shift = np.abs(np.searchsorted(idx, bounds, side="right")
                   - np.searchsorted(ref, bounds, side="right")).max()
    return float(np.mean(idx != ref)), int(shift)


def check_kld(ctx, n):
    """KLD stop counts vs the python-set walk; every count must match."""
    import jax
    import jax.numpy as jnp

    from mcmh_localization.ops.resampling import kld_resample

    rng = np.random.default_rng(ctx.seed)
    centers = rng.normal(scale=3.0, size=(3, 3))
    parts = (centers[rng.integers(0, 3, n)]
             + rng.normal(scale=[0.4, 0.4, 0.2], size=(n, 3)))
    parts = jnp.asarray(parts.astype(np.float32))
    weights = jnp.full(n, 1.0 / n, jnp.float32)
    counts = []
    for eps in (0.05, 0.02, 0.01):
        samples, kept = jax.jit(
            lambda k, p, w, eps=eps: kld_resample(
                k, p, w, max_samples=n, min_particles=n // 100,
                bin_size_xy=0.2, bin_size_theta=0.1745, epsilon=eps, z=2.0,
            )
        )(jax.random.PRNGKey(ctx.seed + 11), parts, weights)
        gold = _reference_impl().ref_kld_stop_count(
            np.asarray(samples), 0.2, 0.1745, eps, 2.0, n, n // 100)
        _require(int(kept) == gold,
                 f"eps {eps}: device {int(kept)} != python-set walk {gold}")
        counts.append(gold)
    return counts


def check_dft_field(ctx):
    """The ``dft`` correlation-field builder vs the ``xla`` one at the
    flagship window; returns (max error / max |field|, max |field|)."""
    import jax
    import jax.numpy as jnp

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.models.corr_field import (
        _bin_offsets,
        _build_field_dft,
        _build_field_xla,
    )
    from mcmh_localization.models.sensor import log_likelihood_field

    s = ctx.sizes
    gm, cfg = ctx.grid_map, FilterConfig()
    lf = log_likelihood_field(gm, cfg)
    ranges = jnp.asarray(ctx.bag.ranges[0])
    angles = jnp.asarray(ctx.angles)
    valid = jnp.isfinite(ranges) & (ranges < cfg.max_range)
    safe = jnp.where(valid, ranges, 0.0)
    u, v = safe * jnp.cos(angles), safe * jnp.sin(angles)
    res = float(gm.resolution)
    pad = int(-(-cfg.max_range // res)) + 2
    win = s.corr_window
    side = win + 2 * pad
    o = (gm.height - win) // 2
    region = jnp.pad(lf, pad)[o:o + side, o:o + side]
    ox, oy = _bin_offsets(u, v, valid, 1.0 / res, 120, pad, side,
                          bin_start=40, nbins=s.corr_bins)
    dft = jax.jit(lambda r: _build_field_dft(r, ox, oy, valid, win, win))
    xla = jax.jit(lambda r: _build_field_xla(
        jnp.pad(r, ((0, win), (0, 0))), ox, oy, win, win))
    a, b = np.asarray(dft(region)), np.asarray(xla(region))
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale, scale


def phase_vs_reference(ctx):
    """Each path that replaces a former kernel vs a plain reference."""
    lines = []
    for n in ctx.sizes.exact_n:
        share, worst, beam = check_exact_scorer(ctx, n)
        _require(worst <= beam, f"exact n={n}: max dev {worst} > {beam}")
        _require(share <= 0.05, f"exact n={n}: {share:.2%} off by > 1e-4")
        lines.append(
            f"exact scorer {n} x {ctx.sizes.beams}: {share:.4%} of particles "
            f"off by > 1e-4, max dev {worst:.3e} <= one beam {beam:.3e}")
    share, shift = check_systematic(ctx, ctx.sizes.resample_n)
    _require(shift <= 1, f"systematic: a boundary moved {shift} slots")
    lines.append(
        f"systematic {ctx.sizes.resample_n}: {share:.4%} of slots differ, "
        f"largest boundary shift {shift} slot (float32 CDF limit: 1)")
    counts = check_kld(ctx, ctx.sizes.kld_n)
    lines.append(f"KLD stop counts {counts} == python-set walk")
    rel, scale = check_dft_field(ctx)
    # a float32 DFT over S ~ 384 points carries ~1e-5 of the field's
    # magnitude; 1e-4 of max |F| is 1e-3 log units per beam after the
    # mean over ~360 beams, far below the field's own 3-degree binning
    _require(rel <= 1e-4, f"dft vs xla field: relative error {rel:.2e}")
    lines.append(
        f"dft vs xla field ({ctx.sizes.corr_bins} bins, "
        f"{ctx.sizes.corr_window}^2 window): max error {rel:.2e} of "
        f"max |F| {scale:.1f} (HIGHEST-precision matmuls; limit 1e-4)")
    return "\n    ".join([""] + lines)


def phase_flagship(ctx):
    """The benchmark's flagship corr configuration, 16 chained steps."""
    import bench

    out = []
    for n in ctx.sizes.flagship_n:
        kw = dict(bench.FLAGSHIP)
        if n >= 1_000_000:
            kw["coarse_gate_escapees"] = 0
        off, ms, extra = _run_circle(
            ctx, _tracking_config(n, **kw),
            memory=n == max(ctx.sizes.flagship_n))
        _require(off <= 0.2, f"{n}: cloud mean {off:.3f} m from the start")
        out.append(f"{n}: cloud {off:.3f} m from start (<= 0.2), "
                   f"{ms:.3f} ms/step chained{extra}")
    return "; ".join(out)


def phase_staged_1m(ctx):
    """make_staged_model + run_staged settles into the tracking program."""
    import jax

    import bench
    from mcmh_localization.config import FilterConfig
    from mcmh_localization.filter.staged import (
        make_staged_model,
        run_staged,
    )

    n = ctx.sizes.staged_n
    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=n, min_particles=n // 10,
        max_particles=n, initialized=True, initial_pose=(0.0, 0.0, 0.3),
        kld_eval_window=0, coarse_gate_escapees=0, **bench.FLAGSHIP,
    )
    staged = make_staged_model(cfg, ctx.grid_map, tracking_ess_threshold=0.9)
    scans, angles, deltas = _circle_inputs(ctx, cfg)
    out = run_staged(
        staged, staged.big.init(jax.random.PRNGKey(ctx.seed)),
        np.tile(np.asarray(scans), (4, 1)), angles,
        np.tile(np.asarray(deltas), (4, 1)), chunk=bench.SCAN_LEN,
    )
    _require(out.modes[-1] == 1,
             f"never settled: modes {out.modes.tolist()}")
    return (f"capacity {n} -> {staged.small_config.max_particles}, "
            f"{out.switches} switch(es), final count "
            f"{int(out.state.count)}, in the tracking program")


def phase_beam_field(ctx):
    """The beam model's windowed score field at 100k x 360."""
    import bench

    off, ms, _ = _run_circle(
        ctx, _tracking_config(ctx.sizes.beam_n, **bench.BEAM_KW))
    _require(off <= 0.2, f"cloud mean {off:.3f} m from the start")
    return f"cloud {off:.3f} m from start (<= 0.2), {ms:.3f} ms/step chained"


def phase_online(ctx):
    """OnlineLocalizer(staged=True): warmup, then scan-by-scan tracking."""
    from mcmh_localization.config import FilterConfig
    from mcmh_localization.filter.online import OnlineLocalizer

    cfg = FilterConfig(initialized=True, initial_pose=ctx.start_pose())
    loc = OnlineLocalizer(cfg, ctx.grid_map, seed=ctx.seed, staged=True)
    bag = ctx.bag
    loc.warmup(np.asarray(bag.ranges[0]), angles=ctx.angles)
    lat = []
    est = None
    t_last = min(ctx.sizes.online_scans, len(bag.times)) - 1
    for t in range(t_last + 1):
        loc.on_odom(*np.asarray(bag.odom[t]))
        t0 = time.perf_counter()
        est = loc.on_scan(np.asarray(bag.ranges[t]), angles=ctx.angles)
        lat.append((time.perf_counter() - t0) * 1e3)
    pose = np.asarray(est["pose3"])
    _require(np.isfinite(pose).all(), f"estimate {pose}")
    err = float(np.hypot(*(pose[:2] - np.asarray(bag.gt[t_last][:2]))))
    _require(err <= 0.10, f"estimate {err:.3f} m from the truth")
    p50, p99 = np.percentile(lat, [50, 99])
    print(f"  online scan-to-estimate latency: p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms over {len(lat)} scans", flush=True)
    return (f"{len(lat)} scans, final estimate {err:.4f} m from truth "
            f"(<= 0.10), tracking program: {loc._in_small}")


def phase_runner_cli(ctx):
    """``eval.runner single`` through its parser, in this process."""
    from mcmh_localization.eval.runner import main

    res = main([
        "single", "--mode", "AMHAMCL", "--scenario", "square",
        "--initialized", "--seed", str(ctx.seed),
        "--beams", str(ctx.sizes.beams),
        "--duration", str(ctx.sizes.bag_seconds),
        "--results-dir", os.path.join(ROOT, "results", "chip_smoke"),
        "--result-name", "runner_cli",
    ])
    _require(np.isfinite(res.rmse) and res.rmse <= 0.10,
             f"RMSE {res.rmse}")
    return f"RMSE {res.rmse:.4f} m (<= 0.10)"


SINGLE = (
    ("reference_point", phase_reference_point),
    ("vs_reference", phase_vs_reference),
    ("flagship", phase_flagship),
    ("staged_1m", phase_staged_1m),
    ("beam_field", phase_beam_field),
    ("online", phase_online),
    ("runner_cli", phase_runner_cli),
)


# -- four-card phases ------------------------------------------------------

def _mesh(ctx):
    import jax

    from mcmh_localization.parallel.sharding import make_mesh

    return make_mesh(jax.devices()[:ctx.sizes.mesh_devices])


def phase_gspmd(ctx):
    """One GSPMD step (make_sharded_model) vs make_model on one card, from
    the same state and key: posterior weights and estimates agree up to
    float32 reduction order (relative 1e-4)."""
    import jax

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.filter.step import make_model
    from mcmh_localization.parallel.sharding import (
        make_sharded_model,
        shard_state,
    )
    from mcmh_localization.sim.simulator import odometry_deltas

    mesh = _mesh(ctx)
    # MCL resampling leaves the posterior weights in the state
    cfg = FilterConfig(mode="MCL", num_particles=ctx.sizes.gspmd_n,
                       initialized=True, initial_pose=ctx.start_pose())
    one = make_model(cfg, ctx.grid_map)
    sharded = make_sharded_model(cfg, ctx.grid_map, mesh)
    state = one.init(jax.random.PRNGKey(ctx.seed))
    delta = odometry_deltas(ctx.bag.odom)[1]
    args = (np.asarray(ctx.bag.ranges[1]), ctx.angles, delta)
    s1, i1 = one.step(jax.device_put(state, jax.devices()[0]), *args)
    s2, i2 = sharded.step(shard_state(state, mesh), *args)
    w1, w2 = np.asarray(s1.weights), np.asarray(s2.weights)
    rel_w = float(np.abs(w1 - w2).max() / w1.max())
    d_est = float(np.abs(np.asarray(i1.estimate.mean)
                         - np.asarray(i2.estimate.mean)).max())
    _require(rel_w <= 1e-4, f"weights differ by {rel_w:.2e} of the max")
    _require(d_est <= 1e-4, f"estimates differ by {d_est:.2e}")
    shards = sorted((s.device.id, s.data.shape)
                    for s in s2.particles.addressable_shards)
    return (f"{ctx.sizes.gspmd_n} particles: weights within {rel_w:.2e} "
            f"of max, estimate within {d_est:.2e}; shards {shards}")


def phase_islands(ctx):
    """make_dist_model: one 1M island per card on the flagship corr
    config, tracking the square bag."""
    import jax

    import bench
    from mcmh_localization.config import FilterConfig
    from mcmh_localization.eval.evaluator import evaluate_run
    from mcmh_localization.parallel.distributed import make_dist_model
    from mcmh_localization.sim.simulator import odometry_deltas

    n = ctx.sizes.island_n * ctx.sizes.mesh_devices
    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=n, min_particles=n, max_particles=n,
        initialized=True, initial_pose=ctx.start_pose(),
        coarse_gate_escapees=0, **bench.FLAGSHIP,
    )
    model = make_dist_model(cfg, ctx.grid_map, _mesh(ctx))
    state = model.init(jax.random.PRNGKey(ctx.seed))
    shards = sorted((s.device.id, s.data.shape)
                    for s in state.particles.addressable_shards)
    bag = ctx.bag
    state, infos = model.run(state, np.asarray(bag.ranges), ctx.angles,
                             odometry_deltas(bag.odom))
    est = np.asarray(infos.estimate.mean)
    rmse = evaluate_run(bag.times, est, bag.gt).rmse
    _require(rmse <= 0.10, f"RMSE {rmse:.4f} m > 0.10 m")
    return f"{n} particles, RMSE {rmse:.4f} m (<= 0.10); shards {shards}"


def phase_staged_mesh(ctx):
    """make_staged_dist_model: big -> shrink -> small -> grow -> big."""
    import jax

    import bench
    from mcmh_localization.config import FilterConfig
    from mcmh_localization.filter.staged import make_staged_dist_model
    from mcmh_localization.sim.simulator import odometry_deltas

    n = ctx.sizes.staged_mesh_n
    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=n, min_particles=n // 10,
        max_particles=n, initialized=True, initial_pose=ctx.start_pose(),
        **bench.FLAGSHIP,
    )
    staged = make_staged_dist_model(cfg, ctx.grid_map, _mesh(ctx))
    delta = odometry_deltas(ctx.bag.odom)[1]
    args = (np.asarray(ctx.bag.ranges[1]), ctx.angles, delta)
    st = staged.init(jax.random.PRNGKey(ctx.seed))
    st, _ = staged.big.step(st, *args)
    st = staged.shrink(st)
    small = st.particles.shape[0]
    _require(small == staged.small_config.max_particles,
             f"shrink gave {small} particles")
    st, _ = staged.small.step(st, *args)
    st = staged.grow(st)
    _require(st.particles.shape[0] == staged.config.max_particles,
             f"grow gave {st.particles.shape[0]} particles")
    st, info = staged.big.step(st, *args)
    mean = np.asarray(info.estimate.mean)
    _require(np.isfinite(mean).all(), f"estimate {mean}")
    err = float(np.hypot(*(mean[:2] - np.asarray(ctx.bag.gt[1][:2]))))
    return (f"{n} -> {small} -> {st.particles.shape[0]} particles, "
            f"estimate {err:.3f} m from truth")


MESH = (
    ("gspmd", phase_gspmd),
    ("islands", phase_islands),
    ("staged_mesh", phase_staged_mesh),
)


# -- entry point -----------------------------------------------------------

def run_phases(phases, ctx) -> list:
    """Run every phase, printing one line each; returns the failed names."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            detail = fn(ctx)
        except Exception:
            traceback.print_exc()
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
                  flush=True)
            failed.append(name)
            continue
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: {detail}",
              flush=True)
    return failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh4", action="store_true",
                   help="run only the four-GPU mesh paths")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    sizes = Sizes()
    devices = require_gpus(sizes.mesh_devices if args.mesh4 else 1)
    import jax

    from mcmh_localization.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    for line in _card_lines():
        print(f"nvidia-smi: {line}")
    print(f"jax {jax.__version__}, {devices[0].device_kind} "
          f"x{len(devices)}", flush=True)
    t0 = time.perf_counter()
    ctx = Ctx(sizes, args.seed)
    print(f"[setup] house map + {len(ctx.bag.times)}-scan square bag in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    failed = run_phases(MESH if args.mesh4 else SINGLE, ctx)
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
