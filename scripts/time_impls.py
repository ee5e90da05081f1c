"""Time each size-dependent implementation choice on the GPU, and trace the
flagship step.

    python scripts/time_impls.py [--out results/time_impls/time_impls.json]

Measures, on the seeded 384x384 house map with 360-beam scans:

* the likelihood scorer ``auto`` resolves to: exact vs correlation field
  (windowed and full map), whole filter steps at 1,500 / 100k / 1M;
* the beam scorer: dense / table / field, whole steps at 100k;
* the correlation-field builders (xla / dft) at the flagship window and
  on the full map, and the coarse fallback's builders;
* the coarse-fallback lookup form: select vs a lax.cond that skips the
  coarse gather when nothing escaped;
* the systematic-resampling rank: scatter + cummax (the code's) vs
  searchsorted, 1M;
* KLD bin counting: sort vs hash, 1M;
* whether the exact scorer's (N, M) endpoint arrays reach device memory;
* a profiler trace of 16 chained steps per traced configuration: device
  busy share and the largest device operations.

Times are medians of repeated calls ended by ``block_until_ready``
(whole steps: the chained protocol of bench.py).  Prints one line per
measurement and writes them all to ``--out``.  Refuses to run on a CPU.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT_DIR = os.path.join(ROOT, "results", "time_impls")  # HLO, traces, JSON

RESULTS = {}
STEP_N = (1_500, 100_000, 1_000_000)   # whole-step particle counts
SCORE_N = 100_000                       # scorer-level particle count
LOOKUP_N = (200_000, 2_000_000)         # lookups (both MH sets)
RESAMPLE_N = 1 << 20
TRACE_N = (100_000, 1_000_000)


def _record(key, value, unit="ms"):
    RESULTS[key] = value
    print(f"{key}: {value:.4f} {unit}" if isinstance(value, float)
          else f"{key}: {value}", flush=True)


def _time(fn, *args, min_s=0.5, max_reps=50):
    """Median ms of ``fn(*args)`` after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    t_end = time.perf_counter() + min_s
    while len(times) < 3 or (time.perf_counter() < t_end
                             and len(times) < max_reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def step_times(grid_map):
    import bench

    bench.WARMUP, bench.ITERS = 1, 3
    corr_win = dict(bench.FLAGSHIP)
    common = dict(motion_validity="score", min_injection_prob=0.02)
    for n in STEP_N:
        gate = dict(coarse_gate_escapees=0) if n >= 1_000_000 else {}
        _record(f"step_exact_{n}", bench.time_fixed_count_step(
            grid_map, n, likelihood_impl="jnp", **common))
        _record(f"step_corr_window_{n}", bench.time_fixed_count_step(
            grid_map, n, **corr_win, **gate))
        _record(f"step_corr_fullmap_{n}", bench.time_fixed_count_step(
            grid_map, n, likelihood_impl="corr", **common))
    for impl in ("field", "table", "dense"):
        kw = dict(bench.BEAM_KW, beam_impl=impl)
        _record(f"step_beam_{impl}_{SCORE_N}",
                bench.time_fixed_count_step(grid_map, SCORE_N, **kw))


def _scan_inputs(grid_map, n, seed=0):
    import jax.numpy as jnp

    from mcmh_localization.models.sensor import raycast

    rng = np.random.default_rng(seed)
    angles = jnp.linspace(-np.pi, np.pi, 360, dtype=jnp.float32)
    ranges = raycast(jnp.asarray([0.0, 0.0]), 0.3 + angles, grid_map, 5.0,
                     hit_unknown=True)
    parts = jnp.asarray((np.array([0.0, 0.0, 0.3])
                         + rng.normal(size=(n, 3)) * (0.1, 0.1, 0.05))
                        .astype(np.float32))
    return parts, ranges, angles


def builder_times(grid_map):
    import jax
    import jax.numpy as jnp

    from mcmh_localization import dispatch
    from mcmh_localization.config import FilterConfig
    from mcmh_localization.models import corr_field as cf
    from mcmh_localization.models.sensor import log_likelihood_field

    parts, ranges, angles = _scan_inputs(grid_map, SCORE_N)
    lf = log_likelihood_field(grid_map, FilterConfig())
    cases = {
        "window": (FilterConfig(likelihood_impl="corr", corr_window_cells=128,
                                corr_theta_window_bins=32), (64, 64, 40)),
        "fullmap": (FilterConfig(likelihood_impl="corr"), None),
    }
    for name, (cfg, wo) in cases.items():
        for impl in ("xla", "dft"):
            fn = jax.jit(lambda p, r, a, cfg=cfg, impl=impl, wo=wo:
                         cf.correlation_field_scores(
                             p, r, a, grid_map, cfg, log_field=lf,
                             n_theta=120, field_impl=impl, window_origin=wo))
            _record(f"corr_score_{name}_{impl}_{SCORE_N}",
                    _time(fn, parts, ranges, angles))
    cfg = FilterConfig(likelihood_impl="corr", corr_window_cells=128)
    valid = jnp.isfinite(ranges) & (ranges < 5.0)
    safe = jnp.where(valid, ranges, 0.0)
    u, v = safe * jnp.cos(angles), safe * jnp.sin(angles)
    orig = dispatch.corr_field_builder
    try:
        for impl in ("xla", "dft"):
            dispatch.corr_field_builder = lambda config, impl=impl: impl
            fn = jax.jit(lambda u, v, valid: cf._coarse_field(
                u, v, valid, lf, grid_map, cfg, float(grid_map.resolution)))
            _record(f"coarse_build_{impl}", _time(fn, u, v, valid))
    finally:
        dispatch.corr_field_builder = orig


def lookup_form_times():
    """The fine/coarse lookup: select (both gathers, one where) vs a
    lax.cond that gathers the coarse field only when a particle escaped."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    field = jnp.asarray(rng.normal(size=(32, 128, 128)).astype(np.float32))
    cfield = jnp.asarray(rng.normal(size=(36, 96, 96)).astype(np.float32))
    for n in LOOKUP_N:
        k = jnp.asarray(rng.integers(0, 32, n), jnp.int32)
        y = jnp.asarray(rng.integers(0, 128, n), jnp.int32)
        x = jnp.asarray(rng.integers(0, 128, n), jnp.int32)
        ck = jnp.asarray(rng.integers(0, 36, n), jnp.int32)
        cy = jnp.asarray(rng.integers(0, 96, n), jnp.int32)
        cx = jnp.asarray(rng.integers(0, 96, n), jnp.int32)
        covered = jnp.ones(n, bool)  # steady tracking: nothing escaped

        @jax.jit
        def select(covered, k, y, x, ck, cy, cx):
            return jnp.where(covered, field[k, y, x], cfield[ck, cy, cx])

        @jax.jit
        def cond(covered, k, y, x, ck, cy, cx):
            fine = field[k, y, x]
            return jax.lax.cond(
                jnp.any(~covered),
                lambda: jnp.where(covered, fine, cfield[ck, cy, cx]),
                lambda: fine,
            )

        args = (covered, k, y, x, ck, cy, cx)
        _record(f"lookup_select_{n}", _time(select, *args))
        _record(f"lookup_cond_{n}", _time(cond, *args))


def resample_times():
    import jax
    import jax.numpy as jnp

    from mcmh_localization.ops import resampling as rs

    n = RESAMPLE_N
    rng = np.random.default_rng(2)
    w = rng.exponential(size=n).astype(np.float32)
    w = jnp.asarray(w / w.sum())
    key = jax.random.PRNGKey(0)
    bound = jax.jit(lambda k, w: rs._segment_bounds(k, w, n))(key, w)
    def searchsorted_rank(b):
        idx = jnp.searchsorted(b, jnp.arange(n, dtype=b.dtype), side="right")
        return jnp.clip(idx, 0, b.shape[0] - 1).astype(jnp.int32)

    scatter = jax.jit(lambda b: rs.rank_in_sorted(b, n))
    search = jax.jit(searchsorted_rank)
    _record(f"rank_scatter_{n}", _time(scatter, bound))
    _record(f"rank_searchsorted_{n}", _time(search, bound))
    _record("rank_impls_agree", bool(np.array_equal(
        np.asarray(scatter(bound)), np.asarray(search(bound)))), unit="")
    parts = jnp.asarray(rng.normal(scale=[0.05, 0.05, 0.02], size=(n, 3))
                        .astype(np.float32))
    for occ in ("sort", "hash"):
        fn = jax.jit(lambda k, p, w, occ=occ: rs.kld_resample(
            k, p, w, max_samples=n, min_particles=n // 10, bin_size_xy=0.2,
            bin_size_theta=0.1745, epsilon=0.03, z=2.0,
            first_occurrence=occ))
        _record(f"kld_{occ}_{n}", _time(fn, key, parts, w))


def exact_scorer_memory(grid_map):
    """Does the exact scorer at the largest step size x 360 beams write
    its (N, M) arrays out?"""
    import jax

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.models.sensor import likelihood_field_scores

    n = STEP_N[-1]
    parts, ranges, angles = _scan_inputs(grid_map, n)
    fn = jax.jit(lambda p, r, a: likelihood_field_scores(
        p, r, a, grid_map, FilterConfig()))
    comp = fn.lower(parts, ranges, angles).compile()
    mem = comp.memory_analysis()
    hlo = comp.as_text()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"exact_scorer_{n}.hlo"),
              "w") as f:
        f.write(hlo)
    _record(f"exact_{n}_temp_bytes", int(mem.temp_size_in_bytes), unit="B")
    _record(f"exact_{n}_nm_array_bytes", n * 360 * 4, unit="B")
    _record(f"exact_{n}_fusions", hlo.count(" fusion("), unit="")
    _record(f"exact_scorer_{n}", _time(fn, parts, ranges, angles))


def _trace_summary(path, top=12):
    """Device busy share over the trace window and the largest device
    operations by summed duration.  Kernel events live on the device
    plane's stream lines; derived lines (modules, steps) are skipped."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    spans, per_op, lines_seen = [], collections.Counter(), []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        lines_seen += [line.name for line in lines]
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_op[ev.name] += ev.duration_ns
    if not spans:
        return {"busy_share": None, "lines": lines_seen, "top": []}
    spans.sort()
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    total = sum(per_op.values())
    return {
        "busy_share": busy / window,
        "window_ms": window / 1e6,
        "device_ms": total / 1e6,
        "lines": lines_seen,
        "top": [(name, ns / 1e6, ns / total) for name, ns in
                per_op.most_common(top)],
    }


def traces(grid_map):
    import jax

    import bench
    from mcmh_localization.config import FilterConfig
    from mcmh_localization.filter.step import (
        _correct,
        _predict,
        _sensor_table,
    )
    from __graft_entry__ import _example_inputs

    small, big = TRACE_N
    cases = {
        f"flagship_{small}": (small, dict(bench.FLAGSHIP)),
        f"flagship_{big}": (big, dict(bench.FLAGSHIP,
                                      coarse_gate_escapees=0)),
        f"exact_{big}": (big, dict(likelihood_impl="jnp",
                                   motion_validity="score",
                                   min_injection_prob=0.02)),
    }
    out_dir = os.path.join(OUT_DIR, "traces")
    for name, (n, kw) in cases.items():
        cfg = FilterConfig(mode="AMHAMCL", num_particles=n, min_particles=n,
                           max_particles=n, initialized=True,
                           initial_pose=(0.0, 0.0, 0.3), **kw)
        table = _sensor_table(grid_map, cfg)
        state, _, angles, _ = _example_inputs(grid_map, cfg, 360)
        rot = np.pi / bench.SCAN_LEN
        delta = jax.numpy.asarray([rot, 0.05, rot], jax.numpy.float32)
        scans = bench._tracking_scans(grid_map, cfg, angles, delta,
                                      (0.0, 0.0, 0.3))

        @jax.jit
        def run(state):
            def body(s, r):
                s = _predict(s, delta, grid_map, cfg)
                return _correct(s, r, angles, grid_map, table, cfg)[0], None

            return jax.lax.scan(body, state, scans)[0]

        state = jax.block_until_ready(run(run(state)))
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        jax.profiler.start_trace(d)
        state = jax.block_until_ready(run(state))
        jax.profiler.stop_trace()
        pb = glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)
        summary = _trace_summary(pb[0])
        RESULTS[f"trace_{name}"] = summary
        if summary["busy_share"] is None:
            print(f"trace {name}: no device events; lines "
                  f"{summary['lines']}", flush=True)
            continue
        print(f"trace {name}: busy share {summary['busy_share']:.3f} over "
              f"{summary['window_ms']:.3f} ms ({bench.SCAN_LEN} steps), "
              f"device {summary['device_ms']:.3f} ms; lines "
              f"{summary['lines']}", flush=True)
        for op, ms, share in summary["top"]:
            print(f"    {ms:9.3f} ms {share:6.1%}  {op}", flush=True)
        for f in pb:  # keep the summary, not the raw trace
            os.remove(f)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(OUT_DIR, "time_impls.json"))
    p.add_argument("--only", default="",
                   help="comma list of: steps,builders,lookup,resample,"
                        "exact,traces")
    args = p.parse_args()

    import jax

    from mcmh_localization.maps.house import make_house_map
    from mcmh_localization.utils.compile_cache import (
        enable_compile_cache,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"time_impls: no GPU found (JAX platform {dev.platform!r})")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    RESULTS["card"] = card
    print(f"card: {card}; jax {jax.__version__} {dev.device_kind}",
          flush=True)
    grid_map = make_house_map(0)
    parts = {
        "steps": lambda: step_times(grid_map),
        "builders": lambda: builder_times(grid_map),
        "lookup": lookup_form_times,
        "resample": resample_times,
        "exact": lambda: exact_scorer_memory(grid_map),
        "traces": lambda: traces(grid_map),
    }
    only = [s for s in args.only.split(",") if s] or list(parts)
    for name in only:
        t0 = time.perf_counter()
        parts[name]()
        print(f"[{name}] {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)


if __name__ == "__main__":
    main()
