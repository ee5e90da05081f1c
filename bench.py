"""Headline benchmark: full flagship filter step throughput on one GPU.

Measures steady-state latency of the complete AMHAMCL scan update —
odometry proposal + double likelihood-field scoring + asymmetric MH +
augmented/KLD resampling — at several operating points on the seeded
384x384 house map (maps/house.py; BASELINE.json: "particle-updates/sec
at 100k particles; ms/scan").  The flagship config is the windowed +
theta-windowed correlation field with the coarse recovery fallback (the
shipped tracking configuration).

Prints one JSON line per metric; the FIRST line is the headline — the
RECOMMENDED configuration (1M-capacity KLD through the staged runner,
ESS-gated tracking program).  Refuses to run without a GPU.

    python bench.py
"""

from __future__ import annotations

import json
import time

import numpy as np

N_BEAMS = 360
WARMUP = 2
ITERS = 6
SCAN_LEN = 16  # chained steps per dispatch

# the shipped tracking configuration: windowed + theta-windowed correlation
# field, score-based motion validity (no per-proposal map lookups) and
# injection gating; tracking parity with reference semantics is asserted
# in tests/test_motion_validity.py
FLAGSHIP = dict(
    corr_window_cells=128,
    corr_theta_window_bins=32,
    likelihood_impl="corr",
    motion_validity="score",
    min_injection_prob=0.02,
)

# BASELINE.json config #3: the ray-cast beam model through the windowed
# per-scan score field (models/range_table.py::beam_field_scores): a
# 96-bin range table (3.75 deg ray headings), a 64-cell (3.2 m) window,
# a 24-bin theta window (+-45 deg: the circle trajectory turns 22.5
# deg/scan) and 24 coarse bins (96 % 24 == 0).  All 360 beams are scored.
BEAM_KW = dict(
    sensor_model="beam", beam_impl="field",
    beam_table_n_theta=96,
    corr_window_cells=64, corr_theta_window_bins=24,
    corr_coarse_n_theta=24,
    motion_validity="score", min_injection_prob=0.02,
)


def _tracking_scans(grid_map, config, angles, delta, initial_pose):
    """(SCAN_LEN, M) scans raycast along the SCAN_LEN-periodic trajectory
    the fixed odometry delta traces (a closed circle when rot1 + rot2 =
    2*pi / SCAN_LEN).  Feeding per-pose scans makes the bench a REAL
    steady-state tracking workload: the fit stays good and augmented-MCL
    injection stays idle, as it does on a converged live filter.  (A fixed
    scan against an integrating pose degrades artificially and fires the
    injection machinery every step — that regime is what the kidnap tests
    cover, not what a steady-state throughput number should measure.)"""
    import jax
    import jax.numpy as jnp

    from mcmh_localization.models.sensor import raycast

    r1, tr, r2 = (float(delta[0]), float(delta[1]), float(delta[2]))
    poses = []
    x, y, th = initial_pose
    for _ in range(SCAN_LEN):
        poses.append((x, y, th))
        th = th + r1
        x = x + tr * np.cos(th)
        y = y + tr * np.sin(th)
        th = th + r2
    scans = [
        raycast(jnp.asarray([px, py]), pth + angles, grid_map,
                config.max_range, hit_unknown=True)
        for (px, py, pth) in poses
    ]
    return jax.numpy.stack(scans)


def _time_step(step, state, ranges_seq, angles, delta):
    """Steady-state ms/scan.  Each dispatch runs SCAN_LEN chained steps
    under lax.scan.  The trajectory is SCAN_LEN-periodic, so every
    dispatch replays the same per-pose scan sequence and the filter
    tracks indefinitely.  Successive dispatches chain through `state`,
    serializing on device; sync is a scalar value fetch."""
    import jax

    @jax.jit
    def run_block(state):
        def body(s, ranges):
            s, _info = step(s, ranges, angles, delta)
            return s, None

        return jax.lax.scan(body, state, ranges_seq)[0]

    for _ in range(WARMUP):
        state = run_block(state)
    float(state.w_slow)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state = run_block(state)
    float(state.w_slow)
    ms = (time.perf_counter() - t0) / (ITERS * SCAN_LEN) * 1e3
    # tracking-health diagnostic (stderr; the driver parses stdout JSON):
    # the circle stays within ~0.2 m of the start pose, so a diverged or
    # injection-storming run is visible instead of silently timed
    import numpy as _np
    import sys as _sys

    mean_xy = _np.asarray(jax.numpy.mean(state.particles[:, :2], axis=0))
    print(
        f"[bench] cloud mean after timing: ({mean_xy[0]:+.3f}, "
        f"{mean_xy[1]:+.3f}) m (start 0,0)", file=_sys.stderr,
    )
    return ms


def time_fixed_count_step(grid_map, n_particles, **config_kw):
    """ms/scan for one jitted predict+correct step at a FIXED particle
    count under the chained-timing protocol (_tracking_scans +
    _time_step), so sweeps share one timing protocol."""
    import jax
    import numpy as _np

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.filter.step import (
        _correct,
        _predict,
        _sensor_table,
    )
    from __graft_entry__ import _example_inputs

    config = FilterConfig(
        mode="AMHAMCL", num_particles=n_particles,
        min_particles=n_particles, max_particles=n_particles,
        initialized=True, initial_pose=(0.0, 0.0, 0.3), **config_kw,
    )
    log_field = _sensor_table(grid_map, config)

    @jax.jit
    def step(state, ranges, angles, delta):
        state = _predict(state, delta, grid_map, config)
        return _correct(state, ranges, angles, grid_map, log_field, config)

    state, _r0, angles, _d0 = _example_inputs(grid_map, config, N_BEAMS)
    rot = _np.pi / SCAN_LEN
    delta = jax.numpy.asarray([rot, 0.05, rot], dtype=jax.numpy.float32)
    ranges_seq = _tracking_scans(
        grid_map, config, angles, delta, (0.0, 0.0, 0.3))
    return _time_step(step, state, ranges_seq, angles, delta)


def _emit(metric, value, unit="ms/scan"):
    print(json.dumps({"metric": metric, "value": value, "unit": unit}),
          flush=True)


def main():
    import sys

    import jax

    from mcmh_localization.utils.compile_cache import (
        enable_compile_cache,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX platform {dev.platform!r})")
    print(f"[bench] device: {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}", file=sys.stderr)
    enable_compile_cache()

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.filter.step import (
        _correct, _predict, _sensor_table,
    )
    from __graft_entry__ import _build_map, _example_inputs

    grid_map = _build_map()

    def run_config(n_particles, min_particles_override=None, **kw):
        # min_particles = N keeps the KLD count at the full N for every
        # timed step — an honest full-population throughput measurement
        # (with a small min, KLD collapses the active count within the
        # warmup steps and the run would time mostly padded slots).  The
        # kld-adaptive metric overrides this to exercise the adaptive path.
        config = FilterConfig(
            mode="AMHAMCL",
            num_particles=n_particles,
            min_particles=(min_particles_override or n_particles),
            max_particles=n_particles,
            initialized=True,
            initial_pose=(0.0, 0.0, 0.3),
            **kw,
        )
        log_field = _sensor_table(grid_map, config)

        @jax.jit
        def step(state, ranges, angles, delta):
            state = _predict(state, delta, grid_map, config)
            return _correct(state, ranges, angles, grid_map, log_field, config)

        state, _ranges0, angles, _delta0 = _example_inputs(
            grid_map, config, N_BEAMS
        )
        # closed circle: rot1 + rot2 = 2*pi / SCAN_LEN -> the trajectory is
        # SCAN_LEN-periodic (radius trans/(rot1+rot2) ~ 0.13 m, safely
        # inside the start room)
        import numpy as _np

        rot = _np.pi / SCAN_LEN
        delta = jax.numpy.asarray([rot, 0.05, rot], dtype=jax.numpy.float32)
        ranges_seq = _tracking_scans(
            grid_map, config, angles, delta, (0.0, 0.0, 0.3)
        )
        return _time_step(step, state, ranges_seq, angles, delta)

    flagship = FLAGSHIP

    # headline (FIRST line): the RECOMMENDED configuration — 1M-capacity
    # KLD semantics executed by the staged runner (filter/staged.py),
    # steady-state tracking in the ESS-gated SMALL program
    from mcmh_localization.filter.staged import (
        make_staged_model, run_staged,
    )

    cfg_kld = FilterConfig(
        mode="AMHAMCL", num_particles=1_000_000, min_particles=100_000,
        max_particles=1_000_000, initialized=True,
        initial_pose=(0.0, 0.0, 0.3), kld_eval_window=0,
        coarse_gate_escapees=0, **flagship,
    )
    staged = make_staged_model(cfg_kld, grid_map,
                               tracking_ess_threshold=0.9)
    state_b = staged.big.init(jax.random.PRNGKey(0))
    rot_s = np.pi / SCAN_LEN
    delta_s = jax.numpy.asarray([rot_s, 0.05, rot_s],
                                dtype=jax.numpy.float32)
    angles_s = jax.numpy.linspace(-np.pi, np.pi, N_BEAMS,
                                  dtype=jax.numpy.float32)
    ranges_seq_s = _tracking_scans(grid_map, cfg_kld, angles_s, delta_s,
                                   (0.0, 0.0, 0.3))
    # settle: run the staged runner until it is IN the small program
    out = run_staged(staged, state_b,
                     np.tile(np.asarray(ranges_seq_s), (4, 1)), angles_s,
                     np.tile(np.asarray(delta_s), (4 * SCAN_LEN, 1)),
                     chunk=SCAN_LEN)
    assert out.modes[-1] == 1, "staged runner did not settle into tracking"
    print(f"[bench] staged settle: modes={out.modes.tolist()}",
          file=sys.stderr)
    ms_staged = _time_step(staged.small.step, out.state, ranges_seq_s,
                           angles_s, delta_s)
    _emit(f"amhamcl_step_ms_1m_kld_staged_tracking_{N_BEAMS}beams_win128",
          ms_staged)

    # single-program flagship tracking config at 100k
    ms = run_config(100_000, **flagship)
    _emit(f"amhamcl_step_ms_100k_particles_{N_BEAMS}beams_win128", ms)
    _emit("particle_updates_per_sec_100k", 100_000 / (ms * 1e-3),
          unit="particles/s")

    # 1M particles, same flagship config, one card; coarse_gate_escapees=0
    # = ungated coarse build (config.py::coarse_gate_escapees)
    ms_1m = run_config(1_000_000, coarse_gate_escapees=0, **flagship)
    _emit(f"amhamcl_step_ms_1m_particles_{N_BEAMS}beams_win128", ms_1m)

    # KLD-ADAPTIVE at 1M capacity: min = N/10, so the full adaptive
    # machinery (bin counting, stopping rule, dynamic count) runs in the
    # timed path and the count actually adapts; ms/scan is over the
    # 1M-slot arrays whatever the active count settles to.
    # kld_eval_window=0 = the EXACT escalating prefix-draw evaluation
    # (ops/resampling.py).  This row times the SINGLE-program adaptive
    # path; the staged runner's steady state is the HEADLINE row.
    ms_kld = run_config(1_000_000, min_particles_override=100_000,
                        kld_eval_window=0, coarse_gate_escapees=0,
                        **flagship)
    _emit(f"amhamcl_step_ms_1m_kld_adaptive_{N_BEAMS}beams_win128", ms_kld)

    # 1M full-population flagship + the ESS resample gate (documented
    # deviation, config.py::resample_ess_threshold)
    ms_1m_gate = run_config(1_000_000, coarse_gate_escapees=0,
                            resample_ess_threshold=0.9, **flagship)
    _emit(f"amhamcl_step_ms_1m_particles_{N_BEAMS}beams_win128_essgate",
          ms_1m_gate)

    ms_100k_gate = run_config(100_000, resample_ess_threshold=0.9,
                              **flagship)
    _emit(f"amhamcl_step_ms_100k_particles_{N_BEAMS}beams_win128_essgate",
          ms_100k_gate)

    # exact-gather scorer at 100k (no corr approximation)
    ms_exact = run_config(100_000, likelihood_impl="jnp")
    _emit(f"amhamcl_step_ms_100k_particles_{N_BEAMS}beams_exact", ms_exact)

    # the reference's own operating point: 1500 particles, exact scorer
    ms_ref = run_config(1_500, likelihood_impl="jnp")
    _emit(f"amhamcl_step_ms_1500_particles_{N_BEAMS}beams_exact", ms_ref)

    # BASELINE.json config #3: 100k particles, ray-cast beam model — the
    # windowed per-scan SCORE-FIELD path; the range-table build is a
    # once-per-map precompute outside the timed step
    ms_beam = run_config(100_000, **BEAM_KW)
    _emit(f"amhamcl_step_ms_100k_particles_{N_BEAMS}beams_raycast_field",
          ms_beam)

    # the beam model with ESS-gated resampling (the staged SMALL program's
    # knob)
    ms_beam_gate = run_config(100_000, resample_ess_threshold=0.9,
                              **BEAM_KW)
    _emit(
        f"amhamcl_step_ms_100k_particles_{N_BEAMS}beams_raycast_field_"
        "essgate", ms_beam_gate,
    )


if __name__ == "__main__":
    main()
