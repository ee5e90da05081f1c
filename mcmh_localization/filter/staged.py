"""Staged two-program execution: 1M-capacity global phases, small-capacity
steady-state tracking (round-4; VERDICT r3 item 2).

KLD-adaptive runs collapse the ACTIVE count to ``min_particles`` once the
cloud converges (resample_amcl_kld semantics, amcmh_localizer.py:496-527),
but a single compiled program still pays (max_particles, .)-shaped arrays
every phase — 7.0 ms/scan at 1M capacity vs 1.5 ms for a native 100k
config (BENCH_r03).  The reference literally reallocates arrays each scan
(:520-522), shrinking its cost with the count; under XLA's static shapes
the equivalent is TWO compiled programs over the same config:

  * BIG:   n_max = max_particles          (global localization, recovery)
  * SMALL: n_max = tracking_capacity      (converged tracking)

with host-side staging: run in chunks of ``chunk`` scans (one dispatch
each, like bench.py), inspect the
chunk's StepInfo, and

  * switch DOWN when every count in the chunk fits the small capacity
    with margin (the state is prefix-packed after the KLD resample, so
    the hand-off is an exact array slice — no resampling, no bias);
  * switch UP (escalate) when injection fires (p_random > 0: the
    augmented-MCL kidnap signal needs room for injected diversity) or
    the count pegs at the small capacity (the KLD bound wants more
    particles than the small program can hold).

SCORING is staged alongside capacity (``global_scoring="full"``): the
BIG program drops the window (full-map field, the reference's scoring
model, parallel_utils.py:85-149) while the SMALL program keeps the
windowed flagship scorer.  Measured rationale (round-4, map_house, chip):
the coarse out-of-window fallback is max-pooled = OPTIMISTIC by design
(kidnap recovery needs injected particles to survive), so competition
between the fine-scored window mode and coarse-scored outside modes is
never fair — a symmetric decoy mode can neither die (its optimistic
coarse scores track the truth's honest fine scores) nor be confirmed.
Full-field scoring during multimodal phases gives every mode fine scores
(the decoy dies on distinguishing geometry: 200k uniform-init on
map_house localizes at scan ~258 full-field, never windowed —
scripts/diag_window_global.py).  Mode dominance (StepInfo.anchor_mass,
the window anchor's cluster weight) gates the hand-off: shrink only when
a single mode holds >= shrink_mass of the weight; escalate when it decays
below escalate_mass.

Deviation (documented): trajectories are NOT bitwise-identical to the
single-program run — kld_resample's draw layout depends on n_max, so the
PRNG consumption differs between programs.  Statistical behavior is the
same (tests/test_staged.py: tracking parity + kidnap escalation).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.config import FilterConfig
from mcmh_localization.filter.state import FilterState
from mcmh_localization.filter.step import make_model, state_size


class StagedModel(NamedTuple):
    config: FilterConfig          # the BIG config (as given)
    small_config: FilterConfig    # capacity-reduced twin
    grid_map: object
    big: object                   # FilterModel (or DistModel)
    small: object                 # FilterModel (or DistModel)
    init: object
    # hand-off callables; None = the single-chip prefix slice / tail pad
    # (shrink_state/grow_state).  The distributed factory installs
    # per-shard variants (the global arrays are sharded by rows, and each
    # island is locally prefix-packed after its resample, so the hand-off
    # must slice/pad EVERY shard's local prefix, not the global prefix).
    shrink: object = None
    grow: object = None


def default_tracking_capacity(config: FilterConfig) -> int:
    """Small-program capacity: 1.3x min_particles (rounded up to 1024) —
    headroom above the KLD steady-state count so a growing bound is
    VISIBLE (count pegging at capacity triggers escalation) without
    paying for slots tracking never uses."""
    cap = int(1.3 * config.min_particles)
    cap = -(-cap // 1024) * 1024
    return min(max(cap, 1024), state_size(config))


def make_staged_model(
    config: FilterConfig,
    grid_map,
    tracking_capacity: int | None = None,
    voxel_map=None,
    global_scoring: str = "full",
    tracking_ess_threshold: float | None = None,
    tracking_theta_bins: int | None = None,
    tracking_window_cells: int | None = None,
    global_score_aggregation: str | None = "sum",
) -> StagedModel:
    """Build the two compiled programs.  ``config`` must be adaptive
    (use_adaptive) — staging is the static-shape answer to the
    reference's dynamic particle counts.

    ``global_scoring``: "full" (default) drops the corr/beam window in
    the BIG program so multimodal phases score every mode fairly (see
    module doc); "windowed" keeps the given window in both programs.

    ``tracking_ess_threshold``: ESS-gated resampling for the SMALL
    (tracking) program only (config.resample_ess_threshold semantics).
    Staging is the right scope for the gate: measured single-program
    kidnap runs with a gate let the losing mode linger (fewer resample
    events to drain it — estimate flips between modes), while here any
    recovery escalates to the BIG program, which always keeps per-scan
    parity resampling.

    ``tracking_theta_bins``: narrower corr/beam theta window for the
    SMALL (tracking) program only.  A converged heading posterior spans
    a few degrees, so the tracking program does not need the global
    config's MH-proposal-headroom width; the field build scales linearly
    with the bin count (models/corr_field.py).  Accuracy measured FLAT from 32 down to
    8 bins on the square/straight_line_spin scenarios
    (scripts/theta_sweep.py); out-of-window headings still fall to the
    coarse fallback, and any recovery escalates to the full-field BIG
    program anyway.

    ``tracking_window_cells``: narrower SPATIAL corr/beam window for the
    SMALL program only — the theta knob's spatial twin.  A converged
    cloud spans centimeters while the global config sizes its window for
    recovery headroom; the field-build region area and the looked-up
    field's volume both scale with the window, and escapees
    still fall to the coarse fallback (which triggers anchor-mass
    escalation if the cloud actually outgrows the window).  RMSE
    measured flat 128 -> 48 cells on square/straight_line_spin
    (scripts/window_sweep.py)."""
    big_config, small_config = _staged_configs(
        config, tracking_capacity, global_scoring, tracking_ess_threshold,
        tracking_theta_bins, tracking_window_cells,
        global_score_aggregation,
    )
    big = make_model(big_config, grid_map, voxel_map=voxel_map)
    small = make_model(small_config, grid_map, voxel_map=voxel_map)
    return StagedModel(
        config=big_config, small_config=small_config, grid_map=grid_map,
        big=big, small=small, init=big.init,
    )


def _staged_configs(
    config: FilterConfig,
    tracking_capacity: int | None,
    global_scoring: str,
    tracking_ess_threshold: float | None,
    tracking_theta_bins: int | None,
    tracking_window_cells: int | None,
    global_score_aggregation: str | None = "sum",
):
    """Derive (big_config, small_config) — shared by the single-chip and
    distributed staged factories so knob semantics cannot drift."""
    if not config.use_adaptive:
        raise ValueError(
            "make_staged_model needs an adaptive mode (AMCL/*AMCL): "
            "non-adaptive counts never change, one program suffices"
        )
    if global_scoring not in ("full", "windowed"):
        raise ValueError(f"unknown global_scoring {global_scoring!r}")
    cap = tracking_capacity or default_tracking_capacity(config)
    n_big = state_size(config)
    if cap >= n_big:
        raise ValueError(
            f"tracking_capacity {cap} must be < max capacity {n_big}"
        )
    if cap < config.min_particles:
        raise ValueError(
            f"tracking_capacity {cap} < min_particles "
            f"{config.min_particles}"
        )
    big_config = config
    # the BIG (recovery/localization) program defaults to the FULL
    # per-scan log-likelihood ("sum" = product over beams, the
    # reference's compute_likelihoods semantics) instead of the per-beam
    # geometric mean: at 1M on map_house the truth-vs-decoy gap is only
    # +0.007..+0.025 mean-log per beam, so "mean" softmax weights are
    # near-uniform (measured ESS frac ~0.999) — resampling pressure
    # ~2%/scan lets near-congruent decoy modes persist for hundreds of
    # scans and the post-recovery cloud never re-concentrates, so
    # StepInfo.anchor_mass decays to ~0 and the host can NEVER shrink
    # back to the tracking program (measured: kidnap_1m seed 0,
    # final_mode_small=false after 500+ post-recovery scans).  "sum"
    # multiplies the same gap by the beam count (~90 at step=4), decoys
    # starve within a few resamples, mass -> ~1, shrink-back fires.
    # Injection robustness is unaffected: the augmented-MCL w_avg signal
    # is per-beam normalized under "sum" (filter/step.py w_avg).
    if (global_score_aggregation is not None
            and global_score_aggregation != config.score_aggregation):
        big_config = big_config.replace(
            score_aggregation=global_score_aggregation)
    # the BIG program is the RECOVERY program: when injection fires, the
    # fresh-uniform block scales with capacity (config.injection_refill)
    # so a kidnap that strikes after tracking shrank the KLD count
    # recovers with the full capacity it paid for.  Zero cost: shapes are
    # static, count is traced.  The reference's KLD regrows its count the
    # same way (parallel_utils.py:529-591 — unbounded independent draws).
    if big_config.use_adaptive and big_config.adaptive_resampler == "kld":
        big_config = big_config.replace(injection_refill=True)
    if global_scoring == "full" and config.corr_window_cells:
        big_config = big_config.replace(
            corr_window_cells=0, corr_theta_window_bins=0,
            # beam_impl="field" hard-requires a window; the full-map beam
            # path is the per-(particle, beam) range-table lookup
            beam_impl=(
                "table" if config.sensor_model == "beam"
                and config.beam_impl in ("auto", "field") else config.beam_impl
            ),
        )
    small_kw = {}
    if tracking_ess_threshold is not None:
        small_kw["resample_ess_threshold"] = tracking_ess_threshold
    if tracking_theta_bins is not None:
        if not config.corr_window_cells:
            raise ValueError(
                "tracking_theta_bins needs a windowed scorer "
                "(corr_window_cells > 0)"
            )
        if (config.corr_theta_window_bins
                and tracking_theta_bins > config.corr_theta_window_bins):
            raise ValueError(
                f"tracking_theta_bins {tracking_theta_bins} > the config's "
                f"corr_theta_window_bins {config.corr_theta_window_bins}: "
                "the tracking theta window only shrinks"
            )
        small_kw["corr_theta_window_bins"] = tracking_theta_bins
    if tracking_window_cells is not None:
        if not config.corr_window_cells:
            raise ValueError(
                "tracking_window_cells needs a windowed scorer "
                "(corr_window_cells > 0)"
            )
        if tracking_window_cells > config.corr_window_cells:
            raise ValueError(
                f"tracking_window_cells {tracking_window_cells} > the "
                f"config's corr_window_cells {config.corr_window_cells}: "
                "the tracking window only shrinks"
            )
        small_kw["corr_window_cells"] = tracking_window_cells
    # the SMALL (tracking) program drops the coarse out-of-window
    # fallback: the max-pooled coarse is OPTIMISTIC by design (kidnap
    # recovery needs injected particles to survive), which lets a
    # near-symmetric decoy mode persist indefinitely through tracking
    # phases (measured: 1M kidnap on map_house — a congruent-room decoy
    # held ~half the mass for 500+ scans, flapping the estimate ~6 m).
    # Tracking is COMMITTED-unimodal by construction here: escapees take
    # the blind penalty and decoys starve within a few resamples, while
    # a true kidnap still recovers via the augmented-MCL fitness
    # collapse -> injection -> escalation to the full-field BIG program
    # (run_staged's escalate_p_random trigger).  Also a perf win: the
    # tracking step never builds the coarse field nor stacks its rows
    # into the fused gather.
    if config.corr_window_cells and config.corr_coarse_factor:
        small_kw.setdefault("corr_coarse_factor", 0)
    small_config = config.replace(
        num_particles=min(config.num_particles, cap),
        max_particles=cap,
        **small_kw,
    )
    return big_config, small_config


def make_staged_dist_model(
    config: FilterConfig,
    grid_map,
    mesh,
    axis: str = "data",
    tracking_capacity: int | None = None,
    voxel_map=None,
    global_scoring: str = "full",
    tracking_theta_bins: int | None = None,
    tracking_window_cells: int | None = None,
    migration_fraction: float = 0.125,
    global_score_aggregation: str | None = "sum",
) -> StagedModel:
    """Staged execution over a device mesh (round-5; VERDICT r4 item 3):
    BOTH programs are shard_map models (parallel/distributed.py) over the
    SAME mesh — the big program's full-field recovery scoring and the
    small program's windowed tracking each shard their particle axis
    across every chip, and the stage hand-off stays on-device.

    Hand-off semantics: the global (N, 3) arrays are row-sharded into
    n_dev contiguous blocks, and the island KLD resample packs each
    island's actives into its LOCAL prefix (randoms first, kept samples
    after — parallel/distributed.py::_dist_step).  The count invariant
    (count a multiple of n_dev, all islands the same size) means
    count <= cap implies count/n_dev <= cap/n_dev per island, so slicing
    cap/n_dev rows off EVERY shard's prefix preserves every active
    particle exactly — the distributed twin of shrink_state's global
    prefix slice.  Growing zero-pads every shard's local tail (inactive
    slots carry zero weight; the dist step's mask is per-shard
    ``slot < count/n_dev``).  Both run as shard_map programs so no
    cross-chip data movement happens at a switch.

    ``tracking_ess_threshold`` is intentionally absent: the distributed
    step always resamples (config.py — island parity), so the knob would
    silently do nothing.

    Counts are rounded to mesh multiples by make_dist_model; the staged
    capacity is rounded the same way here so the invariant holds in both
    programs."""
    from mcmh_localization.parallel.distributed import make_dist_model

    n_dev = int(mesh.devices.size)

    def _round(x):
        return -(-x // n_dev) * n_dev

    config = config.replace(
        num_particles=_round(config.num_particles),
        max_particles=_round(state_size(config)),
        min_particles=max(_round(config.min_particles), n_dev),
    )
    cap = _round(tracking_capacity or default_tracking_capacity(config))
    big_config, small_config = _staged_configs(
        config, cap, global_scoring, None,
        tracking_theta_bins, tracking_window_cells,
        global_score_aggregation,
    )
    big = make_dist_model(
        big_config, grid_map, mesh, axis=axis,
        migration_fraction=migration_fraction, voxel_map=voxel_map,
    )
    small = make_dist_model(
        small_config, grid_map, mesh, axis=axis,
        migration_fraction=migration_fraction, voxel_map=voxel_map,
    )
    shrink = _shard_handoff(mesh, axis, state_size(big.config) // n_dev,
                            state_size(small.config) // n_dev)
    grow = _shard_handoff(mesh, axis, state_size(small.config) // n_dev,
                          state_size(big.config) // n_dev)
    return StagedModel(
        config=big.config, small_config=small.config, grid_map=grid_map,
        big=big, small=small, init=big.init, shrink=shrink, grow=grow,
    )


def _shard_handoff(mesh, axis: str, nl_in: int, nl_out: int):
    """Per-shard resize: slice (nl_out < nl_in) or zero-pad (nl_out >
    nl_in) every shard's LOCAL rows — a pure shard-local op (no
    collectives; verified by the no-big-gather HLO test)."""
    from jax.sharding import PartitionSpec as P

    try:
        from jax.experimental.shard_map import shard_map
    except ImportError:  # jax >= 0.4.35
        from jax import shard_map  # type: ignore

    def local(p, pp, w):
        if nl_out <= nl_in:
            return p[:nl_out], pp[:nl_out], w[:nl_out]
        pad = nl_out - nl_in
        return (
            jnp.pad(p, ((0, pad), (0, 0))),
            jnp.pad(pp, ((0, pad), (0, 0))),
            jnp.pad(w, (0, pad)),
        )

    sm = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis, None), P(axis)),
    )

    @jax.jit
    def resize(state: FilterState) -> FilterState:
        p, pp, w = sm(state.particles, state.prev_particles, state.weights)
        return state.replace(particles=p, prev_particles=pp, weights=w)

    return resize


@functools.partial(jax.jit, static_argnames=("cap",))
def shrink_state(state: FilterState, cap: int) -> FilterState:
    """BIG -> SMALL hand-off: exact prefix slice.  After the KLD resample
    the active particles occupy slots [0, count) (injected randoms first,
    kept samples after — filter/step.py::_resample_kld), so slicing the
    first ``cap`` rows preserves every active particle when count <= cap."""
    return state.replace(
        particles=state.particles[:cap],
        prev_particles=state.prev_particles[:cap],
        weights=state.weights[:cap],
    )


@functools.partial(jax.jit, static_argnames=("n_big",))
def grow_state(state: FilterState, n_big: int) -> FilterState:
    """SMALL -> BIG hand-off: zero-pad the inactive tail (weights are 0
    there; scoring collapses inactive slots onto slot 0 anyway)."""
    pad = n_big - state.particles.shape[0]
    return state.replace(
        particles=jnp.pad(state.particles, ((0, pad), (0, 0))),
        prev_particles=jnp.pad(state.prev_particles, ((0, pad), (0, 0))),
        weights=jnp.pad(state.weights, (0, pad)),
    )


def next_stage(
    in_small: bool,
    counts,
    p_rand,
    mass,
    cap: int,
    shrink_margin: float = 0.9,
    escalate_p_random: float = 1e-6,
    shrink_mass: float = 0.6,
    escalate_mass: float = 0.35,
) -> bool:
    """The stage-switch policy over a window of StepInfo scalars (arrays
    over the last chunk; scalars work too).  Returns the next in_small.
    Shared by run_staged and OnlineLocalizer's staged mode."""
    counts = np.atleast_1d(np.asarray(counts))
    p_rand = np.atleast_1d(np.asarray(p_rand))
    mass = np.atleast_1d(np.asarray(mass))
    if in_small:
        if (
            counts.max() >= cap
            or p_rand.max() > escalate_p_random
            or mass.min() < escalate_mass
        ):
            return False
        return True
    # never shrink mid-recovery (active injection) or without a dominant
    # mode (the windowed program cannot adjudicate between modes)
    if (
        counts.max() <= int(shrink_margin * cap)
        and p_rand.max() <= escalate_p_random
        and mass.min() >= shrink_mass
    ):
        return True
    return False


class StagedRun(NamedTuple):
    state: FilterState
    infos: object          # stacked StepInfo over all T scans
    modes: np.ndarray      # (T,) 0 = big program, 1 = small program
    switches: int


def _handoff_fns(model: StagedModel):
    """(shrink, grow) for this model: the factory-installed per-shard
    callables, else the single-chip prefix slice / tail pad."""
    cap = state_size(model.small_config)
    n_big = state_size(model.config)
    shrink = model.shrink or functools.partial(shrink_state, cap=cap)
    grow = model.grow or functools.partial(grow_state, n_big=n_big)
    return shrink, grow


def warmup_staged(model: StagedModel, state: FilterState, ranges_seq,
                  angles, deltas, chunk: int = 16) -> None:
    """Populate the jit caches of BOTH programs for every chunk length
    ``run_staged`` will dispatch (the ``chunk``-scan body and the final
    remainder), so a timed run measures execution, not XLA compilation —
    the staged twin of ``run_filter_on_bag``'s AOT warmup (a cold compile
    would otherwise be reported as "ms/scan").  Executes one throwaway chunk per (program, length) pair
    on the real inputs; results are discarded (the caller's ``state`` is
    immutable)."""
    ranges_seq = np.asarray(ranges_seq)
    deltas = np.asarray(deltas)
    t_total = len(ranges_seq)
    sizes = {min(chunk, t_total)}
    if t_total % chunk:
        sizes.add(t_total % chunk)
    shrink, grow = _handoff_fns(model)
    small_state = shrink(state)
    # warm the switch-time dispatch too: the jitted grow (and the device
    # slice ops inside shrink) would otherwise pay a remote compile
    # round trip on the FIRST stage switch inside the timed region
    jax.block_until_ready(grow(small_state).particles)
    for tc in sorted(sizes):
        for st, m in ((state, model.big), (small_state, model.small)):
            out_state, _ = m.run(st, ranges_seq[:tc], angles, deltas[:tc])
            jax.block_until_ready(out_state.particles)


def run_staged(
    model: StagedModel,
    state: FilterState,
    ranges_seq,
    angles,
    deltas,
    chunk: int = 16,
    shrink_margin: float = 0.9,
    escalate_p_random: float = 1e-6,
    shrink_mass: float = 0.6,
    escalate_mass: float = 0.35,
) -> StagedRun:
    """Host-staged trajectory run (the lax.scan runner split into chunks
    at program boundaries).  Returns per-scan infos (concatenated across
    chunks) plus the program trace.

    ``shrink_mass`` / ``escalate_mass``: mode-dominance hysteresis on
    StepInfo.anchor_mass — the hand-off to windowed tracking requires one
    mode to hold >= shrink_mass of the weight through the chunk; dominance
    decaying below escalate_mass in the small program (a latent decoy
    re-inflating on optimistic coarse scores) escalates back."""
    cap = state_size(model.small_config)
    shrink, grow = _handoff_fns(model)
    ranges_seq = np.asarray(ranges_seq)
    deltas = np.asarray(deltas)
    t_total = len(ranges_seq)
    in_small = state.particles.shape[0] == cap

    infos_chunks = []
    modes = np.zeros(t_total, np.int8)
    switches = 0
    t = 0
    while t < t_total:
        tc = min(chunk, t_total - t)
        m = model.small if in_small else model.big
        state, infos = m.run(
            state, ranges_seq[t:t + tc], angles, deltas[t:t + tc]
        )
        infos_chunks.append(infos)
        modes[t:t + tc] = 1 if in_small else 0
        nxt = next_stage(
            in_small, np.asarray(infos.count), np.asarray(infos.p_random),
            np.asarray(infos.anchor_mass), cap,
            shrink_margin=shrink_margin,
            escalate_p_random=escalate_p_random,
            shrink_mass=shrink_mass, escalate_mass=escalate_mass,
        )
        if nxt and not in_small:
            state = shrink(state)
            switches += 1
        elif in_small and not nxt:
            state = grow(state)
            switches += 1
        in_small = nxt
        t += tc

    infos = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate([jnp.asarray(x) for x in xs]),
        *infos_chunks,
    )
    return StagedRun(state=state, infos=infos, modes=modes,
                     switches=switches)
