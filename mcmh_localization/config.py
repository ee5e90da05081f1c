"""Filter configuration.

The reference stores all parameters on the ROS parameter server, loaded from
``app/params/amhmcl.yaml`` and read via ~25 ``rospy.get_param`` calls
(``amcmh_localizer.py:18,27-58``).  Here the whole configuration is one frozen
(hashable) dataclass so it can close over jit-compiled step functions as a
static argument: changing a parameter recompiles, which is exactly the XLA
semantics we want (parameters are compile-time constants folded into kernels).

Mode strings are parsed with the reference's substring convention
(``amcmh_localizer.py:19-21``): ``use_mh = 'MH' in mode``,
``use_adaptive = 'AMCL' in mode``, ``asymmetric = 'AMH' in mode``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

MODES = ("MCL", "AMCL", "MHMCL", "MHAMCL", "AMHMCL", "AMHAMCL")


def parse_mode(mode: str) -> Tuple[bool, bool, bool]:
    """Parse a mode string into (use_mh, use_adaptive, asymmetric).

    Reference: amcmh_localizer.py:19-21.
    """
    return ("MH" in mode, "AMCL" in mode, "AMH" in mode)


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """All filter parameters. Defaults follow app/params/amhmcl.yaml:20-67."""

    # --- algorithm mode (amcmh_localizer.py:18-21) ---
    mode: str = "AMHAMCL"

    # --- particle counts (amhmcl.yaml:21,45-46) ---
    # num_particles is the *initial* count; under adaptive (KLD) modes the
    # active count varies in [min_particles, max_particles].  All arrays are
    # statically shaped to max_particles with an active-count mask — the
    # reference instead reallocates arrays per step (amcmh_localizer.py:520-522).
    num_particles: int = 1500
    min_particles: int = 100
    max_particles: int = 5000

    # --- odometry motion-model noise (amhmcl.yaml:29-32) ---
    alpha1: float = 0.002  # rotation noise due to rotation
    alpha2: float = 0.03   # translation noise due to rotation
    alpha3: float = 0.08   # rotation noise due to translation
    alpha4: float = 0.002  # translation noise due to translation

    # --- augmented-MCL recovery (amhmcl.yaml:53-54, amcmh_localizer.py:34-35) ---
    alpha_slow: float = 0.04
    alpha_fast: float = 0.6

    # --- KLD adaptive sampling (amhmcl.yaml:38-44) ---
    kld_epsilon: float = 0.03
    kld_z: float = 2.0
    kld_bin_size_xy: float = 0.20
    kld_bin_size_theta: float = 0.1745  # 10 degrees
    kld_delta: float = 0.99
    # Evaluate the KLD stopping rule on only the first kld_eval_window
    # draws (0 = all, exact reference semantics).  EXACT whenever a stop
    # occurs inside the window; otherwise ALL draws are kept — a one-sided
    # deviation (never fewer particles than the reference) that bounds the
    # bin-counting cost at large max_particles (ops/resampling.py).
    kld_eval_window: int = 0

    # --- likelihood-field sensor model (amhmcl.yaml:63-67) ---
    sigma_hit: float = 0.3
    z_hit: float = 0.75
    z_rand: float = 0.25
    max_range: float = 5.0
    step: int = 1  # beam subsampling stride (parallel_utils.py:118)

    # --- initialization (amhmcl.yaml:22, amcmh_localizer.py:50-52) ---
    initialized: bool = False  # True → Gaussian init around initial_pose
    initial_pose: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # diag of 3x3 initial covariance (amcmh_localizer.py:51)
    initial_cov: Tuple[float, float, float] = (0.05, 0.05, 0.1)

    # --- motion proposal validity retries ---
    # The reference rejection-samples each particle's motion up to 1000 times
    # until it lands on a free cell (parallel_utils.py:339-361).  We use a
    # fixed, shape-static number of masked retry rounds; statistically
    # equivalent fallback-to-old-pose semantics.
    motion_retries: int = 4
    # How proposals landing on non-free cells are handled:
    #   "reject" (default, reference semantics): rejection-sample with
    #       motion_retries masked rounds, fall back to the old pose — costs
    #       retries x N validity lookups per step (parallel_utils.py:339-361).
    #   "score": take the raw proposal and fold validity into the SENSOR
    #       score instead — non-free poses get INVALID_SCORE (-100), so MH
    #       rejects them back to their previous pose and non-MH modes kill
    #       them at resampling.  Zero validity lookups on the corr path (the
    #       penalty is added densely to the correlation field once per
    #       scan).  Deviation (documented): an invalid proposal redistributes
    #       its mass instead of surviving at its old pose; with MH modes the
    #       behavior matches the reference fallback almost exactly.
    motion_validity: str = "reject"
    # Augmented-MCL injection probabilities below this threshold are treated
    # as zero (0.0 = reference parity: any p_random > 0 injects,
    # amcmh_localizer.py:505-513).  In steady tracking the w_fast/w_slow
    # ratio hovers around 1 with scan noise, so tiny positive p_random
    # values trigger the (particle-count-proportional) injection machinery
    # every other step for a handful of particles; a small threshold
    # (e.g. 0.02) skips that work entirely via lax.cond while leaving
    # kidnapped-robot recovery (p_random ~ 0.3-1.0) untouched.
    min_injection_prob: float = 0.0
    # Injection REFILL (documented deviation; default False = reference
    # parity): when augmented-MCL injection fires, draw the random block
    # as p_random * CAPACITY slots instead of p_random * count.  The
    # reference's kld_sampling_amcl regrows its count toward max after an
    # injection spreads the cloud (each KLD draw is an independent CDF
    # sample, so N is unbounded by the previous count,
    # parallel_utils.py:529-591); this port's systematic KLD strides a
    # fixed CDF and can only keep n_kept <= count, so without refill the
    # count is monotone non-increasing and a kidnap that strikes AFTER
    # tracking has shrunk the count recovers with a fraction of the
    # capacity it paid for (measured: the 8-island staged dist kidnap at
    # count 632/3000 locks onto a congruent decoy; with refill it
    # re-localizes).  Compute cost is ZERO: arrays are static n_max
    # shapes, count is a traced scalar.  The kept (posterior) block is
    # unchanged — refill only widens the fresh-uniform block, i.e. pure
    # extra recovery coverage.  The staged BIG (recovery) program enables
    # this (filter/staged.py::_staged_configs).
    injection_refill: bool = False

    # --- reference-compatibility quirks (SURVEY.md §7 "Known reference quirks").
    # Each defaults to the *corrected* behavior; set True to bit-follow the
    # reference's quirk.
    # amcmh_localizer.py:429-434 inverts the (rot1,trans,rot2) delta as if it
    # were (dx,dy,dtheta); the correct inverse is (pi-rot2, trans, -rot1-pi).
    ref_compat_backward_delta: bool = False
    # parallel_utils.py:610-613 validates Gaussian-init samples with
    # ``distance_map < 1.0`` (rejecting poses in OPEN space) and zeroes
    # rejected samples to (0,0,0).  False (default) keeps free-cell samples
    # and collapses invalid ones onto the requested mean instead.
    ref_compat_gaussian_init: bool = False
    # amcmh_localizer.py:86-87 initializes w_slow = w_fast = 1e-3 (= 1/1000).
    # For init_particles > 1000 this sits ABOVE the steady-state w_avg = 1/N,
    # so augmented-MCL injects a large random fraction for dozens of scans
    # after startup (a pure init transient; diverges short runs at N >= 2000).
    # False (default): initialize both to 1/num_particles (no transient).
    ref_compat_w_init: bool = False
    # amcmh_localizer.py:282 computes the augmented-MCL fitness signal as
    # w_avg = np.mean(normalized weights) = 1/count — CONSTANT for a fixed
    # count, so p_random = 1 - w_fast/w_slow never reflects measurement fit
    # and kidnapped-robot recovery cannot trigger.  False (default) uses the
    # textbook Probabilistic Robotics signal: the mean RAW measurement
    # likelihood mean(exp(score)) over active particles, which collapses on
    # a kidnap and drives injection.  True reproduces the reference.
    ref_compat_w_avg: bool = False
    # parallel_utils.py:269 guards the asymmetric-MH acceptance with
    # ``if log_den > 0 else 1.0`` — log_den is ~always <= 0, degenerating to
    # always-accept.  Default True REPRODUCES that reference behavior (the
    # shipped AMHMCL/AMHAMCL modes effectively always accept); False applies
    # the proper MH ratio, which measurably lags during motion because
    # rejected particles keep their pre-motion pose (see tests/test_filter).
    ref_compat_assym_guard: bool = True
    # kld_sampling_amcl evaluates the chi^2 stopping bound ONLY on samples
    # that open a new bin (parallel_utils.py:577-586); once a converged
    # cloud's bins are all open before min_particles the stop never fires
    # and every resample walks all max_samples draws.  Default False uses
    # the textbook every-sample rule (ROS amcl pf.c); True reproduces the
    # reference quirk.  See ops/resampling.py::kld_resample(stop_rule=...).
    ref_compat_kld_newbin_stop: bool = False

    # --- sensor model selection ---
    # "likelihood_field" is the reference's live path (compute_likelihoods);
    # "beam" is its dormant ray-cast model (compute_likelihoods_raycast,
    # parallel_utils.py:151-201 — imported but never called there; fully
    # functional here).  Beam-model parameters reuse sigma_hit/z_hit/z_rand.
    # "lidar3d" (BASELINE stretch config #5, no reference equivalent):
    # planar pose + 3-D multi-ring lidar scored against a voxel-map EDT
    # (models/sensor3d.py); pass the VoxelMap via make_model(...,
    # voxel_map=...) and use a nav_slice GridMap for motion/injection.
    # The step's `angles` argument becomes (M, 2) [azimuth, elevation].
    sensor_model: str = "likelihood_field"
    lidar3d_sensor_z: float = 0.0
    # Per-particle score = mean of beam log-likelihoods (the reference's
    # valid-count normalization, parallel_utils.py:145 — heavily tempered:
    # weights stay near-uniform and global localization converges slowly) or
    # "sum" (textbook MCL: product of beam likelihoods; sharp weights, fast
    # convergence).  "mean" is the reference-parity default.
    score_aggregation: str = "mean"

    # --- adaptive-mode resampler variant ---
    # "kld"    = KLD-sized systematic + random injection (the reference's
    #            live path, resample_amcl_kld, amcmh_localizer.py:496-527)
    # "simple" = multinomial + block random injection (resample_amcl_simple,
    #            :444-458; keeps the particle count fixed)
    # "lvr"    = systematic with per-slot random injection
    #            (resample_amcl_lvr, :460-479; fixed count)
    adaptive_resampler: str = "kld"

    # --- numeric/implementation knobs (new; no reference equivalent) ---
    # "jnp": exact reference semantics, one table gather per (particle, beam)
    # "corr": correlation-field scorer — one lookup per particle into a
    #          per-scan field, theta binned to corr_n_theta
    #          (models/corr_field.py)
    # "auto": chosen from the config's sizes (mcmh_localization/dispatch.py)
    likelihood_impl: str = "auto"
    corr_n_theta: int = 120
    # beam (ray-cast) sensor-model implementation:
    # "dense": per-particle DDA march, exact continuous-angle reference
    #          semantics (parallel_utils.py:151-201) — materializes a
    #          (chunk, M, S) working set
    # "table": precomputed per-map range table + one lookup per
    #          (particle, beam); heading quantized to beam_table_n_theta
    #          bins (models/range_table.py)
    # "field": per-scan windowed beam SCORE field (dense build + ONE
    #          lookup/particle; requires corr_window_cells;
    #          models/range_table.py::beam_field_scores)
    # "auto":  chosen from the config (mcmh_localization/dispatch.py)
    beam_impl: str = "auto"
    beam_table_n_theta: int = 360
    # corr field window (cells, 0 = full map): build the correlation field
    # only over a window centered on the particle cloud — the dominant cost
    # lever once the filter has converged.  Particles outside the window
    # score like fully-out-of-map particles (0 before averaging).
    corr_window_cells: int = 0
    # theta window (bins, 0 = all corr_n_theta bins): with the spatial
    # window on, build only this many theta bins centered on the cloud's
    # circular-mean heading.  Tracking clouds span a few degrees, so most
    # of the K-bin build is wasted; particles outside the theta window
    # score via the coarse fallback like spatial escapees.  Cuts BOTH the
    # field build cost and the lookup table height by n_theta/bins.
    corr_theta_window_bins: int = 0
    # coarse full-map fallback field for particles OUTSIDE the window:
    # downsample factor over map cells (0 disables -> out-of-window
    # particles take the blind -50 penalty, which kills augmented-MCL
    # kidnapped-robot recovery while the window is on).  The coarse field
    # is built once per scan at (H/f x W/f x corr_coarse_n_theta) — cheap
    # next to the fine window — and gives out-of-window hypotheses a
    # smoothed but honest score so injected particles can win.
    corr_coarse_factor: int = 4
    corr_coarse_n_theta: int = 36
    # window CENTER policy (round-4; no reference equivalent — the
    # reference scores the full map, parallel_utils.py:85-149):
    # "anchor" (default) = center the spatial+theta window on the
    #           top-weight particle of the PREVIOUS scan (FilterState.
    #           anchor, refreshed pre-resample each correct and advanced
    #           deterministically by each odometry delta).  On a
    #           multimodal cloud (global localization, kidnapped
    #           recovery) the window locks onto the dominant mode and
    #           MIGRATES when an injected/competing mode out-scores it
    #           via the coarse fallback — so ONE windowed config
    #           survives global + kidnap + tracking phases.
    # "mean"   = round-3 behavior: center on the active cloud's mean
    #           position / pooled circular-mean heading.  Equivalent to
    #           "anchor" once the cloud is unimodal; on a multimodal
    #           cloud the mean sits BETWEEN modes and every mode
    #           coarse-scores forever (the round-3 global demo had to
    #           run window=0 for the global phase because of this).
    window_center: str = "anchor"
    # motion proposal noise bit generator: "threefry" (jax default) or
    # "rbg" (XLA RngBitGenerator; models/motion.py::fast_normal).
    # rbg draws differ between vmapped and unbatched execution (breaking
    # batched-vs-individual bitwise equivalence, tests/test_batched.py),
    # so the default stays threefry; rbg is the cheaper bit generator
    # where the proposal noise shows in a profile.
    motion_rng: str = "threefry"
    # minimum in-map window-escapee count that triggers the coarse
    # fallback FIELD build on a given scan (the escapee lookup itself is
    # never gated).  In steady-state tracking the only escapees are a
    # handful of ~4-sigma proposal-noise tails; below the gate they take
    # BLIND_SCORE (the no-fallback semantics — they die, as tails should)
    # and the build is skipped.  Kidnap / injection-storm / global phases
    # put hundreds of particles outside the window, fire the gate, and
    # recover exactly as ungated.  Set to 1 to build whenever any particle
    # escapes.  Set to 0 to DISABLE the gate (always build, no escapee
    # count); bench.py uses 0 for the 1M operating points.
    coarse_gate_escapees: int = 8
    # --- pose-estimate mode (new; no reference equivalent) ---
    # "mean"    = global weighted mean (amcmh_localizer.py:584-597) — the
    #             reference behavior; meaningless while the cloud is
    #             multimodal (global localization, kidnapped recovery).
    # "cluster" = weighted mean over the top-weight cluster only: anchor at
    #             the highest-weight particle, average particles within
    #             (cluster_radius_xy, cluster_radius_theta) of it.  Converges
    #             to "mean" once the filter is unimodal.
    # "anchor"  = cluster mean around the HYSTERETIC window anchor
    #             (refresh_anchor's committed mode) instead of the
    #             per-scan argmax particle.  With two persistent
    #             near-symmetric modes (measured: 1M staged kidnap on
    #             map_house, the old-room decoy holds ~half the mass
    #             indefinitely), the argmax anchor flips modes on weight
    #             noise and the published estimate teleports ~6 m every
    #             few scans; the committed anchor only migrates when a
    #             challenger definitively out-masses it (see
    #             anchor_hysteresis), so the estimate stays on the
    #             committed mode — what a TF re-anchor loop needs.
    estimate_mode: str = "mean"
    cluster_radius_xy: float = 0.5
    cluster_radius_theta: float = 1.0
    # anchor commitment hysteresis: a DIFFERENT-mode argmax candidate
    # only steals the window anchor (and the "anchor" estimate) when its
    # cluster mass exceeds hysteresis * the incumbent's.  1.0 = round-4
    # behavior (any momentary out-massing flips); ~2.0 keeps the
    # committed mode through mass-noise flapping between near-symmetric
    # modes while still yielding to genuine evidence (a real mode shift
    # doubles its mass within a few resamples).
    anchor_hysteresis: float = 1.0
    # EVIDENCE veto on different-mode anchor migration (round-5; no
    # reference equivalent).  Mass dominance measures basin size +
    # history, not fit: after a kidnap's injection storm, congruent-fit
    # decoy basins collect ~95% of the mass by AREA while the truth
    # cluster — whose every particle OUTSCORES every decoy particle
    # (measured, 1M kidnap on map_house) — holds ~5% and needs ~100
    # full-field scans of the ~4%/scan mean-aggregation resampling edge
    # to win the mass race.  A mass-only adoption rule hands the anchor
    # to the decoy long before that.  With margin m > 0, a
    # different-mode candidate must ALSO outscore the incumbent
    # cluster's best particle by m (in score units: mean-log-likelihood
    # per beam for score_aggregation="mean" — weights are the softmax of
    # scores, so the test is w_inc_top < w_cand_top * exp(-m)).  A true
    # kidnap still migrates immediately: the incumbent's fit collapses
    # by whole log units.  0.0 disables (mass-only, round-4 parity).
    # Recommended 0.02 with "mean" aggregation (half the measured
    # truth-vs-congruent-decoy gap of ~0.038 on map_house).  NOTE: under
    # the ESS-gate weight carry the proxy includes history, not pure
    # evidence — acceptable for the committed-unimodal tracking program.
    anchor_score_margin: float = 0.0
    # DEBOUNCED commitment (round-5; no reference equivalent): a
    # different-mode candidate must win the mass-hysteresis + evidence
    # tests for this many CONSECUTIVE scans before the anchor migrates.
    # Rationale (measured, 1M staged at 5 Hz wall-clock on map_house —
    # RESULTS.md "Real-time duty cycle"): a 1-2 scan transient fit
    # collapse (rate-induced scan/odometry misalignment) spikes
    # p_random, escalates the staged runner to the full-field program,
    # and under score_aggregation="sum" ONE scan where the misaligned
    # truth cluster scores below a near-congruent decoy is enough for
    # the resampler + single-scan veto to hand the anchor over (2/3
    # 60 s runs locked onto a 5.5 m decoy; as-fast-as-possible replays
    # of the same config never do).  A true kidnap sustains the
    # inversion — it migrates anchor_commit_scans later (at 5 Hz,
    # commit=5 adds 1.0 s to the measured 2.0-2.6 s reloc).  1 = no
    # debounce (round-4 behavior).
    anchor_commit_scans: int = 1
    # --- ESS-gated resampling with weight carry-over (round-4; documented
    # deviation — the reference resamples EVERY scan and recomputes
    # weights from scratch, amcmh_localizer.py:329-335 + :252-273) ---
    # Below 1.0, the resample block (systematic/KLD draw + expansion +
    # injection) runs ONLY when ESS < threshold * count
    # or augmented-MCL injection fires; on skipped scans the normalized
    # posterior weights CARRY to the next scan, whose softmax folds
    # log(carried) into the scores (standard adaptive resampling, Doucet
    # et al.; after a resample the carry is uniform, so threshold=1.0 is
    # bitwise-parity semantics).  MH acceptance is carry-invariant: the
    # per-particle ratio w_post[i]/w_pre[i] multiplies the SAME carry
    # into numerator and denominator (both sets share particle identity
    # i), so it cancels exactly.  Measured steady-state tracking ESS is
    # ~0.97 N (the resample is near-identity — which is WHY skipping it
    # is sound), so the ~40% of the 1M step spent resampling amortizes
    # away; the gate is a 0/1-iteration while_loop (lax.cond is
    # speculated by XLA).  Single-chip step only: the shard_map
    # distributed step ignores the knob and always resamples (= parity).
    resample_ess_threshold: float = 1.0
    # --- OnlineLocalizer predict batching (round-4; reference anchor:
    # amcmh_localizer.py:379-408 runs one proposal per /odom message) ---
    # "per_message": reference semantics — every on_odom dispatches a
    #                predict (motion noise applied per message): one
    #                device dispatch per odometry message, 30 Hz.
    # "per_scan":    on_odom is host-side bookkeeping only; ONE predict
    #                per scan using the (rot1, trans, rot2) decomposition
    #                between the last-predicted and latest odom poses.
    #                Documented deviation: motion noise is applied once
    #                per scan (scaled by the whole inter-scan delta) and
    #                the decomposition is endpoint-to-endpoint rather
    #                than per-segment; tracking parity is asserted in
    #                tests/test_online.py.
    predict_batching: str = "per_message"
    dt: float = 0.02  # scan interval used by w_slow/w_fast bookkeeping
                      # (amcmh_localizer.py:37; note the reference computes
                      # alpha_*_eff from dt but never uses them, :280-281)

    def __post_init__(self):
        if self.max_particles < self.num_particles:
            object.__setattr__(self, "max_particles", self.num_particles)
        if self.step < 1:
            raise ValueError("step must be >= 1")
        if self.sensor_model not in ("likelihood_field", "beam", "lidar3d"):
            raise ValueError(f"unknown sensor_model {self.sensor_model!r}")
        if self.adaptive_resampler not in ("kld", "simple", "lvr"):
            raise ValueError(f"unknown adaptive_resampler {self.adaptive_resampler!r}")
        if self.likelihood_impl not in ("auto", "jnp", "corr"):
            raise ValueError(f"unknown likelihood_impl {self.likelihood_impl!r}")
        if self.score_aggregation not in ("mean", "sum"):
            raise ValueError(f"unknown score_aggregation {self.score_aggregation!r}")
        if self.corr_window_cells and self.corr_window_cells % 8:
            raise ValueError("corr_window_cells must be a multiple of 8")
        if self.corr_theta_window_bins and (
            self.corr_theta_window_bins >= self.corr_n_theta
            or self.corr_theta_window_bins < 2
        ):
            raise ValueError(
                "corr_theta_window_bins must be 0 or in [2, corr_n_theta)"
            )
        if self.kld_eval_window and (
            self.kld_eval_window <= self.min_particles
        ):
            raise ValueError(
                "kld_eval_window must exceed min_particles (the stopping "
                "rule needs m >= min_particles inside the window; a "
                "smaller window silently disables adaptation while still "
                "paying the bin-count cost)"
            )
        if self.estimate_mode not in ("mean", "cluster", "anchor"):
            raise ValueError(f"unknown estimate_mode {self.estimate_mode!r}")
        if self.anchor_hysteresis < 1.0:
            raise ValueError(
                "anchor_hysteresis must be >= 1.0 (1.0 = no hysteresis)"
            )
        if self.anchor_commit_scans < 1:
            raise ValueError(
                "anchor_commit_scans must be >= 1 (1 = no debounce)"
            )
        if self.window_center not in ("anchor", "mean"):
            raise ValueError(f"unknown window_center {self.window_center!r}")
        if self.predict_batching not in ("per_message", "per_scan"):
            raise ValueError(
                f"unknown predict_batching {self.predict_batching!r}"
            )
        if not 0.0 < self.resample_ess_threshold <= 1.0:
            raise ValueError(
                "resample_ess_threshold must be in (0, 1] "
                "(1.0 = resample every scan, reference parity)"
            )
        if self.corr_coarse_factor < 0:
            raise ValueError("corr_coarse_factor must be >= 0")
        if self.coarse_gate_escapees < 0:
            raise ValueError(
                "coarse_gate_escapees must be >= 0 (0 = ungated)"
            )
        if self.motion_rng not in ("rbg", "threefry"):
            raise ValueError(f"unknown motion_rng {self.motion_rng!r}")
        if self.motion_validity not in ("reject", "score"):
            raise ValueError(f"unknown motion_validity {self.motion_validity!r}")
        if self.beam_impl not in ("auto", "dense", "table", "field"):
            raise ValueError(f"unknown beam_impl {self.beam_impl!r}")
        if self.beam_table_n_theta < 8:
            raise ValueError("beam_table_n_theta must be >= 8")

    # -- derived, all static --
    @property
    def use_mh(self) -> bool:
        return parse_mode(self.mode)[0]

    @property
    def use_adaptive(self) -> bool:
        return parse_mode(self.mode)[1]

    @property
    def asymmetric(self) -> bool:
        return parse_mode(self.mode)[2]

    @property
    def alpha(self) -> Tuple[float, float, float, float]:
        return (self.alpha1, self.alpha2, self.alpha3, self.alpha4)

    def with_mode(self, mode: str) -> "FilterConfig":
        return dataclasses.replace(self, mode=mode)

    def replace(self, **kw) -> "FilterConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "FilterConfig":
        """Load from a reference-format params YAML (app/params/amhmcl.yaml).

        The YAML is flat key: value; keys map 1:1 onto fields below.  Parsed
        with a tiny hand-rolled reader so we need no yaml dependency for the
        exact subset the reference uses.

        Keys that are not reference aliases but match a FilterConfig field
        name directly (e.g. ``likelihood_impl: corr``,
        ``corr_window_cells: 128``) pass through as that field, so a params
        file can configure this framework's extensions alongside the
        reference's knobs.
        """
        raw = _parse_flat_yaml(path)
        mapping = {
            "localization_mode": "mode",
            "init_particles": "num_particles",
            "min_particles": "min_particles",
            "max_particles": "max_particles",
            "alpha1": "alpha1",
            "alpha2": "alpha2",
            "alpha3": "alpha3",
            "alpha4": "alpha4",
            "alpha_slow": "alpha_slow",
            "alpha_fast": "alpha_fast",
            "kld_epsilon": "kld_epsilon",
            "kld_z": "kld_z",
            "kld_bin_size_xy": "kld_bin_size_xy",
            "kld_bin_size_theta": "kld_bin_size_theta",
            "kld_delta": "kld_delta",
            "sigma_hit": "sigma_hit",
            "z_hit": "z_hit",
            "z_rand": "z_rand",
            "max_range": "max_range",
            "step": "step",
            "initialized": "initialized",
        }
        kwargs = {}
        for yaml_key, field in mapping.items():
            if yaml_key in raw:
                kwargs[field] = raw[yaml_key]
        # direct field-name pass-through for this framework's extensions
        # (reference aliases above win on collision)
        field_types = {f.name: f.type for f in dataclasses.fields(cls)}
        for key, val in raw.items():
            if key in mapping or key in kwargs or key not in field_types:
                continue
            kwargs[key] = val
        int_fields = {
            name for name, t in field_types.items() if t in (int, "int")
        }
        for f in list(kwargs):
            if f in int_fields and kwargs[f] is not None:
                kwargs[f] = int(kwargs[f])
        # tuple-typed fields (initial_pose / initial_cov) must arrive as
        # [a, b, c] lists — a scalar or unparsed string would only blow
        # up much later inside jnp.asarray in model.init
        for f, t in field_types.items():
            if f in kwargs and "Tuple" in str(t):
                v = kwargs[f]
                if (
                    not isinstance(v, tuple)
                    or len(v) != 3
                    or not all(isinstance(e, (int, float)) for e in v)
                ):
                    raise ValueError(
                        f"params key {f!r} needs a [a, b, c] list of 3 "
                        f"numbers, got {v!r}"
                    )
        kwargs.update(overrides)
        return cls(**kwargs)


def _parse_flat_yaml(path: str) -> dict:
    """Minimal flat `key: value` YAML reader (comments + blank lines ok)."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, _, val = line.partition(":")
            key, val = key.strip(), val.strip()
            if not val:
                continue
            out[key] = _coerce(val)
    return out


def _coerce(val: str):
    if val.startswith(("'", '"')) and val.endswith(("'", '"')):
        return val[1:-1]
    if val.startswith("[") and val.endswith("]"):
        inner = val[1:-1].strip()
        if not inner:
            return ()
        return tuple(_coerce(v.strip()) for v in inner.split(","))
    low = val.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    try:
        if any(c in val for c in ".eE") and not val.lstrip("+-").isdigit():
            return float(val)
        return int(val)
    except ValueError:
        try:
            return float(val)
        except ValueError:
            return val
