"""The unified filter step: ONE pure function covering all six modes.

The reference's six mode strings (MCL, AMCL, MHMCL, MHAMCL, AMHMCL, AMHAMCL)
are three orthogonal booleans (amcmh_localizer.py:19-21); here they select
static branches at trace time, so each mode jit-compiles to its own fused
program with zero runtime dispatch.

Step anatomy (mirrors the reference's callback pipeline, SURVEY.md §3.2-3.3):
  predict  : odometry proposal for every particle      (odom_callback)
  correct  : score prev+proposed sets, optional MH,
             augmented-MCL bookkeeping, estimate,
             KLD-or-systematic resample                (lidar_callback)

``make_run`` wraps the step in ``lax.scan`` so a whole trajectory compiles
once and runs entirely on device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mcmh_localization import dispatch
from mcmh_localization.config import FilterConfig
from mcmh_localization.filter.estimate import (
    PoseEstimate,
    estimate_pose,
    estimate_pose_cluster,
)
from mcmh_localization.filter.init import init_gaussian, init_uniform
from mcmh_localization.filter.mh import asymmetric_mh, symmetric_mh
from mcmh_localization.filter.state import FilterState, make_state
from mcmh_localization.models.motion import (
    invert_delta,
    motion_density,
    sample_motion,
)
from mcmh_localization.models.sensor import (
    likelihood_field_scores,
    log_likelihood_field,
)
from mcmh_localization.ops.resampling import (
    effective_sample_size,
    kld_resample,
    softmax_weights,
    systematic_resample_indices,
    systematic_resample_particles,
)
from mcmh_localization.utils import pytree as struct


@struct.dataclass
class StepInfo:
    """Per-step observability record (JSONL-able); the reference has no
    equivalent (SURVEY.md §5 metrics note)."""

    estimate: PoseEstimate
    ess: jnp.ndarray            # effective sample size before resampling
    accept_rate: jnp.ndarray    # MH acceptance fraction (1.0 in non-MH modes)
    count: jnp.ndarray          # active particles after resampling
    p_random: jnp.ndarray       # augmented-MCL injection probability
    w_slow: jnp.ndarray
    w_fast: jnp.ndarray
    anchor_mass: jnp.ndarray    # total weight in the window anchor's
                                # cluster — the mode-dominance signal the
                                # staged runner shrinks/escalates on
                                # (filter/staged.py); 1.0 when unimodal


state_size = dispatch.state_size


# ---------------------------------------------------------------------------
# predict (odom) step
# ---------------------------------------------------------------------------

def _predict(state: FilterState, delta: jnp.ndarray, grid_map, config: FilterConfig):
    """Motion proposal (move_particles, amcmh_localizer.py:384-408)."""
    key, sub = jax.random.split(state.key)
    retries = 0 if config.motion_validity == "score" else config.motion_retries
    proposed = sample_motion(
        sub, state.particles, delta, config.alpha, grid_map,
        retries=retries, rng_impl=config.motion_rng,
    )
    # keep BOTH sets for MH (amcmh_localizer.py:404-405)
    return state.replace(
        prev_particles=state.particles,
        particles=proposed,
        delta=delta.astype(jnp.float32),
        anchor=advance_anchor(state.anchor, delta),
        key=key,
    )


def advance_anchor(anchor: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """Deterministic (noise-free) odometry application to the window-anchor
    pose — the rot1/trans/rot2 composition of sample_motion
    (parallel_utils.py:349-357) without the sampled noise, so the anchor
    stays on the top-weight cluster as the whole cloud moves."""
    from mcmh_localization.utils.angles import normalize_angle

    th1 = anchor[2] + delta[0]
    x = anchor[0] + delta[1] * jnp.cos(th1)
    y = anchor[1] + delta[1] * jnp.sin(th1)
    return jnp.stack(
        [x, y, normalize_angle(th1 + delta[2])]
    ).astype(jnp.float32)


# ---------------------------------------------------------------------------
# correct (scan) step
# ---------------------------------------------------------------------------

def _make_scorer(ranges, angles, grid_map, log_field, config: FilterConfig):
    """Sensor-model dispatch (static): likelihood field (exact or
    correlation field) or the ray-cast beam model.  ``log_field`` carries
    the per-(map, config) sensor table built by make_step: the
    log-likelihood field, or the cell-major range table for the beam
    "table" path."""
    if config.sensor_model == "lidar3d":
        from mcmh_localization.models.sensor3d import lidar3d_scores

        # angles carries (M, 2) [azimuth, elevation]; log_field carries the
        # VoxelMap pytree (see _sensor_table)
        return functools.partial(
            lidar3d_scores,
            ranges=ranges, directions=angles, voxel_map=log_field,
            config=config, sensor_z=config.lidar3d_sensor_z,
        )
    if config.sensor_model == "beam":
        if dispatch.beam_impl(config) == "field":
            from mcmh_localization.models.range_table import (
                beam_field_scores,
            )

            return functools.partial(
                beam_field_scores,
                ranges=ranges, angles=angles, grid_map=grid_map,
                config=config, table=log_field,
                n_theta=config.beam_table_n_theta,
            )
        if dispatch.beam_impl(config) == "table":
            from mcmh_localization.models.range_table import (
                raycast_table_scores,
            )

            return functools.partial(
                raycast_table_scores,
                ranges=ranges, angles=angles, grid_map=grid_map,
                config=config, table_cm=log_field,
                n_theta=config.beam_table_n_theta,
            )
        from mcmh_localization.models.sensor import raycast_beam_scores

        # config.step beam subsampling applied here (raycast_beam_scores is
        # config-less); keeps all three beam impls scoring the same subset
        return functools.partial(
            raycast_beam_scores,
            ranges=ranges[:: config.step] if config.step > 1 else ranges,
            angles=angles[:: config.step] if config.step > 1 else angles,
            grid_map=grid_map,
            sigma_hit=config.sigma_hit, z_hit=config.z_hit,
            z_rand=config.z_rand, max_range=config.max_range,
            aggregation=config.score_aggregation,
        )
    impl = dispatch.likelihood_impl(config)
    if impl == "corr":
        from mcmh_localization.models.corr_field import (
            correlation_field_scores,
        )

        return functools.partial(
            correlation_field_scores,
            ranges=ranges, angles=angles, grid_map=grid_map,
            config=config, log_field=log_field, n_theta=config.corr_n_theta,
        )
    return functools.partial(
        likelihood_field_scores,
        ranges=ranges, angles=angles, grid_map=grid_map,
        config=config, log_field=log_field,
    )


def _window_origin(
    state: FilterState, grid_map, config: FilterConfig,
    n_theta: int | None = None,
):
    """Cell coords of the corr-field window's lower-left corner, centered on
    the active particle cloud's mean position; with a theta window
    configured, also the starting global theta-bin (circular-mean heading
    minus half the window).  ``n_theta`` overrides the bin count (the beam
    score field uses beam_table_n_theta bins; default corr_n_theta).

    Under MH the SAME window scores BOTH sets (current + prev).  The
    THETA center is therefore the pooled circular mean over both sets: a
    fast-turning robot separates the sets' mean headings by rot1+rot2
    per scan, and a theta window centered on the current set alone can
    push the ENTIRE prev set outside a narrow window (measured on the
    beam bench config — 360-bin table, 32-bin window = +-16 deg,
    22.5 deg/scan turn: ~50% of scored particles coarse-scored every
    scan).  The SPATIAL center deliberately stays on the current set:
    the sets are at most one translation step apart (~1 cell), and
    during kidnapped-robot recovery the window must migrate with the
    winning injected mode — pooling positions with the stale prev set
    was measured to stall that migration (late re-localization spikes in
    tests/test_corr_field.py::test_kidnapped_recovery_windowed).

    window_center="anchor" (round-4 default): center on state.anchor —
    the previous scan's top-weight pose advanced by the odometry delta —
    instead of the cloud mean.  Identical once the cloud is unimodal; on
    a multimodal cloud (global localization) the mean sits BETWEEN modes
    and nothing ever fine-scores, while the anchor locks the dominant
    mode and migrates to whichever mode wins the coarse-scored
    competition.  Under MH the anchor tracks the CURRENT set (it was
    advanced by the full delta), so the theta center backs off by
    (rot1+rot2)/2 to pool with the un-advanced prev set."""
    mask = state.active_mask
    inv_res = 1.0 / grid_map.resolution
    half = config.corr_window_cells // 2
    if config.window_center == "anchor":
        from mcmh_localization.utils.angles import normalize_angle

        cx, cy = state.anchor[0], state.anchor[1]
        mean_t = state.anchor[2]
        if config.use_mh:
            # keep in [-pi, pi): the kmid int32 truncation below needs
            # mean_t + pi >= 0
            mean_t = normalize_angle(
                mean_t - 0.5 * (state.delta[0] + state.delta[2])
            )
    else:
        n = jnp.maximum(jnp.sum(mask), 1)
        cx = jnp.sum(jnp.where(mask, state.particles[:, 0], 0.0)) / n
        cy = jnp.sum(jnp.where(mask, state.particles[:, 1], 0.0)) / n
        mean_t = None
    ox0 = ((cx - grid_map.origin[0]) * inv_res).astype(jnp.int32) - half
    oy0 = ((cy - grid_map.origin[1]) * inv_res).astype(jnp.int32) - half
    if config.corr_theta_window_bins:
        if mean_t is None:
            sets = (
                (state.particles, state.prev_particles) if config.use_mh
                else (state.particles,)
            )
            c = sum(
                jnp.sum(jnp.where(mask, jnp.cos(p[:, 2]), 0.0)) for p in sets
            )
            s = sum(
                jnp.sum(jnp.where(mask, jnp.sin(p[:, 2]), 0.0)) for p in sets
            )
            mean_t = jnp.arctan2(s, c)
        k = n_theta if n_theta is not None else config.corr_n_theta
        kmid = (
            ((mean_t + jnp.pi) * (k / (2.0 * jnp.pi))).astype(jnp.int32) % k
        )
        kstart = (kmid - config.corr_theta_window_bins // 2) % k
        return oy0, ox0, kstart
    return oy0, ox0


def refresh_anchor(particles, weights, anchor, streak, config: FilterConfig,
                   mask, score_scale=1.0):
    """Window-anchor update, CLUSTER-MASS GATED: the raw argmax pose
    hijacks the window for a scan whenever one lucky coarse-scored
    particle out-scores the tracked cluster (the coarse field is
    max-pooled = optimistic by design), which was measured to flicker
    the beam kidnap recovery (4 m estimate spikes every few scans).
    The anchor therefore only MIGRATES to the argmax candidate when the
    candidate's total cluster weight beats the incumbent anchor's — a
    genuine competing mode accumulates resampled followers, a lucky
    outlier has mass ~ its own weight.  A candidate inside the
    incumbent's cluster radius always adopts (same mode; re-centering
    prevents the deterministically-advanced anchor from accumulating
    odometry drift).  Cost: one argmax + two masked weighted sums.

    ``streak`` (state.anchor_streak) debounces migration: the full
    different-mode test (mass hysteresis AND evidence veto) must pass
    config.anchor_commit_scans CONSECUTIVE scans before the anchor
    moves (see the config.py rationale — measured at-rate transient
    misalignment flips a single-scan veto).  Returns
    (anchor, anchor_mass, streak).

    ``score_scale``: anchor_score_margin is calibrated in PER-BEAM
    mean-log units, but the log-weight gap this veto tests is in the
    aggregation's units — under score_aggregation="sum" that is
    per-beam * n_valid_beams, so an unscaled 0.02 margin is vacuous
    (0.02 log units against gaps of hundreds) and the veto silently
    degenerates to mass-only exactly in the staged BIG program where
    decisive resampling makes it matter (measured: the at-rate decoy
    captures, RESULTS.md duty cycle).  Callers pass the effective
    beam count for "sum" (the same normalization the w_avg fitness
    signal uses above), 1.0 for "mean"."""
    from mcmh_localization.filter.estimate import cluster_mass
    from mcmh_localization.utils.angles import normalize_angle_about

    w = jnp.where(mask, weights, 0.0)
    cand = particles[jnp.argmax(w)].astype(jnp.float32)
    m_cand = cluster_mass(
        particles, w, cand,
        config.cluster_radius_xy, config.cluster_radius_theta,
    )
    m_cur = cluster_mass(
        particles, w, anchor,
        config.cluster_radius_xy, config.cluster_radius_theta,
    )
    d_xy = jnp.hypot(cand[0] - anchor[0], cand[1] - anchor[1])
    d_th = jnp.abs(normalize_angle_about(cand[2], anchor[2]))
    same_mode = (d_xy <= config.cluster_radius_xy) & (
        d_th <= config.cluster_radius_theta
    )
    # different-mode migration requires the challenger to out-mass the
    # incumbent by the commitment hysteresis factor — near-symmetric
    # persistent modes (~equal mass) otherwise flip the anchor on weight
    # noise every few scans (config.anchor_hysteresis)
    migrate = m_cand > config.anchor_hysteresis * m_cur
    if config.anchor_score_margin > 0.0:
        # EVIDENCE veto (config.anchor_score_margin): the candidate is
        # the global top-weight particle; migration additionally
        # requires it to outscore the incumbent cluster's best particle
        # by the margin.  weights = softmax(scores), so the score gap is
        # the log weight ratio.  An empty incumbent cluster (ghost
        # anchor) has w_inc_top ~ 0 and never vetoes.
        d2 = (
            (particles[:, 0] - anchor[0]) ** 2
            + (particles[:, 1] - anchor[1]) ** 2
        )
        inc = (d2 <= config.cluster_radius_xy ** 2) & (
            jnp.abs(normalize_angle_about(particles[:, 2], anchor[2]))
            <= config.cluster_radius_theta
        )
        w_inc_top = jnp.max(jnp.where(inc, w, 0.0))
        w_cand_top = w[jnp.argmax(w)]
        migrate = migrate & (
            w_inc_top
            < w_cand_top * jnp.exp(-config.anchor_score_margin * score_scale)
        )
    # debounced commitment: count consecutive scans the different-mode
    # challenge wins; migrate only at anchor_commit_scans.  Same-mode
    # re-centering neither counts nor resets-to-win (K=1 == round-4).
    challenge = migrate & ~same_mode
    streak = jnp.where(challenge, streak + 1, 0).astype(jnp.int32)
    migrate = migrate & (streak >= config.anchor_commit_scans)
    adopt = same_mode | migrate
    streak = jnp.where(migrate, 0, streak)
    return (
        jnp.where(adopt, cand, anchor).astype(jnp.float32),
        jnp.where(adopt, m_cand, m_cur),
        streak,
    )


def _transition_probabilities(state: FilterState, config: FilterConfig):
    """Forward/backward odometry transition densities for asymmetric MH
    (transition_probability, amcmh_localizer.py:424-439)."""
    fwd = motion_density(state.prev_particles, state.particles, state.delta, config.alpha)
    bwd_delta = invert_delta(state.delta, ref_compat=config.ref_compat_backward_delta)
    bwd = motion_density(state.particles, state.prev_particles, bwd_delta, config.alpha)
    return fwd, bwd


def _resample_systematic(key, state: FilterState, config: FilterConfig):
    """Non-adaptive path (resample_lvr, amcmh_localizer.py:488-492): LVR to
    the fixed particle count; weights left untouched like the reference
    (the next step recomputes them from scratch anyway) — EXCEPT under
    ESS-gated carry-over, where the next step folds the stored weights
    into its softmax: resampled particles already encode them, so they
    reset to uniform (double-counting otherwise)."""
    resampled = systematic_resample_particles(
        key, state.particles, state.weights, state.n_max, count=state.count
    )
    if config.resample_ess_threshold < 1.0:
        mask = jnp.arange(state.n_max) < state.count
        weights = jnp.where(
            mask, 1.0 / jnp.maximum(state.count, 1), 0.0
        ).astype(jnp.float32)
        return state.replace(particles=resampled, weights=weights), jnp.float32(0.0)
    return state.replace(particles=resampled), jnp.float32(0.0)


def _resample_amcl_simple(key, state: FilterState, grid_map, config: FilterConfig):
    """Adaptive 'simple' variant (resample_amcl_simple, amcmh_localizer.py
    :444-458): multinomial resampling of N - N_random slots + N_random fresh
    uniform particles; count unchanged; uniform weights."""
    k_rs, k_rand = jax.random.split(key)
    n = state.count
    p_random = jnp.maximum(0.0, 1.0 - state.w_fast / (state.w_slow + 1e-9))
    p_random = jnp.where(p_random >= config.min_injection_prob, p_random, 0.0)
    n_random = (p_random * n.astype(jnp.float32)).astype(jnp.int32)
    n_resampled = n - n_random

    from mcmh_localization.ops.resampling import multinomial_resample_indices

    idx = multinomial_resample_indices(k_rs, state.weights, state.n_max)
    randoms = init_uniform(k_rand, state.n_max, grid_map)
    slot = jnp.arange(state.n_max)
    particles = jnp.where(
        (slot < n_resampled)[:, None], state.particles[idx], randoms
    )
    mask = slot < n
    weights = jnp.where(mask, 1.0 / jnp.maximum(n, 1), 0.0)
    return state.replace(particles=particles, weights=weights), p_random


def _resample_amcl_lvr(key, state: FilterState, grid_map, config: FilterConfig):
    """Adaptive 'lvr' variant (resample_amcl_lvr, amcmh_localizer.py:460-479):
    systematic resampling with per-slot probability p_random of replacement
    by a fresh uniform particle; count unchanged; uniform weights."""
    k_rs, k_rand, k_coin = jax.random.split(key, 3)
    n = state.count
    p_random = jnp.maximum(0.0, 1.0 - state.w_fast / (state.w_slow + 1e-9))
    p_random = jnp.where(p_random >= config.min_injection_prob, p_random, 0.0)
    resampled = systematic_resample_particles(
        k_rs, state.particles, state.weights, state.n_max, count=n
    )
    randoms = init_uniform(k_rand, state.n_max, grid_map)
    coins = jax.random.uniform(k_coin, (state.n_max,)) < p_random
    particles = jnp.where(coins[:, None], randoms, resampled)
    mask = jnp.arange(state.n_max) < n
    weights = jnp.where(mask, 1.0 / jnp.maximum(n, 1), 0.0)
    return state.replace(particles=particles, weights=weights), p_random


def _resample_kld(key, state: FilterState, grid_map, config: FilterConfig):
    """Adaptive path (resample_amcl_kld, amcmh_localizer.py:496-527):
    augmented-MCL random injection + KLD-sized systematic resampling.
    Deviation from the reference (documented): the new count is the actual
    size of the combined set (the reference stores the PREVIOUS length,
    :520-521)."""
    k_kld, k_rand = jax.random.split(key)
    n = state.count
    p_random = jnp.maximum(0.0, 1.0 - state.w_fast / (state.w_slow + 1e-9))
    p_random = jnp.where(
        p_random >= config.min_injection_prob, p_random, 0.0
    )
    n_drop = (p_random * n.astype(jnp.float32)).astype(jnp.int32)
    n_resampled = n - n_drop
    if config.injection_refill:
        # escalation refill (config.injection_refill): the kept posterior
        # block is the same n_resampled-target systematic draw, but the
        # fresh-uniform block scales with CAPACITY, regrowing the count
        # on a fitness collapse like the reference's unbounded KLD draws
        # (parallel_utils.py:529-591).  floor() on both terms keeps
        # n_random + n_kept <= n_max for every n <= n_max.
        n_random = (p_random * jnp.float32(state.n_max)).astype(jnp.int32)
    else:
        n_random = n_drop

    samples, n_kept = kld_resample(
        k_kld,
        state.particles,
        state.weights,
        max_samples=state.n_max,
        min_particles=config.min_particles,
        bin_size_xy=config.kld_bin_size_xy,
        bin_size_theta=config.kld_bin_size_theta,
        epsilon=config.kld_epsilon,
        z=config.kld_z,
        count=n_resampled,
        eval_window=config.kld_eval_window,
        stop_rule=(
            "new_bin" if config.ref_compat_kld_newbin_stop
            else "every_sample"
        ),
    )
    n_kept = jnp.minimum(n_kept, n_resampled)

    def _inject(samples):
        randoms = init_uniform(k_rand, state.n_max, grid_map)
        take_random = jnp.arange(state.n_max) < n_random
        # injected randoms must occupy the FIRST slots (reference order,
        # amcmh_localizer.py:505-513): the NEXT step's KLD stop rule counts
        # occupied bins in draw==slot order, and spread-out randoms up
        # front keep k(m) high so the stop cannot truncate the injected
        # diversity away (placing them after the kept samples measurably
        # breaks kidnapped-robot recovery — see
        # tests/test_corr_field.py::test_kidnapped_recovery_windowed).
        # The shift of the kept samples is a roll; masked slots don't care
        # about the wrap
        shifted = jnp.roll(samples, n_random, axis=0)
        return jnp.where(take_random[:, None], randoms, shifted)

    # free-cell sampling + roll only run on steps that actually inject
    particles = jax.lax.cond(n_random > 0, _inject, lambda s: s, samples)

    new_count = jnp.clip(
        n_random + n_kept, config.min_particles, state.n_max
    ).astype(jnp.int32)
    mask = jnp.arange(state.n_max) < new_count
    weights = jnp.where(mask, 1.0 / new_count.astype(jnp.float32), 0.0)
    return (
        state.replace(particles=particles, weights=weights, count=new_count),
        p_random,
    )


def _correct(
    state: FilterState,
    ranges: jnp.ndarray,
    angles: jnp.ndarray,
    grid_map,
    log_field: jnp.ndarray,
    config: FilterConfig,
) -> Tuple[FilterState, StepInfo]:
    """Measurement update (lidar_callback, amcmh_localizer.py:294-338)."""
    key, k_mh, k_rs = jax.random.split(state.key, 3)
    mask = state.active_mask

    # -- weights on previous and proposed sets (update_weights, :252-273)
    score = _make_scorer(ranges, angles, grid_map, log_field, config)
    beam_field = (
        config.sensor_model == "beam"
        and dispatch.beam_impl(config) == "field"
    )
    if config.corr_window_cells and (
        beam_field
        or (
            config.sensor_model == "likelihood_field"
            and dispatch.likelihood_impl(config) == "corr"
        )
    ):
        # window-limited score field centered on the particle cloud;
        # the SAME origin for both score calls so XLA CSE builds one field
        wo = _window_origin(
            state, grid_map, config,
            n_theta=config.beam_table_n_theta if beam_field else None,
        )
        score = functools.partial(score, window_origin=wo)
    # collapse INACTIVE (padded) slots onto an active pose before scoring:
    # their scores are masked out of the softmax anyway, but stale padded
    # poses spread across the map would pull the window anchor and the
    # coarse fallback into play (slot 0 is always active; count >= 1)
    anchor = state.particles[0]
    p_sc = jnp.where(mask[:, None], state.particles, anchor)

    # paths that fold the motion-validity penalty into their own field
    # build (corr / beam score field); every OTHER scorer (exact,
    # beam table/dense, lidar3d) gets the explicit valid_mask wrap below
    corr_path = beam_field or (
        config.sensor_model == "likelihood_field"
        and dispatch.likelihood_impl(config) == "corr"
    )
    if config.motion_validity == "score" and not corr_path:
        from mcmh_localization.models.sensor import (
            wrap_score_with_validity,
        )

        score = wrap_score_with_validity(score, grid_map, config, ranges)

    # ESS-gated resampling (config.resample_ess_threshold < 1): fold the
    # CARRIED posterior into the softmax logits.  After a resample the
    # carry is uniform over active slots, so the addend is a constant and
    # the weights equal the reference's fresh softmax; on skipped scans
    # the carry is the previous posterior and the softmax composes it
    # with the new scores.  MH acceptance is carry-invariant (same carry
    # term in w_post[i] and w_pre[i] — see config.py).
    carry_on = config.resample_ess_threshold < 1.0
    log_carry = (
        jnp.log(jnp.maximum(state.weights, 1e-30)) if carry_on else 0.0
    )
    if config.use_mh:
        # ONE scorer invocation for both sets: the field build is shared
        n_max = state.n_max
        prev_sc = jnp.where(mask[:, None], state.prev_particles, anchor)
        s_both = score(jnp.concatenate([p_sc, prev_sc]))
        s_post = s_both[:n_max]
        weights_post = softmax_weights(s_post + log_carry, mask)
        weights_pre = softmax_weights(s_both[n_max:] + log_carry, mask)
    else:
        s_post = score(p_sc)
        weights_post = softmax_weights(s_post + log_carry, mask)
    if config.use_mh:
        if config.asymmetric:
            fwd, bwd = _transition_probabilities(state, config)
            particles, weights, accepted = asymmetric_mh(
                k_mh, state.prev_particles, state.particles,
                weights_post, weights_pre, fwd, bwd,
                ref_compat_guard=config.ref_compat_assym_guard,
            )
        else:
            particles, weights, accepted = symmetric_mh(
                k_mh, state.prev_particles, state.particles,
                weights_post, weights_pre,
            )
        accept_rate = jnp.sum(
            jnp.where(mask, accepted, False)
        ) / jnp.maximum(state.count, 1)
        state = state.replace(particles=particles)
    else:
        weights = weights_post
        accept_rate = jnp.float32(1.0)

    # -- augmented-MCL bookkeeping (update_acml_weights, :276-286)
    weights = jnp.where(mask, weights, 0.0)
    weights = weights / jnp.maximum(jnp.sum(weights), 1e-30)
    if config.use_adaptive:
        if config.ref_compat_w_avg:
            # reference quirk (amcmh_localizer.py:282): mean of NORMALIZED
            # weights = 1/count — fit-blind, recovery never triggers
            w_avg = jnp.sum(weights) / jnp.maximum(state.count, 1)
        else:
            # textbook augmented MCL: mean raw measurement likelihood of the
            # current set — collapses on a kidnap, driving injection.  The
            # signal is always the PER-BEAM geometric-mean likelihood
            # (exp of the per-beam mean log): scale-free in the beam count,
            # bounded in [1e-6, ~e], so one bad scan cannot crash w_fast by
            # orders of magnitude and cause an injection storm (which the
            # raw exp(sum) of score_aggregation="sum" would).
            if config.step > 1:
                sig_ranges = ranges[:: config.step]
            else:
                sig_ranges = ranges
            n_beams = jnp.sum(
                jnp.isfinite(sig_ranges) & (sig_ranges < config.max_range)
            )
            per_beam = (
                s_post / jnp.maximum(n_beams, 1)
                if config.score_aggregation == "sum"
                else s_post
            )
            w_avg = jnp.sum(
                jnp.where(mask, jnp.exp(per_beam), 0.0)
            ) / jnp.maximum(state.count, 1)
        state = state.replace(
            w_slow=state.w_slow + config.alpha_slow * (w_avg - state.w_slow),
            w_fast=state.w_fast + config.alpha_fast * (w_avg - state.w_fast),
        )
    state = state.replace(weights=weights)

    # -- window anchor refresh (pre-resample weights identify modes;
    # post-resample they are uniform)
    if config.score_aggregation == "sum":
        _sig = ranges[:: config.step] if config.step > 1 else ranges
        _scale = jnp.maximum(
            jnp.sum(jnp.isfinite(_sig) & (_sig < config.max_range)), 1
        ).astype(jnp.float32)
    else:
        _scale = 1.0
    new_anchor, anchor_mass, new_streak = refresh_anchor(
        state.particles, state.weights, state.anchor, state.anchor_streak,
        config, mask, score_scale=_scale
    )
    state = state.replace(anchor=new_anchor, anchor_streak=new_streak)

    # -- estimate BEFORE resampling (:327)
    if config.estimate_mode in ("cluster", "anchor"):
        est = estimate_pose_cluster(
            state.particles, state.weights, mask,
            radius_xy=config.cluster_radius_xy,
            radius_theta=config.cluster_radius_theta,
            # "anchor": center on the hysteretic committed anchor
            # (refreshed just above) instead of the per-scan argmax
            anchor=(state.anchor if config.estimate_mode == "anchor"
                    else None),
        )
    else:
        est = estimate_pose(state.particles, state.weights, mask)
    ess = effective_sample_size(state.weights)

    # -- resample (:329-335)
    if config.use_adaptive:
        resampler = {
            "kld": _resample_kld,
            "simple": _resample_amcl_simple,
            "lvr": _resample_amcl_lvr,
        }[config.adaptive_resampler]
        do_resample = functools.partial(
            resampler, k_rs, grid_map=grid_map, config=config
        )
    else:
        do_resample = functools.partial(_resample_systematic, k_rs,
                                        config=config)
    if config.resample_ess_threshold < 1.0:
        # ESS gate: run the whole resample block (draws + expansion +
        # injection) only when the weights have degenerated past the
        # threshold or augmented-MCL wants to inject.  0/1-iteration
        # while_loop, NOT lax.cond — XLA speculates cond and would
        # execute the resample anyway (see kld_resample / the coarse
        # field gate).
        if config.use_adaptive:
            p_gate = jnp.maximum(
                0.0, 1.0 - state.w_fast / (state.w_slow + 1e-9)
            )
            p_gate = jnp.where(
                p_gate >= config.min_injection_prob, p_gate, 0.0
            )
        else:
            p_gate = jnp.float32(0.0)
        need = (
            ess < config.resample_ess_threshold
            * state.count.astype(jnp.float32)
        ) | (p_gate > 0)

        def _wcond(c):
            return jnp.logical_not(c[0])

        def _wbody(c):
            _, st, _ = c
            st, p_r = do_resample(st)
            return jnp.bool_(True), st, p_r

        _, state, p_random = jax.lax.while_loop(
            _wcond, _wbody,
            (jnp.logical_not(need), state, jnp.float32(0.0)),
        )
    else:
        state, p_random = do_resample(state)

    state = state.replace(key=key)
    info = StepInfo(
        estimate=est,
        ess=ess,
        accept_rate=accept_rate,
        count=state.count,
        p_random=p_random,
        w_slow=state.w_slow,
        w_fast=state.w_fast,
        anchor_mass=anchor_mass,
    )
    return state, info


# ---------------------------------------------------------------------------
# public factories
# ---------------------------------------------------------------------------

class FilterModel(NamedTuple):
    """A config + map bound into jitted predict/correct/step/run callables."""

    config: FilterConfig
    grid_map: object
    log_field: jnp.ndarray
    predict: object
    correct: object
    step: object
    run: object
    init: object


def _sensor_table(grid_map, config: FilterConfig, voxel_map=None):
    """Per-(map, config) sensor precompute: the log-likelihood field, or the
    cell-major raycast range table for the beam "table" path."""
    if config.sensor_model == "lidar3d":
        if voxel_map is None:
            raise ValueError(
                "sensor_model='lidar3d' requires make_step/make_model("
                "..., voxel_map=VoxelMap); grid_map stays the 2-D "
                "navigation slice (maps/voxel_map.py::nav_slice)"
            )
        return voxel_map
    if config.sensor_model == "beam":
        impl = dispatch.beam_impl(config)
        if impl in ("table", "field"):
            from mcmh_localization.models.range_table import (
                build_range_table,
                make_beam_tables,
                table_cell_major,
            )

            # "field" carries the BeamTables bundle (f32 table + the
            # quantized coarse-fallback table); "table" flattens cell-major
            # for the per-(particle, beam) lookup
            if impl == "field":
                return make_beam_tables(grid_map, config)
            table = build_range_table(
                grid_map, config.beam_table_n_theta, config.max_range
            )
            return table_cell_major(table)
    return log_likelihood_field(grid_map, config)


def make_step(config: FilterConfig, grid_map, voxel_map=None):
    """Build jitted (predict, correct, step) closures for a config + map.

    ``voxel_map``: VoxelMap for sensor_model="lidar3d" (grid_map is then
    the 2-D navigation slice used by motion validity and injection)."""
    log_field = _sensor_table(grid_map, config, voxel_map)

    @jax.jit
    def predict(state, delta):
        return _predict(state, delta, grid_map, config)

    @jax.jit
    def correct(state, ranges, angles):
        return _correct(state, ranges, angles, grid_map, log_field, config)

    @jax.jit
    def step(state, ranges, angles, delta):
        return _correct(
            _predict(state, delta, grid_map, config),
            ranges, angles, grid_map, log_field, config,
        )

    return predict, correct, step, log_field


def make_model(config: FilterConfig, grid_map, voxel_map=None) -> FilterModel:
    """One-stop construction: init + jitted step functions + scan runner."""
    predict, correct, step, log_field = make_step(config, grid_map, voxel_map)
    n_max = state_size(config)

    def init(key, initial_pose=None, initial_cov=None) -> FilterState:
        """initialize_particles (amcmh_localizer.py:179-197): Gaussian around
        a given pose when config.initialized, else uniform over free space."""
        k_init, k_state = jax.random.split(key)
        n = config.num_particles
        if config.initialized or initial_pose is not None:
            mean = jnp.asarray(
                initial_pose if initial_pose is not None else config.initial_pose
            )
            cov = (
                jnp.diag(jnp.asarray(config.initial_cov, dtype=jnp.float32))
                if initial_cov is None
                else jnp.asarray(initial_cov)
            )
            particles = init_gaussian(
                k_init, mean, cov, n, grid_map,
                ref_compat=config.ref_compat_gaussian_init,
            )
        else:
            particles = init_uniform(k_init, n, grid_map)
        w_init = 1e-3 if config.ref_compat_w_init else 1.0 / n
        return make_state(particles, n, k_state, n_max, w_init=w_init)

    @jax.jit
    def run(state, ranges_seq, angles, deltas):
        """lax.scan the full trajectory: (T, M) ranges, (M,) angles, (T, 3)
        deltas -> (final state, stacked StepInfo)."""

        def body(s, inputs):
            r, d = inputs
            s, info = step(s, r, angles, d)
            return s, info

        return jax.lax.scan(body, state, (ranges_seq, deltas))

    return FilterModel(
        config=config,
        grid_map=grid_map,
        log_field=log_field,
        predict=predict,
        correct=correct,
        step=step,
        run=run,
        init=init,
    )


def make_run(config: FilterConfig, grid_map):
    return make_model(config, grid_map).run
