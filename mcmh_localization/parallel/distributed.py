"""Explicit multi-chip execution: shard_map step with bounded collectives.

Round-1's GSPMD path (parallel/sharding.py) is correct but lets XLA
all-gather the FULL particle set every step (the resamplers index the global
array) and replicates the correlation-field build on every chip.  This
module is the designed multi-chip execution, replacing the reference's only
parallelism (Numba prange over particles, parallel_utils.py:85):

  * particles sharded over a 1-D ``"data"`` mesh axis; the map, scan, and
    scalars replicated;
  * scoring: correlation-field build THETA-SHARDED (each chip builds
    n_theta/D bins, one small-field all_gather of ~K*win^2*4 bytes — the
    build cost was the dominant replicated work);
  * weight normalization / augmented-MCL signal / ESS / estimate: scalar
    psum/pmax only;
  * resampling: per-shard (stratified "island") systematic/KLD resampling —
    each chip resamples its local shard to the same count — plus a ring
    MIGRATION of a fixed particle block (ppermute) every step to mix
    islands.  No collective ever moves O(N) particle data: the exchanged
    block is nl/8 particles (nl = N/D).

Design note (deviation from a textbook global resampler, documented):
exact global systematic resampling would require redistributing a
data-dependent number of particles between chips — unbounded buffers under
XLA's static shapes.  Per-shard stratified resampling with equal allocation
is the standard distributed-PF compromise (island particle models /
"resampling with non-proportional allocation", Bolic et al. 2005): each
island resamples locally, and inter-island mass imbalance mixes away
through the per-step ring migration (full mixing in D steps, D = chips).
Filter-level tracking equivalence is asserted in tests/test_distributed.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.4.35 moved shard_map
    from jax.experimental.shard_map import shard_map
except ImportError:  # pragma: no cover
    from jax import shard_map  # type: ignore

from mcmh_localization import dispatch
from mcmh_localization.config import FilterConfig
from mcmh_localization.filter.estimate import PoseEstimate
from mcmh_localization.filter.init import init_uniform
from mcmh_localization.filter.mh import asymmetric_mh, symmetric_mh
from mcmh_localization.filter.state import FilterState
from mcmh_localization.filter.step import StepInfo, state_size
from mcmh_localization.models.motion import (
    invert_delta,
    motion_density,
    sample_motion,
)
from mcmh_localization.models.sensor import log_likelihood_field
from mcmh_localization.ops.resampling import (
    kld_resample,
    multinomial_resample_indices,
    systematic_resample_particles,
)
from mcmh_localization.parallel.sharding import make_mesh, shard_state
from mcmh_localization.utils.angles import normalize_angle_about


# ---------------------------------------------------------------------------
# collective-aware numerics (mirror filter/step.py's single-chip versions)
# ---------------------------------------------------------------------------

def softmax_weights_dist(scores, mask, axis):
    """Globally-normalized softmax over sharded scores
    (ops/resampling.py::softmax_weights with psum/pmax)."""
    scores = jnp.where(mask, scores, -jnp.inf)
    m = jax.lax.pmax(jnp.max(scores), axis)
    w = jnp.where(mask, jnp.exp(scores - m), 0.0)
    return w / jax.lax.psum(jnp.sum(w), axis)


def estimate_pose_dist(particles, weights, mask, axis) -> PoseEstimate:
    """filter/estimate.py::estimate_pose with global psum reductions."""
    w = jnp.where(mask, weights, 0.0)
    v1 = jax.lax.psum(jnp.sum(w), axis)
    wn = w / jnp.maximum(v1, 1e-30)
    mean_xy = jax.lax.psum(jnp.sum(particles[:, :2] * wn[:, None], axis=0), axis)
    cos_m = jax.lax.psum(jnp.sum(jnp.cos(particles[:, 2]) * wn), axis)
    sin_m = jax.lax.psum(jnp.sum(jnp.sin(particles[:, 2]) * wn), axis)
    mean_theta = jnp.arctan2(sin_m, cos_m)
    mean = jnp.concatenate([mean_xy, mean_theta[None]])
    res = jnp.stack(
        [
            particles[:, 0] - mean_xy[0],
            particles[:, 1] - mean_xy[1],
            normalize_angle_about(particles[:, 2], mean_theta),
        ],
        axis=1,
    )
    res = jnp.where(mask[:, None], res, 0.0)
    v2 = jax.lax.psum(jnp.sum(wn * wn), axis)
    denom = jnp.maximum(1.0 - v2, 1e-12)
    cov = jax.lax.psum((res * wn[:, None]).T @ res, axis) / denom
    return PoseEstimate(mean=mean, cov=cov)


def _global_top_pose(particles, w, axis):
    """Pose of the globally-highest-weight particle across shards: local
    argmax, then pmax + first-shard tiebreak + psum broadcast (3 scalar
    collectives; no particle data moves)."""
    i = jnp.argmax(w)
    w_best = w[i]
    cand = particles[i]
    wmax = jax.lax.pmax(w_best, axis)
    ax = jax.lax.axis_index(axis)
    is_max = w_best >= wmax
    first_ax = jax.lax.pmin(jnp.where(is_max, ax, jnp.int32(2 ** 30)), axis)
    return jax.lax.psum(
        jnp.where(is_max & (ax == first_ax), cand, jnp.zeros(3)), axis
    )


def estimate_pose_cluster_dist(
    particles, weights, mask, axis, radius_xy, radius_theta, anchor=None
) -> PoseEstimate:
    """filter/estimate.py::estimate_pose_cluster, global anchor via pmax;
    ``anchor`` = explicit center (estimate_mode="anchor", replicated)."""
    w = jnp.where(mask, weights, 0.0)
    if anchor is None:
        anchor = _global_top_pose(particles, w, axis)
    dx = particles[:, 0] - anchor[0]
    dy = particles[:, 1] - anchor[1]
    dth = jnp.abs(normalize_angle_about(particles[:, 2], anchor[2]))
    near = (dx * dx + dy * dy <= radius_xy * radius_xy) & (dth <= radius_theta)
    return estimate_pose_dist(particles, weights, near & mask, axis)


# ---------------------------------------------------------------------------
# the sharded step body (runs per shard under shard_map)
# ---------------------------------------------------------------------------

def _dist_window_origin(particles, mask, count, grid_map, config, axis,
                        n_theta=None, prev_particles=None, anchor=None,
                        delta=None):
    """THETA center pooled over BOTH scored sets when ``prev_particles``
    is given; spatial center on the current set only — same rationale as
    filter/step.py::_window_origin.  With config.window_center="anchor"
    (and ``anchor`` given, replicated across shards), the window centers
    on the top-weight pose instead — see filter/step.py."""
    inv_res = 1.0 / grid_map.resolution
    half = config.corr_window_cells // 2
    if config.window_center == "anchor" and anchor is not None:
        from mcmh_localization.utils.angles import normalize_angle

        cx, cy = anchor[0], anchor[1]
        mean_t = anchor[2]
        if prev_particles is not None and delta is not None:
            mean_t = normalize_angle(mean_t - 0.5 * (delta[0] + delta[2]))
        ox0 = ((cx - grid_map.origin[0]) * inv_res).astype(jnp.int32) - half
        oy0 = ((cy - grid_map.origin[1]) * inv_res).astype(jnp.int32) - half
        if not config.corr_theta_window_bins:
            return oy0, ox0
        k = n_theta if n_theta is not None else config.corr_n_theta
        kmid = (
            ((mean_t + jnp.pi) * (k / (2.0 * jnp.pi))).astype(jnp.int32) % k
        )
        kstart = (kmid - config.corr_theta_window_bins // 2) % k
        return oy0, ox0, kstart
    n = jnp.maximum(jax.lax.psum(jnp.sum(mask), axis), 1)
    sx = jax.lax.psum(jnp.sum(jnp.where(mask, particles[:, 0], 0.0)), axis)
    sy = jax.lax.psum(jnp.sum(jnp.where(mask, particles[:, 1], 0.0)), axis)
    ox0 = ((sx / n - grid_map.origin[0]) * inv_res).astype(jnp.int32) - half
    oy0 = ((sy / n - grid_map.origin[1]) * inv_res).astype(jnp.int32) - half
    if config.corr_theta_window_bins:
        sets = (
            (particles, prev_particles) if prev_particles is not None
            else (particles,)
        )
        c = jax.lax.psum(
            sum(jnp.sum(jnp.where(mask, jnp.cos(p[:, 2]), 0.0))
                for p in sets), axis)
        s = jax.lax.psum(
            sum(jnp.sum(jnp.where(mask, jnp.sin(p[:, 2]), 0.0))
                for p in sets), axis)
        mean_t = jnp.arctan2(s, c)
        k = n_theta if n_theta is not None else config.corr_n_theta
        kmid = (
            ((mean_t + jnp.pi) * (k / (2.0 * jnp.pi))).astype(jnp.int32) % k
        )
        kstart = (kmid - config.corr_theta_window_bins // 2) % k
        return oy0, ox0, kstart
    return oy0, ox0


def _dist_scorer(ranges, angles, grid_map, log_field, config, axis, n_dev,
                 window_origin):
    """Likelihood scorer for a local shard; corr builds are theta-sharded.
    lidar3d is fully shard-local (the voxel-map score volume is replicated
    — ~map bytes, small next to the particle shards; the per-particle
    trilinear lookups have no cross-shard structure)."""
    if config.sensor_model == "lidar3d":
        from mcmh_localization.models.sensor3d import lidar3d_scores

        # log_field carries the VoxelMap pytree (filter/step.py::
        # _sensor_table); angles carries (M, 2) [azimuth, elevation]
        return functools.partial(
            lidar3d_scores,
            ranges=ranges, directions=angles, voxel_map=log_field,
            config=config, sensor_z=config.lidar3d_sensor_z,
        )
    impl = dispatch.likelihood_impl(config)
    if config.sensor_model == "likelihood_field" and impl == "corr":
        from mcmh_localization.models.corr_field import (
            correlation_field_scores,
        )

        # the sharded build slices the ACTIVE bin set, mirroring the
        # scorer's own resolution: the theta window's bins only when the
        # spatial window is actually in effect (a window covering the
        # whole map is disabled inside correlation_field_scores), else
        # all corr_n_theta bins
        tw = config.corr_theta_window_bins
        h, w = grid_map.occupancy.shape
        win_on = (
            bool(config.corr_window_cells)
            and config.corr_window_cells < min(h, w)
            and window_origin is not None
        )
        theta_win_on = (
            bool(tw) and win_on
            and window_origin is not None and len(window_origin) == 3
        )
        active_bins = tw if theta_win_on else config.corr_n_theta
        shard_ok = active_bins % n_dev == 0 and active_bins >= n_dev
        return functools.partial(
            correlation_field_scores,
            ranges=ranges, angles=angles, grid_map=grid_map, config=config,
            log_field=log_field, n_theta=config.corr_n_theta,
            window_origin=window_origin,
            shard_bins_axis=axis if shard_ok else None,
        )
    if config.sensor_model == "beam":
        beam_impl = dispatch.beam_impl(config)
        if beam_impl == "field":
            # theta-sharded per-scan score-field build (the build is the
            # dominant per-scan cost; embarrassingly parallel over bins,
            # models/range_table.py::_sharded_bin_stack)
            from mcmh_localization.models.range_table import (
                beam_field_scores,
            )

            tw = config.corr_theta_window_bins
            theta_win_on = (
                bool(tw) and window_origin is not None
                and len(window_origin) == 3
            )
            active_bins = tw if theta_win_on else config.beam_table_n_theta
            shard_ok = active_bins % n_dev == 0 and active_bins >= n_dev
            return functools.partial(
                beam_field_scores,
                ranges=ranges, angles=angles, grid_map=grid_map,
                config=config, table=log_field,
                n_theta=config.beam_table_n_theta,
                window_origin=window_origin,
                shard_bins_axis=axis if shard_ok else None,
            )
        if beam_impl == "table":
            # fully local per particle: the cell-major LUT lookup has no
            # cross-shard structure (replicated table)
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

        return functools.partial(
            raycast_beam_scores,
            ranges=ranges[:: config.step] if config.step > 1 else ranges,
            angles=angles[:: config.step] if config.step > 1 else angles,
            grid_map=grid_map,
            sigma_hit=config.sigma_hit, z_hit=config.z_hit,
            z_rand=config.z_rand, max_range=config.max_range,
            aggregation=config.score_aggregation,
        )
    if config.sensor_model != "likelihood_field":  # pragma: no cover
        raise ValueError(f"unknown sensor_model {config.sensor_model!r}")
    from mcmh_localization.models.sensor import likelihood_field_scores

    return functools.partial(
        likelihood_field_scores,
        ranges=ranges, angles=angles, grid_map=grid_map, config=config,
        log_field=log_field,
    )


def _dist_step(
    state: FilterState,
    ranges,
    angles,
    delta,
    *,
    grid_map,
    log_field,
    config: FilterConfig,
    axis: str,
    n_dev: int,
    migrate: int,
):
    nl = state.particles.shape[0]  # local shard size
    ax = jax.lax.axis_index(axis)
    key, k_motion, k_mh, k_rs, k_rand = jax.random.split(state.key, 5)
    k_motion_l = jax.random.fold_in(k_motion, ax)
    k_mh_l = jax.random.fold_in(k_mh, ax)
    k_rs_l = jax.random.fold_in(k_rs, ax)
    k_rand_l = jax.random.fold_in(k_rand, ax)

    count_l = state.count // n_dev  # invariant: count is a multiple of n_dev
    mask = jnp.arange(nl) < count_l

    # ---- predict (motion proposal), fully local
    retries = 0 if config.motion_validity == "score" else config.motion_retries
    proposed = sample_motion(
        k_motion_l, state.particles, delta, config.alpha, grid_map,
        retries=retries, rng_impl=config.motion_rng,
    )
    prev = state.particles
    from mcmh_localization.filter.step import advance_anchor

    state = state.replace(
        prev_particles=prev, particles=proposed,
        delta=delta.astype(jnp.float32),
        anchor=advance_anchor(state.anchor, delta),
    )

    # ---- correct: global softmax over theta-sharded corr/beam scores
    beam_field = (
        config.sensor_model == "beam"
        and dispatch.beam_impl(config) == "field"
    )
    corr_field = (
        config.sensor_model == "likelihood_field"
        and dispatch.likelihood_impl(config) == "corr"
    )
    if beam_field:
        wo = _dist_window_origin(
            state.particles, mask, state.count, grid_map, config, axis,
            n_theta=config.beam_table_n_theta,
            prev_particles=state.prev_particles if config.use_mh else None,
            anchor=state.anchor, delta=state.delta,
        )
    elif config.corr_window_cells and corr_field:
        wo = _dist_window_origin(
            state.particles, mask, state.count, grid_map, config, axis,
            prev_particles=state.prev_particles if config.use_mh else None,
            anchor=state.anchor, delta=state.delta,
        )
    else:
        wo = None
    score = _dist_scorer(
        ranges, angles, grid_map, log_field, config, axis, n_dev, wo
    )
    if config.motion_validity == "score" and not (beam_field or corr_field):
        # the corr scorer folds the invalid-pose penalty into its field;
        # the exact scorer needs the explicit wrap (shared with
        # filter/step.py so the semantics cannot drift)
        from mcmh_localization.models.sensor import (
            wrap_score_with_validity,
        )

        score = wrap_score_with_validity(score, grid_map, config, ranges)

    # collapse INACTIVE padded slots onto an active pose before scoring —
    # stale padded poses spread across the map would count as window
    # escapees and force the coarse build every step (filter/step.py
    # parity)
    anchor = state.particles[0]
    p_sc = jnp.where(mask[:, None], state.particles, anchor)
    if config.use_mh:
        # ONE scorer invocation for both sets: shared field build
        # (filter/step.py parity)
        prev_sc = jnp.where(mask[:, None], prev, anchor)
        s_both = score(jnp.concatenate([p_sc, prev_sc]))
        s_post = s_both[:nl]
        weights_post = softmax_weights_dist(s_post, mask, axis)
        weights_pre = softmax_weights_dist(s_both[nl:], mask, axis)
    else:
        s_post = score(p_sc)
        weights_post = softmax_weights_dist(s_post, mask, axis)

    if config.use_mh:
        if config.asymmetric:
            # raw densities + global psum normalization (the single-chip
            # path normalizes over all N, filter/step.py:_transition_probabilities)
            fwd = motion_density(
                prev, state.particles, state.delta, config.alpha,
                normalize=False,
            )
            bwd_delta = invert_delta(
                state.delta, ref_compat=config.ref_compat_backward_delta
            )
            bwd = motion_density(
                state.particles, prev, bwd_delta, config.alpha,
                normalize=False,
            )
            fwd = fwd / jnp.maximum(jax.lax.psum(jnp.sum(fwd), axis), 1e-30)
            bwd = bwd / jnp.maximum(jax.lax.psum(jnp.sum(bwd), axis), 1e-30)
            particles, weights, accepted = asymmetric_mh(
                k_mh_l, prev, state.particles, weights_post, weights_pre,
                fwd, bwd, ref_compat_guard=config.ref_compat_assym_guard,
            )
        else:
            particles, weights, accepted = symmetric_mh(
                k_mh_l, prev, state.particles, weights_post, weights_pre,
            )
        accept_rate = jax.lax.psum(
            jnp.sum(jnp.where(mask, accepted, False)), axis
        ) / jnp.maximum(state.count, 1)
        state = state.replace(particles=particles)
    else:
        weights = weights_post
        accept_rate = jnp.float32(1.0)

    weights = jnp.where(mask, weights, 0.0)
    weights = weights / jnp.maximum(
        jax.lax.psum(jnp.sum(weights), axis), 1e-30
    )
    if config.use_adaptive:
        if config.ref_compat_w_avg:
            w_avg = jax.lax.psum(jnp.sum(weights), axis) / jnp.maximum(
                state.count, 1)
        else:
            sig = ranges[:: config.step] if config.step > 1 else ranges
            n_beams = jnp.sum(jnp.isfinite(sig) & (sig < config.max_range))
            per_beam = (
                s_post / jnp.maximum(n_beams, 1)
                if config.score_aggregation == "sum" else s_post
            )
            w_avg = jax.lax.psum(
                jnp.sum(jnp.where(mask, jnp.exp(per_beam), 0.0)), axis
            ) / jnp.maximum(state.count, 1)
        state = state.replace(
            w_slow=state.w_slow + config.alpha_slow * (w_avg - state.w_slow),
            w_fast=state.w_fast + config.alpha_fast * (w_avg - state.w_fast),
        )
    state = state.replace(weights=weights)

    # ---- window anchor refresh, cluster-mass gated (mirrors
    # filter/step.py's pre-resample refresh; masses are psum'd)
    from mcmh_localization.filter.estimate import cluster_mass

    cand = _global_top_pose(
        state.particles, jnp.where(mask, state.weights, 0.0), axis
    ).astype(jnp.float32)
    m_cand = jax.lax.psum(cluster_mass(
        state.particles, state.weights, cand,
        config.cluster_radius_xy, config.cluster_radius_theta, mask,
    ), axis)
    m_cur = jax.lax.psum(cluster_mass(
        state.particles, state.weights, state.anchor,
        config.cluster_radius_xy, config.cluster_radius_theta, mask,
    ), axis)
    d_xy = jnp.hypot(cand[0] - state.anchor[0], cand[1] - state.anchor[1])
    d_th = jnp.abs(normalize_angle_about(cand[2], state.anchor[2]))
    same_mode = (d_xy <= config.cluster_radius_xy) & (
        d_th <= config.cluster_radius_theta
    )
    # commitment hysteresis — filter/step.py::refresh_anchor parity
    mode_migrate = m_cand > config.anchor_hysteresis * m_cur
    if config.anchor_score_margin > 0.0:
        # evidence veto (config.anchor_score_margin), pmax'd across
        # islands — filter/step.py::refresh_anchor parity
        w_all = jnp.where(mask, state.weights, 0.0)
        d2 = (
            (state.particles[:, 0] - state.anchor[0]) ** 2
            + (state.particles[:, 1] - state.anchor[1]) ** 2
        )
        inc = (d2 <= config.cluster_radius_xy ** 2) & (
            jnp.abs(
                normalize_angle_about(state.particles[:, 2], state.anchor[2])
            ) <= config.cluster_radius_theta
        )
        w_inc_top = jax.lax.pmax(jnp.max(jnp.where(inc, w_all, 0.0)), axis)
        w_cand_top = jax.lax.pmax(jnp.max(w_all), axis)
        # margin is in PER-BEAM units; the weight gap is in aggregation
        # units (filter/step.py::refresh_anchor score_scale) — ranges is
        # replicated, so the local count is the global one
        if config.score_aggregation == "sum":
            _sig = ranges[:: config.step] if config.step > 1 else ranges
            _scale = jnp.maximum(
                jnp.sum(jnp.isfinite(_sig) & (_sig < config.max_range)), 1
            ).astype(jnp.float32)
        else:
            _scale = 1.0
        mode_migrate = mode_migrate & (
            w_inc_top
            < w_cand_top * jnp.exp(-config.anchor_score_margin * _scale)
        )
    # debounced commitment (config.anchor_commit_scans) — refresh_anchor
    # parity; the streak is replicated, so no collective is needed
    challenge = mode_migrate & ~same_mode
    streak = jnp.where(
        challenge, state.anchor_streak + 1, 0
    ).astype(jnp.int32)
    mode_migrate = mode_migrate & (streak >= config.anchor_commit_scans)
    adopt = same_mode | mode_migrate
    anchor_mass = jnp.where(adopt, m_cand, m_cur)
    state = state.replace(
        anchor=jnp.where(adopt, cand, state.anchor).astype(jnp.float32),
        anchor_streak=jnp.where(mode_migrate, 0, streak),
    )

    # ---- estimate (global reductions)
    if config.estimate_mode in ("cluster", "anchor"):
        est = estimate_pose_cluster_dist(
            state.particles, state.weights, mask, axis,
            config.cluster_radius_xy, config.cluster_radius_theta,
            anchor=(state.anchor if config.estimate_mode == "anchor"
                    else None),
        )
    else:
        est = estimate_pose_dist(state.particles, state.weights, mask, axis)
    ess = 1.0 / jnp.maximum(
        jax.lax.psum(jnp.sum(state.weights * state.weights), axis), 1e-30
    )

    # ---- per-shard (island) resampling; count invariant kept multiple of D
    p_random = jnp.float32(0.0)
    if config.use_adaptive:
        p_random = jnp.maximum(0.0, 1.0 - state.w_fast / (state.w_slow + 1e-9))
        p_random = jnp.where(
            p_random >= config.min_injection_prob, p_random, 0.0
        )
        n_drop_l = (p_random * count_l.astype(jnp.float32)).astype(jnp.int32)
        if config.injection_refill:
            # escalation refill (config.injection_refill; filter/step.py
            # ::_resample_kld twin): the fresh-uniform block scales with
            # the ISLAND capacity so a fitness collapse regrows each
            # island's count toward nl — recovery coverage the monotone
            # systematic-KLD count otherwise lacks (see config.py)
            n_random_l = (p_random * jnp.float32(nl)).astype(jnp.int32)
        else:
            n_random_l = n_drop_l
        if config.adaptive_resampler == "kld":
            samples, n_kept = kld_resample(
                k_rs_l, state.particles, state.weights,
                max_samples=nl,
                min_particles=max(config.min_particles // n_dev, 1),
                bin_size_xy=config.kld_bin_size_xy,
                bin_size_theta=config.kld_bin_size_theta,
                # the Fox bound is a GLOBAL criterion: stop when the
                # global sample count M = m * n_dev exceeds
                # chi2(k)/(2 eps), i.e. per-island m > chi2(k)/(2 eps
                # n_dev) — islands are iid subsamples of one posterior,
                # so k_island ~= k_global.  An unscaled eps leaves the
                # bound above the island size nl for moderate k and the
                # island stop can NEVER fire (measured: the staged dist
                # count pegged at capacity and never shrank)
                epsilon=config.kld_epsilon * n_dev,
                z=config.kld_z,
                count=count_l - n_drop_l,
                # per-shard scaling mirrors min_particles // n_dev: an
                # unscaled global window would exceed the shard size and
                # silently disable the prefix evaluation.  The clamp keeps
                # the window STRICTLY above the per-shard min actually
                # passed to kld_resample — with min_particles < n_dev both
                # terms would otherwise collapse to equal values and
                # silently disable the KLD stop the config-level
                # validation (kld_eval_window > min_particles) guarantees
                eval_window=(
                    max(config.kld_eval_window // n_dev,
                        max(config.min_particles // n_dev, 1) + 1)
                    if config.kld_eval_window else 0
                ),
                stop_rule=(
                    "new_bin" if config.ref_compat_kld_newbin_stop
                    else "every_sample"
                ),
            )
            n_kept = jnp.minimum(n_kept, count_l - n_drop_l)
            # all shards adopt the max island count (conservative: never
            # fewer particles than the KLD bound demands anywhere)
            new_count_l = jnp.clip(
                jax.lax.pmax(n_random_l + n_kept, axis),
                max(config.min_particles // n_dev, 1), nl,
            ).astype(jnp.int32)
            randoms = init_uniform(k_rand_l, nl, grid_map)
            # randoms in the FIRST slots (reference order; the next step's
            # KLD stop counts bins in slot order — see filter/step.py)
            slot = jnp.arange(nl)
            shifted = jnp.roll(samples, n_random_l, axis=0)
            particles = jnp.where(
                (slot < n_random_l)[:, None], randoms, shifted
            )
            new_mask = slot < new_count_l
            new_weights = jnp.where(
                new_mask,
                1.0 / (new_count_l * n_dev).astype(jnp.float32), 0.0,
            )
            state = state.replace(
                particles=particles, weights=new_weights,
                count=new_count_l * n_dev,
            )
        else:  # "simple" | "lvr": fixed count, local injection
            if config.adaptive_resampler == "simple":
                idx = multinomial_resample_indices(k_rs_l, state.weights, nl)
                randoms = init_uniform(k_rand_l, nl, grid_map)
                slot = jnp.arange(nl)
                particles = jnp.where(
                    (slot < count_l - n_drop_l)[:, None],
                    state.particles[idx], randoms,
                )
            else:
                k_inj_l, k_coin_l = jax.random.split(k_rand_l)
                resampled = systematic_resample_particles(
                    k_rs_l, state.particles, state.weights, nl, count=count_l)
                randoms = init_uniform(k_inj_l, nl, grid_map)
                coins = jax.random.uniform(k_coin_l, (nl,)) < p_random
                particles = jnp.where(coins[:, None], randoms, resampled)
            new_weights = jnp.where(
                mask, 1.0 / jnp.maximum(state.count, 1).astype(jnp.float32), 0.0
            )
            state = state.replace(particles=particles, weights=new_weights)
    else:
        state = state.replace(particles=systematic_resample_particles(
            k_rs_l, state.particles, state.weights, nl, count=count_l))

    # ---- ring migration: rotate a fixed block to the next island
    if migrate > 0 and n_dev > 1:
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        block = jax.lax.ppermute(state.particles[:migrate], axis, perm)
        state = state.replace(
            particles=state.particles.at[:migrate].set(block)
        )

    state = state.replace(key=key)
    info = StepInfo(
        estimate=est, ess=ess, accept_rate=accept_rate, count=state.count,
        p_random=p_random, w_slow=state.w_slow, w_fast=state.w_fast,
        anchor_mass=anchor_mass,
    )
    return state, info


# ---------------------------------------------------------------------------
# public factory
# ---------------------------------------------------------------------------

class DistModel(NamedTuple):
    config: FilterConfig
    grid_map: object
    mesh: Mesh
    step: object
    run: object
    init: object


def make_dist_model(
    config: FilterConfig, grid_map, mesh: Mesh, axis: str = "data",
    migration_fraction: float = 0.125, voxel_map=None,
) -> DistModel:
    """Build the explicit shard_map step (all 6 modes; likelihood_field,
    beam, and lidar3d sensor models — lidar3d's score volume is
    replicated, its lookups shard-local).

    Particle counts are rounded up so num/max particles divide evenly by the
    mesh size (the count invariant keeps every island the same size).
    """
    if config.sensor_model not in ("likelihood_field", "beam", "lidar3d"):
        raise ValueError(
            f"unknown sensor_model {config.sensor_model!r}"
        )
    n_dev = int(mesh.devices.size)

    def _round(x):
        return -(-x // n_dev) * n_dev

    config = config.replace(
        num_particles=_round(config.num_particles),
        max_particles=_round(state_size(config)),
        min_particles=max(_round(config.min_particles), n_dev),
    )
    n_max = state_size(config)
    nl = n_max // n_dev
    migrate = int(nl * migration_fraction)
    from mcmh_localization.filter.step import _sensor_table

    log_field = _sensor_table(grid_map, config, voxel_map)

    state_specs = FilterState(
        particles=P(axis, None),
        prev_particles=P(axis, None),
        weights=P(axis),
        count=P(),
        w_slow=P(),
        w_fast=P(),
        delta=P(),
        anchor=P(),
        anchor_streak=P(),
        key=P(),
    )
    body = functools.partial(
        _dist_step, grid_map=grid_map, log_field=log_field, config=config,
        axis=axis, n_dev=n_dev, migrate=migrate,
    )
    sm = shard_map(
        body, mesh=mesh,
        in_specs=(state_specs, P(), P(), P()),
        out_specs=(state_specs, P()),
        check_rep=False,
    )
    step = jax.jit(sm)

    from mcmh_localization.filter.step import make_model

    base = make_model(config, grid_map, voxel_map=voxel_map)

    def init(key, **kw) -> FilterState:
        return shard_state(base.init(key, **kw), mesh, axis)

    @jax.jit
    def run(state, ranges_seq, angles, deltas):
        def scan_body(s, inputs):
            r, d = inputs
            s, info = sm(s, r, angles, d)
            return s, info

        return jax.lax.scan(scan_body, state, (ranges_seq, deltas))

    return DistModel(
        config=config, grid_map=grid_map, mesh=mesh,
        step=step, run=run, init=init,
    )
