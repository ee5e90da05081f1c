"""Sensor models: likelihood field (the workhorse) and ray-cast beam model.

Replaces the reference's Numba kernels:
  * likelihood field: ``compute_likelihoods`` (parallel_utils.py:85-149)
  * beam model:       ``compute_likelihoods_raycast`` + ``raycast``
                      (parallel_utils.py:151-201, 4-29)

Design:
  * The per-(particle, beam) contribution in the likelihood field is
    ``log(max(z_hit * p_hit(d(cell)) + z_rand / max_range, 1e-6))`` — for
    *valid* beams (finite, r < max_range) this depends ONLY on the map cell
    the endpoint lands in.  So we precompute a per-map **log-likelihood
    table** ``L(cell)`` once (``log_likelihood_field``) and the entire sensor
    model collapses to: endpoint transform (two small matmuls) + one gather +
    a masked mean.  This is bit-equivalent in structure to the reference's
    inner loop but moves all transcendentals out of the hot path.
  * Endpoint computation is expressed as (N, 2) x (2, M) products — batched,
    static-shape, fusable; the table gather is the only irregular op.
  * The beam model's DDA march is a ``lax.scan``-free fixed-step walk over a
    static step axis with event masking (no data-dependent loop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mcmh_localization.config import FilterConfig

LOG_FLOOR = 1e-6        # probability floor (parallel_utils.py:141)
BLIND_SCORE = -50.0     # no-valid-beam penalty (parallel_utils.py:147)
RAY_STEP = 0.1          # DDA step in meters (parallel_utils.py:10)
# Score for poses on non-free cells under motion_validity="score" — must be
# decisively below any real score so MH rejects and resampling starves them
# (replaces the reference's motion-model rejection, parallel_utils.py:339-361)
INVALID_SCORE = -100.0


# ---------------------------------------------------------------------------
# Likelihood-field model
# ---------------------------------------------------------------------------

def log_likelihood_field(grid_map, config: FilterConfig) -> jnp.ndarray:
    """Per-cell log mixture weight L(cell), (H, W) float32.

    L = log(max(z_hit * N(d; 0, sigma_hit) + z_rand / max_range, 1e-6)) with
    the reference's ``p_hit = 0`` cutoff for d > max_range
    (parallel_utils.py:135-141).  Depends only on the map and config, so it
    is computed once per (map, config) and reused for every scan.
    """
    d = grid_map.distance
    sigma = config.sigma_hit
    p_hit = jnp.exp(-0.5 * (d * d) / (sigma * sigma)) / jnp.sqrt(
        2.0 * jnp.pi * sigma * sigma
    )
    p_hit = jnp.where(d <= config.max_range, p_hit, 0.0)
    p = config.z_hit * p_hit + config.z_rand / config.max_range
    return jnp.log(jnp.maximum(p, LOG_FLOOR)).astype(jnp.float32)


def scan_endpoints(
    particles: jnp.ndarray, ranges: jnp.ndarray, angles: jnp.ndarray
):
    """World-frame endpoints of every beam from every particle.

    particles: (N, 3); ranges/angles: (M,).  Returns (lx, ly), each (N, M).

    lx = x + cos(theta) * u - sin(theta) * v,  u = r cos(a), v = r sin(a)
    — the rotation is factored so the (N, M) computation is two outer
    products instead of per-element trig over N x M
    (the reference recomputes cos/sin per particle-beam pair,
    parallel_utils.py:126-127).
    """
    u = ranges * jnp.cos(angles)  # (M,)
    v = ranges * jnp.sin(angles)
    cos_t = jnp.cos(particles[:, 2])[:, None]  # (N, 1)
    sin_t = jnp.sin(particles[:, 2])[:, None]
    lx = particles[:, 0][:, None] + cos_t * u[None, :] - sin_t * v[None, :]
    ly = particles[:, 1][:, None] + sin_t * u[None, :] + cos_t * v[None, :]
    return lx, ly


def likelihood_field_scores(
    particles: jnp.ndarray,
    ranges: jnp.ndarray,
    angles: jnp.ndarray,
    grid_map,
    config: FilterConfig,
    log_field: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Per-particle log-likelihood scores, (N,) float32.

    Semantics match compute_likelihoods (parallel_utils.py:85-149):
      * beams subsampled with stride ``config.step``;
      * a beam is *valid* iff finite and r < max_range; invalid beams are
        ignored entirely;
      * valid beams whose endpoint falls OUTSIDE the map still count in the
        averaging denominator but contribute 0 (the reference's
        count-then-continue at :124-131);
      * score = sum(log p) / valid_count, or -50 if no valid beams.
    """
    if log_field is None:
        log_field = log_likelihood_field(grid_map, config)

    if config.step > 1:
        ranges = ranges[:: config.step]
        angles = angles[:: config.step]

    valid = jnp.isfinite(ranges) & (ranges < config.max_range)  # (M,)
    safe_ranges = jnp.where(valid, ranges, 0.0)

    lx, ly = scan_endpoints(particles, safe_ranges, angles)  # (N, M)
    mx, my = grid_map.world_to_grid(lx, ly)
    in_map = grid_map.in_bounds(mx, my)

    # (N, M) table lookup — the hot op
    myc = jnp.clip(my, 0, grid_map.height - 1)
    mxc = jnp.clip(mx, 0, grid_map.width - 1)
    contrib = jnp.where(valid[None, :] & in_map, log_field[myc, mxc], 0.0)

    count = jnp.sum(valid)
    total = jnp.sum(contrib, axis=1)
    if config.score_aggregation == "sum":
        score = total
    else:
        score = total / jnp.maximum(count, 1)
    return jnp.where(count > 0, score, BLIND_SCORE).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Ray-cast beam model
# ---------------------------------------------------------------------------

def raycast(
    pose_xy: jnp.ndarray,
    angles: jnp.ndarray,
    grid_map,
    max_range: float,
    step: float = RAY_STEP,
    hit_unknown: bool = False,
) -> jnp.ndarray:
    """Fixed-step ray march; returns predicted range per angle, (M,).

    Matches ``raycast`` (parallel_utils.py:4-29): march in ``step``-meter
    increments from i=1; leaving the map returns max_range; the first cell
    with occupancy > 0.5 (i.e. occupied=100; unknown=-1 passes through, as
    in the reference's ``grid_map[gy, gx] > 0.5`` on trinary data) returns
    i * step.

    ``hit_unknown=True`` treats unknown (-1) cells as obstacles too — used
    by the synthetic scan simulator so generated scans are consistent with
    the likelihood field's EDT, which counts unknown as occupied
    (amcmh_localizer.py:153).
    """
    n_steps = int(max_range / step)
    dists = (jnp.arange(1, n_steps + 1, dtype=jnp.float32) * step)  # (S,)
    dx = jnp.cos(angles)[:, None] * dists[None, :]  # (M, S)
    dy = jnp.sin(angles)[:, None] * dists[None, :]
    px = pose_xy[0] + dx
    py = pose_xy[1] + dy
    mx, my = grid_map.world_to_grid(px, py)
    out = ~grid_map.in_bounds(mx, my)                      # leaving the map
    occ = grid_map.occupancy_at(mx, my, fill=0)
    hit = (occ > 50) | (hit_unknown & (occ != 0))          # occupied cell
    event = out | hit                                       # (M, S)
    any_event = jnp.any(event, axis=1)
    first = jnp.argmax(event, axis=1)                       # first event idx
    first_is_hit = jnp.take_along_axis(hit, first[:, None], axis=1)[:, 0]
    d_event = jnp.where(first_is_hit, dists[first], max_range)
    return jnp.where(any_event, d_event, jnp.float32(max_range))


def raycast_beam_scores(
    particles: jnp.ndarray,
    ranges: jnp.ndarray,
    angles: jnp.ndarray,
    grid_map,
    sigma_hit: float = 0.05,
    z_hit: float = 0.8,
    z_rand: float = 0.1,
    max_range: float = 10.0,
    chunk: int = 64,
    aggregation: str = "mean",
) -> jnp.ndarray:
    """Per-particle log-likelihood under the beam (ray-cast) model, (N,).

    Matches compute_likelihoods_raycast (parallel_utils.py:151-201),
    including its hard-coded defaults.  Deviation: the reference's -inf
    blind-particle penalty is replaced by the finite BLIND_SCORE (-50) the
    likelihood-field path uses — an all--inf score vector would make
    softmax_weights produce NaN (exp(-inf - (-inf))) and poison the filter
    state; -50 keeps the zero-valid-beam scan a no-op like the reference's
    lidar_callback early-return intends.
    Particles are processed in chunks to bound the (chunk, M, S) working set.
    """
    valid = jnp.isfinite(ranges) & (ranges < max_range)  # (M,)
    count = jnp.sum(valid)
    inv_sqrt = 1.0 / (jnp.sqrt(2.0 * jnp.pi) * sigma_hit)
    p_rand = 1.0 / max_range

    def score_one(p):
        r_pred = raycast(p[:2], p[2] + angles, grid_map, max_range)  # (M,)
        prob_hit = inv_sqrt * jnp.exp(
            -0.5 * ((ranges - r_pred) / sigma_hit) ** 2
        )
        # reference p_hit guard: 0 <= r <= max_range (true for valid beams)
        prob = z_hit * prob_hit + z_rand * p_rand
        logp = jnp.log(jnp.maximum(prob, LOG_FLOOR))
        return jnp.sum(jnp.where(valid, logp, 0.0))

    n = particles.shape[0]
    pad = (-n) % chunk
    padded = jnp.pad(particles, ((0, pad), (0, 0)))
    chunks = padded.reshape(-1, chunk, 3)
    totals = jax.lax.map(jax.vmap(score_one), chunks).reshape(-1)[:n]
    if aggregation == "sum":
        score = totals
    else:
        score = totals / jnp.maximum(count, 1)
    return jnp.where(count > 0, score, BLIND_SCORE).astype(jnp.float32)


def wrap_score_with_validity(score, grid_map, config, ranges):
    """Wrap a scorer so poses on non-free cells take INVALID_SCORE — the
    motion_validity="score" penalty for scorers that do not fold it into
    their own field build (exact/beam-table/dense/lidar3d).  Shared
    by filter/step.py and parallel/distributed.py so the semantics cannot
    drift between the single-chip and distributed paths."""
    rr = ranges[:: config.step] if config.step > 1 else ranges
    n_valid = jnp.sum(jnp.isfinite(rr) & (rr < config.max_range))
    pen = (
        INVALID_SCORE * jnp.maximum(n_valid, 1).astype(jnp.float32)
        if config.score_aggregation == "sum"
        else jnp.float32(INVALID_SCORE)
    )

    def wrapped(p):
        return jnp.where(grid_map.valid_mask(p), score(p), pen)

    return wrapped
