"""Precomputed ray-cast range table — the beam sensor model at scale.

Replaces the per-(particle, beam) DDA march of
``compute_likelihoods_raycast`` + ``raycast`` (parallel_utils.py:151-201,
4-29).  A literal port performs N x M x S map lookups per scan (3.6e9 at
100k particles x 360 beams x 100 steps).

The classic range-LUT trick (cf. range_libc/CDDT), built densely so the
*construction* is also gather-free:

  1. ONCE PER MAP, build ``R[k, cy, cx]`` = the reference-semantics raycast
     distance from the center of cell (cy, cx) along theta-bin center k.
     Key insight: from a CELL CENTER, the cell visited at march step i is
     ``(cy + dy_i, cx + dx_i)`` with offsets ``d*_i = floor(0.5 +
     i*step*cos/sin(theta_k)/res)`` INDEPENDENT of the cell — so one march
     step for ALL cells of a bin is a single shifted read of the occupancy
     grid (dense dynamic_slice), and the whole table is K x S shifted reads
     + first-event masking.  No random access anywhere.
  2. PER SCAN, the predicted range for (particle n, beam j) is one lookup
     ``R[bin(theta_n + a_j), cell_n]``, laid out CELL-MAJOR so all beams of
     a particle read one table row.

Approximation vs the reference (documented): the ray heading is quantized
to ``n_theta`` bins and the ray origin to the particle's cell center — the
same quantization class as the correlation field (models/corr_field.py),
exact when poses sit at cell centers and headings at bin centers.  One
genuine edge difference: the reference's ``int()`` truncation maps
world positions in (-1, 0) cells to index 0 instead of out-of-map
(parallel_utils.py:377-378 toward-zero truncation); the table build uses
floor semantics there.  Rays that terminate inside the map (any walled
environment) are unaffected.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.config import FilterConfig
from mcmh_localization.models.sensor import (
    BLIND_SCORE,
    LOG_FLOOR,
    RAY_STEP,
)


class BeamTables(NamedTuple):
    """Per-(map, config) precompute bundle for the beam score-field path.

    ``table`` is the f32 range table the fine window field is built from;
    ``qtc`` the block-center subsample of its quantized-index form
    (values index ``dvals``) for the coarse recovery-fallback field (None
    when the coarse fallback is disabled)."""

    table: jnp.ndarray        # (K, H, W) float32
    dvals: jnp.ndarray        # (nq,) float32 distinct range values
    qtc: jnp.ndarray | None   # (K, Hc, Wc) int8 or None


def quantize_table(table: jnp.ndarray, max_range: float,
                   step: float = RAY_STEP):
    """(K, H, W) f32 range table -> (int8 value-index table, (nq,) values).

    The table only ever contains ``i * step`` for i in [1, n_steps] plus
    ``max_range`` (map-exit rays) — ``nq = n_steps + 1`` distinct values —
    so the per-beam log-mixture of the beam model collapses to a (M, nq)
    LUT per scan (see _beam_coarse_field).  Exact: round-trip
    ``dvals[qt]`` reproduces the f32 table bit-for-bit.
    """
    n_steps = int(max_range / step)
    # float64 products rounded once to f32 — the exact values
    # build_range_table stores (its d_steps follows the same path)
    dvals = jnp.asarray(
        np.concatenate([np.arange(1, n_steps + 1) * step, [max_range]]),
        jnp.float32,
    )
    nq = int(dvals.shape[0])
    assert nq <= 127, "int8 quantized table needs max_range/step <= 126"
    qi = jnp.clip((table / step + 0.5).astype(jnp.int32) - 1, 0, n_steps - 1)
    qi = jnp.where(table >= jnp.float32(max_range), n_steps, qi)
    return qi.astype(jnp.int8), dvals


def make_beam_tables(grid_map, config: FilterConfig) -> BeamTables:
    """Build the full beam-field precompute bundle for a map."""
    return _as_beam_tables(
        build_range_table(
            grid_map, config.beam_table_n_theta, config.max_range
        ),
        config,
    )


def _as_beam_tables(table, config: FilterConfig) -> BeamTables:
    if isinstance(table, BeamTables):
        return table
    table = jnp.asarray(table)
    qt, dvals = quantize_table(table, config.max_range)
    qtc = None
    if config.corr_coarse_factor > 0:
        f = config.corr_coarse_factor
        qtc = qt[:, f // 2::f, f // 2::f]
    return BeamTables(table=table, dvals=dvals, qtc=qtc)


def build_range_table(
    grid_map,
    n_theta: int,
    max_range: float,
    step: float = RAY_STEP,
    hit_unknown: bool = False,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """(n_theta, H, W) raycast ranges from every cell center.

    Matches ``models.sensor.raycast`` (and therefore parallel_utils.py:4-29)
    at cell centers and bin-center angles: march i = 1..S in ``step``-meter
    increments; leaving the map returns max_range, the first cell with
    occupancy > 50 returns i*step (``hit_unknown`` also stops on unknown
    cells, the simulator convention).  Built once per (map, config); the
    build is dense shifted reads — see module docstring.
    """
    occ = grid_map.occupancy
    h, w = occ.shape
    res = float(jax.device_get(grid_map.resolution))
    n_steps = int(max_range / step)
    pad = int(np.ceil(max_range / res)) + 2

    # (K, S) integer cell offsets, concrete at trace time
    thetas = (
        -np.pi + (np.arange(n_theta) + 0.5) * (2.0 * np.pi / n_theta)
    )
    dists = (np.arange(1, n_steps + 1) * step)
    dx = np.floor(0.5 + np.outer(np.cos(thetas), dists) / res).astype(np.int32)
    dy = np.floor(0.5 + np.outer(np.sin(thetas), dists) / res).astype(np.int32)
    dx = jnp.asarray(dx + pad)  # slice starts into the padded grid
    dy = jnp.asarray(dy + pad)

    hit_grid = (occ > 50) | (hit_unknown & (occ != 0))
    hit_p = jnp.pad(hit_grid, pad, constant_values=False)
    in_p = jnp.pad(
        jnp.ones((h, w), dtype=bool), pad, constant_values=False
    )
    d_steps = jnp.asarray(dists, dtype=jnp.float32)

    def one_bin(dxy):
        dx_k, dy_k = dxy

        def body(i, carry):
            done, result = carry
            oy = dy_k[i]
            ox = dx_k[i]
            hit = jax.lax.dynamic_slice(hit_p, (oy, ox), (h, w))
            inb = jax.lax.dynamic_slice(in_p, (oy, ox), (h, w))
            event = hit | ~inb
            # first event wins: hit -> i*step, exit -> max_range
            d_evt = jnp.where(hit, d_steps[i], jnp.float32(max_range))
            result = jnp.where(~done & event, d_evt, result)
            return done | event, result

        init = (
            jnp.zeros((h, w), dtype=bool),
            jnp.full((h, w), max_range, dtype=jnp.float32),
        )
        _, result = jax.lax.fori_loop(0, n_steps, body, init)
        return result

    table = jax.lax.map(one_bin, (dx, dy))
    return table.astype(dtype)


def table_cell_major(table: jnp.ndarray) -> jnp.ndarray:
    """(K, H, W) -> (H*W, K): one row per cell, theta bins on the fast axis.

    The scan-time lookup gathers all M beams of a particle from its single
    cell row."""
    k, h, w = table.shape
    return table.transpose(1, 2, 0).reshape(h * w, k)


def _sharded_bin_stack(build_k, stack_k: int, axis: str | None):
    """Build a (stack_k, ...) per-theta-bin stack via ``build_k(rows)``,
    theta-sharded over a shard_map ``axis`` when set (the
    models/corr_field.py::_shard_bins idiom): each device builds
    stack_k/n_dev bins, one all_gather reassembles the stack.  Falls back
    to the local build when the bin count does not divide the axis
    (``jax.lax.psum(1, axis)`` constant-folds to the static axis size)."""
    rows_all = jnp.arange(stack_k, dtype=jnp.int32)
    if axis is None:
        return build_k(rows_all)
    ndev = jax.lax.psum(1, axis)
    if stack_k % ndev != 0 or stack_k < ndev:
        return build_k(rows_all)
    axd = jax.lax.axis_index(axis)
    kd = stack_k // ndev
    rows = jax.lax.dynamic_slice_in_dim(rows_all, axd * kd, kd, 0)
    return jax.lax.all_gather(build_k(rows), axis, axis=0, tiled=True)


def _beam_lut(safe_r, valid, dvals, config: FilterConfig) -> jnp.ndarray:
    """(M, nq) per-beam log-mixture at each quantized range value.

    lp[j, q] = log(max(z_hit * N(r_j - dvals[q]; sigma_hit) + z_rand /
    max_range, 1e-6)) — the beam model of compute_likelihoods_raycast
    (parallel_utils.py:151-201) evaluated once per (beam, distinct table
    value); invalid beams carry weight 0.
    """
    sigma = config.sigma_hit
    inv_sqrt = 1.0 / (jnp.sqrt(2.0 * jnp.pi) * sigma)
    ph = inv_sqrt * jnp.exp(
        -0.5 * ((safe_r[:, None] - dvals[None, :]) / sigma) ** 2
    )
    lp = jnp.log(jnp.maximum(
        config.z_hit * ph + config.z_rand / config.max_range, LOG_FLOOR
    ))
    return jnp.where(valid[:, None], lp, 0.0)


def _bin_lut_matrix(g, lp, n_theta):
    """S[k, g, q] = sum_{j: g[k, j] = g} lp[j, q] via a one-hot einsum.
    f32-exact (HIGHEST precision; the array is tiny).

    Fallback only: when the field-bin centers sit at integer-plus-half
    multiples of the TABLE bin width the matrix is exactly circulant and
    ``_rolled_bin_lut_matrix`` builds it from one (M -> K) einsum."""
    bg = (g[:, :, None] == jnp.arange(n_theta, dtype=jnp.int32)[None, None, :])
    return jnp.einsum(
        "kjg,jq->kgq", bg.astype(jnp.float32), lp,
        precision=jax.lax.Precision.HIGHEST,
    )


def _rolled_bin_lut_matrix(lp, angles, n_theta, starts, use_half):
    """S[b, g, q] = T[(g - starts[b]) % K, q] — the EXACT circulant
    structure of the bin-sum matrix.

    The table bin of beam j evaluated at field-bin center b is
    ``(s_b + d_j) mod K`` with a PER-BEAM offset d_j independent of b:
    for fine window bins (centers at (kstart + b + 0.5) * dtheta - pi),
    ``d_j = floor(0.5 + a_j / dtheta)`` and ``s_b = kstart + b``; for
    coarse bins with an integer width ratio r = K / kc,
    ``d_j = floor(a_j / dtheta + (0.5 if r odd))`` and
    ``s_b = r*b + floor(r / 2 or (r-1)/2)`` (callers pass the matching
    ``starts``/``use_half``).  So S collapses to ONE tiny (M -> K)
    offset-bin einsum building T[d, q] = sum_{j: d_j = d} lp[j, q],
    followed by B rolled slices of concat(T, T) — pure data movement.
    Bit-identical to ``_bin_lut_matrix`` (integer bin arithmetic is
    exact; the einsum contractions sum the same lp rows in the same
    one-beam-per-bin groups)."""
    k = n_theta
    dtheta = 2.0 * jnp.pi / k
    shift = 0.5 if use_half else 0.0
    d = jnp.floor(angles / dtheta + shift).astype(jnp.int32) % k   # (M,)
    oh = d[:, None] == jnp.arange(k, dtype=jnp.int32)[None, :]
    t = jnp.einsum(
        "jd,jq->dq", oh.astype(jnp.float32), lp,
        precision=jax.lax.Precision.HIGHEST,
    )
    tt = jnp.concatenate([t, t], axis=0)
    nq = t.shape[1]
    rows = [
        jax.lax.dynamic_slice(tt, ((k - s % k) % k, 0), (k, nq))
        for s in starts
    ]
    return jnp.stack(rows)


def _lut_field(qt: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """(B, C) float32: out[b, c] = sum_g s[b, g, qt[g, c]].

    qt: (K, C) quantized-range rows per table bin, values in [0, nq);
    s: (B, K, nq) per-(field-bin, table-bin) LUT.  One gather of K values
    per (bin, cell), bins processed one at a time."""
    q = qt.astype(jnp.int32)
    return jax.lax.map(
        lambda s_b: jnp.sum(jnp.take_along_axis(s_b, q, axis=1), axis=0), s
    )


def _beam_coarse_field(
    lp, count, angles, grid_map, tables: BeamTables,
    config: FilterConfig, n_theta: int,
    shard_bins_axis: str | None = None,
):
    """Coarse full-map fallback FIELD for the beam model — the
    recovery-parity twin of models/corr_field.py::_coarse_field
    (round-2 verdict: windowed beam escapees BLIND-scored and died, so
    augmented-MCL injection — amcmh_localizer.py:496-527 — could not
    recover a kidnapped robot under sensor_model="beam").  Split from the
    per-particle index math (``_beam_coarse_indices``) so the caller can
    gate THIS build behind an escapee-count predicate while the lookup
    stays unconditional.

    The field is evaluated at block-CENTER cells (``tables.qtc`` is the
    f-strided subsample of the quantized table) under a MILDLY optimistic
    per-beam LUT: lpc[j, q] = max over |q' - q| <= 1 of lp[j, q'],
    covering only the RAY_STEP range quantization.  Unlike the corr
    path's coarse field, NO block-level max is applied: block-center
    evaluation is an unbiased sample of the block (the corr field needed
    max-pooling because MEAN-pooling the log field systematically
    handicaps free-space poses near obstacles), and a wider window-max
    was measured to let routine theta-window escapees outscore the honest
    in-window cloud and drag tracking off (~1.1 m RMSE on the CPU house
    run).  Heading stays quantized to corr_coarse_n_theta bin centers,
    the same class of approximation as the corr coarse field.
    """
    from mcmh_localization.models.sensor import INVALID_SCORE

    f = config.corr_coarse_factor
    kc = config.corr_coarse_n_theta
    qtc = tables.qtc
    k_tab, hc, wc = qtc.shape

    slack = 1
    lpc = lp
    for sft in range(1, slack + 1):
        # edge-mode padding: the window clips at the q boundaries (zero
        # padding would lift the common max_range slot to max(lp, 0) = 0)
        lpc = jnp.maximum(
            lpc, jnp.pad(lp, ((0, 0), (sft, 0)), mode="edge")[:, :-sft]
        )
        lpc = jnp.maximum(
            lpc, jnp.pad(lp, ((0, 0), (0, sft)), mode="edge")[:, sft:]
        )

    dtheta = 2.0 * jnp.pi / n_theta
    if n_theta % kc == 0:
        # integer width ratio r: coarse centers land at r*i + r/2 table
        # bins, so the circulant construction applies (see
        # _rolled_bin_lut_matrix; r odd folds the half-bin into d_j)
        r = n_theta // kc
        sc = _rolled_bin_lut_matrix(
            lpc, angles, n_theta,
            [r * i + (r // 2 if r % 2 == 0 else (r - 1) // 2)
             for i in range(kc)],
            use_half=(r % 2 == 1),
        )
    else:
        centers_c = (jnp.arange(kc) + 0.5) * (2.0 * jnp.pi / kc) - jnp.pi
        gc = (
            jnp.floor(
                (centers_c[:, None] + angles[None, :] + jnp.pi) / dtheta
            ).astype(jnp.int32) % n_theta
        )  # (kc, M)
        sc = _bin_lut_matrix(gc, lpc, n_theta)
    cfield = _sharded_bin_stack(
        lambda rows: _lut_field(qtc.reshape(k_tab, hc * wc), sc[rows]),
        kc, shard_bins_axis,
    ).reshape(kc, hc, wc)

    if config.motion_validity == "score":
        # blocks with NO free cell take the invalid penalty; blocks with
        # any free cell stay optimistic (mirrors the corr coarse field)
        occ = grid_map.occupancy
        h, w = occ.shape
        free = jnp.pad(
            occ == 0, ((0, hc * f - h), (0, wc * f - w)),
            constant_values=False,
        )
        any_free = free.reshape(hc, f, wc, f).any(axis=(1, 3))
        cfield = cfield + (
            INVALID_SCORE * jnp.maximum(count, 1).astype(jnp.float32)
        ) * jnp.where(any_free, 0.0, 1.0)[None]
    return cfield.astype(jnp.float32)


def _beam_coarse_indices(px, py, pth, grid_map, tables: BeamTables,
                         config: FilterConfig, res):
    """Per-particle (theta-bin, row, col) lookup indices into the coarse
    fallback field — cheap per-particle math, always computed so the
    lookup keeps a valid index set whether or not the coarse FIELD build
    fired this scan."""
    f = config.corr_coarse_factor
    kc = config.corr_coarse_n_theta
    _, hc, wc = tables.qtc.shape
    res_c = f * res
    cx = jnp.clip(
        ((px - grid_map.origin[0]) / res_c).astype(jnp.int32), 0, wc - 1
    )
    cy = jnp.clip(
        ((py - grid_map.origin[1]) / res_c).astype(jnp.int32), 0, hc - 1
    )
    ck = (((pth + jnp.pi) * (kc / (2.0 * jnp.pi))).astype(jnp.int32)) % kc
    return ck, cy, cx


def beam_field_scores(
    particles: jnp.ndarray,
    ranges: jnp.ndarray,
    angles: jnp.ndarray,
    grid_map,
    config: FilterConfig,
    table,                   # (K, H, W) range table or BeamTables bundle
    n_theta: int,
    window_origin: tuple,    # (oy0, ox0[, kstart]) cell/bin coords, traced
    shard_bins_axis: str | None = None,  # shard_map axis: theta-sharded build
) -> jnp.ndarray:
    """Per-particle beam-model scores via a per-scan SCORE FIELD — the
    gather-light formulation of ``compute_likelihoods_raycast``
    (parallel_utils.py:151-201).

    The table-lookup path still pays N x M gathers per scan (36M at
    100k x 360).  But the beam model's per-beam term only depends on the
    particle through (cell, theta-bin):

        score[k, cy, cx] = sum_j log p(r_j | R[bin(c_k + a_j), cy, cx])

    so the whole scan collapses to a dense field build followed by ONE
    field lookup per particle.  The build evaluates each window bin
    directly over (M, win, win) slabs of the range table.

    Agrees with ``raycast_table_scores`` exactly when poses sit at cell
    centers and headings at bin centers (heading is quantized to the
    particle's theta-bin CENTER — the same quantization class as the corr
    scorer; tests/test_range_table.py).

    Requires a spatial window (``corr_window_cells``); a theta window
    (``corr_theta_window_bins``) cuts the build by K/bins.  In-map
    particles escaping the window score via the coarse full-map fallback
    field when ``corr_coarse_factor > 0`` (kidnapped-robot recovery — see
    ``_beam_coarse_field``), or take BLIND_SCORE when disabled.  The
    coarse build is further gated on ``config.coarse_gate_escapees``
    in-map escapees (see the inline comment at the gate).

    ``shard_bins_axis``: under shard_map, build only this device's slice
    of the window's theta bins and all_gather the stack (the build is
    embarrassingly parallel over bins — the multi-chip story mirrors
    models/corr_field.py::_shard_bins; requires nbins %% n_devices == 0,
    guarded in parallel/distributed.py).  The coarse fallback field
    shards over its own corr_coarse_n_theta bins when divisible.
    """
    from mcmh_localization.models.sensor import INVALID_SCORE

    tables = _as_beam_tables(table, config)
    max_range = config.max_range
    sigma = config.sigma_hit
    if config.step > 1:
        ranges = ranges[:: config.step]
        angles = angles[:: config.step]
    valid = jnp.isfinite(ranges) & (ranges < max_range)
    count = jnp.sum(valid)
    safe_r = jnp.where(valid, ranges, 0.0)

    k_tab, h, w = tables.table.shape
    win = min(config.corr_window_cells, h, w)
    oy0 = jnp.clip(jnp.asarray(window_origin[0], jnp.int32), 0, h - win)
    ox0 = jnp.clip(jnp.asarray(window_origin[1], jnp.int32), 0, w - win)
    tw = config.corr_theta_window_bins
    use_theta_win = bool(tw) and len(window_origin) == 3
    nbins = min(tw, n_theta) if use_theta_win else n_theta
    kstart = (
        jnp.asarray(window_origin[2], jnp.int32) if use_theta_win
        else jnp.int32(0)
    )

    # global table bin per (window bin, beam): headings at bin CENTERS
    dtheta = 2.0 * jnp.pi / n_theta
    centers = (kstart + jnp.arange(nbins) + 0.5) * dtheta - jnp.pi
    g = (
        jnp.floor((centers[:, None] + angles[None, :] + jnp.pi) / dtheta)
        .astype(jnp.int32) % n_theta
    )  # (nbins, M)

    _over_bins = functools.partial(_sharded_bin_stack, axis=shard_bins_axis)

    lp = _beam_lut(safe_r, valid, tables.dvals, config)  # (M, nq)
    # (K, win, win) window of the precomputed table: ONE dynamic slice
    rw = jax.lax.dynamic_slice(
        tables.table, (0, oy0, ox0), (k_tab, win, win)
    )
    inv_sqrt = 1.0 / (jnp.sqrt(2.0 * jnp.pi) * sigma)
    z_floor = config.z_rand / max_range

    def one_bin(g_k):
        rows = rw[g_k]  # (M, win, win): M row gathers of dense slabs
        ph = inv_sqrt * jnp.exp(
            -0.5 * ((safe_r[:, None, None] - rows) / sigma) ** 2
        )
        lpd = jnp.log(jnp.maximum(config.z_hit * ph + z_floor, LOG_FLOOR))
        return jnp.sum(jnp.where(valid[:, None, None], lpd, 0.0), axis=0)

    field = _over_bins(
        lambda rows: jax.lax.map(one_bin, g[rows]), nbins
    )  # (nbins, win, win)

    score_validity = config.motion_validity == "score"
    if score_validity:
        # fold motion validity into the field (same trick as the corr
        # scorer): non-free window cells score INVALID, no per-proposal
        # map lookups
        occ_win = jax.lax.dynamic_slice(
            grid_map.occupancy, (oy0, ox0), (win, win)
        )
        pen_total = INVALID_SCORE * jnp.maximum(count, 1).astype(jnp.float32)
        field = field + pen_total * jnp.where(occ_win == 0, 0.0, 1.0)[None]

    # ---- one lookup per particle
    px, py, pth = particles[:, 0], particles[:, 1], particles[:, 2]
    mx, my = grid_map.world_to_grid(px, py)
    in_map = grid_map.in_bounds(mx, my)
    tbin = ((pth + jnp.pi) / dtheta).astype(jnp.int32) % n_theta
    if use_theta_win:
        k_rel = (tbin - kstart) % n_theta
        in_theta = k_rel < nbins
        tbin = jnp.where(in_theta, k_rel, 0)
    else:
        in_theta = jnp.ones(particles.shape[0], dtype=bool)
    mxw = jnp.clip(mx, 0, w - 1) - ox0
    myw = jnp.clip(my, 0, h - 1) - oy0
    in_window = (mxw >= 0) & (mxw < win) & (myw >= 0) & (myw < win)
    covered = in_window & in_theta
    fine = field[
        tbin, jnp.clip(myw, 0, win - 1), jnp.clip(mxw, 0, win - 1)
    ]

    res = float(jax.device_get(grid_map.resolution))
    use_coarse = config.corr_coarse_factor > 0 and tables.qtc is not None

    if use_coarse:
        # fine lookup for covered particles, coarse-fallback for escapees.
        # The coarse FIELD build (but never the lookup) is gated: in
        # steady-state tracking the only escapees are a handful of
        # ~4-sigma proposal-noise tails.  Below
        # ``config.coarse_gate_escapees`` in-map escapees the field is a
        # BLIND_SCORE-equivalent constant (exactly the pre-fallback
        # semantics for those few particles: they die, as tails should);
        # at or above the gate — injection storms, kidnaps, global phases —
        # the real build fires and recovery behaves identically to the
        # ungated path (tests/test_range_table.py kidnap coverage).
        kc = config.corr_coarse_n_theta
        _, hc, wc = tables.qtc.shape
        ck, cy, cx = _beam_coarse_indices(
            px, py, pth, grid_map, tables, config, res
        )

        def _build_coarse(_):
            return _beam_coarse_field(
                lp, count, angles, grid_map, tables, config, n_theta,
                shard_bins_axis=shard_bins_axis,
            )

        def _blind_fill(_):
            # constant whose post-aggregation score equals BLIND_SCORE
            fill = BLIND_SCORE * (
                jnp.maximum(count, 1).astype(jnp.float32)
                if config.score_aggregation == "mean" else jnp.float32(1.0)
            )
            return jnp.broadcast_to(fill, (kc, hc, wc)).astype(jnp.float32)

        if shard_bins_axis is not None or config.coarse_gate_escapees == 0:
            # never gate under bin sharding: the build contains an
            # all_gather and per-shard predicates could disagree — one
            # device entering the collective while another skips deadlocks.
            # gate == 0: explicitly ungated (config.py)
            cfield = _build_coarse(None)
        else:
            # 0-or-1-iteration while_loop, NOT lax.cond: XLA may execute
            # both sides of a data-flow conditional, while a while body runs
            # only when entered (the same gate as the KLD escalation —
            # ops/resampling.py::kld_resample)
            n_esc = jnp.sum(in_map & ~covered)

            def _wcond(carry):
                done, _ = carry
                return jnp.logical_not(done)

            def _wbody(carry):
                return jnp.bool_(True), _build_coarse(None)

            _, cfield = jax.lax.while_loop(
                _wcond, _wbody,
                (n_esc < config.coarse_gate_escapees, _blind_fill(None)),
            )
        totals = jnp.where(
            in_map, jnp.where(covered, fine, cfield[ck, cy, cx]), 0.0
        )
    else:
        totals = jnp.where(in_map & covered, fine, 0.0)

    if config.score_aggregation == "sum":
        score = totals
    else:
        score = totals / jnp.maximum(count, 1)
    # out-of-map: reference zero-contribution (or invalid pen under
    # score-validity); in-map window escapees: blind penalty unless the
    # coarse fallback scored them
    if not use_coarse:
        score = jnp.where(in_map & ~covered, BLIND_SCORE, score)
    if score_validity:
        pen = (
            INVALID_SCORE * jnp.maximum(count, 1).astype(jnp.float32)
            if config.score_aggregation == "sum"
            else jnp.float32(INVALID_SCORE)
        )
        score = jnp.where(in_map, score, pen)
    return jnp.where(count > 0, score, BLIND_SCORE).astype(jnp.float32)


def raycast_table_scores(
    particles: jnp.ndarray,
    ranges: jnp.ndarray,
    angles: jnp.ndarray,
    grid_map,
    config: FilterConfig,
    table_cm: jnp.ndarray,   # (H*W, K) cell-major range table
    n_theta: int,
) -> jnp.ndarray:
    """Per-particle beam-model log-likelihood via the range table, (N,).

    Same mixture and aggregation semantics as
    ``sensor.raycast_beam_scores`` (parallel_utils.py:151-201): only beams
    with finite r < max_range count; per-beam
    log(max(z_hit*N(r - r_pred; sigma_hit) + z_rand/max_range, 1e-6));
    blind scans score BLIND_SCORE.

    ``config.step`` beam subsampling applies here exactly as in the field
    impl and the likelihood-field scorer, so beam_impl="auto" cannot flip
    between impls that score different beam subsets (the REFERENCE's
    raycast scorer ignores its step parameter — parallel_utils.py:151-201
    has no stride — a quirk we deviate from for cross-impl consistency;
    see PARITY.md).
    """
    max_range = config.max_range
    sigma = config.sigma_hit
    if config.step > 1:
        ranges = ranges[:: config.step]
        angles = angles[:: config.step]
    valid = jnp.isfinite(ranges) & (ranges < max_range)
    count = jnp.sum(valid)
    safe_r = jnp.where(valid, ranges, 0.0)

    mx, my = grid_map.world_to_grid(particles[:, 0], particles[:, 1])
    in_map = grid_map.in_bounds(mx, my)
    cell = (
        jnp.clip(my, 0, grid_map.height - 1) * grid_map.width
        + jnp.clip(mx, 0, grid_map.width - 1)
    )  # (N,)

    dtheta = 2.0 * jnp.pi / n_theta
    # floor (not toward-zero truncation): theta + a spans [-2pi, 2pi]
    k_nj = (
        jnp.floor((particles[:, 2][:, None] + angles[None, :] + jnp.pi)
                  / dtheta).astype(jnp.int32) % n_theta
    )  # (N, M)

    r_pred = table_cm[cell[:, None], k_nj]  # (N, M)

    inv_sqrt = 1.0 / (jnp.sqrt(2.0 * jnp.pi) * sigma)
    prob_hit = inv_sqrt * jnp.exp(
        -0.5 * ((safe_r[None, :] - r_pred) / sigma) ** 2
    )
    prob = config.z_hit * prob_hit + config.z_rand / max_range
    logp = jnp.log(jnp.maximum(prob, LOG_FLOOR))
    totals = jnp.sum(jnp.where(valid[None, :] & in_map[:, None], logp, 0.0),
                     axis=1)
    # out-of-map particles keep the reference's zero-contribution score
    if config.score_aggregation == "sum":
        score = totals
    else:
        score = totals / jnp.maximum(count, 1)
    return jnp.where(count > 0, score, BLIND_SCORE).astype(jnp.float32)
