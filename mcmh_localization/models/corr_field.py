"""Correlation-field likelihood scorer.

The exact scorer (models/sensor.py) looks up one table cell per
(particle, beam).  This module restructures the sensor model so the
per-beam lookups become a per-scan dense build plus one lookup per
particle:

  1. Per scan, build a correlation field F[k, cy, cx]: the summed per-beam
     log-likelihood a pose in cell (cy, cx) with heading in theta-bin k
     would get — F_k = sum_j shift(L, offset_j(theta_k)), dense shifted
     adds of the log-likelihood table (``_build_field_xla``) or the same
     correlation as DFT-domain matmuls (``_build_field_dft``).  Cost is
     independent of the particle count.
  2. Score all N particles with ONE lookup each into F — N gathers
     instead of N x M.

Approximation vs the exact scorer (documented): heading is quantized to
``n_theta`` bins and the endpoint cell is particle-cell + offset-cell
(double truncation) rather than trunc of the continuous endpoint — both on
the order of the reference's own 5 cm cell quantization for reasonable
n_theta.  Exact semantics remain available via likelihood_impl="jnp";
filter-level RMSE is indistinguishable (tests/test_corr_field.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mcmh_localization import dispatch
from mcmh_localization.config import FilterConfig
from mcmh_localization.models.sensor import (
    BLIND_SCORE,
    INVALID_SCORE,
    log_likelihood_field,
)


_HIGHEST = jax.lax.Precision.HIGHEST


def _bin_offsets(u, v, valid, inv_res, n_theta, pad_cells, zero_band_row,
                 bin_start=0, nbins=None):
    """(nbins, M) int32 slice-start offsets per theta-bin; invalid beams
    point at the all-zero band.  ``bin_start`` (traced ok) selects a
    contiguous circular window of ``nbins`` of the n_theta global bins."""
    if nbins is None:
        nbins = n_theta
    # bin CENTERS (left edges would give a systematic half-bin heading bias
    # that steadily drags tracking; lookup uses floor-to-bin below)
    thetas = (
        (bin_start + jnp.arange(nbins, dtype=jnp.float32) + 0.5)
        * (2.0 * jnp.pi / n_theta)
        - jnp.pi
    )
    c = jnp.cos(thetas)[:, None]
    s = jnp.sin(thetas)[:, None]
    ox = ((c * u[None, :] - s * v[None, :]) * inv_res).astype(jnp.int32) + pad_cells
    oy = ((s * u[None, :] + c * v[None, :]) * inv_res).astype(jnp.int32) + pad_cells
    ox = jnp.clip(ox, 0, 2 * pad_cells)
    oy = jnp.clip(oy, 0, 2 * pad_cells)
    ox = jnp.where(valid[None, :], ox, 0)
    oy = jnp.where(valid[None, :], oy, zero_band_row)
    return ox, oy


def _build_field_xla(padded, ox, oy, h, w):
    """XLA fallback: per-bin vmapped dynamic slices + sum."""

    def one_bin(ox_k, oy_k):
        def one_beam(oxj, oyj):
            return jax.lax.dynamic_slice(padded, (oyj, oxj), (h, w))

        return jnp.sum(jax.vmap(one_beam)(ox_k, oy_k), axis=0)

    return jax.lax.map(lambda o: one_bin(o[0], o[1]), (ox, oy))


def _coarse_field(u, v, valid, log_field, grid_map, config, res):
    """Coarse full-map fallback FIELD, (kc, hc, wc).

    The per-particle indices live in ``_coarse_indices`` so the caller can
    gate THIS build behind an escapee-count predicate (the build is skipped
    in steady-state tracking).

    Gives out-of-window (but in-map) particles an honest smoothed score so
    augmented-MCL injection can recover a kidnapped robot while the fine
    field only covers the window (VERDICT round-1: out-of-window particles
    scored -50 and died instantly, neutralizing the recovery of
    amcmh_localizer.py:496-527).

    The coarse log field is the f x f block MAX of the fine log field: an
    optimistic (admissible) bound — "somewhere in this block the fit is this
    good".  Mean pooling was tried first and systematically handicaps
    out-of-window hypotheses against the in-window cluster's fine scores,
    so a kidnapped-robot's injected true-pose particles could never win;
    max pooling keeps them alive until the window migrates and fine scoring
    calibrates them.  Build cost: corr_coarse_n_theta small dense fields,
    independent of particle count.
    """
    f = config.corr_coarse_factor
    kc = config.corr_coarse_n_theta
    h, w = log_field.shape
    hc, wc = -(-h // f), -(-w // f)
    lf = jnp.pad(
        log_field.astype(jnp.float32),
        ((0, hc * f - h), (0, wc * f - w)),
        constant_values=-13.815511,  # log(1e-6), the probability floor
    )
    coarse_lf = lf.reshape(hc, f, wc, f).max(axis=(1, 3))

    res_c = f * res  # concrete: res is a python float at trace time
    pad_c = int(-(-config.max_range // res_c)) + 2
    padded = jnp.pad(coarse_lf, pad_c)
    zero_band_row = padded.shape[0]
    ox, oy = _bin_offsets(u, v, valid, 1.0 / res_c, kc, pad_c, zero_band_row)
    if dispatch.corr_field_builder(config) == "dft":
        field = _build_field_dft(padded, ox, oy, valid, hc, wc)
    else:
        padded = jnp.pad(padded, ((0, hc), (0, 0)))
        field = _build_field_xla(padded, ox, oy, hc, wc)

    if config.motion_validity == "score":
        # blocks with NO free cell get the invalid-pose penalty; blocks with
        # any free cell stay optimistic, consistent with the max-pooling
        free = jnp.pad(
            grid_map.occupancy == 0,
            ((0, hc * f - h), (0, wc * f - w)),
            constant_values=False,
        )
        any_free = free.reshape(hc, f, wc, f).any(axis=(1, 3))
        count = jnp.sum(valid).astype(jnp.float32)
        field = field + (INVALID_SCORE * jnp.maximum(count, 1.0)) * jnp.where(
            any_free, 0.0, 1.0
        )[None]
    return field.astype(jnp.float32)


def _coarse_indices(px, py, pth, grid_map, config, res):
    """Per-particle (theta-bin, row, col) indices into the coarse field —
    cheap per-particle math kept OUTSIDE the gated field build so the
    lookup always has a valid index set."""
    f = config.corr_coarse_factor
    kc = config.corr_coarse_n_theta
    h, w = grid_map.occupancy.shape
    hc, wc = -(-h // f), -(-w // f)
    res_c = f * res
    mx = ((px - grid_map.origin[0]) / res_c).astype(jnp.int32)
    my = ((py - grid_map.origin[1]) / res_c).astype(jnp.int32)
    tbin = (
        ((pth + jnp.pi) * (kc / (2.0 * jnp.pi))).astype(jnp.int32)
        % kc
    )
    return tbin, jnp.clip(my, 0, hc - 1), jnp.clip(mx, 0, wc - 1)


def _build_field_dft(region, ox, oy, valid, fh, fw):
    """Field build as a DFT-domain cross-correlation — dense matmuls.

    F[k, y, x] = sum_j region[y + oy[k,j], x + ox[k,j]]
               = real(IDFT2( DFT2(region) * conj(DFT2(stamp_k)) ))

    * HALF SPECTRUM: region and stamps are real, so their 2-D DFTs are
      Hermitian (X[S-u, S-v] = conj(X[u, v])) and the product P inherits
      the symmetry.  Only Sh = S/2 + 1 frequency ROWS are computed
      end-to-end; the final inverse-u transform folds each conjugate pair
      with weights alpha = [1, 2, ..., 2, 1] (rfft-style).
    * SUPPORT TRIMMING: the stamp occupies [0, ksize)^2, the region
      [0, hr) x [0, wr), and the output only [0, fh) x [0, fw) — every
      matmul contracts over the occupied rows/cols instead of the padded
      (S, S) square.
    * SCATTER-FREE STAMPS: the (nbins, ksize, ksize) beam-count images are
      built as batched one-hot matmuls (counts stay exact via f32
      accumulation).
    * the region transform is computed ONCE for all bins.

    Every product runs at ``Precision.HIGHEST``: the field values are sums
    of up to M per-beam log-likelihoods, and a reduced-precision (TF32 or
    bf16) pass would shift log-weights by O(1).

    ksize (stamp support) is inferred as hr - fh + 1: both callers size the
    region as output + stamp support - 1.  DFT size S >= fh + ksize - 1
    guarantees the evaluated lags never wrap, so the circular correlation
    equals the linear one on [0, fh) x [0, fw).
    """
    mm = functools.partial(jnp.matmul, precision=_HIGHEST)
    ein = functools.partial(jnp.einsum, precision=_HIGHEST)
    hr, wr = region.shape
    ksize = hr - fh + 1
    s = max(-(-hr // 128) * 128, -(-wr // 128) * 128)
    sh = s // 2 + 1

    n_grid = jnp.arange(s, dtype=jnp.float32)
    ang = (2.0 * jnp.pi / s) * jnp.outer(n_grid, n_grid)  # (S, S)
    ct = jnp.cos(ang)
    st = jnp.sin(ang)
    # D[v, x] = ct - i*st; D_h = first Sh rows (u axis)

    # ---- region spectrum R_hat (Sh, wr-trimmed -> full v)
    r32 = region.astype(jnp.float32)
    a_r = mm(ct[:sh, :hr], r32)       # (Sh, wr)  real(D_h @ R)
    a_i = mm(-st[:sh, :hr], r32)      # imag
    cvr = ct[:, :wr]                  # (S, wr)   right-side D[v, x]
    cvi = st[:, :wr]
    rr = mm(a_r, cvr.T) + mm(a_i, cvi.T)   # R_hat = A @ D[:, :wr]^T
    ri = mm(a_i, cvr.T) - mm(a_r, cvi.T)

    # ---- stamps via one-hot matmuls: C[k] = OHY[k] @ (w * OHX[k])
    w = jnp.where(valid, 1.0, 0.0).astype(jnp.float32)
    oyc = jnp.clip(oy, 0, ksize - 1)  # invalid beams carry weight 0
    oxc = jnp.clip(ox, 0, ksize - 1)
    kio = jnp.arange(ksize, dtype=jnp.int32)
    ohy = (oyc[:, None, :] == kio[None, :, None]).astype(jnp.float32)
    ohx = (oxc[:, :, None] == kio[None, None, :]).astype(jnp.float32)
    stamp = ein("ksj,kjt->kst", ohy, ohx * w[None, :, None])

    # ---- stamp spectra S_hat (nbins, Sh, S)
    c_r = ein("us,ksv->kuv", ct[:sh, :ksize], stamp)
    c_i = ein("us,ksv->kuv", -st[:sh, :ksize], stamp)
    ckr = ct[:, :ksize]               # (S, ksize)
    cki = st[:, :ksize]
    srr = mm(c_r, ckr.T) + mm(c_i, cki.T)
    sri = mm(c_i, ckr.T) - mm(c_r, cki.T)

    # ---- P_k = R_hat * conj(S_hat_k)   (nbins, Sh, S)
    pr = rr[None] * srr + ri[None] * sri
    pi = ri[None] * srr - rr[None] * sri

    # ---- inverse along v (only x < fw needed): Q = P @ E, E[v,x]=e^{+ivx}
    exr = ct[:, :fw]                  # (S, fw)
    exi = st[:, :fw]
    qr = mm(pr, exr) - mm(pi, exi)
    qi = mm(pr, exi) + mm(pi, exr)

    # ---- inverse along u with Hermitian fold (only y < fh needed)
    alpha = jnp.full((sh,), 2.0, jnp.float32).at[0].set(1.0).at[sh - 1].set(1.0)
    eyr = ct[:fh, :sh] * alpha[None, :]   # (fh, Sh)
    eyi = st[:fh, :sh] * alpha[None, :]
    f = mm(eyr, qr) - mm(eyi, qi)
    return f / (s * s)


def _shard_bins(builder, ox, oy, axis):
    """Run a per-bin field ``builder(ox_l, oy_l)`` on this device's slice of
    the theta bins and all_gather the full stack — the theta-bin-sharded
    multi-chip build (build cost is embarrassingly parallel over bins;
    requires nbins %% n_devices == 0, guarded in parallel/distributed.py)."""
    ndev = jax.lax.psum(1, axis)
    axd = jax.lax.axis_index(axis)
    kd = ox.shape[0] // ndev
    ox_l = jax.lax.dynamic_slice_in_dim(ox, axd * kd, kd, 0)
    oy_l = jax.lax.dynamic_slice_in_dim(oy, axd * kd, kd, 0)
    return jax.lax.all_gather(builder(ox_l, oy_l), axis, axis=0, tiled=True)


def correlation_field_scores(
    particles: jnp.ndarray,
    ranges: jnp.ndarray,
    angles: jnp.ndarray,
    grid_map,
    config: FilterConfig,
    log_field: jnp.ndarray | None = None,
    n_theta: int = 180,
    field_impl: str = "auto",  # "auto" | "xla" | "dft"
    window_origin: tuple | None = None,  # (oy0, ox0) cell coords, traced ok
    shard_bins_axis: str | None = None,  # shard_map axis: theta-sharded build
) -> jnp.ndarray:
    """Per-particle scores via one field lookup each; same normalization and
    blind penalty as the exact scorer (parallel_utils.py:144-147).

    When called twice with identical (ranges, angles) inside one jit trace
    (the previous + proposed sets of a scan update), XLA CSE merges the two
    field builds into one.

    NOTE: ``grid_map`` must be a concrete (non-traced) map — the static pad
    size derives from its resolution at trace time, which holds for the
    step-factory pattern where the map is a closure constant.
    """
    if log_field is None:
        log_field = log_likelihood_field(grid_map, config)
    if config.step > 1:
        ranges = ranges[:: config.step]
        angles = angles[:: config.step]
    valid = jnp.isfinite(ranges) & (ranges < config.max_range)

    h, w = log_field.shape
    res = float(jax.device_get(grid_map.resolution))
    pad_cells = int(-(-config.max_range // res)) + 2
    inv_res = 1.0 / grid_map.resolution
    safe_r = jnp.where(valid, ranges, 0.0)
    u = (safe_r * jnp.cos(angles)).astype(jnp.float32)
    v = (safe_r * jnp.sin(angles)).astype(jnp.float32)

    # theta window: build only corr_theta_window_bins bins starting at the
    # traced global-bin offset window_origin[2] (cloud mean heading); the
    # cos/sin in _bin_offsets are periodic so no wrapping is needed
    win = config.corr_window_cells
    use_window = bool(win) and win < min(h, w) and window_origin is not None
    tw = config.corr_theta_window_bins
    use_theta_win = (
        bool(tw) and use_window and len(window_origin) == 3
    )
    nbins = tw if use_theta_win else n_theta
    kstart = (
        jnp.asarray(window_origin[2], jnp.int32) if use_theta_win else 0
    )

    # the build reads a region of the zero-padded log field: the whole map,
    # or the (win + 2 pad)^2 square around the window at window_origin
    padded0 = jnp.pad(log_field, pad_cells)
    if use_window:
        oy0 = jnp.clip(jnp.asarray(window_origin[0], jnp.int32), 0, h - win)
        ox0 = jnp.clip(jnp.asarray(window_origin[1], jnp.int32), 0, w - win)
        fh = fw = win
        side = win + 2 * pad_cells
        region = jax.lax.dynamic_slice(padded0, (oy0, ox0), (side, side))
    else:
        fh, fw = h, w
        region = padded0
    # invalid beams point at an all-zero band appended below the region
    zero_band_row = region.shape[0]
    ox, oy = _bin_offsets(
        u, v, valid, inv_res, n_theta, pad_cells, zero_band_row,
        bin_start=kstart, nbins=nbins,
    )

    if field_impl == "auto":
        field_impl = dispatch.corr_field_builder(config)
    if field_impl not in ("xla", "dft"):
        raise ValueError(
            f"unknown field_impl {field_impl!r} (expected 'auto', 'xla' "
            f"or 'dft')"
        )

    def _builder(ox_b, oy_b):
        if field_impl == "dft":
            return _build_field_dft(region, ox_b, oy_b, valid, fh, fw)
        return _build_field_xla(
            jnp.pad(region, ((0, fh), (0, 0))), ox_b, oy_b, fh, fw
        )

    if shard_bins_axis is not None:
        field = _shard_bins(_builder, ox, oy, shard_bins_axis)
    else:
        field = _builder(ox, oy)

    count = jnp.sum(valid)
    score_validity = config.motion_validity == "score"
    if score_validity:
        # fold motion validity into the field: non-free cells score
        # INVALID_SCORE, replacing the motion model's retries x N validity
        # lookups (motion_validity="score"; see config.py) with one dense
        # (win x win) add broadcast over theta bins
        if use_window:
            occ_win = jax.lax.dynamic_slice(
                grid_map.occupancy, (oy0, ox0), (fh, fw)
            )
        else:
            occ_win = grid_map.occupancy
        pen_total = INVALID_SCORE * jnp.maximum(count, 1).astype(jnp.float32)
        field = field + pen_total * jnp.where(
            occ_win == 0, 0.0, 1.0
        )[None].astype(field.dtype)

    px, py, pth = particles[:, 0], particles[:, 1], particles[:, 2]
    mx = ((px - grid_map.origin[0]) * inv_res).astype(jnp.int32)
    my = ((py - grid_map.origin[1]) * inv_res).astype(jnp.int32)
    tbin = (
        ((pth + jnp.pi) * (n_theta / (2.0 * jnp.pi)))
        .astype(jnp.int32) % n_theta
    )
    if use_theta_win:
        k_rel = (tbin - kstart) % n_theta
        in_theta = k_rel < nbins
        tbin = jnp.where(in_theta, k_rel, 0)
    else:
        in_theta = jnp.ones(particles.shape[0], dtype=bool)
    in_map = grid_map.in_bounds(mx, my)
    if use_window:
        mxw = mx - ox0
        myw = my - oy0
        in_window = (mxw >= 0) & (mxw < fw) & (myw >= 0) & (myw < fh)
        mxc = jnp.clip(mxw, 0, fw - 1)
        myc = jnp.clip(myw, 0, fh - 1)
    else:
        in_window = jnp.ones_like(in_map)
        mxc = jnp.clip(mx, 0, fw - 1)
        myc = jnp.clip(my, 0, fh - 1)

    covered = in_window & in_theta
    fine = field.astype(jnp.float32)[tbin, myc, mxc]  # ONE lookup/particle
    use_coarse = use_window and config.corr_coarse_factor > 0
    if use_coarse:
        # fine lookup for covered particles, coarse-fallback lookup for the
        # rest.  Only the coarse FIELD build is gated, on the escapee count,
        # via a 0-or-1-iteration while_loop (XLA may execute both sides of
        # a lax.cond; a while body runs only when entered — see
        # ops/resampling.py::kld_resample and the beam twin in
        # models/range_table.py): in steady-state tracking the only
        # escapees are proposal-noise tails below
        # config.coarse_gate_escapees, which take BLIND_SCORE (the
        # no-fallback semantics) while the build is skipped.
        f_c = config.corr_coarse_factor
        kc = config.corr_coarse_n_theta
        hmap, wmap = log_field.shape
        hc, wc = -(-hmap // f_c), -(-wmap // f_c)
        ck, cy, cx = _coarse_indices(px, py, pth, grid_map, config, res)

        def _build_coarse(_):
            return _coarse_field(u, v, valid, log_field, grid_map, config,
                                 res)

        def _blind_fill(_):
            fill = BLIND_SCORE * (
                jnp.maximum(count, 1).astype(jnp.float32)
                if config.score_aggregation == "mean" else jnp.float32(1.0)
            )
            return jnp.broadcast_to(fill, (kc, hc, wc)).astype(jnp.float32)

        if config.coarse_gate_escapees == 0:
            cfield = _build_coarse(None)  # ungated: always build
        else:
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
    # out-of-map keeps the reference's zero-contribution score; in-map
    # particles that escaped the WINDOW score via the coarse full-map field
    # (honest smoothed score -> kidnapped-robot recovery works), or take the
    # blind penalty when the coarse fallback is disabled (scores are mostly
    # negative, so they must not outscore real ones)
    if not use_coarse:
        score = jnp.where(in_map & ~covered, BLIND_SCORE, score)
    if score_validity:
        # out-of-map poses are invalid too (the reference's motion model
        # would have rejected them, parallel_utils.py:383-386)
        pen = (
            INVALID_SCORE * jnp.maximum(count, 1).astype(jnp.float32)
            if config.score_aggregation == "sum"
            else jnp.float32(INVALID_SCORE)
        )
        score = jnp.where(in_map, score, pen)
    return jnp.where(count > 0, score, BLIND_SCORE).astype(jnp.float32)
