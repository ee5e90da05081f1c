"""Resampling primitives, all static-shape and fully on-device.

Replaces the reference's Numba resamplers:
  * softmax weight conversion:  ``convert_scores`` (amcmh_localizer.py:351-358)
  * systematic (low-variance):  ``low_variance_resample_numba``
                                (parallel_utils.py:416-446)
  * multinomial:                ``parallel_resample_simple``
                                (parallel_utils.py:467-477)
  * KLD-adaptive:               ``kld_sampling_amcl`` (parallel_utils.py:529-591)

Design:
  * The reference's systematic resampler is a sequential pointer walk; here
    it is cumsum + a sorted rank (scatter-max + cumulative max) — fully
    parallel work.  The KLD sampler's python ``set`` of occupied bins becomes a
    sort-based first-occurrence scan, and its data-dependent stopping point
    becomes a masked argmax over a statically-shaped candidate array:
    identical statistics, no dynamic shapes (SURVEY.md §7 "KLD under static
    shapes").
  * Adaptive particle counts are carried as an explicit ``count`` scalar
    against padded (N_max, ...) arrays; the reference instead reallocates
    arrays every step (amcmh_localizer.py:520-522).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# Per-sample jitter applied by KLD sampling (parallel_utils.py:552)
KLD_NOISE_STD = (0.001, 0.001, 0.02)

# Stage-1 prefix of the escalating KLD stop evaluation (see kld_resample):
# large enough that any converged cloud stops inside it, small enough that
# its bin counting stays a fraction of the full-size pass
_KLD_STAGE1 = 131072


def softmax_weights(scores: jnp.ndarray, mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Log-scores -> normalized weights (amcmh_localizer.py:351-358).

    With ``mask``, masked-out entries get weight 0 and the normalization runs
    over the active set only (used for padded particle arrays).
    """
    if mask is not None:
        scores = jnp.where(mask, scores, -jnp.inf)
    w = jnp.exp(scores - jnp.max(scores))
    if mask is not None:
        w = jnp.where(mask, w, 0.0)
    return w / jnp.sum(w)


def effective_sample_size(weights: jnp.ndarray) -> jnp.ndarray:
    """ESS = 1 / sum(w^2) for normalized weights (new observability metric)."""
    return 1.0 / jnp.maximum(jnp.sum(weights * weights), 1e-30)


def _normalized_cumsum(weights: jnp.ndarray) -> jnp.ndarray:
    c = jnp.cumsum(weights)
    return c / jnp.maximum(c[-1], 1e-30)


def _lookup(cum: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Index of the first cumsum entry >= u."""
    return jnp.clip(
        jnp.searchsorted(cum, u, side="left", method="sort"), 0, cum.shape[0] - 1
    )


def systematic_resample_indices(
    key: jax.Array,
    weights: jnp.ndarray,
    num_out: int,
    count: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Systematic (stochastic-universal) resampling -> (num_out,) int32.

    Draw positions u_m = (r + m) / M with one shared r ~ U(0, 1/M), walk the
    normalized cumulative weights (parallel_utils.py:416-446).  With
    ``count`` (traced scalar M <= num_out), only the first M outputs are
    meaningful — positions use M as the stride so statistics match a
    resampler of exactly M draws; the tail repeats the final index.

    Because BOTH the positions u_m and the CDF are monotone, the merge
    needs no sort or per-query binary search.  Each input particle i
    covers output slots [L(c_{i-1}), L(c_i)) with L(c) = #{m: u_m < c} =
    clip(ceil(c*M - r), 0, num_out), so ``idx[m] = #{i : L(c_i) <= m}`` —
    the rank of m in the sorted bound array (``rank_in_sorted``).

    With ``count`` given, output slots m >= count are implementation-
    defined tail repeats (callers mask them); slots < count agree across
    implementations.
    """
    bound = _segment_bounds(key, weights, num_out, count)
    return rank_in_sorted(bound, num_out)


def rank_in_sorted(bound: jnp.ndarray, num_out: int) -> jnp.ndarray:
    """(num_out,) int32: out[m] = #{j : bound[j] <= m} clipped to
    [0, R-1] — the index of the input whose segment
    [bound[j-1], bound[j]) covers output slot m.

    ``bound``: (R,) int32, NONDECREASING, values in [0, num_out].  Each
    segment's index is scattered (max) at its start slot, then a
    cumulative max fills the covered slots."""
    r = bound.shape[0]
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), bound[:-1]])
    starts = jnp.where(bound > prev, prev, num_out)  # num_out -> dropped
    seg = jnp.full(num_out, -1, dtype=jnp.int32)
    seg = seg.at[starts].max(jnp.arange(r, dtype=jnp.int32), mode="drop")
    return jnp.clip(jax.lax.cummax(seg), 0, r - 1)


def _segment_bounds(key, weights, num_out, count=None):
    """(N,) int32 segment ends: input i covers output slots
    [bound_{i-1}, bound_i) under systematic resampling."""
    denom = jnp.float32(num_out) if count is None else count.astype(jnp.float32)
    r = jax.random.uniform(key, (), minval=0.0, maxval=1.0)
    c = _normalized_cumsum(weights)  # (N,)
    # boundary L(c_i): number of output positions strictly below c_i.
    # XLA's parallel-scan cumsum is NOT guaranteed monotone (tree
    # reassociation can dip adjacent partial sums by an ulp), and ceil
    # amplifies a dip across an integer boundary into bound[i+1] < bound[i]
    # — which breaks the sorted rank and makes segment starts
    # implementation-dependent.  cummax restores the mathematical
    # monotonicity (observed: about 1 dip per 1M entries).
    bound = jnp.clip(jnp.ceil(c * denom - r), 0, num_out).astype(jnp.int32)
    return jax.lax.cummax(bound)


def _fill_forward(vals: jnp.ndarray, flags: jnp.ndarray) -> jnp.ndarray:
    """Forward-fill rows of ``vals`` (S, C) from the last row with
    ``flags`` set (rows before the first set flag keep their value).
    One associative scan — O(S log S) fully parallel work."""

    def op(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf[:, None], bv, av), af | bf

    v, _ = jax.lax.associative_scan(op, (vals, flags))
    return v


def systematic_resample_particles(
    key: jax.Array,
    particles: jnp.ndarray,
    weights: jnp.ndarray,
    num_out: int,
    count: jnp.ndarray | None = None,
    impl: str = "auto",
) -> jnp.ndarray:
    """(num_out, 3) resampled particles — same draw as
    ``particles[systematic_resample_indices(...)]``.

    impl="gather" (``auto``): sorted-rank indices, then a row gather.
    impl="scan": scatter the particle VALUES at their segment starts and
    forward-fill with an associative scan — no index gather, but log2(N)
    full passes over (N, 3).  All draws are identical by construction
    (tests/test_resampling.py).
    """
    if impl == "auto":
        impl = "gather"
    if impl == "gather":
        idx = systematic_resample_indices(key, weights, num_out, count=count)
        return particles[idx]
    if impl != "scan":
        raise ValueError(
            f"unknown resample impl {impl!r} (expected 'auto', 'gather' "
            f"or 'scan')"
        )
    bound = _segment_bounds(key, weights, num_out, count)
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), bound[:-1]])
    has_copies = bound > prev
    starts = jnp.where(has_copies, prev, num_out)  # num_out -> dropped
    seg_vals = jnp.zeros((num_out, particles.shape[1]), particles.dtype)
    seg_vals = seg_vals.at[starts].set(particles, mode="drop")
    flags = jnp.zeros(num_out, bool).at[starts].set(True, mode="drop")
    return _fill_forward(seg_vals, flags)


def multinomial_resample_indices(
    key: jax.Array, weights: jnp.ndarray, num_out: int
) -> jnp.ndarray:
    """i.i.d. resampling: u_m ~ U(0,1) each (parallel_utils.py:467-477)."""
    u = jax.random.uniform(key, (num_out,))
    return _lookup(_normalized_cumsum(weights), u).astype(jnp.int32)


def _kld_chi2_bound(k: jnp.ndarray, epsilon: float, z: float) -> jnp.ndarray:
    """Wilson-Hilferty chi^2 upper-quantile bound / (2 eps) used as the KLD
    sample-count requirement for k occupied bins (parallel_utils.py:584-585)."""
    km1 = jnp.maximum(k - 1.0, 1.0)
    chi2 = km1 * (1.0 - 2.0 / (9.0 * km1) + jnp.sqrt(2.0 / (9.0 * km1)) * z) ** 3
    return chi2 / (2.0 * epsilon)


def _first_occurrence_sort(bx, by, bt) -> jnp.ndarray:
    """Exact first-occurrence via stable lexsort over the three int32 bin
    coords (no hash packing, which would need int64).  Replaces the
    reference's python ``set`` (parallel_utils.py:549,578-579)."""
    s = bx.shape[0]
    order = jnp.lexsort((bx, by, bt))  # grouping only; key order irrelevant
    sx, sy, st = bx[order], by[order], bt[order]
    differs = (sx[1:] != sx[:-1]) | (sy[1:] != sy[:-1]) | (st[1:] != st[:-1])
    is_new_sorted = jnp.concatenate([jnp.ones(1, dtype=bool), differs])
    out = jnp.zeros(s, dtype=bool)
    return out.at[order].set(is_new_sorted)


_HASH_BITS = 18  # 256k-slot table


def _first_occurrence_hash(bx, by, bt, bits: int = _HASH_BITS) -> jnp.ndarray:
    """Sort-free first-occurrence via a spatial-hash scatter-min table.

    Each sample's bin hashes to a slot; scatter-min of the sample index
    marks the slot's first visitor.  Distinct bins colliding in a slot are
    merged — an undercount of the occupied-bin count k bounded by the
    birthday term ~k^2/2^19 (a few bins at realistic cloud densities),
    statistically negligible for the KLD stopping rule.  An explicit
    alternative to the exact sort (``kld_resample(first_occurrence=
    "hash")``); never chosen automatically.

    The slot hash MUST avalanche AND carry: the classic spatial hash
    (low 18 bits of an XOR of prime products) collides structurally —
    XOR never propagates carries, so products of small bin coords merge
    ~38% of distinct bins even BEFORE masking (measured at 4k bins); a
    murmur finalizer cannot separate inputs that are already equal.
    ADDING the products (carries propagate) and then running a
    murmur3-style finalizer restores the birthday bound (measured 26
    merges at 4k bins vs ~32 predicted).

    The winners are converted back to a per-sample mask by SCATTERING the
    table's winner indices (table-size elements) instead of gathering
    ``table[slot]`` per sample.
    """
    s = bx.shape[0]
    h = (
        bx.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
        + by.astype(jnp.uint32) * jnp.uint32(0x85EBCA77)
        + bt.astype(jnp.uint32) * jnp.uint32(0xC2B2AE3D)
    )
    # murmur3 fmix32 finalizer: full avalanche so the masked low bits
    # depend on every input bit
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    slot = (h & jnp.uint32((1 << bits) - 1)).astype(jnp.int32)
    table = jnp.full(1 << bits, s, dtype=jnp.int32)
    table = table.at[slot].min(jnp.arange(s, dtype=jnp.int32))
    # mask[i] = True iff i won its slot (empty slots hold s -> dropped)
    return jnp.zeros(s, dtype=bool).at[table].set(True, mode="drop")


def _first_occurrence(bx, by, bt, impl: str = "sort") -> jnp.ndarray:
    """(S,) bool: True where bin (bx, by, bt)[m] does not appear earlier.
    ``sort`` is exact; ``hash`` may merge colliding bins."""
    if impl == "hash":
        return _first_occurrence_hash(bx, by, bt)
    if impl != "sort":
        raise ValueError(f"unknown first-occurrence impl {impl!r}")
    return _first_occurrence_sort(bx, by, bt)


def _hash_bits_for(n_samples: int) -> int:
    """Table size for an n-sample first-occurrence pass: ~1x the sample
    count (the distinct-bin load is always well below the sample count at
    stop-relevant densities, and the debias correction absorbs the rest).
    The scatter-back walks the whole table, so an oversized table
    dominates small passes."""
    bits = 14
    while (1 << bits) < n_samples and bits < _HASH_BITS:
        bits += 1
    return bits


def _hash_debias(k_occ: jnp.ndarray, bits: int = _HASH_BITS) -> jnp.ndarray:
    """Occupied-slot count -> expected distinct-bin count for the hash path.

    A table of T slots holding k distinct bins occupies T(1 - e^(-k/T))
    slots in expectation; inverting gives k = -T log1p(-occ/T) — the
    standard load-factor correction for hash-based distinct counting.
    Exact in expectation at every load factor, so the KLD bound sees an
    unbiased bin count even when the table saturates (diffuse clouds).
    """
    t = float(1 << bits)
    occ = jnp.minimum(k_occ.astype(jnp.float32), t - 1.0)
    return -t * jnp.log1p(-occ / t)


def kld_resample(
    key: jax.Array,
    particles: jnp.ndarray,
    weights: jnp.ndarray,
    max_samples: int,
    min_particles: int,
    bin_size_xy: float,
    bin_size_theta: float,
    epsilon: float,
    z: float,
    count: jnp.ndarray | None = None,
    eval_window: int = 0,
    stop_rule: str = "every_sample",
    first_occurrence: str = "sort",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """KLD-adaptive resampling (Fox 2003) with static shapes.

    Mirrors kld_sampling_amcl (parallel_utils.py:529-591): low-variance draws
    over the weight CDF, per-sample Gaussian jitter, xy/theta binning, and
    the Wilson-Hilferty stopping rule "stop once the stored sample count
    exceeds chi2_bound(k)/(2 eps)" with k the number of occupied bins seen so
    far (including the bin the stopping sample would open).

    ``stop_rule``: the reference evaluates the bound ONLY on samples that
    open a new bin (parallel_utils.py:577-586) — a converged cloud whose
    ~10^2 bins are all open well before ``min_particles`` then never
    triggers the stop and the walk degenerates to all ``max_samples``
    draws (measured live at 1M/min=100k: 160 bins, last new bin at
    m=96k, stop never fires).  The default ``"every_sample"`` applies the
    textbook rule (ROS amcl pf.c likewise): stop at the first m with
    k > 1, m >= min_particles and m > chi2_bound(k(m)) regardless of
    whether sample m opens a bin — identical whenever the reference rule
    stops at a new-bin sample past both bounds, and exact (not one-sided)
    always.  ``"new_bin"`` reproduces the reference quirk
    (config.ref_compat_kld_newbin_stop).

    Returns (samples (max_samples, 3), n_kept scalar int32): entries at
    index >= n_kept are drawn but statistically discarded (mask them).

    ``count``: traced number of meaningful output slots to stride over
    (defaults to max_samples, the reference's N_resampled).

    ``eval_window`` (static, 0 = adaptive): with a window set, the stopping
    rule is evaluated on only the first ``eval_window`` draws — EXACT
    whenever a stop occurs inside the window, else ALL max_samples are
    kept (a one-sided deviation that hard-bounds the bin-counting cost).

    With ``eval_window=0`` (default) the evaluation ESCALATES, and so does
    the DRAW: stage 1 draws and evaluates only a ~128k prefix of the
    systematic sequence (prefix-consistent by construction — the stride is
    1/count regardless of how many draws are realized, and the jitter for
    the tail uses a separate fold of the key so the stage-1 rows are
    bitwise-identical in both branches).  Only when no stop occurs in the
    prefix does a lax.cond draw + jitter + evaluate the full range.  EXACT
    at every size: the stop rule at sample m depends only on samples
    <= m, so a prefix stop equals the monolithic stop, and the full branch
    extends the same realized sequence.  A converged cloud (the
    steady-state regime) stops in stage 1 and never pays the full-size
    expand, jitter, or bin counting; a diffuse cloud pays them exactly
    when the reference's python set-loop would also have walked every
    sample (parallel_utils.py:529-591).

    ``first_occurrence``: bin counting by exact lexsort (``"sort"``) or
    by the hash table (``"hash"``, see ``_first_occurrence_hash``).

    Samples at index >= n_kept are implementation-defined (the stage-1
    branch zero-pads them); callers mask by n_kept.
    """
    if stop_rule not in ("every_sample", "new_bin"):
        raise ValueError(f"unknown stop_rule {stop_rule!r}")
    if first_occurrence not in ("sort", "hash"):
        raise ValueError(f"unknown first_occurrence {first_occurrence!r}")
    k_idx, k_noise, k_noise_tail = jax.random.split(key, 3)
    noise_std = jnp.asarray(KLD_NOISE_STD, dtype=particles.dtype)

    def _draw(num_out, k_n):
        """First num_out draws + jitter of the systematic sequence whose
        stride is 1/count (prefix-consistent across num_out)."""
        stride = count if count is not None else jnp.int32(max_samples)
        d = systematic_resample_particles(
            k_idx, particles, weights, num_out, count=stride
        )
        return d + jax.random.normal(k_n, d.shape, d.dtype) * noise_std

    impl = first_occurrence

    def _first_stop(sub):
        """(any_stop, first_stop) of the KLD rule over a samples prefix."""
        # bin ids; int() truncation toward zero like the reference (:573-575)
        bx = (sub[:, 0] / bin_size_xy).astype(jnp.int32)
        by = (sub[:, 1] / bin_size_xy).astype(jnp.int32)
        bt = (sub[:, 2] / bin_size_theta).astype(jnp.int32)
        bits = _hash_bits_for(sub.shape[0])
        new_bin = (
            _first_occurrence_hash(bx, by, bt, bits=bits)
            if impl == "hash" else _first_occurrence_sort(bx, by, bt)
        )
        k_bins = jnp.cumsum(new_bin)  # bins occupied including sample m
        # hash path: slot-collision merges undercount k; debias via the
        # occupancy inversion so the chi^2 bound is unbiased at any load
        k_f = (
            _hash_debias(k_bins, bits) if impl == "hash"
            else k_bins.astype(jnp.float32)
        )
        m = jnp.arange(sub.shape[0])
        # stopping test with m samples already stored (reference: `count`
        # samples stored, breaks before storing); under the reference
        # "new_bin" quirk it is additionally gated on sample m opening a
        # new bin
        required = _kld_chi2_bound(k_f, epsilon, z)
        stop_here = (k_bins > 1) & (m >= min_particles) & (m > required)
        if stop_rule == "new_bin":
            stop_here = new_bin & stop_here
        return jnp.any(stop_here), jnp.argmax(stop_here).astype(jnp.int32)

    if min_particles >= max_samples:
        # the caller clamps the new count to [min_particles, max_samples],
        # so with min == max the stopping rule is provably dead — skip the
        # bin-counting machinery entirely; draws and jitter semantics are
        # unchanged
        return _draw(max_samples, k_noise), jnp.int32(max_samples)

    if eval_window and eval_window < max_samples:
        samples = _draw(max_samples, k_noise)
        any_stop, first_stop = _first_stop(samples[:eval_window])
        n_kept = jnp.where(any_stop, first_stop, max_samples)
        return samples, n_kept.astype(jnp.int32)

    # stage-1 window: headroom of ~max(32k, min/4) past min_particles —
    # converged clouds stop within a few thousand draws of the min, and a
    # tighter window keeps the bin-counting pass small
    w1 = max(_KLD_STAGE1, min_particles + min_particles // 4)
    if w1 < max_samples:
        samples1 = _draw(w1, k_noise)  # == full sequence rows [0, w1)
        a1, f1 = _first_stop(samples1)
        pad = jnp.zeros((max_samples - w1, 3), samples1.dtype)

        # The escalation is a while_loop, not lax.cond: XLA may execute
        # both sides of a big data-flow conditional, while a while body is
        # real control flow that runs only when entered, so steady-state
        # steps (stage-1 stop fires) never pay the full-size
        # expand/jitter/bin count; the body runs at most once (`done`
        # flips after one iteration).
        def _cond(carry):
            done, _, _ = carry
            return jnp.logical_not(done)

        def _body(carry):
            _, _, _ = carry
            drawn = systematic_resample_particles(
                k_idx, particles, weights, max_samples,
                count=count if count is not None else jnp.int32(max_samples),
            )
            tail = (
                jax.random.normal(
                    k_noise_tail, (max_samples - w1, 3), drawn.dtype
                ) * noise_std
            )
            # rows [0, w1) reuse samples1 (same k_idx bounds + k_noise
            # jitter -> bitwise-equal prefix; the tail extends the
            # realized sequence instead of redrawing it)
            samples = jnp.concatenate([samples1, drawn[w1:] + tail])
            a2, f2 = _first_stop(samples)
            n2 = jnp.where(a2, f2, max_samples).astype(jnp.int32)
            return jnp.bool_(True), samples, n2

        init = (a1, jnp.concatenate([samples1, pad]), f1)
        _, samples, n_kept = jax.lax.while_loop(_cond, _body, init)
        return samples, n_kept

    samples = _draw(max_samples, k_noise)
    any_stop, first_stop = _first_stop(samples)
    n_kept = jnp.where(any_stop, first_stop, max_samples)
    return samples, n_kept.astype(jnp.int32)
