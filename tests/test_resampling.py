"""Resampler tests: softmax conversion, unbiasedness, LVR variance, KLD
bin-count stopping vs a python-set golden implementation."""

import jax
import jax.numpy as jnp
import numpy as np

from mcmh_localization.ops.resampling import (
    KLD_NOISE_STD,
    _first_occurrence,
    _kld_chi2_bound,
    effective_sample_size,
    kld_resample,
    multinomial_resample_indices,
    softmax_weights,
    systematic_resample_indices,
)
from tests.reference_impl import ref_kld_stop_count


def test_softmax_weights_matches_reference_form():
    scores = jnp.array([-3.0, -1.0, -2.0, -10.0])
    w = np.asarray(softmax_weights(scores))
    e = np.exp(np.asarray(scores) - (-1.0))
    np.testing.assert_allclose(w, e / e.sum(), rtol=1e-6)
    assert abs(w.sum() - 1.0) < 1e-6


def test_softmax_weights_masked():
    scores = jnp.array([0.0, 5.0, 100.0, 200.0])
    mask = jnp.array([True, True, False, False])
    w = np.asarray(softmax_weights(scores, mask))
    assert w[2] == 0 and w[3] == 0
    np.testing.assert_allclose(w[:2].sum(), 1.0, atol=1e-6)


def test_ess():
    w = jnp.full(100, 0.01)
    assert abs(float(effective_sample_size(w)) - 100.0) < 1e-3
    w2 = jnp.zeros(100).at[0].set(1.0)
    assert abs(float(effective_sample_size(w2)) - 1.0) < 1e-6


def test_systematic_unbiased():
    # E[count_i] = N * w_i; systematic guarantees floor(N w_i) <= count_i
    w = jnp.array([0.1, 0.4, 0.2, 0.3])
    idx = np.asarray(systematic_resample_indices(jax.random.PRNGKey(0), w, 1000))
    counts = np.bincount(idx, minlength=4) / 1000
    np.testing.assert_allclose(counts, np.asarray(w), atol=0.002)


def test_systematic_with_padded_zero_weights():
    w = jnp.concatenate([jnp.array([0.5, 0.5]), jnp.zeros(6)])
    idx = np.asarray(systematic_resample_indices(jax.random.PRNGKey(1), w, 100))
    assert set(idx.tolist()) <= {0, 1}


def test_systematic_count_stride():
    # with count=M < num_out, the first M draws behave like an M-resampler
    w = jnp.array([0.25, 0.25, 0.25, 0.25])
    idx = np.asarray(
        systematic_resample_indices(
            jax.random.PRNGKey(2), w, 8, count=jnp.int32(4)
        )
    )
    # exactly one draw per quartile among the first 4
    assert sorted(idx[:4].tolist()) == [0, 1, 2, 3]


def test_multinomial_unbiased():
    w = jnp.array([0.7, 0.1, 0.2])
    idx = np.asarray(multinomial_resample_indices(jax.random.PRNGKey(3), w, 20000))
    counts = np.bincount(idx, minlength=3) / 20000
    np.testing.assert_allclose(counts, np.asarray(w), atol=0.02)


def test_lvr_lower_variance_than_multinomial():
    w = jnp.asarray(np.random.default_rng(0).dirichlet(np.ones(50)).astype(np.float32))
    n = 500
    sys_var, mult_var = [], []
    for s in range(20):
        i1 = np.bincount(
            np.asarray(systematic_resample_indices(jax.random.PRNGKey(s), w, n)),
            minlength=50,
        )
        i2 = np.bincount(
            np.asarray(multinomial_resample_indices(jax.random.PRNGKey(100 + s), w, n)),
            minlength=50,
        )
        sys_var.append(((i1 / n - np.asarray(w)) ** 2).sum())
        mult_var.append(((i2 / n - np.asarray(w)) ** 2).sum())
    assert np.mean(sys_var) < np.mean(mult_var)


def test_first_occurrence():
    bx = jnp.array([5, 3, 5, 7, 3, 3, 9])
    by = jnp.array([1, 1, 1, 1, 1, 2, 1])
    bt = jnp.array([0, 0, 0, 0, 0, 0, 0])
    out = np.asarray(_first_occurrence(bx, by, bt))
    # (3,1) repeats at idx 4; (3,2) at idx 5 is a NEW bin
    assert out.tolist() == [True, True, False, True, False, True, True]


def test_kld_stopping_matches_golden():
    # a handful of clusters -> small occupied-bin count k -> the chi^2 bound
    # m > chi2(k)/(2 eps) trips at a data-dependent early stopping point
    rng = np.random.default_rng(4)
    n = 400
    particles = jnp.asarray(
        rng.normal(scale=[1.0, 1.0, 0.4], size=(n, 3)).astype(np.float32)
    )
    weights = jnp.full(n, 1.0 / n)
    for rule in ("every_sample", "new_bin"):
        for eps, expect_early in ((0.3, True), (0.5, True), (0.05, False)):
            samples, n_kept = kld_resample(
                jax.random.PRNGKey(5), particles, weights,
                max_samples=n, min_particles=20,
                bin_size_xy=0.5, bin_size_theta=0.3, epsilon=eps, z=2.0,
                stop_rule=rule,
            )
            golden = ref_kld_stop_count(
                np.asarray(samples), 0.5, 0.3, eps, 2.0, n, 20, rule=rule
            )
            assert int(n_kept) == golden, (rule, eps, int(n_kept), golden)
            if expect_early:
                assert 20 <= int(n_kept) < n


def test_kld_spread_runs_to_max():
    # widely spread particles: k grows ~ with m, bound never trips -> keeps
    # all max_samples (matches the python-set golden)
    rng = np.random.default_rng(14)
    n = 400
    particles = jnp.asarray(
        np.stack(
            [rng.uniform(-5, 5, n), rng.uniform(-5, 5, n), rng.uniform(-3, 3, n)],
            axis=1,
        ).astype(np.float32)
    )
    weights = jnp.full(n, 1.0 / n)
    samples, n_kept = kld_resample(
        jax.random.PRNGKey(15), particles, weights,
        max_samples=n, min_particles=20,
        bin_size_xy=0.5, bin_size_theta=0.3, epsilon=0.05, z=2.0,
    )
    golden = ref_kld_stop_count(np.asarray(samples), 0.5, 0.3, 0.05, 2.0, n, 20)
    assert int(n_kept) == golden == n


def test_kld_concentrated_stops_at_min():
    # all particles in one bin -> k=1 forever -> never triggers the k>1
    # stopping rule -> runs to max_samples (both stop rules agree).  The
    # pose sits at bin centers: on an edge (e.g. 1.0/0.5) the 1mm jitter
    # would straddle two bins and k>1 would fire the every-sample stop.
    particles = jnp.tile(jnp.array([[0.7, 0.7, 0.2]]), (200, 1))
    weights = jnp.full(200, 1.0 / 200)
    _, n_kept = kld_resample(
        jax.random.PRNGKey(6), particles, weights,
        max_samples=200, min_particles=10,
        bin_size_xy=0.5, bin_size_theta=0.5, epsilon=0.05, z=2.0,
    )
    assert int(n_kept) == 200


def test_kld_stop_rule_saturated_bins():
    """Converged cloud whose few bins are all open long before
    min_particles: the reference new-bin rule never stops again (walks to
    max_samples) while the default every-sample rule stops right at
    min_particles — the live 1M/min=100k degenerate regime diagnosed in
    scripts/microbench18.py (160 bins, last new bin at m=96k)."""
    rng = np.random.default_rng(8)
    n = 8192
    particles = jnp.asarray(
        (np.array([0.5, 0.5, 0.0])
         + rng.normal(size=(n, 3)) * np.array([0.05, 0.05, 0.02]))
        .astype(np.float32)
    )
    w = jnp.full((n,), 1.0 / n, jnp.float32)
    kw = dict(max_samples=n, min_particles=4096, bin_size_xy=0.5,
              bin_size_theta=0.3, epsilon=0.3, z=2.0)
    _, k_ref = kld_resample(jax.random.PRNGKey(9), particles, w,
                            stop_rule="new_bin", **kw)
    _, k_def = kld_resample(jax.random.PRNGKey(9), particles, w, **kw)
    assert int(k_ref) == n, int(k_ref)       # quirk: stop never fires
    assert int(k_def) == 4096, int(k_def)    # textbook: stops at min


def test_kld_bound_monotone():
    ks = jnp.array([2.0, 5.0, 20.0, 100.0])
    b = np.asarray(_kld_chi2_bound(ks, 0.05, 2.0))
    assert np.all(np.diff(b) > 0)


def test_kld_jitter_scale():
    particles = jnp.tile(jnp.array([[2.0, -1.0, 0.5]]), (5000, 1))
    weights = jnp.full(5000, 1.0 / 5000)
    samples, _ = kld_resample(
        jax.random.PRNGKey(7), particles, weights,
        max_samples=5000, min_particles=10,
        bin_size_xy=0.5, bin_size_theta=0.5, epsilon=0.05, z=2.0,
    )
    s = np.asarray(samples)
    np.testing.assert_allclose(s.mean(0), [2.0, -1.0, 0.5], atol=0.01)
    np.testing.assert_allclose(s.std(0), KLD_NOISE_STD, rtol=0.15)



def test_scan_expansion_matches_gather():
    """impl="scan" (scatter values + associative fill-forward) must produce
    exactly particles[idx] from impl="gather" — same key, same bounds."""
    from mcmh_localization.ops.resampling import (
        systematic_resample_particles,
    )

    rng = np.random.default_rng(11)
    n = 4096
    particles = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    w = jnp.asarray(rng.exponential(size=n).astype(np.float32))
    w = w / jnp.sum(w)
    key = jax.random.PRNGKey(5)
    for count in (None, jnp.int32(1000)):
        a = systematic_resample_particles(
            key, particles, w, n, count=count, impl="gather")
        b = systematic_resample_particles(
            key, particles, w, n, count=count, impl="scan")
        if count is None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            c = int(count)
            np.testing.assert_array_equal(
                np.asarray(a)[:c], np.asarray(b)[:c])


def test_kld_eval_window_exact_when_stopped():
    """With the stop point inside the window, eval_window gives the exact
    full-evaluation n_kept; a window excluding the stop keeps everything
    (the documented one-sided deviation)."""
    from mcmh_localization.ops.resampling import kld_resample

    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(7)
    n = 8192
    # converged cloud: tight cluster -> few bins -> early stop
    particles = jnp.asarray(
        (rng.normal(size=(n, 3)) * np.array([0.05, 0.05, 0.02]))
        .astype(np.float32)
    )
    w = jnp.full((n,), 1.0 / n, jnp.float32)
    kw = dict(max_samples=n, min_particles=16, bin_size_xy=0.2,
              bin_size_theta=0.1745, epsilon=0.03, z=2.0)
    s_full, k_full = kld_resample(key, particles, w, **kw)
    s_win, k_win = kld_resample(key, particles, w, eval_window=4096, **kw)
    assert int(k_full) < 4096  # the premise: stop inside the window
    assert int(k_full) == int(k_win)
    np.testing.assert_array_equal(np.asarray(s_full), np.asarray(s_win))

    # spread cloud: no stop inside a tiny window -> keep all
    spread = jnp.asarray((rng.uniform(-8, 8, (n, 3))).astype(np.float32))
    _, k_spread = kld_resample(key, spread, w, eval_window=256, **kw)
    assert int(k_spread) == n


def test_first_occurrence_hash_forced():
    """The explicit spatial-hash first-occurrence path:
    matches the exact sort path up to the birthday-bound ~k^2/2^19 slot
    collisions (the add+fmix hash must hit this bound; the original
    XOR-of-products hash merged 38% of bins here)."""
    from mcmh_localization.ops.resampling import (
        _first_occurrence_hash,
        _first_occurrence_sort,
    )

    rng = np.random.default_rng(11)
    n = 20000
    # realistic tracking-cloud density: ~4k distinct bins; expected
    # distinct-bin collisions in the 2^18-slot table ~ k^2/2^19 ~ 32
    bx = jnp.asarray(rng.integers(-8, 8, n).astype(np.int32))
    by = jnp.asarray(rng.integers(-8, 8, n).astype(np.int32))
    bt = jnp.asarray(rng.integers(-8, 8, n).astype(np.int32))
    got = np.asarray(_first_occurrence_hash(bx, by, bt))
    want = np.asarray(_first_occurrence_sort(bx, by, bt))
    # a collision merges two distinct bins: strictly an UNDERCOUNT of
    # occupied bins, bounded by the ~k^2/2^19 birthday term (x4 slack)
    k = want.sum()
    assert got.sum() <= k
    assert (k - got.sum()) / k < 4.0 * k / 2 ** 19, (got.sum(), k)
    # per-sample mask disagreements stay in the same collision budget
    assert np.mean(got != want) < 4.0 * k ** 2 / 2 ** 19 / n


def test_hash_debias_recovers_distinct_count():
    """The occupancy->distinct inversion recovers the true bin count
    within a few percent from tracking density up to table saturation."""
    from mcmh_localization.ops.resampling import (
        _first_occurrence_hash,
        _first_occurrence_sort,
        _hash_debias,
    )

    rng = np.random.default_rng(5)
    for n, span in [(20000, 8), (200000, 60)]:
        bx = jnp.asarray(rng.integers(-span, span, n).astype(np.int32))
        by = jnp.asarray(rng.integers(-span, span, n).astype(np.int32))
        bt = jnp.asarray(rng.integers(-16, 16, n).astype(np.int32))
        occ = int(np.asarray(_first_occurrence_hash(bx, by, bt)).sum())
        k_true = int(np.asarray(_first_occurrence_sort(bx, by, bt)).sum())
        k_est = float(_hash_debias(jnp.int32(occ)))
        assert abs(k_est - k_true) / k_true < 0.03, (n, occ, k_true, k_est)


def test_kld_escalation_exact():
    """eval_window=0 escalates the draw+evaluation: with the stage-1
    window shrunk so both branches are exercised, each branch's stopping
    point must match the python-set golden walk over the sequence the
    call actually realized (samples beyond n_kept are padding in the
    stage-1 branch; the golden walk never reaches them when it stops at
    the same point)."""
    from mcmh_localization.ops import resampling as rs

    key = jax.random.PRNGKey(7)
    n = 4096
    w = jnp.full((n,), 1.0 / n, jnp.float32)
    kw = dict(max_samples=n, min_particles=20, bin_size_xy=0.5,
              bin_size_theta=0.3, epsilon=0.3, z=2.0)

    orig = rs._KLD_STAGE1
    rs._KLD_STAGE1 = 128
    try:
        # clustered cloud: the rule trips early -> STAGE-1 branch
        rng = np.random.default_rng(4)
        clustered = jnp.asarray(
            rng.normal(scale=[0.3, 0.3, 0.1], size=(n, 3)).astype(np.float32)
        )
        samples1, k1 = rs.kld_resample(key, clustered, w, **kw)
        golden1 = ref_kld_stop_count(
            np.asarray(samples1), 0.5, 0.3, 0.3, 2.0, n, 20
        )
        assert int(k1) == golden1, (int(k1), golden1)
        assert int(k1) < 128  # really stopped inside stage 1
        # stage-1 branch zero-pads the tail
        assert np.all(np.asarray(samples1)[2048:] == 0.0)

        # spread cloud + tight epsilon: no stage-1 stop -> FULL branch
        # (prefix + extended tail); the golden walk must reproduce the
        # stop over that exact realized sequence
        spread = jnp.asarray(
            rng.uniform(-50, 50, size=(n, 3)).astype(np.float32)
        )
        kw2 = dict(kw, epsilon=0.05)
        samples2, k2 = rs.kld_resample(key, spread, w, **kw2)
        golden2 = ref_kld_stop_count(
            np.asarray(samples2), 0.5, 0.3, 0.05, 2.0, n, 20
        )
        assert int(k2) == golden2 == n
        # full-branch output is real draws everywhere, not padding
        assert np.all(np.abs(np.asarray(samples2)) > 0.0)
    finally:
        rs._KLD_STAGE1 = orig
