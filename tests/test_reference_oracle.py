"""Gold oracle: execute the REFERENCE'S OWN kernels, not a re-derivation.

Every other parity test in this suite compares against
``tests/reference_impl.py`` — a hand-written numpy re-derivation of
``parallel_utils.py``.  Round-4 verdict Missing-1: that chain is "a
reimplementation of a reimplementation".  ``parallel_utils.py`` imports only
numpy + numba (``app/scripts/parallel_utils.py:1-2``), so with
``numba.njit`` stubbed to identity (numba is not installed here) the file
executes directly as the gold oracle.  These tests run the reference's actual
code at small N and assert:

  * per-particle log-likelihoods (``compute_likelihoods``, :85-149) match
    ``models/sensor.py::likelihood_field_scores`` to f32 tolerance;
  * MH accept decisions on SHARED uniforms (``mh_resampling`` :208-236,
    ``assym_mh_resampling`` :238-276 incl. the ``log_den > 0`` quirk) match
    ``filter/mh.py``;
  * KLD-sampling stop counts (``kld_sampling_amcl`` :529-591) match
    ``ops/resampling.py::kld_resample(stop_rule="new_bin")`` on identical
    realized draw sequences (uniform weights + zero jitter make the
    low-variance index sequence r-independent so both sides see the same
    samples);
  * odometry motion densities (``motion_model_odometry_parallel`` :282-330)
    match ``models/motion.py::motion_density``.

The reference module is loaded fresh per test session from the reference
project's checkout named by MCMH_REFERENCE_REPO; nothing is copied, and the
tests skip when that checkout is not available.
"""

import importlib.util
import sys
import types

import numpy as np
import pytest

from tests.reference_impl import reference_file


@pytest.fixture(scope="module")
def ref():
    """Load parallel_utils.py with numba stubbed to identity.

    ``@njit`` / ``@njit(parallel=True)`` both must work; ``prange`` becomes
    ``range``.  The stub lives only in this module's import, and the real
    ``numba`` entry (absent in this image) is restored after load.
    """

    def njit(*args, **kwargs):
        if args and callable(args[0]) and not kwargs:
            return args[0]

        def deco(fn):
            return fn

        return deco

    stub = types.ModuleType("numba")
    stub.njit = njit
    stub.prange = range
    ref_path = reference_file("app/scripts/parallel_utils.py")
    if ref_path is None:
        pytest.skip("the reference's app/scripts/parallel_utils.py is not "
                    "available (set MCMH_REFERENCE_REPO to its checkout)")
    saved = sys.modules.get("numba")
    sys.modules["numba"] = stub
    try:
        spec = importlib.util.spec_from_file_location("ref_parallel_utils",
                                                      ref_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            sys.modules.pop("numba", None)
        else:
            sys.modules["numba"] = saved
    return mod


def _free_particles(house_map, n, rng):
    """n poses on free cells of the fixture map (world coords)."""
    import numpy as _np

    occ = _np.asarray(house_map.occupancy)
    free_y, free_x = _np.where(occ == 0)
    pick = rng.integers(0, len(free_y), n)
    res = float(house_map.resolution)
    ox, oy = (float(v) for v in _np.asarray(house_map.origin))
    x = ox + (free_x[pick] + 0.5) * res
    y = oy + (free_y[pick] + 0.5) * res
    th = rng.uniform(-_np.pi, _np.pi, n)
    return _np.stack([x, y, th], axis=1).astype(_np.float32)


def test_compute_likelihoods_gold(ref, house_map):
    """Reference compute_likelihoods == likelihood_field_scores, f32 tol."""
    import jax.numpy as jnp

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.models.sensor import likelihood_field_scores

    rng = np.random.default_rng(7)
    n, m = 256, 90
    particles = _free_particles(house_map, n, rng)
    angles = np.linspace(-np.pi, np.pi, m, endpoint=False).astype(np.float32)
    max_range = 5.0
    ranges = rng.uniform(0.2, 6.0, m).astype(np.float32)
    ranges[::17] = np.inf            # dropouts
    ranges[::23] = max_range + 1.0   # beyond max_range -> invalid

    cfg = FilterConfig(
        num_particles=n, max_particles=n, min_particles=n,
        sigma_hit=0.35, z_hit=0.9, z_rand=0.1, max_range=max_range, step=2,
    )
    dist = np.asarray(house_map.distance, np.float32)
    origin = np.asarray(house_map.origin, np.float64)
    gold = ref.compute_likelihoods(
        ranges.astype(np.float64), angles.astype(np.float64),
        particles.astype(np.float64), dist.ravel(),
        float(house_map.resolution), origin,
        house_map.width, house_map.height,
        sigma_hit=0.35, z_hit=0.9, z_rand=0.1, max_range=max_range, step=2,
    )
    mine = np.asarray(likelihood_field_scores(
        jnp.asarray(particles), jnp.asarray(ranges), jnp.asarray(angles),
        house_map, cfg,
    ))
    # gold accumulates in float64 on a float32 field; scores are O(1) logs
    np.testing.assert_allclose(mine, gold, rtol=2e-4, atol=2e-4)
    assert np.std(gold) > 0.1  # non-degenerate fixture: scores spread


def test_mh_symmetric_accepts_gold(ref, monkeypatch):
    """Accept decisions of mh_resampling on shared uniforms."""
    import jax.numpy as jnp
    import jax.random

    from mcmh_localization.filter.mh import symmetric_mh

    rng = np.random.default_rng(3)
    n = 512
    prev = rng.normal(size=(n, 3))
    prop = prev + rng.normal(scale=0.1, size=(n, 3))
    w_pre = rng.uniform(0.0, 1.0, n)
    w_pre[::50] = 0.0  # exercise the p_old <= 0 always-accept guard
    w_post = rng.uniform(0.0, 1.0, n)

    # the reference consumes one np.random.rand() per particle in loop
    # order; re-seeding and drawing the same MT19937 sequence yields the
    # exact uniforms it used
    np.random.seed(1234)
    gp, gw = ref.mh_resampling(prev.copy(), prop.copy(), w_post.copy(),
                               w_pre.copy())
    np.random.seed(1234)
    u = np.random.rand(n)

    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=None, **kw: jnp.asarray(u))
    mp, mw, accept = symmetric_mh(
        jax.random.PRNGKey(0), jnp.asarray(prev), jnp.asarray(prop),
        jnp.asarray(w_post), jnp.asarray(w_pre),
    )
    gold_accept = np.any(gp != prev, axis=1) | (
        np.all(prop == prev, axis=1) & (gw == w_post))
    # identical uniforms + identical alphas -> identical decisions
    np.testing.assert_array_equal(np.asarray(accept), gold_accept)
    np.testing.assert_allclose(np.asarray(mw), gw, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mp), gp, rtol=1e-6)
    assert 0 < gold_accept.sum() < n  # both branches exercised


def test_mh_asymmetric_accepts_gold(ref, monkeypatch):
    """assym_mh_resampling incl. its log_den>0 guard (quirk flag ON)."""
    import jax.numpy as jnp
    import jax.random

    from mcmh_localization.filter.mh import asymmetric_mh

    rng = np.random.default_rng(5)
    n = 512
    prev = rng.normal(size=(n, 3))
    prop = prev + rng.normal(scale=0.1, size=(n, 3))
    w_pre = rng.uniform(0.0, 4.0, n)   # some log_den > 0, some < 0
    w_post = rng.uniform(0.0, 4.0, n)
    tf = rng.uniform(0.1, 2.0, n)
    tb = rng.uniform(0.1, 2.0, n)

    np.random.seed(99)
    gp, gw = ref.assym_mh_resampling(prev.copy(), prop.copy(), w_post.copy(),
                                     w_pre.copy(), tf, tb)
    np.random.seed(99)
    u = np.random.rand(n)

    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=None, **kw: jnp.asarray(u))
    mp, mw, accept = asymmetric_mh(
        jax.random.PRNGKey(0), jnp.asarray(prev), jnp.asarray(prop),
        jnp.asarray(w_post), jnp.asarray(w_pre),
        jnp.asarray(tf), jnp.asarray(tb), ref_compat_guard=True,
    )
    gold_accept = np.any(gp != prev, axis=1)
    np.testing.assert_array_equal(np.asarray(accept), gold_accept)
    np.testing.assert_allclose(np.asarray(mw), gw, rtol=1e-5)
    assert 0 < gold_accept.sum() < n


def test_kld_stop_count_gold(ref, monkeypatch):
    """kld_sampling_amcl stop count == kld_resample(stop_rule="new_bin").

    Uniform weights make the low-variance index sequence exactly
    0,1,2,... for ANY offset r, and the per-sample jitter is zeroed on
    both sides (reference: numpy.random shim in its module globals; mine:
    KLD_NOISE_STD patched), so both walk the identical particle sequence
    and the comparison isolates the bin math (int() truncation toward
    zero, :573-575) and the Wilson-Hilferty new-bin stop rule (:578-586).
    """
    import jax.random

    import mcmh_localization.ops.resampling as rs

    rng = np.random.default_rng(11)
    max_samples = 4000
    min_particles = 200
    # clustered cloud: ~60 occupied bins so the stop fires well before
    # max_samples; include negative coords to exercise int() truncation
    centers = rng.uniform(-3.0, 3.0, (60, 3))
    particles = np.repeat(centers, max_samples // 60 + 1, axis=0)[
        :max_samples].astype(np.float32)
    weights = np.full(max_samples, 1.0 / max_samples)

    class _RandShim:
        """numpy.random lookalike: zero jitter, midpoint low-variance offset.

        r must be STRICTLY inside (0, 1/max_samples): r = 0 puts every
        u_m = m/M exactly on a CDF boundary of the uniform-weight cumsum,
        where the reference's `while u > c` strict compare resolves to
        index m-1 while any interior r (including kld_resample's
        key-derived one) resolves to index m — a float-boundary artifact
        of the shim, not a semantic difference."""

        @staticmethod
        def uniform(lo, hi, *a, **k):
            return (lo + hi) / 2.0

        @staticmethod
        def normal(mu, std, *a, **k):
            return 0.0

    class _NpShim:
        def __getattr__(self, name):
            if name == "random":
                return _RandShim()
            return getattr(np, name)

    monkeypatch.setitem(ref.__dict__, "np", _NpShim())
    gold = ref.kld_sampling_amcl(
        particles, weights, bin_size_xy=0.5, bin_size_theta=np.pi / 6,
        epsilon=0.05, z=3.0, max_samples=max_samples,
        min_particles=min_particles,
    )
    monkeypatch.setitem(ref.__dict__, "np", np)

    monkeypatch.setattr(rs, "KLD_NOISE_STD", (0.0, 0.0, 0.0))
    _samples, n_kept = rs.kld_resample(
        jax.random.PRNGKey(0), particles, weights,
        max_samples=max_samples, min_particles=min_particles,
        bin_size_xy=0.5, bin_size_theta=float(np.pi / 6),
        epsilon=0.05, z=3.0, stop_rule="new_bin",
    )
    assert min_particles < len(gold) < max_samples  # stop actually fired
    assert int(n_kept) == len(gold)


def test_motion_density_gold(ref, house_map):
    """motion_model_odometry_parallel == motion_density (normalized)."""
    import jax.numpy as jnp

    from mcmh_localization.models.motion import motion_density

    rng = np.random.default_rng(21)
    n = 512
    prev = _free_particles(house_map, n, rng).astype(np.float64)
    delta = np.array([0.12, 0.3, -0.08])
    alpha = (0.1, 0.1, 0.05, 0.05)
    # current poses: noisy application of the odometry delta
    r1 = delta[0] + rng.normal(0, 0.05, n)
    t = delta[1] + rng.normal(0, 0.05, n)
    r2 = delta[2] + rng.normal(0, 0.05, n)
    curr = np.stack([
        prev[:, 0] + t * np.cos(prev[:, 2] + r1),
        prev[:, 1] + t * np.sin(prev[:, 2] + r1),
        prev[:, 2] + r1 + r2,
    ], axis=1)

    gold = ref.motion_model_odometry_parallel(prev, curr, delta, alpha)
    mine = np.asarray(motion_density(
        jnp.asarray(prev, jnp.float32), jnp.asarray(curr, jnp.float32),
        jnp.asarray(delta, jnp.float32), alpha,
    ))
    np.testing.assert_allclose(mine, gold, rtol=5e-3, atol=1e-9)
    assert np.std(gold) > 0  # non-degenerate
