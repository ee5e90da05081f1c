"""The plain XLA paths that replaced the former hand-written kernels, checked
against NumPy at the kernels' old test shapes and edge cases: per-particle
table lookups (2-D, wide, 3-D, clustered, fine/coarse select), the exact
scorer, and the systematic-resampling rank and expansion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmh_localization.config import FilterConfig
from mcmh_localization.models.sensor import (
    BLIND_SCORE,
    likelihood_field_scores,
    log_likelihood_field,
    raycast,
)
from mcmh_localization.ops.resampling import (
    _segment_bounds,
    rank_in_sorted,
    systematic_resample_indices,
    systematic_resample_particles,
)
from tests.reference_impl import (
    ref_likelihood_field_scores,
    ref_likelihood_field_scores_np,
    ref_systematic_indices,
)


def _grid_map(occ, res=0.05, origin=(0.0, 0.0)):
    from mcmh_localization.maps.grid_map import build_grid_map

    return build_grid_map(occ, res, origin, edt_impl="scipy")


# -- per-particle lookups ----------------------------------------------------

@pytest.mark.parametrize("h, w, n, rows", [
    (256, 128, 8192, None),        # square table
    (192, 384, 9000, None),        # wide table
    (2048, 128, 8192, (700, 760)),  # clustered rows
    (64, 80, 500, None),           # small, few particles
])
def test_is_free_world_matches_numpy(h, w, n, rows):
    rng = np.random.default_rng(h + w)
    occ = np.where(rng.random((h, w)) < 0.3, 100, 0).astype(np.int8)
    gm = _grid_map(occ, res=0.1, origin=(-1.0, -2.0))
    ys = (rng.integers(*rows, n) if rows else rng.integers(-5, h + 5, n))
    xs = rng.integers(-5, w + 5, n)
    px = -1.0 + (xs + 0.5) * 0.1
    py = -2.0 + (ys + 0.5) * 0.1
    px, py = px.astype(np.float32), py.astype(np.float32)
    got = np.asarray(gm.is_free_world(jnp.asarray(px), jnp.asarray(py)))
    # toward-zero truncation, like the reference's int() cast
    cx = ((px - np.float32(-1.0)) / np.float32(0.1)).astype(np.int32)
    cy = ((py - np.float32(-2.0)) / np.float32(0.1)).astype(np.int32)
    inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    want = inside & (occ[np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)] == 0)
    np.testing.assert_array_equal(got, want)


def test_voxel_distance_lookup_matches_numpy():
    """3-D lookups: the lidar scorer's gathered distances (checked through
    its score) equal a NumPy evaluation over the (D, H, W) volume."""
    from mcmh_localization.maps.voxel_map import build_voxel_map
    from mcmh_localization.models.sensor import LOG_FLOOR
    from mcmh_localization.models.sensor3d import lidar3d_scores

    occ = np.zeros((16, 64, 96), np.int8)
    occ[:, 0, :] = occ[:, -1, :] = occ[:, :, 0] = occ[:, :, -1] = 100
    occ[0] = 100
    occ[4:9, 20:30, 40:50] = 100
    vm = build_voxel_map(occ, 0.1, (-4.8, -3.2, 0.0))
    rng = np.random.default_rng(3)
    n, m = 300, 48
    parts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2.5, 2.5, n),
                      rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    dirs = np.stack([rng.uniform(-np.pi, np.pi, m),
                     rng.uniform(-0.3, 0.3, m)], 1).astype(np.float32)
    ranges = rng.uniform(0.3, 3.5, m).astype(np.float32)
    cfg = FilterConfig(max_range=3.0)
    got = np.asarray(lidar3d_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(dirs), vm, cfg,
        sensor_z=0.5))
    dist = np.asarray(vm.distance)
    valid = ranges < cfg.max_range
    r, az, el = ranges[valid], dirs[valid, 0], dirs[valid, 1]
    want = np.empty(n)
    for i, (x, y, th) in enumerate(parts.astype(np.float64)):
        ex = x + r * np.cos(el) * np.cos(th + az)
        ey = y + r * np.cos(el) * np.sin(th + az)
        ez = 0.5 + r * np.sin(el)
        vx = np.floor((ex + 4.8) / 0.1).astype(int)
        vy = np.floor((ey + 3.2) / 0.1).astype(int)
        vz = np.floor(ez / 0.1).astype(int)
        ok = ((vx >= 0) & (vx < 96) & (vy >= 0) & (vy < 64) & (vz >= 0)
              & (vz < 16))
        d = dist[np.clip(vz, 0, 15), np.clip(vy, 0, 63), np.clip(vx, 0, 95)]
        ph = np.exp(-0.5 * (d / cfg.sigma_hit) ** 2) / (
            np.sqrt(2 * np.pi) * cfg.sigma_hit)
        lp = np.log(np.maximum(cfg.z_hit * ph + cfg.z_rand / cfg.max_range,
                               LOG_FLOOR))
        want[i] = np.where(ok, lp, 0.0).sum() / valid.sum()
    # endpoints on a voxel face may flip cells (float32 vs float64)
    close = np.abs(got - want) < 1e-4
    assert close.mean() > 0.95, close.mean()
    assert np.abs(got - want).max() < 14.0 / valid.sum()


def _corr_reference(lf, parts, ranges, angles, res, n_theta, valid_max):
    """Correlation-field scores from the definition: per particle, cell and
    theta-bin center, sum the log field at every valid beam's offset
    endpoint (0 outside the map), divided by the valid-beam count."""
    h, w = lf.shape
    valid = np.isfinite(ranges) & (ranges < valid_max)
    u = np.where(valid, ranges, 0) * np.cos(angles)
    v = np.where(valid, ranges, 0) * np.sin(angles)
    out = np.empty(len(parts))
    for i, (x, y, th) in enumerate(parts):
        mx, my = int(x / res), int(y / res)
        k = int((th + np.pi) * n_theta / (2 * np.pi)) % n_theta
        t = (k + 0.5) * 2 * np.pi / n_theta - np.pi
        ox = np.trunc((np.cos(t) * u - np.sin(t) * v) / res).astype(int)
        oy = np.trunc((np.sin(t) * u + np.cos(t) * v) / res).astype(int)
        cx, cy = mx + ox, my + oy
        ok = valid & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        out[i] = lf[np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)][ok].sum()
    return out / max(valid.sum(), 1)


@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("field_impl", ["xla", "dft"])
def test_corr_lookup_matches_definition(house_occupancy, window, field_impl):
    """One lookup per particle into the per-scan field (full map and
    windowed) equals the field's definition evaluated per particle."""
    from mcmh_localization.models.corr_field import correlation_field_scores

    gm = _grid_map(house_occupancy, res=0.05)
    cfg = FilterConfig(max_range=3.0, corr_window_cells=window,
                       corr_coarse_factor=0)
    lf = np.asarray(log_likelihood_field(gm, cfg), np.float64)
    rng = np.random.default_rng(window)
    n_theta = 24
    parts = np.stack([rng.uniform(1.5, 8.0, 200), rng.uniform(1.5, 8.0, 200),
                      rng.uniform(-np.pi, np.pi, 200)], 1).astype(np.float32)
    angles = np.linspace(-np.pi, np.pi, 45, endpoint=False).astype(np.float32)
    ranges = np.asarray(raycast(jnp.asarray(parts[0, :2]),
                                parts[0, 2] + jnp.asarray(angles), gm, 3.0))
    wo = (40, 40) if window else None
    got = np.asarray(correlation_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles), gm,
        cfg, n_theta=n_theta, field_impl=field_impl, window_origin=wo))
    want = _corr_reference(lf, parts.astype(np.float64), ranges, angles,
                           0.05, n_theta, 3.0)
    if window:
        mx, my = (parts[:, 0] / 0.05).astype(int), (parts[:, 1] / 0.05)
        inside = ((mx >= 40) & (mx < 40 + window)
                  & (my.astype(int) >= 40) & (my.astype(int) < 40 + window))
        want = np.where(inside, want, BLIND_SCORE)
        assert inside.any() and (~inside).any()
    close = np.abs(got - want) < 2e-3
    assert close.mean() > 0.95, close.mean()


def test_corr_coarse_select_keeps_fine_scores(house_map):
    """The fine/coarse select: covered particles score exactly as with the
    coarse fallback disabled; in-map escapees take the coarse field."""
    from mcmh_localization.models.corr_field import correlation_field_scores

    rng = np.random.default_rng(9)
    n = 256
    inner = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(-np.pi, np.pi, n)], 1)
    outer = np.array([[3.5, 3.5, 0.0], [-3.5, 3.0, 1.0], [3.0, -3.5, -2.0]])
    parts = jnp.asarray(np.concatenate([inner, outer]).astype(np.float32))
    angles = jnp.linspace(-np.pi, np.pi, 36).astype(jnp.float32)
    ranges = raycast(parts[0, :2], parts[0, 2] + angles, house_map, 3.0)
    base = FilterConfig(max_range=3.0, corr_window_cells=64,
                        coarse_gate_escapees=0, corr_coarse_n_theta=8)
    kw = dict(ranges=ranges, angles=angles, grid_map=house_map, n_theta=24,
              window_origin=(64, 64))
    with_coarse = np.asarray(correlation_field_scores(parts, config=base,
                                                      **kw))
    no_coarse = np.asarray(correlation_field_scores(
        parts, config=base.replace(corr_coarse_factor=0), **kw))
    np.testing.assert_array_equal(with_coarse[:n], no_coarse[:n])
    assert (no_coarse[n:] == BLIND_SCORE).all()
    assert (with_coarse[n:] > BLIND_SCORE).all()


@pytest.mark.parametrize("step", [1, 2])
def test_table_lookup_matches_numpy(step):
    """The beam table path's (N, M) lookup into the cell-major range table
    equals NumPy indexing, and its scores follow."""
    from mcmh_localization.models.range_table import (
        build_range_table,
        raycast_table_scores,
        table_cell_major,
    )
    from mcmh_localization.models.sensor import LOG_FLOOR

    occ = np.zeros((48, 48), np.int8)
    occ[[1, 46], 1:47] = 100
    occ[1:47, [1, 46]] = 100
    occ[20:26, 20:26] = 100
    gm = _grid_map(occ, origin=(-1.2, -1.2))
    k = 32
    table_cm = table_cell_major(build_range_table(gm, k, 2.0))
    rng = np.random.default_rng(step)
    n = 400
    parts = np.stack([rng.uniform(-1.3, 1.3, n), rng.uniform(-1.3, 1.3, n),
                      rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    angles = np.linspace(-np.pi, np.pi, 40, endpoint=False).astype(np.float32)
    ranges = rng.uniform(0.1, 2.5, 40).astype(np.float32)
    cfg = FilterConfig(max_range=2.0, sigma_hit=0.1, step=step)
    got = np.asarray(raycast_table_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles), gm,
        cfg, jnp.asarray(table_cm), k))
    r, a = ranges[::step], angles[::step]
    valid = r < 2.0
    mx = ((parts[:, 0] + 1.2) / np.float32(0.05)).astype(np.int32)
    my = ((parts[:, 1] + 1.2) / np.float32(0.05)).astype(np.int32)
    inside = (mx >= 0) & (mx < 48) & (my >= 0) & (my < 48)
    cell = np.clip(my, 0, 47) * 48 + np.clip(mx, 0, 47)
    dth = np.float32(2 * np.pi / k)
    kk = np.floor((parts[:, 2:3] + a[None] + np.float32(np.pi)) / dth)
    r_pred = np.asarray(table_cm)[cell[:, None], kk.astype(int) % k]
    ph = np.exp(-0.5 * ((r[None] - r_pred) / 0.1) ** 2) / (
        np.sqrt(2 * np.pi) * 0.1)
    lp = np.log(np.maximum(cfg.z_hit * ph + cfg.z_rand / 2.0, LOG_FLOOR))
    want = np.where(valid[None] & inside[:, None], lp, 0).sum(1) / valid.sum()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# -- exact scorer -------------------------------------------------------------

@pytest.mark.parametrize("n, m, step, blind", [
    (64, 90, 1, False),
    (1000, 360, 1, False),     # not a multiple of any tile
    (300, 120, 3, False),      # beam subsampling
    (50, 60, 1, True),         # blind scan
])
def test_exact_scorer_matches_reference(house_map, n, m, step, blind):
    rng = np.random.default_rng(n + m)
    parts = np.stack([rng.uniform(-3.5, 3.5, n), rng.uniform(-3.5, 3.5, n),
                      rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    angles = np.linspace(-np.pi, np.pi, m).astype(np.float32)
    ranges = rng.uniform(0.2, 6.0, m).astype(np.float32)
    if blind:
        ranges[:] = np.inf
    cfg = FilterConfig(max_range=5.0, step=step)
    got = np.asarray(likelihood_field_scores(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(angles),
        house_map, cfg))
    want = ref_likelihood_field_scores_np(
        parts.astype(np.float64), ranges.astype(np.float64),
        angles.astype(np.float64), np.asarray(house_map.distance),
        float(house_map.resolution), tuple(map(float, house_map.origin)),
        house_map.width, house_map.height, cfg.sigma_hit, cfg.z_hit,
        cfg.z_rand, cfg.max_range, step)
    if blind:
        assert (got == BLIND_SCORE).all()
        return
    n_valid = int((ranges[::step] < 5.0).sum())
    dev = np.abs(got - want)
    assert dev.max() <= 14.0 / n_valid, dev.max()   # at most one beam
    assert (dev < 1e-4).mean() > 0.95


def test_array_reference_matches_loop(house_map):
    """The array form of the scorer reference equals its loop form."""
    rng = np.random.default_rng(5)
    parts = np.stack([rng.uniform(-4, 4, 40), rng.uniform(-4, 4, 40),
                      rng.uniform(-np.pi, np.pi, 40)], 1)
    angles = np.linspace(-np.pi, np.pi, 72)
    ranges = rng.uniform(0.2, 6.0, 72)
    ranges[::7] = np.inf
    args = (ranges, angles, np.asarray(house_map.distance, np.float64),
            float(house_map.resolution), tuple(map(float, house_map.origin)),
            house_map.width, house_map.height, 0.3, 0.75, 0.25, 5.0, 2)
    np.testing.assert_allclose(
        ref_likelihood_field_scores_np(parts, *args),
        ref_likelihood_field_scores(parts, *args), rtol=0, atol=1e-12)


# -- systematic resampling: rank and expansion ---------------------------------

def _weights(kind, n, rng):
    if kind == "uniform":
        return np.full(n, 1.0 / n)
    if kind == "exponential":
        return rng.exponential(size=n)
    if kind == "spiky":
        return np.where(rng.random(n) < 0.001, 1000.0, 1e-6)
    if kind == "dominant":
        w = np.full(n, 1e-9)
        w[n // 3] = 1.0
        return w
    w = rng.exponential(size=n)  # "zero_tail": padded inactive slots
    w[n // 2:] = 0.0
    return w


@pytest.mark.parametrize(
    "kind", ["uniform", "exponential", "spiky", "dominant", "zero_tail"])
def test_rank_matches_searchsorted(kind):
    n = 16384
    rng = np.random.default_rng(len(kind))
    w = _weights(kind, n, rng)
    w = jnp.asarray((w / w.sum()).astype(np.float32))
    bound = _segment_bounds(jax.random.PRNGKey(1), w, n)
    got = np.asarray(rank_in_sorted(bound, n))
    b = np.asarray(bound)
    want = np.clip(np.searchsorted(b, np.arange(n), side="right"), 0, n - 1)
    covered = np.arange(n) < b[-1]
    np.testing.assert_array_equal(got[covered], want[covered])


def test_rank_window_boundary():
    """Bounds that jump across long runs of empty segments (thousands of
    zero-copy inputs between two outputs) rank exactly."""
    n, num_out = 32768, 8192
    rng = np.random.default_rng(2)
    steps = np.zeros(n, np.int64)
    picks = np.sort(rng.choice(n, num_out, replace=False))
    steps[picks] = 1
    bound = jnp.asarray(np.cumsum(steps).astype(np.int32))
    got = np.asarray(rank_in_sorted(bound, num_out))
    want = np.searchsorted(np.asarray(bound), np.arange(num_out),
                           side="right")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, picks)


def test_systematic_matches_float64_reference():
    """Indices vs float64 searchsorted: a segment boundary may move by at
    most one slot (the float32 CDF's resolution), never more."""
    n = 65536
    rng = np.random.default_rng(4)
    w = rng.exponential(size=n).astype(np.float32)
    w /= w.sum()
    key = jax.random.PRNGKey(7)
    idx = np.asarray(systematic_resample_indices(key, jnp.asarray(w), n))
    r = float(jax.random.uniform(key, (), minval=0.0, maxval=1.0))
    ref = ref_systematic_indices(w, n, r)
    slots = np.arange(n)
    shift = np.abs(np.searchsorted(idx, slots, side="right")
                   - np.searchsorted(ref, slots, side="right"))
    assert shift.max() <= 1
    assert np.mean(idx != ref) < 0.01


def test_systematic_count_prefix_and_tail():
    """With a traced count, slots < count follow the count-stride draw and
    the tail repeats the final index."""
    n, count = 8192, 3000
    rng = np.random.default_rng(8)
    w = rng.exponential(size=n).astype(np.float32)
    w /= w.sum()
    key = jax.random.PRNGKey(3)
    idx = np.asarray(systematic_resample_indices(
        key, jnp.asarray(w), n, count=jnp.int32(count)))
    r = float(jax.random.uniform(key, (), minval=0.0, maxval=1.0))
    ref = ref_systematic_indices(w, count, r)
    slots = np.arange(count)
    shift = np.abs(np.searchsorted(idx[:count], slots, side="right")
                   - np.searchsorted(ref, slots, side="right"))
    assert shift.max() <= 1
    assert (idx[count:] == idx[count - 1]).all()


@pytest.mark.parametrize("impl", ["gather", "scan"])
def test_expansion_single_dominant_particle(impl):
    """One particle holding all the weight fills every output slot."""
    n = 20_000
    rng = np.random.default_rng(6)
    parts = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    w = np.zeros(n, np.float32)
    w[12345] = 1.0
    out = np.asarray(systematic_resample_particles(
        jax.random.PRNGKey(0), parts, jnp.asarray(w), n, impl=impl))
    np.testing.assert_array_equal(out, np.broadcast_to(parts[12345], out.shape))
