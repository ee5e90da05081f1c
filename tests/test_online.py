"""OnlineLocalizer facade tests: callback-style tracking at odom > scan rate."""

import jax
import numpy as np
import pytest

from mcmh_localization.config import FilterConfig
from mcmh_localization.filter.online import OnlineLocalizer
from mcmh_localization.models.sensor import raycast
import jax.numpy as jnp


def test_online_localizer_tracks(house_map):
    cfg = FilterConfig(
        mode="MHAMCL", num_particles=300, min_particles=50, max_particles=400,
        initialized=True, initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
    )
    loc = OnlineLocalizer(cfg, house_map, seed=0)
    angles = jnp.linspace(-np.pi, np.pi, 90)

    pose = np.array([1.0, -1.0, 0.0])
    est = None
    for t in range(30):
        # 3 odometry updates per scan (odom rate > scan rate, like ROS)
        for _ in range(3):
            pose = pose + [0.05 * np.cos(pose[2]), 0.05 * np.sin(pose[2]), 0.02]
            pose[2] = (pose[2] + np.pi) % (2 * np.pi) - np.pi
            loc.on_odom(*pose)
        scan = raycast(jnp.asarray(pose[:2]), pose[2] + angles, house_map,
                       5.0, hit_unknown=True)
        est = loc.on_scan(scan, angles)
    err = np.hypot(est["pose3"][0] - pose[0], est["pose3"][1] - pose[1])
    assert err < 0.3, (est["pose3"], pose)
    assert est["covariance"].shape == (36,)

    parts, weights = loc.particles()
    assert parts.shape[1] == 3
    assert len(parts) == len(weights) == int(loc.state.count)


def test_online_quaternion_odom(house_map):
    cfg = FilterConfig(
        mode="MCL", num_particles=100, initialized=True,
        initial_pose=(1.0, -1.0, 0.5), max_range=5.0,
    )
    loc = OnlineLocalizer(cfg, house_map, seed=1)
    yaw = 0.5
    loc.on_odom_quaternion(1.0, -1.0, 0, 0, np.sin(yaw / 2), np.cos(yaw / 2))
    assert loc._last_odom is not None
    np.testing.assert_allclose(loc._last_odom[2], yaw, atol=1e-6)


def test_online_per_scan_batching_tracks(house_map):
    """predict_batching="per_scan": on_odom is host-side only (no device
    dispatch, state object unchanged); one predict per scan.  Tracking
    parity with per_message on the same trajectory (documented deviation:
    noise once per scan).  Ref anchor: amcmh_localizer.py:379-408."""
    angles = jnp.linspace(-np.pi, np.pi, 90)
    finals = {}
    for batching in ("per_message", "per_scan"):
        cfg = FilterConfig(
            mode="MHAMCL", num_particles=300, min_particles=50,
            max_particles=400, initialized=True,
            initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
            predict_batching=batching,
        )
        loc = OnlineLocalizer(cfg, house_map, seed=0)
        pose = np.array([1.0, -1.0, 0.0])
        est = None
        for t in range(30):
            for _ in range(3):
                pose = pose + [0.05 * np.cos(pose[2]),
                               0.05 * np.sin(pose[2]), 0.02]
                pose[2] = (pose[2] + np.pi) % (2 * np.pi) - np.pi
                before = loc.state
                loc.on_odom(*pose)
                if batching == "per_scan":
                    assert loc.state is before  # no dispatch on odom
            est = loc.on_scan(
                raycast(jnp.asarray(pose[:2]), pose[2] + angles, house_map,
                        5.0, hit_unknown=True),
                angles,
            )
        finals[batching] = np.hypot(
            est["pose3"][0] - pose[0], est["pose3"][1] - pose[1]
        )
    assert finals["per_scan"] < 0.3, finals
    assert finals["per_message"] < 0.3, finals


def test_online_reanchor_stream(house_map):
    """The live map->odom re-anchoring loop (pose_broadcaster.py:22,88-105):
    every scan with an available odom->base emits one transform, and
    composing map->odom . odom->base reproduces the estimated pose."""
    from mcmh_localization.viz import _pose_to_matrix

    cfg = FilterConfig(
        mode="MCL", num_particles=200, initialized=True,
        initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
    )
    loc = OnlineLocalizer(cfg, house_map, seed=0)
    angles = jnp.linspace(-np.pi, np.pi, 90)
    # no odom yet -> scan estimates but broadcasts nothing (the reference's
    # failed TF lookup; deviation: we skip instead of crashing)
    loc.on_scan(
        raycast(jnp.asarray([1.0, -1.0]), 0.0 + angles, house_map, 5.0,
                hit_unknown=True), angles)
    assert loc.reanchor.latest() is None

    pose = np.array([1.0, -1.0, 0.0])
    odom = np.array([0.0, 0.0, 0.0])  # odom frame starts at the origin
    for t in range(5):
        for _ in range(3):
            step = np.array([0.05 * np.cos(pose[2]),
                             0.05 * np.sin(pose[2]), 0.02])
            pose = pose + step
            odom = odom + step
            loc.on_odom(*odom)  # odom->base (drift-free here)
        est = loc.on_scan(
            raycast(jnp.asarray(pose[:2]), pose[2] + angles, house_map,
                    5.0, hit_unknown=True), angles)
    assert len(loc.reanchor.transforms) == 5
    t = loc.reanchor.latest()
    # recompose: T_map_base = T_map_odom @ T_odom_base must equal estimate
    yaw_mo = 2 * np.arctan2(t["rotation"][2], t["rotation"][3])
    t_mo = _pose_to_matrix(t["translation"][0], t["translation"][1], yaw_mo)
    t_ob = _pose_to_matrix(*odom)
    t_mb = t_mo @ t_ob
    assert abs(t_mb[0, 3] - est["pose3"][0]) < 1e-5
    assert abs(t_mb[1, 3] - est["pose3"][1]) < 1e-5
    yaw_mb = np.arctan2(t_mb[1, 0], t_mb[0, 0])
    d = (yaw_mb - est["pose3"][2] + np.pi) % (2 * np.pi) - np.pi
    assert abs(d) < 1e-5
    assert t["rotation"][3] >= 0  # w >= 0 (pose_broadcaster.py:83-84)


def test_reanchor_staleness():
    """stale_after rejects odom older than the estimate (the
    ExtrapolationException analogue)."""
    from mcmh_localization.viz import TFReanchorer

    r = TFReanchorer(stale_after=0.5)
    r.on_odom(1.0, 0.0, 0.0, stamp=10.0)
    assert r.on_estimate((1.0, 0.0, 0.0), stamp=10.2) is not None
    assert r.on_estimate((1.0, 0.0, 0.0), stamp=11.0) is None
    assert len(r.transforms) == 1


def test_online_set_initial_pose(house_map):
    cfg = FilterConfig(
        mode="MCL", num_particles=100, initialized=True,
        initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
    )
    loc = OnlineLocalizer(cfg, house_map)
    loc.set_initial_pose(2.0, 1.0, 0.3)
    parts, _ = loc.particles()
    np.testing.assert_allclose(parts[:, 0].mean(), 2.0, atol=0.2)
    np.testing.assert_allclose(parts[:, 1].mean(), 1.0, atol=0.2)


def test_online_staged_tracks_and_shrinks(house_map):
    """OnlineLocalizer(staged=True): converged tracking hands off to the
    small windowed program per scan; recovery events (set_initial_pose)
    return to the big one."""
    from mcmh_localization.models.sensor import raycast as _rc

    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=2000, min_particles=300,
        max_particles=2000, initialized=True, initial_pose=(1.0, -1.0, 0.0),
        max_range=5.0, likelihood_impl="corr", corr_n_theta=90,
        corr_window_cells=96, estimate_mode="cluster",
    )
    loc = OnlineLocalizer(cfg, house_map, seed=0, staged=True,
                          tracking_capacity=1024,
                          tracking_ess_threshold=0.9)
    angles = jnp.linspace(-np.pi, np.pi, 90)
    pose = np.array([1.0, -1.0, 0.0])
    est = None
    for t in range(40):
        for _ in range(3):
            pose = pose + [0.04 * np.cos(pose[2]), 0.04 * np.sin(pose[2]),
                           0.02]
            pose[2] = (pose[2] + np.pi) % (2 * np.pi) - np.pi
            loc.on_odom(*pose)
        est = loc.on_scan(
            _rc(jnp.asarray(pose[:2]), pose[2] + angles, house_map, 5.0,
                hit_unknown=True), angles)
    assert loc._in_small, "never handed off to the tracking program"
    assert loc.state.particles.shape[0] == 1024
    err = np.hypot(est["pose3"][0] - pose[0], est["pose3"][1] - pose[1])
    assert err < 0.3, (est["pose3"], pose)
    # a re-initialization is a global event: back to the big program
    loc.set_initial_pose(2.0, 1.0, 0.3)
    assert not loc._in_small
    assert loc.state.particles.shape[0] == 2000


def test_online_staged_checkpoint_resume(house_map, tmp_path):
    """save_checkpoint/load_checkpoint on the staged facade: the
    checkpoint's array capacity selects the compiled program on resume,
    and the resumed run continues bit-exactly (same scans -> same
    estimates, PRNG key included)."""
    from mcmh_localization.models.sensor import raycast as _rc

    cfg = FilterConfig(
        mode="AMHAMCL", num_particles=2000, min_particles=300,
        max_particles=2000, initialized=True, initial_pose=(1.0, -1.0, 0.0),
        max_range=5.0, likelihood_impl="corr", corr_n_theta=90,
        corr_window_cells=96, estimate_mode="cluster",
    )

    def make():
        return OnlineLocalizer(cfg, house_map, seed=0, staged=True,
                               tracking_capacity=1024,
                               tracking_ess_threshold=0.9)

    angles = jnp.linspace(-np.pi, np.pi, 90)

    def drive(loc, pose, n):
        est = None
        for _ in range(n):
            pose = pose + [0.04 * np.cos(pose[2]), 0.04 * np.sin(pose[2]),
                           0.02]
            pose[2] = (pose[2] + np.pi) % (2 * np.pi) - np.pi
            loc.on_odom(*pose)
            est = loc.on_scan(
                _rc(jnp.asarray(pose[:2]), pose[2] + angles, house_map, 5.0,
                    hit_unknown=True), angles)
        return pose, est

    loc = make()
    pose, _ = drive(loc, np.array([1.0, -1.0, 0.0]), 35)
    assert loc._in_small  # checkpoint taken IN the tracking program
    path = str(tmp_path / "staged.npz")
    loc.save_checkpoint(path)
    pose_a, est_a = drive(loc, pose.copy(), 5)

    loc2 = make()
    assert not loc2._in_small
    loc2.load_checkpoint(path)
    assert loc2._in_small and loc2.state.particles.shape[0] == 1024
    # odometry bookkeeping resets: re-seed with the checkpoint-time pose
    loc2.on_odom(*pose)
    pose_b, est_b = drive(loc2, pose.copy(), 5)
    np.testing.assert_allclose(est_a["pose3"], est_b["pose3"], atol=1e-6)

    # capacity matching neither program is rejected
    from mcmh_localization.utils.checkpoint import save_state

    bad = str(tmp_path / "bad.npz")
    save_state(bad, loc.state.replace(
        particles=loc.state.particles[:512],
        prev_particles=loc.state.prev_particles[:512],
        weights=loc.state.weights[:512]))
    with pytest.raises(ValueError, match="neither"):
        loc2.load_checkpoint(bad)


def test_online_frame_recorder_hook(house_map, tmp_path):
    """frame_recorder= hook: every on_scan renders a live frame (the
    reference node's per-scan MarkerArray stream, amcmh_localizer.py
    :538-581, directly off the facade)."""
    from mcmh_localization.models.sensor import raycast as _rc
    from mcmh_localization.viz import FrameRecorder

    cfg = FilterConfig(
        mode="MCL", num_particles=150, initialized=True,
        initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
    )
    rec = FrameRecorder(house_map, str(tmp_path / "frames"), every=2)
    loc = OnlineLocalizer(cfg, house_map, seed=0, frame_recorder=rec)
    angles = jnp.linspace(-np.pi, np.pi, 60)
    pose = np.array([1.0, -1.0, 0.0])
    for t in range(5):
        pose = pose + [0.05 * np.cos(pose[2]), 0.05 * np.sin(pose[2]), 0.02]
        loc.on_odom(*pose)
        loc.on_scan(
            _rc(jnp.asarray(pose[:2]), pose[2] + angles, house_map, 5.0,
                hit_unknown=True), angles)
    assert len(rec.frames) == 3  # scans 0, 2, 4 with every=2
    assert len(rec.trail) == 5   # estimate recorded every scan
    gif = rec.to_gif()
    assert gif is not None and gif.endswith(".gif")


def test_online_estimate_cached_and_packed(house_map):
    """estimate() returns the per-step cached dict (a second call per
    scan must not pay device fetches again) with the host-side flat
    covariance packing matching filter.estimate.covariance_6x6."""
    from mcmh_localization.filter.estimate import covariance_6x6
    from mcmh_localization.models.sensor import raycast as _rc

    cfg = FilterConfig(
        mode="MCL", num_particles=200, initialized=True,
        initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
    )
    loc = OnlineLocalizer(cfg, house_map, seed=0)
    angles = jnp.linspace(-np.pi, np.pi, 60)
    pose = np.array([1.0, -1.0, 0.0])
    loc.on_odom(*pose)
    est = loc.on_scan(
        _rc(jnp.asarray(pose[:2]), pose[2] + angles, house_map, 5.0,
            hit_unknown=True), angles)
    assert loc.estimate() is est
    assert loc.estimate() is est  # stable across repeated calls
    np.testing.assert_allclose(
        est["covariance"],
        np.asarray(covariance_6x6(loc.last_info.estimate.cov)),
        rtol=1e-6,
    )
    # a new scan invalidates the cache
    loc.on_odom(*(pose + [0.05, 0.0, 0.0]))
    est2 = loc.on_scan(
        _rc(jnp.asarray(pose[:2] + [0.05, 0.0]), pose[2] + angles,
            house_map, 5.0, hit_unknown=True), angles)
    assert est2 is not est
    assert loc.estimate() is est2


def test_online_warmup_no_mutation(house_map):
    """warmup() populates the jit caches for BOTH staged programs + the
    shrink/grow hand-off without touching the localizer's state, odometry
    bookkeeping, or estimate cache — so a real-time caller can warm
    outside its deadline window and the FIRST stage switch doesn't pay a
    cold compile (measured 17.6 s = 88 dropped 5 Hz periods on the chip,
    RESULTS.md "Real-time duty cycle")."""
    from mcmh_localization.models.sensor import raycast as _rc

    angles = jnp.linspace(-np.pi, np.pi, 90)
    scan = _rc(jnp.asarray([1.0, -1.0]), angles, house_map, 5.0,
               hit_unknown=True)
    for staged in (False, True):
        cfg = FilterConfig(
            mode="AMHAMCL", num_particles=2000, min_particles=300,
            max_particles=2000, initialized=True,
            initial_pose=(1.0, -1.0, 0.0), max_range=5.0,
            likelihood_impl="corr", corr_n_theta=90, corr_window_cells=96,
        )
        loc = OnlineLocalizer(cfg, house_map, seed=0, staged=staged,
                              tracking_capacity=1024 if staged else None)
        state_before = loc.state
        loc.warmup(scan, angles)
        assert loc.state is state_before  # untouched, not just equal
        assert loc._last_odom is None and loc.last_info is None
        if staged:
            assert not loc._in_small
            assert loc.state.particles.shape[0] == 2000
        # the facade still works normally after warming
        loc.on_odom(1.0, -1.0, 0.0)
        est = loc.on_scan(scan, angles)
        assert "pose3" in est
