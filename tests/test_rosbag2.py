"""ROS2 bag reader/writer (io/rosbag2.py): CDR round-trip, directory
input, alignment edge cases with odd-length strings, beam-count
validation, and a filter run fed from a parsed bag — the rosbag2 twin of
tests/test_rosbag.py (the reference consumed ROS1 bags,
test_algs.launch:40-44; modern recorders produce rosbag2)."""

import os
import sqlite3

import numpy as np
import pytest

from mcmh_localization.io import rosbag2 as rb2
from mcmh_localization.sim.simulator import Bag


@pytest.fixture()
def small_bag():
    rng = np.random.default_rng(0)
    t_steps, m = 12, 36
    times = 100.0 + np.arange(t_steps) * 0.25
    angles = np.linspace(-np.pi, np.pi, m, endpoint=False).astype(np.float32)
    ranges = rng.uniform(0.2, 4.5, size=(t_steps, m)).astype(np.float32)
    odom = np.cumsum(
        rng.normal(0, 0.05, size=(t_steps, 3)).astype(np.float32), axis=0
    )
    return Bag(ranges=ranges, angles=angles, odom=odom, gt=odom.copy(),
               times=times, max_range=5.0, meta={})


def test_roundtrip(tmp_path, small_bag):
    path = str(tmp_path / "run.db3")
    rb2.write_rosbag2(path, small_bag)
    out = rb2.read_rosbag2(path)
    np.testing.assert_allclose(out.ranges, small_bag.ranges, rtol=1e-6)
    np.testing.assert_allclose(out.angles, small_bag.angles, atol=2e-4)
    np.testing.assert_allclose(out.odom[:, :2], small_bag.odom[:, :2],
                               atol=1e-6)
    np.testing.assert_allclose(out.odom[:, 2], small_bag.odom[:, 2],
                               atol=1e-6)
    np.testing.assert_allclose(out.times, small_bag.times, atol=1e-6)
    assert out.max_range == small_bag.max_range
    assert out.meta["gt_from"] == "odom"


def test_directory_input(tmp_path, small_bag):
    """Standard rosbag2 layout: a bag DIRECTORY containing the .db3."""
    bag_dir = tmp_path / "rosbag2_2026_08_17"
    bag_dir.mkdir()
    rb2.write_rosbag2(str(bag_dir / "rosbag2_0.db3"), small_bag)
    (bag_dir / "metadata.yaml").write_text("rosbag2_bagfile_information: {}")
    out = rb2.read_rosbag2(str(bag_dir))
    np.testing.assert_allclose(out.ranges, small_bag.ranges, rtol=1e-6)


def test_cdr_alignment_odd_strings(tmp_path, small_bag):
    """CDR aligns each primitive to its size relative to the payload
    start; odd-length frame strings force realignment before the f64
    pose block — the hand-rolled parser must track it."""
    path = str(tmp_path / "run.db3")
    rb2.write_rosbag2(path, small_bag)
    # re-serialize odometry with odd/awkward frame-string lengths
    con = sqlite3.connect(path)
    try:
        rows = list(con.execute(
            "SELECT id, timestamp FROM messages WHERE topic_id = 2 "
            "ORDER BY timestamp"
        ))
        for i, (mid, _ts) in enumerate(rows):
            blob = rb2.ser_odometry2(
                float(small_bag.times[i]), small_bag.odom[i],
                frame="o", child="base_link_f",  # 1- and 11-byte names
            )
            con.execute("UPDATE messages SET data = ? WHERE id = ?",
                        (blob, mid))
        con.commit()
    finally:
        con.close()
    out = rb2.read_rosbag2(path)
    np.testing.assert_allclose(out.odom[:, :2], small_bag.odom[:, :2],
                               atol=1e-6)
    np.testing.assert_allclose(out.odom[:, 2], small_bag.odom[:, 2],
                               atol=1e-6)


def test_mismatched_beam_count_skipped(tmp_path, small_bag):
    """A scan whose beam count differs from the first is skipped with a
    warning instead of crashing np.stack (real drivers drop beams)."""
    path = str(tmp_path / "run.db3")
    rb2.write_rosbag2(path, small_bag)
    con = sqlite3.connect(path)
    try:
        # truncate the LAST scan message to half the beams
        mid, = con.execute(
            "SELECT id FROM messages WHERE topic_id = 1 "
            "ORDER BY timestamp DESC LIMIT 1"
        ).fetchone()
        m = len(small_bag.angles)
        inc = float(small_bag.angles[1] - small_bag.angles[0])
        blob = rb2.ser_laserscan2(
            float(small_bag.times[-1]), float(small_bag.angles[0]), inc,
            small_bag.ranges[-1][: m // 2], small_bag.max_range,
        )
        con.execute("UPDATE messages SET data = ? WHERE id = ?", (blob, mid))
        con.commit()
    finally:
        con.close()
    with pytest.warns(UserWarning, match="beam count"):
        out = rb2.read_rosbag2(path)
    assert out.ranges.shape[0] == len(small_bag.times) - 1


def test_missing_db3_raises(tmp_path):
    empty = tmp_path / "empty_dir"
    empty.mkdir()
    with pytest.raises(ValueError, match="no .db3"):
        rb2.read_rosbag2(str(empty))


def test_filter_runs_from_rosbag2(tmp_path, house_map):
    """A recorded rosbag2 drives the filter end to end (the replay path of
    test_algs.launch:40-44, rosbag2 storage)."""
    import jax
    import jax.numpy as jnp

    from mcmh_localization.config import FilterConfig
    from mcmh_localization.filter.step import make_model
    from mcmh_localization.sim.simulator import odometry_deltas
    from tests.test_filter import _simulate, _square_trajectory, _wrap

    poses = _square_trajectory(12)
    scans, angles, deltas = _simulate(house_map, poses, max_range=5.0)
    odom = np.asarray([_wrap(p) for p in poses], dtype=np.float32)
    bag = Bag(ranges=np.asarray(scans), angles=np.asarray(angles),
              odom=odom, gt=odom.copy(),
              times=np.arange(len(poses)) * 0.25, max_range=5.0, meta={})
    path = str(tmp_path / "sim.db3")
    rb2.write_rosbag2(path, bag)

    loaded = rb2.read_rosbag2(path)
    cfg = FilterConfig(
        mode="MCL", num_particles=300, initialized=True,
        initial_pose=tuple(float(v) for v in loaded.odom[0]),
        max_range=loaded.max_range,
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    model = make_model(cfg, house_map)
    state = model.init(jax.random.PRNGKey(0))
    d = odometry_deltas(loaded.odom)
    state, infos = model.run(
        state, jnp.asarray(loaded.ranges), jnp.asarray(loaded.angles),
        jnp.asarray(d),
    )
    est = np.asarray(infos.estimate.mean)
    true = _wrap(poses[-1])
    assert np.hypot(est[-1, 0] - true[0], est[-1, 1] - true[1]) < 0.3
