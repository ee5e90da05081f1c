"""ROS1 bag reader/writer (io/rosbag.py): round-trip, bz2 chunks, and a
filter run fed from a parsed bag (test_algs.launch:40-44 parity)."""

import bz2
import struct

import numpy as np
import pytest

from mcmh_localization.io import rosbag as rb
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
    path = str(tmp_path / "run.bag")
    rb.write_rosbag(path, small_bag)
    out = rb.read_rosbag(path)
    np.testing.assert_allclose(out.ranges, small_bag.ranges, rtol=1e-6)
    np.testing.assert_allclose(out.angles, small_bag.angles, atol=2e-4)
    # yaw goes through a quaternion; xy exact
    np.testing.assert_allclose(out.odom[:, :2], small_bag.odom[:, :2],
                               atol=1e-6)
    np.testing.assert_allclose(out.odom[:, 2], small_bag.odom[:, 2],
                               atol=1e-6)
    np.testing.assert_allclose(out.times, small_bag.times, atol=1e-6)
    assert out.max_range == small_bag.max_range
    assert out.meta["gt_from"] == "odom"


def test_reader_handles_bz2_chunks(tmp_path, small_bag):
    """Re-pack the writer's chunk with bz2 (the rosbag default option)."""
    path = str(tmp_path / "run.bag")
    rb.write_rosbag(path, small_bag)
    blob = open(path, "rb").read()

    # locate the chunk record and recompress it
    off = len(rb.MAGIC)
    out = bytearray(rb.MAGIC)
    for header, data in rb._iter_records(blob, off):
        if header["op"][0] == rb._OP_CHUNK:
            comp = bz2.compress(data)
            h = rb._encode_header(
                {"op": bytes([rb._OP_CHUNK]), "compression": b"bz2",
                 "size": header["size"]}
            )
            out += struct.pack("<I", len(h)) + h
            out += struct.pack("<I", len(comp)) + comp
        else:
            h = rb._encode_header(header)
            out += struct.pack("<I", len(h)) + h
            out += struct.pack("<I", len(data)) + data
    p2 = str(tmp_path / "run_bz2.bag")
    open(p2, "wb").write(bytes(out))

    res = rb.read_rosbag(p2)
    np.testing.assert_allclose(res.ranges, small_bag.ranges, rtol=1e-6)


def test_messages_stream_order_and_types(tmp_path, small_bag):
    path = str(tmp_path / "run.bag")
    rb.write_rosbag(path, small_bag)
    msgs = list(rb.read_messages(path))
    topics = {t for t, _, _, _ in msgs}
    assert topics == {"/scan", "/odom"}
    types = {ty for _, ty, _, _ in msgs}
    assert types == {rb.LASERSCAN_TYPE, rb.ODOMETRY_TYPE}
    assert len(msgs) == 2 * len(small_bag.times)


def test_filter_runs_from_rosbag(tmp_path, house_map):
    """A recorded bag (here: simulated + written to .bag) drives the filter
    end to end — the reference's test_algs.launch replay path."""
    import jax
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
    path = str(tmp_path / "sim.bag")
    rb.write_rosbag(path, bag)

    loaded = rb.read_rosbag(path)
    cfg = FilterConfig(
        mode="MCL", num_particles=300, initialized=True,
        initial_pose=tuple(float(v) for v in loaded.odom[0]),
        max_range=loaded.max_range,
        alpha1=0.02, alpha2=0.02, alpha3=0.05, alpha4=0.01,
    )
    model = make_model(cfg, house_map)
    state = model.init(jax.random.PRNGKey(0))
    d = odometry_deltas(loaded.odom)
    import jax.numpy as jnp

    state, infos = model.run(
        state, jnp.asarray(loaded.ranges), jnp.asarray(loaded.angles),
        jnp.asarray(d),
    )
    est = np.asarray(infos.estimate.mean)
    true = _wrap(poses[-1])
    assert np.hypot(est[-1, 0] - true[0], est[-1, 1] - true[1]) < 0.3
