"""Pure-python ROS2 bag (rosbag2 sqlite3 storage) reader — /scan + /odom.

Completes the recorded-data story next to the ROS1 reader (io/rosbag.py):
the reference consumed ROS1 bags (test_algs.launch:40-44); modern robots
record rosbag2.  No ROS dependency: the storage is a sqlite3 database
(python stdlib) with tables

    topics   (id, name, type, serialization_format, ...)
    messages (id, topic_id, timestamp, data)

and message payloads are CDR-encapsulated (XCDR1 little-endian: a 4-byte
encapsulation header {0x00, 0x01, 0x00, 0x00}, then fields aligned to
their primitive size relative to the payload start).  Only the two
message types the filter consumes are deserialized:

    sensor_msgs/msg/LaserScan
    nav_msgs/msg/Odometry

A matching minimal writer backs the round-trip tests.
"""

from __future__ import annotations

import os
import sqlite3
import struct

import numpy as np

LASERSCAN_TYPE = "sensor_msgs/msg/LaserScan"
ODOMETRY_TYPE = "nav_msgs/msg/Odometry"


class _Cdr:
    """XCDR1 little-endian cursor over an encapsulated payload."""

    def __init__(self, data: bytes):
        if len(data) < 4 or data[1] not in (0x01, 0x03):
            raise ValueError("not a little-endian CDR payload")
        self.buf = data
        self.off = 4  # skip encapsulation header

    def _align(self, size: int):
        # alignment origin is the start of the serialized payload (offset 4)
        rel = self.off - 4
        pad = (-rel) % size
        self.off += pad

    def u32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<I", self.buf, self.off)[0]
        self.off += 4
        return v

    def i32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<i", self.buf, self.off)[0]
        self.off += 4
        return v

    def f32(self) -> float:
        self._align(4)
        v = struct.unpack_from("<f", self.buf, self.off)[0]
        self.off += 4
        return v

    def f64(self) -> float:
        self._align(8)
        v = struct.unpack_from("<d", self.buf, self.off)[0]
        self.off += 8
        return v

    def string(self) -> str:
        n = self.u32()  # length INCLUDING the terminating null
        s = self.buf[self.off:self.off + max(n - 1, 0)]
        self.off += n
        return s.decode("utf-8", errors="replace")

    def f32_seq(self) -> np.ndarray:
        n = self.u32()
        self._align(4)
        v = np.frombuffer(self.buf, dtype="<f4", count=n, offset=self.off)
        self.off += 4 * n
        return v.astype(np.float32)

    def f64_array(self, n: int) -> np.ndarray:
        self._align(8)
        v = np.frombuffer(self.buf, dtype="<f8", count=n, offset=self.off)
        self.off += 8 * n
        return v

    def header(self) -> float:
        sec = self.i32()
        nsec = self.u32()
        _frame = self.string()
        return sec + nsec * 1e-9


def parse_laserscan2(data: bytes) -> dict:
    c = _Cdr(data)
    stamp = c.header()
    out = {
        "stamp": stamp,
        "angle_min": c.f32(),
        "angle_max": c.f32(),
        "angle_increment": c.f32(),
        "time_increment": c.f32(),
        "scan_time": c.f32(),
        "range_min": c.f32(),
        "range_max": c.f32(),
        "ranges": c.f32_seq(),
    }
    return out


def parse_odometry2(data: bytes) -> dict:
    c = _Cdr(data)
    stamp = c.header()
    _child = c.string()
    px, py, _pz = c.f64(), c.f64(), c.f64()
    qx, qy, qz, qw = c.f64(), c.f64(), c.f64(), c.f64()
    c.f64_array(36)  # pose covariance
    yaw = np.arctan2(2.0 * (qw * qz + qx * qy),
                     1.0 - 2.0 * (qy * qy + qz * qz))
    return {"stamp": stamp, "pose": (px, py, yaw)}


def read_rosbag2(path: str, scan_topic: str = "/scan",
                 odom_topic: str = "/odom"):
    """Parse a rosbag2 .db3 file (or a bag directory containing one) into
    the framework Bag, scan-aligned exactly like io/rosbag.py."""
    from mcmh_localization.sim.simulator import Bag

    if os.path.isdir(path):
        db3 = [f for f in sorted(os.listdir(path)) if f.endswith(".db3")]
        if not db3:
            raise ValueError(f"{path}: no .db3 storage file in directory")
        path = os.path.join(path, db3[0])

    con = sqlite3.connect(path)
    try:
        topics = {
            tid: (name, mtype)
            for tid, name, mtype in con.execute(
                "SELECT id, name, type FROM topics"
            )
        }
        scans, odoms = [], []
        scan_meta = None
        for tid, ts, data in con.execute(
            "SELECT topic_id, timestamp, data FROM messages ORDER BY timestamp"
        ):
            name, mtype = topics.get(tid, (None, None))
            if name == scan_topic and mtype == LASERSCAN_TYPE:
                msg = parse_laserscan2(bytes(data))
                if msg["stamp"] == 0.0:
                    msg["stamp"] = ts * 1e-9  # unstamped: use bag receipt time
                if scan_meta is None:
                    scan_meta = msg  # angles/range_max from the FIRST scan
                scans.append(msg)
            elif name == odom_topic and mtype == ODOMETRY_TYPE:
                msg = parse_odometry2(bytes(data))
                if msg["stamp"] == 0.0:
                    msg["stamp"] = ts * 1e-9
                odoms.append(msg)
    finally:
        con.close()

    if not scans:
        raise ValueError(f"{path}: no {scan_topic} LaserScan messages")
    if not odoms:
        raise ValueError(f"{path}: no {odom_topic} Odometry messages")

    odom_t = np.array([o["stamp"] for o in odoms])
    odom_p = np.array([o["pose"] for o in odoms], dtype=np.float32)
    order = np.argsort(odom_t, kind="stable")
    odom_t, odom_p = odom_t[order], odom_p[order]

    ranges, poses, times = [], [], []
    m_first = len(scan_meta["ranges"])
    n_skipped = 0
    for s in scans:
        i = int(np.searchsorted(odom_t, s["stamp"], side="right")) - 1
        if i < 0:
            continue
        if len(s["ranges"]) != m_first:
            # real drivers occasionally drop beams; a silent np.stack
            # error here would be opaque — skip with a warning instead
            n_skipped += 1
            continue
        ranges.append(s["ranges"])
        poses.append(odom_p[i])
        times.append(s["stamp"])
    if n_skipped:
        import warnings

        warnings.warn(
            f"{path}: skipped {n_skipped} LaserScan message(s) whose beam "
            f"count differs from the first scan's ({m_first})",
            stacklevel=2,
        )
    if not ranges:
        raise ValueError(f"{path}: no usable LaserScan/odometry pairs")
    m = m_first
    angles = (
        scan_meta["angle_min"]
        + scan_meta["angle_increment"] * np.arange(m)
    ).astype(np.float32)
    odom = np.stack(poses)
    return Bag(
        ranges=np.stack(ranges).astype(np.float32),
        angles=angles,
        odom=odom,
        gt=odom.copy(),
        times=np.asarray(times, dtype=np.float64),
        max_range=float(scan_meta["range_max"]),
        meta={"source": os.path.basename(path), "gt_from": "odom"},
    )


# ---------------------------------------------------------------------------
# minimal writer (round-trip tests + exporting simulated bags to ROS2 tools)
# ---------------------------------------------------------------------------

class _CdrW:
    def __init__(self):
        self.parts = bytearray(b"\x00\x01\x00\x00")

    def _align(self, size: int):
        rel = len(self.parts) - 4
        self.parts += b"\x00" * ((-rel) % size)

    def u32(self, v):
        self._align(4)
        self.parts += struct.pack("<I", v)

    def i32(self, v):
        self._align(4)
        self.parts += struct.pack("<i", v)

    def f32(self, v):
        self._align(4)
        self.parts += struct.pack("<f", v)

    def f64(self, v):
        self._align(8)
        self.parts += struct.pack("<d", v)

    def string(self, s: str):
        b = s.encode() + b"\x00"
        self.u32(len(b))
        self.parts += b

    def f32_seq(self, arr):
        arr = np.asarray(arr, dtype="<f4")
        self.u32(len(arr))
        self._align(4)
        self.parts += arr.tobytes()

    def f64_array(self, arr):
        arr = np.asarray(arr, dtype="<f8")
        self._align(8)
        self.parts += arr.tobytes()

    def header(self, stamp: float, frame: str):
        # floor (not toward-zero) so stamps an epsilon below an integer —
        # e.g. the odometry's t - 1ns at t = 0 — keep nsec in [0, 1e9)
        sec = int(np.floor(stamp))
        nsec = int(round((stamp - sec) * 1e9))
        if nsec >= 1_000_000_000:
            sec += 1
            nsec -= 1_000_000_000
        self.i32(sec)
        self.u32(nsec)
        self.string(frame)


def ser_laserscan2(stamp, angle_min, angle_increment, ranges,
                   range_max, frame="base_scan") -> bytes:
    c = _CdrW()
    c.header(stamp, frame)
    m = len(ranges)
    c.f32(angle_min)
    c.f32(angle_min + angle_increment * (m - 1))
    c.f32(angle_increment)
    c.f32(0.0)
    c.f32(0.0)
    c.f32(0.05)
    c.f32(range_max)
    c.f32_seq(ranges)
    c.f32_seq([])  # intensities
    return bytes(c.parts)


def ser_odometry2(stamp, pose, frame="odom", child="base_footprint") -> bytes:
    c = _CdrW()
    c.header(stamp, frame)
    c.string(child)
    x, y, yaw = pose
    c.f64(x)
    c.f64(y)
    c.f64(0.0)
    c.f64(0.0)
    c.f64(0.0)
    c.f64(np.sin(yaw / 2.0))
    c.f64(np.cos(yaw / 2.0))
    c.f64_array(np.zeros(36))
    c.f64(0.0)
    c.f64(0.0)
    c.f64(0.0)
    c.f64(0.0)
    c.f64(0.0)
    c.f64(0.0)
    c.f64_array(np.zeros(36))
    return bytes(c.parts)


def write_rosbag2(path: str, bag, scan_topic: str = "/scan",
                  odom_topic: str = "/odom") -> None:
    """Write a Bag as a rosbag2 sqlite3 storage file (.db3)."""
    if os.path.exists(path):
        os.remove(path)
    con = sqlite3.connect(path)
    try:
        con.executescript(
            """
            CREATE TABLE topics (
                id INTEGER PRIMARY KEY, name TEXT NOT NULL,
                type TEXT NOT NULL, serialization_format TEXT NOT NULL,
                offered_qos_profiles TEXT NOT NULL
            );
            CREATE TABLE messages (
                id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL,
                timestamp INTEGER NOT NULL, data BLOB NOT NULL
            );
            """
        )
        con.execute(
            "INSERT INTO topics VALUES (1, ?, ?, 'cdr', '')",
            (scan_topic, LASERSCAN_TYPE),
        )
        con.execute(
            "INSERT INTO topics VALUES (2, ?, ?, 'cdr', '')",
            (odom_topic, ODOMETRY_TYPE),
        )
        m = len(bag.angles)
        inc = float(bag.angles[1] - bag.angles[0]) if m > 1 else 0.0
        rows = []
        for t in range(len(bag.times)):
            ts = int(bag.times[t] * 1e9)
            rows.append((2, ts - 1, ser_odometry2(
                float(bag.times[t]) - 1e-9, tuple(map(float, bag.odom[t])))))
            rows.append((1, ts, ser_laserscan2(
                float(bag.times[t]), float(bag.angles[0]), inc,
                bag.ranges[t], float(bag.max_range))))
        con.executemany(
            "INSERT INTO messages (topic_id, timestamp, data) VALUES (?, ?, ?)",
            rows,
        )
        con.commit()
    finally:
        con.close()
