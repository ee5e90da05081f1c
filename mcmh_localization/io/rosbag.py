"""Minimal pure-python ROS1 bag (format 2.0) reader/writer.

The reference replayed recorded rosbags into the filter
(`rosbag play`, app/launch/test_algs.launch:40-44); its
evaluation bags were stripped from the repo, but a user with recorded
TurtleBot3 bags needs a path into this framework without any ROS
installation.  This module parses the on-disk bag container and the two
message types the localization stack consumes:

  * ``sensor_msgs/LaserScan``  -> scan ranges + beam angles
  * ``nav_msgs/Odometry``      -> (x, y, yaw) odometry poses

and assembles them into the framework's :class:`~...sim.simulator.Bag`
(scan-aligned arrays).  ``write_rosbag`` emits a spec-compliant
single-chunk uncompressed bag — used for round-trip fixtures and so
framework runs can be exported toward ROS tooling.

Format reference: http://wiki.ros.org/Bags/Format/2.0 (public spec).
Supported chunk compressions: none, bz2 (stdlib).  lz4 requires the
optional ``lz4`` package and raises a clear error otherwise.
"""

from __future__ import annotations

import bz2
import os
import struct
from typing import Iterator, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONN = 0x07

LASERSCAN_TYPE = "sensor_msgs/LaserScan"
LASERSCAN_MD5 = "90c7ef2dc6895d81024acba2ac42f369"
ODOMETRY_TYPE = "nav_msgs/Odometry"
ODOMETRY_MD5 = "cd5e73d190d741a2f92e81eda573aca7"


# ---------------------------------------------------------------------------
# container plumbing
# ---------------------------------------------------------------------------

def _parse_header(buf: bytes) -> dict:
    """Bag record header: sequence of <len:u32><name>=<value> fields."""
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        eq = buf.index(b"=", off, off + flen)
        fields[buf[off:eq].decode()] = buf[eq + 1 : off + flen]
        off += flen
    return fields


def _encode_header(fields: dict) -> bytes:
    out = b""
    for name, value in fields.items():
        item = name.encode() + b"=" + value
        out += struct.pack("<I", len(item)) + item
    return out


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[dict, bytes]]:
    end = len(buf)
    while off < end:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off : off + dlen]
        off += dlen
        yield header, data


def read_messages(path: str) -> Iterator[Tuple[str, str, float, bytes]]:
    """Yield (topic, msg_type, time_sec, raw_message_bytes) in file order.

    Walks top-level records, decompresses chunks (none/bz2), and resolves
    connection ids to topics.  Index/chunk-info records are skipped — the
    full file is scanned instead (bags the reference used are tens of MB)."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise ValueError(f"{path}: not a ROS bag 2.0 file")

    conns: dict[int, tuple[str, str]] = {}

    def handle(header, data):
        op = header["op"][0]
        if op == _OP_CONN:
            cid = struct.unpack("<I", header["conn"])[0]
            ch = _parse_header(data)  # connection header: topic/type/md5...
            topic = (ch.get("topic") or header["topic"]).decode()
            conns[cid] = (topic, ch["type"].decode() if "type" in ch else "")
        elif op == _OP_MSG:
            cid = struct.unpack("<I", header["conn"])[0]
            secs, nsecs = struct.unpack("<II", header["time"])
            topic, mtype = conns.get(cid, ("?", "?"))
            return topic, mtype, secs + nsecs * 1e-9, data
        return None

    for header, data in _iter_records(blob, len(MAGIC)):
        op = header["op"][0]
        if op == _OP_CHUNK:
            comp = header["compression"].decode()
            if comp == "none":
                inner = data
            elif comp == "bz2":
                inner = bz2.decompress(data)
            elif comp == "lz4":  # pragma: no cover - optional dep
                try:
                    import lz4.frame
                except ImportError as e:
                    raise RuntimeError(
                        "bag uses lz4 chunks; install the 'lz4' package"
                    ) from e
                inner = lz4.frame.decompress(data)
            else:
                raise ValueError(f"unknown chunk compression {comp!r}")
            for h2, d2 in _iter_records(inner):
                out = handle(h2, d2)
                if out is not None:
                    yield out
        elif op in (_OP_CONN, _OP_MSG):  # unchunked (our writer, old tools)
            out = handle(header, data)
            if out is not None:
                yield out
        # bag header / index / chunk info: skipped


# ---------------------------------------------------------------------------
# message (de)serialization — only what the localizer consumes
# ---------------------------------------------------------------------------

def _read_string(buf, off):
    (n,) = struct.unpack_from("<I", buf, off)
    return buf[off + 4 : off + 4 + n].decode(errors="replace"), off + 4 + n


def parse_laserscan(data: bytes) -> dict:
    """sensor_msgs/LaserScan: Header, 7x float32, ranges[], intensities[]."""
    off = 4  # header.seq
    secs, nsecs = struct.unpack_from("<II", data, off)
    off += 8
    _, off = _read_string(data, off)  # frame_id
    (a_min, a_max, a_inc, t_inc, scan_t, r_min, r_max) = struct.unpack_from(
        "<7f", data, off
    )
    off += 28
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    ranges = np.frombuffer(data, dtype="<f4", count=n, offset=off).copy()
    return {
        "stamp": secs + nsecs * 1e-9,
        "angle_min": a_min,
        "angle_max": a_max,
        "angle_increment": a_inc,
        "range_min": r_min,
        "range_max": r_max,
        "ranges": ranges,
    }


def parse_odometry(data: bytes) -> dict:
    """nav_msgs/Odometry: Header, child_frame_id, pose+cov, twist+cov."""
    off = 4
    secs, nsecs = struct.unpack_from("<II", data, off)
    off += 8
    _, off = _read_string(data, off)  # frame_id
    _, off = _read_string(data, off)  # child_frame_id
    x, y, _z, qx, qy, qz, qw = struct.unpack_from("<7d", data, off)
    yaw = float(np.arctan2(2.0 * (qw * qz + qx * qy),
                           1.0 - 2.0 * (qy * qy + qz * qz)))
    return {"stamp": secs + nsecs * 1e-9, "pose": (x, y, yaw)}


def _ser_header(stamp: float, frame_id: str, seq: int) -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    fid = frame_id.encode()
    return struct.pack("<III", seq, secs, nsecs) + struct.pack(
        "<I", len(fid)
    ) + fid


def ser_laserscan(stamp, angle_min, angle_increment, ranges,
                  range_max, frame_id="base_scan", seq=0) -> bytes:
    r = np.asarray(ranges, dtype="<f4")
    angle_max = angle_min + angle_increment * (len(r) - 1)
    return (
        _ser_header(stamp, frame_id, seq)
        + struct.pack("<7f", angle_min, angle_max, angle_increment,
                      0.0, 0.0, 0.0, range_max)
        + struct.pack("<I", len(r)) + r.tobytes()
        + struct.pack("<I", 0)  # intensities: empty
    )


def ser_odometry(stamp, pose, frame_id="odom", child="base_footprint",
                 seq=0) -> bytes:
    x, y, yaw = (float(v) for v in pose)
    qz, qw = np.sin(yaw / 2.0), np.cos(yaw / 2.0)
    child_b = child.encode()
    return (
        _ser_header(stamp, frame_id, seq)
        + struct.pack("<I", len(child_b)) + child_b
        + struct.pack("<7d", x, y, 0.0, 0.0, 0.0, qz, qw)
        + b"\x00" * (36 * 8)
        + struct.pack("<6d", 0, 0, 0, 0, 0, 0)
        + b"\x00" * (36 * 8)
    )


# ---------------------------------------------------------------------------
# Bag assembly
# ---------------------------------------------------------------------------

def read_rosbag(path: str, scan_topic: str = "/scan",
                odom_topic: str = "/odom"):
    """Parse a ROS1 bag into the framework's scan-aligned Bag.

    Each LaserScan is paired with the latest Odometry at-or-before its
    stamp (the reference's callback ordering: odom_callback stores the pose
    a later lidar_callback consumes, amcmh_localizer.py:199-235).  Scans
    before the first odometry message are dropped.  Real bags carry no
    ground truth: ``gt`` is filled with the odometry poses and
    ``meta["gt_from"] = "odom"`` records that RMSE vs gt is then
    odometry-relative, not absolute.
    """
    from mcmh_localization.sim.simulator import Bag

    scans = []
    odoms = []
    scan_meta = None
    for topic, mtype, _t, raw in read_messages(path):
        if topic == scan_topic and mtype == LASERSCAN_TYPE:
            msg = parse_laserscan(raw)
            if scan_meta is None:
                scan_meta = msg  # angles/range_max from the FIRST scan
            scans.append(msg)
        elif topic == odom_topic and mtype == ODOMETRY_TYPE:
            odoms.append(parse_odometry(raw))
    if not scans:
        raise ValueError(f"{path}: no {scan_topic} LaserScan messages")
    if not odoms:
        raise ValueError(f"{path}: no {odom_topic} Odometry messages")

    odom_t = np.array([o["stamp"] for o in odoms])
    odom_p = np.array([o["pose"] for o in odoms], dtype=np.float32)
    order = np.argsort(odom_t, kind="stable")
    odom_t, odom_p = odom_t[order], odom_p[order]

    ranges, poses, times = [], [], []
    m_first = len(scans[0]["ranges"])
    n_skipped = 0
    for s in scans:
        i = int(np.searchsorted(odom_t, s["stamp"], side="right")) - 1
        if i < 0:
            continue  # scan before any odometry
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


def write_rosbag(path: str, bag, scan_topic: str = "/scan",
                 odom_topic: str = "/odom") -> None:
    """Write a Bag as a spec-compliant single-chunk uncompressed rosbag.

    Connections carry the real type/md5 strings so standard ROS tooling
    recognizes the messages; the (optional-for-readers) index records are
    emitted so strict readers can seek."""

    def record(header: dict, data: bytes) -> bytes:
        h = _encode_header(header)
        return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data

    def time_field(t: float) -> bytes:
        secs = int(t)
        return struct.pack("<II", secs, int(round((t - secs) * 1e9)))

    conns = [
        (0, scan_topic, LASERSCAN_TYPE, LASERSCAN_MD5),
        (1, odom_topic, ODOMETRY_TYPE, ODOMETRY_MD5),
    ]
    conn_recs = b""
    for cid, topic, mtype, md5 in conns:
        ch = _encode_header(
            {"topic": topic.encode(), "type": mtype.encode(),
             "md5sum": md5.encode(), "message_definition": b""}
        )
        conn_recs += record(
            {"op": bytes([_OP_CONN]), "conn": struct.pack("<I", cid),
             "topic": topic.encode()},
            ch,
        )

    msgs = b""
    angle_min = float(bag.angles[0])
    angle_inc = float(bag.angles[1] - bag.angles[0]) if len(bag.angles) > 1 else 0.0
    t0 = float(bag.times[0])
    tn = float(bag.times[-1])
    count = 0
    for i in range(len(bag.times)):
        t = float(bag.times[i])
        msgs += record(
            {"op": bytes([_OP_MSG]), "conn": struct.pack("<I", 1),
             "time": time_field(t)},
            ser_odometry(t, bag.odom[i], seq=i),
        )
        msgs += record(
            {"op": bytes([_OP_MSG]), "conn": struct.pack("<I", 0),
             "time": time_field(t)},
            ser_laserscan(t, angle_min, angle_inc, bag.ranges[i],
                          bag.max_range, seq=i),
        )
        count += 2

    chunk_data = conn_recs + msgs
    out = bytearray()
    out += MAGIC
    # bag header record (data padded to 4096 like rosbag does)
    bh_data_len = 4096
    bag_header_pos = len(out)
    chunk_pos_field = struct.pack("<Q", 0)  # patched below
    # placeholder; we patch index_pos after layout is known
    out += record(
        {"op": bytes([_OP_BAGHDR]), "index_pos": struct.pack("<Q", 0),
         "conn_count": struct.pack("<I", len(conns)),
         "chunk_count": struct.pack("<I", 1)},
        b" " * bh_data_len,
    )
    chunk_pos = len(out)
    out += record(
        {"op": bytes([_OP_CHUNK]), "compression": b"none",
         "size": struct.pack("<I", len(chunk_data))},
        chunk_data,
    )
    index_pos = len(out)
    # connection records repeated at the end (the "index" section)
    out += conn_recs
    out += record(
        {"op": bytes([_OP_CHUNKINFO]), "ver": struct.pack("<I", 1),
         "chunk_pos": struct.pack("<Q", chunk_pos),
         "start_time": time_field(t0), "end_time": time_field(tn),
         "count": struct.pack("<I", len(conns))},
        struct.pack("<II", 0, count // 2) + struct.pack("<II", 1, count // 2),
    )
    # patch index_pos in the bag header (re-serialize the header record)
    patched = record(
        {"op": bytes([_OP_BAGHDR]), "index_pos": struct.pack("<Q", index_pos),
         "conn_count": struct.pack("<I", len(conns)),
         "chunk_count": struct.pack("<I", 1)},
        b" " * bh_data_len,
    )
    out[bag_header_pos : chunk_pos] = patched
    del chunk_pos_field
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(bytes(out))
