"""Minimal pure-Python ROS1 bag reader, no ROS installation required (a copy
of `limovelo_tpu/io/rosbag.py`, which the port must not import).

Replaces the reference's rosbag-replay input path (the Xaloc slow/fast and
Ouster sample bags are the project's validation datasets, and the reference
consumes them through roscore + rosbag play).  This reader parses the ROS bag
v2.0 container format directly (records, chunk decompression, connection
headers) and decodes the two message types the pipeline needs:
`sensor_msgs/PointCloud2` and `sensor_msgs/Imu`.

Format reference: http://wiki.ros.org/Bags/Format/2.0 (public spec).
Supported compressions: none, bz2 (stdlib); lz4 through the `lz4` module,
imported only when a bag needs it.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..native import PF_DTYPES

_RECORD_HEADER_STRUCT = struct.Struct("<I")


def _parse_header(data: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(data):
        (flen,) = _RECORD_HEADER_STRUCT.unpack_from(data, off)
        off += 4
        field = data[off : off + flen]
        off += flen
        k, _, v = field.partition(b"=")
        fields[k] = v
    return fields


def _read_record(f) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
    head_len_b = f.read(4)
    if len(head_len_b) < 4:
        return None
    (hlen,) = _RECORD_HEADER_STRUCT.unpack(head_len_b)
    header = _parse_header(f.read(hlen))
    (dlen,) = _RECORD_HEADER_STRUCT.unpack(f.read(4))
    data = f.read(dlen)
    return header, data


@dataclass
class Connection:
    cid: int
    topic: str
    msg_type: str
    md5: str


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    t: float          # receive timestamp (sec)
    raw: bytes


class BagReader:
    """Stream messages in chunk order (≈ time order for normal bags)."""

    def __init__(self, path: str):
        self.path = path

    def messages(self, topics: Optional[List[str]] = None) -> Iterator[BagMessage]:
        with open(self.path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"not a ROS bag v2.0: {self.path} ({magic!r})")
            conns: Dict[int, Connection] = {}
            while True:
                rec = _read_record(f)
                if rec is None:
                    break
                header, data = rec
                op = header.get(b"op", b"")[0] if header.get(b"op") else None
                if op == 0x07:  # connection
                    self._add_connection(header, data, conns)
                elif op == 0x05:  # chunk
                    compression = header.get(b"compression", b"none").decode()
                    if compression == "bz2":
                        payload = bz2.decompress(data)
                    elif compression == "lz4":
                        import lz4.frame  # optional dependency

                        payload = lz4.frame.decompress(data)
                    else:
                        payload = data
                    yield from self._iter_chunk(payload, conns, topics)
                # in well-formed v2.0 bags every message lives in a chunk

    def _add_connection(self, header, data, conns):
        cid = struct.unpack("<I", header[b"conn"])[0]
        topic = header.get(b"topic", b"").decode()
        chdr = _parse_header(data)
        conns[cid] = Connection(
            cid=cid,
            topic=chdr.get(b"topic", topic.encode()).decode() or topic,
            msg_type=chdr.get(b"type", b"").decode(),
            md5=chdr.get(b"md5sum", b"").decode(),
        )

    def _iter_chunk(self, payload, conns, topics):
        off = 0
        n = len(payload)
        while off < n:
            (hlen,) = _RECORD_HEADER_STRUCT.unpack_from(payload, off)
            off += 4
            header = _parse_header(payload[off : off + hlen])
            off += hlen
            (dlen,) = _RECORD_HEADER_STRUCT.unpack_from(payload, off)
            off += 4
            data = payload[off : off + dlen]
            off += dlen
            op = header.get(b"op", b"")[0] if header.get(b"op") else None
            if op == 0x07:
                self._add_connection(header, data, conns)
            elif op == 0x02:
                cid = struct.unpack("<I", header[b"conn"])[0]
                conn = conns.get(cid)
                if conn is None:
                    continue
                if topics and conn.topic not in topics:
                    continue
                sec, nsec = struct.unpack("<II", header[b"time"])
                yield BagMessage(conn.topic, conn.msg_type, sec + nsec * 1e-9, data)


# ---------------------------------------------------------------------------
# message decoding
# ---------------------------------------------------------------------------


def _read_string(buf, off):
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off : off + n].decode(), off + n


def decode_pointcloud2(raw: bytes):
    """sensor_msgs/PointCloud2 → (stamp, fields dict of named arrays)."""
    off = 0
    (seq,) = struct.unpack_from("<I", raw, off); off += 4
    sec, nsec = struct.unpack_from("<II", raw, off); off += 8
    frame, off = _read_string(raw, off)
    height, width = struct.unpack_from("<II", raw, off); off += 8
    (nfields,) = struct.unpack_from("<I", raw, off); off += 4
    fields = []
    for _ in range(nfields):
        name, off = _read_string(raw, off)
        foffset, datatype, count = struct.unpack_from("<IBI", raw, off); off += 9
        fields.append((name, foffset, datatype, count))
    is_bigendian = raw[off]; off += 1
    point_step, row_step = struct.unpack_from("<II", raw, off); off += 8
    (dsize,) = struct.unpack_from("<I", raw, off); off += 4
    data = raw[off : off + dsize]; off += dsize

    n = height * width
    out = {}
    buf = np.frombuffer(data, np.uint8)
    if len(buf) < n * point_step:
        n = len(buf) // point_step
    buf = buf[: n * point_step].reshape(n, point_step)
    for name, foff, dtype_code, count in fields:
        dt = PF_DTYPES[dtype_code]
        nbytes = np.dtype(dt).itemsize * count
        col = buf[:, foff : foff + nbytes].copy().view(dt)
        out[name] = col.reshape(n) if count == 1 else col.reshape(n, count)
    return sec + nsec * 1e-9, out


def decode_imu(raw: bytes):
    """sensor_msgs/Imu → (stamp, q(x,y,z,w), w(3,), a(3,))."""
    off = 0
    off += 4  # seq
    sec, nsec = struct.unpack_from("<II", raw, off); off += 8
    _, off = _read_string(raw, off)  # frame_id
    q = np.array(struct.unpack_from("<4d", raw, off)); off += 32  # x,y,z,w
    off += 72  # orientation covariance
    w = np.array(struct.unpack_from("<3d", raw, off)); off += 24
    off += 72
    a = np.array(struct.unpack_from("<3d", raw, off)); off += 24
    return sec + nsec * 1e-9, q, w, a


# ---------------------------------------------------------------------------
# pipeline feed
# ---------------------------------------------------------------------------


def feed_pipeline(pipe, bag_path: str, config, max_msgs: Optional[int] = None):
    """Replay a bag through the pipeline using the configured topics
    (points_topic / imus_topic — main.cpp:33-41) and vendor decode
    (io.pointcloud)."""
    from .pointcloud import decode_scan

    reader = BagReader(bag_path)
    count = 0
    # The reference main loop runs after EVERY message (ros::spinOnce at up
    # to 5 kHz, main.cpp:50-63): with real_time=True each IMU arrival moves
    # `latest_time` forward and can open a new window, so delta=0.01 configs
    # really update at ~100 Hz instead of being capped at the ~10 Hz scan
    # rate.  Offline (real_time=False) windows advance by fixed deltas from
    # buffered data, so spinning once per scan is equivalent and far cheaper
    # on the host.
    spin_every_imu = bool(config.real_time)
    for msg in reader.messages(topics=[config.points_topic, config.imus_topic]):
        if msg.msg_type.endswith("Imu"):
            t, q, w, a = decode_imu(msg.raw)
            pipe.add_imu(t, a.astype(np.float32), w.astype(np.float32), q=q)
            if spin_every_imu:
                pipe.spin()
        else:
            stamp, fields = decode_pointcloud2(msg.raw)
            xyz = np.stack([fields["x"], fields["y"], fields["z"]], axis=1)
            tf = None
            for cand in ("time", "t", "timestamp"):
                if cand in fields:
                    tf = fields[cand]
                    break
            # intensity channel: velodyne/hesai `intensity`, ouster
            # `reflectivity` (Point.cpp:172-175)
            inten = None
            for cand in ("intensity", "reflectivity"):
                if cand in fields:
                    inten = fields[cand]
                    break
            if inten is not None:
                pts, ts, ii = decode_scan(config, xyz, stamp, time_field=tf, intensity=inten)
                pipe.add_scan(pts, ts, intensity=ii)
            else:
                pts, ts = decode_scan(config, xyz, stamp, time_field=tf)
                pipe.add_scan(pts, ts)
            pipe.spin()
        count += 1
        if max_msgs is not None and count >= max_msgs:
            break
    pipe.spin()
