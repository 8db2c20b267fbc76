"""RTP packetization, packet-file I/O, dump and loss-simulation tools.

Mirrors the reference's RTP subsystem: packet composition
(``ComposeRTPPacket``, ``FR/src/rtp_.c:96`` — JM's little-endian header
layout), packet-file format (``WriteRTPPacket`` ``FR/src/rtp_.c:156``:
u32le packet length | u32le timestamp(-1) | packet bytes), and the two C++
tools ``JM/rtpdump/rtpdump.cpp`` (packet inspection) and
``JM/rtp_loss/rtp_loss.cpp`` (random packet dropping with
``keep_leading_packets``).

One NALU per packet (the reference's only mode).  The payload is the NALU
byte sequence (header byte + EBSP), no start codes.

The port's own copy of ``h264tpu/bitstream/rtp.py`` (host numpy); it imports
nothing from ``h264tpu``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from . import nal

RTP_HEADER_LEN = 12
DEFAULT_PT = 105        # dynamic payload type, as in JM's RTPUpdateTimestamp
TIMESTAMP_PER_FRAME = 3600  # 90 kHz / 25 fps, JM default


@dataclasses.dataclass
class RTPPacket:
    seq: int
    timestamp: int
    payload: bytes           # NALU bytes (header + EBSP)
    ssrc: int = 0x12345678
    pt: int = DEFAULT_PT
    marker: int = 0


def compose_packet(p: RTPPacket) -> bytes:
    """12-byte header + payload; bit layout of ComposeRTPPacket
    (FR/src/rtp_.c:113-123: v/p/x/cc packed LSB-first, seq little-endian)."""
    b = bytearray(RTP_HEADER_LEN)
    b[0] = 2 | (0 << 2) | (0 << 3) | (0 << 4)       # v=2, p, x, cc
    b[1] = (p.marker & 1) | ((p.pt & 0x7F) << 1)
    b[2] = p.seq & 0xFF
    b[3] = (p.seq >> 8) & 0xFF
    b[4:8] = struct.pack("<I", p.timestamp & 0xFFFFFFFF)
    b[8:12] = struct.pack("<I", p.ssrc & 0xFFFFFFFF)
    return bytes(b) + p.payload


def parse_packet(data: bytes) -> RTPPacket:
    if len(data) < RTP_HEADER_LEN or (data[0] & 3) != 2:
        raise ValueError("bad RTP packet")
    return RTPPacket(
        seq=data[2] | (data[3] << 8),
        timestamp=struct.unpack("<I", data[4:8])[0],
        ssrc=struct.unpack("<I", data[8:12])[0],
        pt=(data[1] >> 1) & 0x7F, marker=data[1] & 1,
        payload=data[RTP_HEADER_LEN:])


# ---------------------------------------------------------------------------
# Packet file (JM .rtp format)
# ---------------------------------------------------------------------------

def write_rtp_file(packets) -> bytes:
    """u32le length | u32le intime(-1) | packet, per WriteRTPPacket."""
    out = bytearray()
    for pkt in packets:
        data = compose_packet(pkt) if isinstance(pkt, RTPPacket) else pkt
        out += struct.pack("<Ii", len(data), -1)
        out += data
    return bytes(out)


def read_rtp_file(data: bytes):
    packets = []
    off = 0
    while off + 8 <= len(data):
        n, _intime = struct.unpack_from("<Ii", data, off)
        off += 8
        packets.append(parse_packet(data[off:off + n]))
        off += n
    return packets


# ---------------------------------------------------------------------------
# Stream-level packetize / depacketize
# ---------------------------------------------------------------------------

def packetize(cfg, header_bytes: bytes, frame_payloads,
              frames_per_payload=None) -> bytes:
    """FVC stream -> RTP packet file.  One NALU per packet; SPS/PPS/stream
    header first (these are what rtp_loss's keep_leading_packets protects)."""
    nalus = [nal.NALU(nal.NAL_SPS, 3, nal.write_sps(cfg)),
             nal.NALU(nal.NAL_PPS, 3, nal.write_pps(cfg)),
             nal.NALU(nal.NAL_FVC_HEADER, 3, header_bytes + b"\x80")]
    for i, payload in enumerate(frame_payloads):
        idx = bytes([(i >> 8) & 0xFF, i & 0xFF])
        nalus.append(nal.NALU(nal.NAL_FVC_FRAME, 2, idx + payload + b"\x80"))
    packets = []
    for i, n in enumerate(nalus):
        ts = max(0, i - 3) * TIMESTAMP_PER_FRAME
        packets.append(RTPPacket(seq=i & 0xFFFF, timestamp=ts,
                                 payload=nal.nalu_to_bytes(n), marker=1))
    return write_rtp_file(packets)


def depacketize(data: bytes):
    """RTP packet file -> (sps, pps, header bytes, {index: payload}).
    Lost packets simply leave gaps in the payload dict."""
    sps = pps = header = None
    payloads = {}
    for pkt in read_rtp_file(data):
        n = nal.nalu_from_bytes(pkt.payload)
        if n.nal_type == nal.NAL_SPS:
            sps = nal.read_sps(n.rbsp)
        elif n.nal_type == nal.NAL_PPS:
            pps = nal.read_pps(n.rbsp)
        elif n.nal_type == nal.NAL_FVC_HEADER:
            header = n.rbsp[:-1]
        elif n.nal_type == nal.NAL_FVC_FRAME:
            idx = (n.rbsp[0] << 8) | n.rbsp[1]
            payloads[idx] = n.rbsp[2:-1]
    if header is None:
        raise ValueError("no FVC header packet (lost?)")
    return sps, pps, header, payloads


# ---------------------------------------------------------------------------
# Tools: rtpdump / rtp_loss equivalents
# ---------------------------------------------------------------------------

def rtpdump(data: bytes):
    """Per-packet info rows (JM/rtpdump/rtpdump.cpp equivalent)."""
    rows = []
    for pkt in read_rtp_file(data):
        ntype = pkt.payload[0] & 0x1F if pkt.payload else -1
        rows.append(dict(seq=pkt.seq, timestamp=pkt.timestamp,
                         pt=pkt.pt, marker=pkt.marker,
                         nal_type=ntype, bytes=len(pkt.payload)))
    return rows


def rtp_loss(data: bytes, loss_percent: int, keep_leading: int = 3,
             seed: int = 0) -> bytes:
    """Randomly drop packets (JM/rtp_loss/rtp_loss.cpp keep_packet logic:
    drop when rnd < loss_percent), always keeping the first
    ``keep_leading`` packets (parameter sets)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    off = 0
    i = 0
    while off + 8 <= len(data):
        n, _ = struct.unpack_from("<Ii", data, off)
        rec = data[off:off + 8 + n]
        off += 8 + n
        if i < keep_leading or int(rng.integers(0, 100)) >= loss_percent:
            out += rec
        i += 1
    return bytes(out)
