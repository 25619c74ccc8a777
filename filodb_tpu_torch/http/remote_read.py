"""Prometheus remote-read: snappy-framed protobuf over HTTP POST.

(Reference: prometheus/src/main/proto/remote-storage.proto +
PrometheusApiRoute.scala:129 — the standard Prometheus remote storage
interchange: ReadRequest{Query{matchers,start,end}} in,
ReadResponse{QueryResult{TimeSeries{labels,samples}}} out, both snappy
raw-block compressed.)

No third-party deps: the protobuf wire format for these flat messages is
hand-coded (varint/length-delimited/fixed64), and snappy's raw block
format is implemented here — a complete decompressor (Prometheus sends
real compressed bodies) and a spec-valid literal-run compressor for
responses.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

# ---------------------------------------------------------------------------
# snappy raw block format (no framing)
# ---------------------------------------------------------------------------


MAX_UNCOMPRESSED = 64 << 20     # decompression-bomb guard (DoS)


def snappy_decompress(buf: bytes,
                      max_len: int = MAX_UNCOMPRESSED) -> bytes:
    """Full snappy block decompressor (literals + all three copy tags).
    Bounded by ``max_len`` — /read is unauthenticated, so a crafted tiny
    body must not balloon into unbounded memory/CPU."""
    # preamble: uvarint uncompressed length (<= 5 bytes per snappy spec;
    # unbounded continuation bytes would be a bigint CPU bomb)
    ulen = 0
    shift = 0
    pos = 0
    while True:
        if shift > 32:
            raise ValueError("snappy: preamble varint too long")
        b = buf[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if ulen > max_len:
        raise ValueError(f"snappy: declared length {ulen} over limit")
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                       # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                length = int.from_bytes(buf[pos:pos + extra], "little")
                pos += extra
            length += 1
            out += buf[pos:pos + length]
            pos += length
            continue
        if kind == 1:                       # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:                     # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:                               # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if offset == 0:
            raise ValueError("snappy: zero copy offset")
        start = len(out) - offset
        if start < 0:
            raise ValueError("snappy: offset before start")
        if len(out) + length > ulen:
            raise ValueError("snappy: output exceeds declared length")
        if offset >= length:
            out += out[start:start + length]    # non-overlapping: slice
        else:
            # overlapping copies are byte-at-a-time by spec
            for i in range(length):
                out.append(out[start + i])
    if len(out) != ulen:
        raise ValueError(f"snappy: length mismatch {len(out)} != {ulen}")
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """Spec-valid snappy: uvarint length + literal runs (no back-refs —
    correctness over ratio; peers decompress it with any snappy impl)."""
    out = bytearray()
    ulen = len(data)
    while True:
        b = ulen & 0x7F
        ulen >>= 7
        out.append(b | (0x80 if ulen else 0))
        if not ulen:
            break
    pos = 0
    n = len(data)
    while pos < n:
        chunk = min(n - pos, 1 << 24)
        if chunk <= 60:
            out.append((chunk - 1) << 2)
        elif chunk <= 0xFF:
            out.append(60 << 2)
            out.append(chunk - 1)
        elif chunk <= 0xFFFF:
            out.append(61 << 2)
            out += (chunk - 1).to_bytes(2, "little")
        else:
            out.append(62 << 2)
            out += (chunk - 1).to_bytes(3, "little")
        out += data[pos:pos + chunk]
        pos += chunk
    return bytes(out)


# ---------------------------------------------------------------------------
# minimal protobuf wire codec for the remote-storage messages
# ---------------------------------------------------------------------------


def _uvarint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v &= (1 << 64) - 1              # proto int64 two's complement
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _read_uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        if shift > 63:      # proto varints are <= 10 bytes
            raise ValueError("protobuf: varint too long")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_uvarint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_uvarint(buf, pos)
        elif wire == 1:
            v = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_uvarint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _ld(field: int, payload: bytes) -> bytes:
    return _uvarint((field << 3) | 2) + _uvarint(len(payload)) + payload


def _vi(field: int, v: int) -> bytes:
    return _uvarint(field << 3) + _uvarint(v)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# matcher type enum -> our ColumnFilter ops (LabelMatcher.Type)
_MATCHER_OPS = {0: "eq", 1: "neq", 2: "re", 3: "nre"}


def decode_read_request(buf: bytes) -> List[Dict]:
    """[{start_ms, end_ms, matchers: [(name, op, value), ...]}, ...]"""
    queries = []
    for field, _, v in _fields(buf):
        if field != 1:          # repeated Query queries = 1
            continue
        q = {"start_ms": 0, "end_ms": 0, "matchers": []}
        for f2, _, v2 in _fields(v):
            if f2 == 1:
                q["start_ms"] = _signed(v2)
            elif f2 == 2:
                q["end_ms"] = _signed(v2)
            elif f2 == 3:       # LabelMatcher
                mtype, name, value = 0, "", ""
                for f3, _, v3 in _fields(v2):
                    if f3 == 1:
                        mtype = v3
                    elif f3 == 2:
                        name = v3.decode()
                    elif f3 == 3:
                        value = v3.decode()
                q["matchers"].append(
                    (name, _MATCHER_OPS.get(mtype, "eq"), value))
        queries.append(q)
    return queries


def encode_read_request(queries: Sequence[Dict]) -> bytes:
    """Inverse of decode_read_request (used by tests/clients)."""
    ops = {v: k for k, v in _MATCHER_OPS.items()}
    out = b""
    for q in queries:
        body = _vi(1, q["start_ms"]) + _vi(2, q["end_ms"])
        for name, op, value in q["matchers"]:
            m = _vi(1, ops[op]) + _ld(2, name.encode()) \
                + _ld(3, value.encode())
            body += _ld(3, m)
        out += _ld(1, body)
    return out


def encode_read_response(results: Sequence[Sequence[Tuple[Dict, list]]]
                         ) -> bytes:
    """results: per query, a list of (labels, [(ts_ms, value), ...])."""
    out = b""
    for series_list in results:
        qr = b""
        for labels, samples in series_list:
            ts_msg = b""
            for name in sorted(labels):
                ts_msg += _ld(1, _ld(1, name.encode())
                              + _ld(2, labels[name].encode()))
            for ts_ms, value in samples:
                s = _uvarint((1 << 3) | 1) + struct.pack("<d", value) \
                    + _vi(2, int(ts_ms))
                ts_msg += _ld(2, s)
            qr += _ld(1, ts_msg)
        out += _ld(1, qr)
    return out


def decode_read_response(buf: bytes):
    """Inverse of encode_read_response."""
    results = []
    for field, _, v in _fields(buf):
        if field != 1:
            continue
        series_list = []
        for f2, _, v2 in _fields(v):
            if f2 != 1:
                continue
            labels: Dict[str, str] = {}
            samples: List[Tuple[int, float]] = []
            for f3, _, v3 in _fields(v2):
                if f3 == 1:
                    name = value = ""
                    for f4, _, v4 in _fields(v3):
                        if f4 == 1:
                            name = v4.decode()
                        elif f4 == 2:
                            value = v4.decode()
                    labels[name] = value
                elif f3 == 2:
                    val, ts = 0.0, 0
                    for f4, _, v4 in _fields(v3):
                        if f4 == 1:
                            (val,) = struct.unpack("<d", v4)
                        elif f4 == 2:
                            ts = _signed(v4)
                    samples.append((ts, val))
            series_list.append((labels, samples))
        results.append(series_list)
    return results
