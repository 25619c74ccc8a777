"""Columnar chunk vectors: the immutable, compressed per-chunk column format.

TPU-native re-design of the reference's BinaryVector family
(memory/src/main/scala/filodb.memory/format/BinaryVector.scala:19,
vectors/DeltaDeltaVector.scala:28, vectors/DoubleVector.scala:14,
vectors/LongBinaryVector.scala:15).  Semantics preserved:

- Timestamps / longs: **delta-delta** — value modeled as ``init + slope*i``
  with NibblePacked residuals; perfectly regular series collapse to a
  16-byte const vector (DeltaDeltaVector.scala "const variant").
- Doubles: XOR-predictor NibblePack (Gorilla-style), or a delta-delta long
  vector when all values are integral.
- Counter doubles: same encoding, tagged so readers apply **counter
  correction** (reset detection) at decode — the reference does this row-wise
  in CorrectingDoubleVectorReader (DoubleVector.scala:301); here correction is
  computed vectorized over the whole decoded chunk (cumsum of drops), which is
  the TPU-friendly formulation.

Wire layout (little-endian), one vector = ``bytes``::

    u8  kind
    u32 num_rows
    kind-specific payload

This is this framework's interchange format; the inner bit codec (NibblePack)
is bit-compatible with the reference so chunk payloads can be transcoded
losslessly at the host boundary.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from filodb_tpu_torch.memory import nibblepack as nbp

# vector kinds
K_TS_CONST = 1       # init i64, slope i64 : value(i) = init + slope * i
K_TS_DELTA_DELTA = 2  # init i64, slope i64, min_resid i64, packed residuals
K_DOUBLE_XOR = 3      # pack_doubles payload
K_DOUBLE_COUNTER = 4  # pack_doubles payload, counter semantics (apply correction)
K_LONG_AS_DOUBLE = 5  # delta-delta longs holding integral doubles
K_DOUBLE_CONST = 6    # f64 value repeated num_rows times
K_STR_CONST = 7       # one UTF-8 value repeated num_rows times
K_STR_DICT = 8        # dict UTF-8 + multi-width (8/16-bit) index stream
K_STR_UTF8 = 9        # u32 offsets (n+1) + UTF-8 blob

_HDR = struct.Struct("<BI")


def _header(kind: int, n: int) -> bytes:
    return _HDR.pack(kind, n)


def parse_header(buf: bytes) -> Tuple[int, int]:
    """Returns (kind, num_rows)."""
    return _HDR.unpack_from(buf, 0)


# ---------------------------------------------------------------------------
# Long / timestamp vectors (delta-delta)
# ---------------------------------------------------------------------------

def encode_longs(values: np.ndarray) -> bytes:
    """Encode int64 values with delta-delta + NibblePack
    (DeltaDeltaVector.scala:28; appender :293)."""
    values = np.asarray(values, dtype=np.int64)
    n = values.size
    if n == 0:
        return _header(K_TS_CONST, 0) + struct.pack("<qq", 0, 0)
    init = int(values[0])
    slope = int((int(values[-1]) - init) // (n - 1)) if n > 1 else 0
    predicted = init + slope * np.arange(n, dtype=np.int64)
    resid = values - predicted
    if not resid.any():
        return _header(K_TS_CONST, n) + struct.pack("<qq", init, slope)
    min_resid = int(resid.min())
    out = bytearray(_header(K_TS_DELTA_DELTA, n))
    out.extend(struct.pack("<qqq", init, slope, min_resid))
    nbp.pack_non_increasing((resid - min_resid).astype(np.uint64), out)
    return bytes(out)


def decode_longs(buf: bytes) -> np.ndarray:
    kind, n = parse_header(buf)
    off = _HDR.size
    if kind == K_TS_CONST:
        init, slope = struct.unpack_from("<qq", buf, off)
        return init + slope * np.arange(n, dtype=np.int64)
    if kind == K_TS_DELTA_DELTA:
        init, slope, min_resid = struct.unpack_from("<qqq", buf, off)
        words, _ = nbp.unpack_to_words(buf, off + 24, n)
        resid = np.array(words, dtype=np.uint64).astype(np.int64) + min_resid
        return init + slope * np.arange(n, dtype=np.int64) + resid
    raise ValueError(f"not a long vector kind: {kind}")


# ---------------------------------------------------------------------------
# Double vectors
# ---------------------------------------------------------------------------

def encode_doubles(values: np.ndarray, counter: bool = False) -> bytes:
    """Encode float64 values (DoubleVector.scala:14).

    Picks the smallest of: const, integral-as-delta-delta-long, XOR-packed —
    mirroring the reference's ``optimize()`` choice
    (format/BinaryVector.scala:496 OptimizingPrimitiveAppender).
    """
    values = np.asarray(values, dtype=np.float64)
    n = values.size
    kind = K_DOUBLE_COUNTER if counter else K_DOUBLE_XOR
    if n == 0:
        return _header(K_DOUBLE_CONST, 0) + struct.pack("<d", 0.0)
    if not counter and n > 0 and np.all(values == values[0]):
        return _header(K_DOUBLE_CONST, n) + struct.pack("<d", float(values[0]))
    finite = np.isfinite(values)
    if finite.all() and np.all(values == np.floor(values)) \
            and np.all(np.abs(values) < 2**62):
        inner = encode_longs(values.astype(np.int64))
        out = _header(K_LONG_AS_DOUBLE, n) + bytes([1 if counter else 0]) + inner
    else:
        out = None
    xor = bytearray(_header(kind, n))
    nbp.pack_doubles(values, xor)
    xor = bytes(xor)
    if out is not None and len(out) < len(xor):
        return out
    return xor


def decode_doubles(buf: bytes) -> np.ndarray:
    """Decode to raw (uncorrected) float64 values."""
    kind, n = parse_header(buf)
    off = _HDR.size
    if kind == K_DOUBLE_CONST:
        (v,) = struct.unpack_from("<d", buf, off)
        return np.full(n, v, dtype=np.float64)
    if kind in (K_DOUBLE_XOR, K_DOUBLE_COUNTER):
        vals, _ = nbp.unpack_double_xor(buf, off, n)
        return vals
    if kind == K_LONG_AS_DOUBLE:
        return decode_longs(buf[off + 1 :]).astype(np.float64)
    raise ValueError(f"not a double vector kind: {kind}")


# ---------------------------------------------------------------------------
# String vectors (UTF8Vector.scala / DictUTF8Vector.scala /
# ConstVector.scala): const when every row repeats one value,
# dict-encoded with MULTI-WIDTH integer indices (IntBinaryVector.scala's
# 8/16-bit packing applied to the code stream) at low cardinality, raw
# offsets + blob otherwise.
# ---------------------------------------------------------------------------

def encode_strings(values) -> bytes:
    """Encode a string column chunk. None encodes as ""."""
    vals = ["" if v is None else str(v) for v in values]
    n = len(vals)
    if n and all(v == vals[0] for v in vals):
        b = vals[0].encode()
        if len(b) <= 0xFFFFFFFF:
            return (_header(K_STR_CONST, n)
                    + struct.pack("<I", len(b)) + b)
    uniq = list(dict.fromkeys(vals))
    # dict only pays when values repeat (DictUTF8Vector's shouldMakeDict
    # samples cardinality before committing to the dict form)
    if n and len(uniq) <= 0x10000 and 2 * len(uniq) <= n \
            and all(len(v.encode()) <= 0xFFFF for v in uniq):
        idx_of = {v: i for i, v in enumerate(uniq)}
        width = 1 if len(uniq) <= 0x100 else 2
        out = bytearray(_header(K_STR_DICT, n))
        out += struct.pack("<IB", len(uniq), width)
        for v in uniq:
            vb = v.encode()
            out += struct.pack("<H", len(vb))
            out += vb
        dt = np.uint8 if width == 1 else np.uint16
        out += np.asarray([idx_of[v] for v in vals], dtype=dt).tobytes()
        return bytes(out)
    blob = bytearray()
    offs = np.zeros(n + 1, dtype=np.uint32)
    for i, v in enumerate(vals):
        blob += v.encode()
        offs[i + 1] = len(blob)
    return (bytes(_header(K_STR_UTF8, n)) + offs.tobytes() + bytes(blob))


def decode_strings(buf: bytes) -> np.ndarray:
    """Decode to a numpy object array of str."""
    kind, n = parse_header(buf)
    off = _HDR.size
    if kind == K_STR_CONST:
        (blen,) = struct.unpack_from("<I", buf, off)
        v = buf[off + 4:off + 4 + blen].decode()
        out = np.empty(n, dtype=object)
        out[:] = v
        return out
    if kind == K_STR_DICT:
        nuniq, width = struct.unpack_from("<IB", buf, off)
        off += 5
        uniq = []
        for _ in range(nuniq):
            (vlen,) = struct.unpack_from("<H", buf, off)
            off += 2
            uniq.append(buf[off:off + vlen].decode())
            off += vlen
        dt = np.uint8 if width == 1 else np.uint16
        idx = np.frombuffer(buf, dtype=dt, count=n, offset=off)
        out = np.empty(n, dtype=object)
        for i, code in enumerate(idx):
            out[i] = uniq[code]
        return out
    if kind == K_STR_UTF8:
        offs = np.frombuffer(buf, dtype=np.uint32, count=n + 1,
                             offset=off)
        base = off + 4 * (n + 1)
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = buf[base + offs[i]:base + offs[i + 1]].decode()
        return out
    raise ValueError(f"not a string vector kind: {kind}")


def is_counter_vector(buf: bytes) -> bool:
    kind, _ = parse_header(buf)
    if kind == K_DOUBLE_COUNTER:
        return True
    if kind == K_LONG_AS_DOUBLE:
        return buf[_HDR.size] == 1
    return False


def counter_correction(values: np.ndarray) -> np.ndarray:
    """Per-row accumulated counter-reset correction for a decoded chunk.

    corrected = values + counter_correction(values).  Vectorized equivalent of
    the reference's row-at-a-time drop detection
    (DoubleVector.scala:301 CorrectingDoubleVectorReader).
    NaNs (stale markers) do not participate in drop detection.
    """
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        return np.zeros(0)
    filled = v.copy()
    mask = np.isnan(filled)
    if mask.any():
        # forward-fill NaNs so they don't create artificial drops
        idx = np.where(~mask, np.arange(v.size), 0)
        np.maximum.accumulate(idx, out=idx)
        filled = filled[idx]
        filled[np.isnan(filled)] = 0.0
    diffs = np.diff(filled)
    drops = np.where(diffs < 0, filled[:-1], 0.0)
    corr = np.zeros_like(v)
    corr[1:] = np.cumsum(drops)
    return corr


# ---------------------------------------------------------------------------
# Generic dispatch
# ---------------------------------------------------------------------------

def num_rows(buf: bytes) -> int:
    return parse_header(buf)[1]


def decode(buf: bytes) -> np.ndarray:
    """Decode any vector to a numpy array (longs -> int64, doubles -> f64)."""
    kind, _ = parse_header(buf)
    if kind in (K_TS_CONST, K_TS_DELTA_DELTA):
        return decode_longs(buf)
    return decode_doubles(buf)
