"""First-class histogram columns: bucket schemes, histogram values, and the
2D-delta compressed histogram vector.

Re-design of the reference's histogram support
(memory/format/vectors/Histogram.scala:17,456,488 and
HistogramVector.scala:34,378 "2D delta" — delta across time AND buckets; spec
in doc/compression.md).  Buckets are cumulative (Prometheus ``le`` semantics).

Vector wire layout (little-endian)::

    u8  kind (K_HIST_2D)
    u32 num_rows
    u8  counter (1 = increasing counter histogram)
    bucket scheme:
        u8 scheme (0 = geometric, 1 = custom)
        geometric: f64 firstBucket, f64 multiplier, u16 numBuckets
        custom:    u16 numBuckets, f64 * numBuckets (le values)
    row 0:   pack_delta over bucket values (increasing within a histogram)
    rows 1+: pack_non_increasing over two's-complement time-deltas per bucket
             (DeltaDiffPackSink semantics, NibblePack.scala:259)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.memory import nibblepack as nbp

K_HIST_2D = 16
# Sectioned 2D-delta: same payload, plus an explicit drop-section table
# (row indices where ANY bucket decreased) recorded at encode time — the
# reader applies counter correction without rescanning buckets
# (HistogramVector.scala:427 SectDelta / Section.scala drop sections).
K_HIST_SECT = 17

_U64 = (1 << 64) - 1


@dataclass(frozen=True)
class GeometricBuckets:
    """le_i = firstBucket * multiplier**i (Histogram.scala:456)."""
    first: float
    multiplier: float
    num: int

    def les(self) -> np.ndarray:
        return self.first * self.multiplier ** np.arange(self.num)


@dataclass(frozen=True)
class CustomBuckets:
    """Explicit le values (Histogram.scala:488)."""
    le_values: Tuple[float, ...]

    @property
    def num(self) -> int:
        return len(self.le_values)

    def les(self) -> np.ndarray:
        return np.asarray(self.le_values, dtype=np.float64)


def _encode_scheme(scheme) -> bytes:
    if isinstance(scheme, GeometricBuckets):
        return struct.pack("<BddH", 0, scheme.first, scheme.multiplier, scheme.num)
    return struct.pack("<BH", 1, scheme.num) + np.asarray(
        scheme.le_values, dtype="<f8").tobytes()


def _decode_scheme(buf: bytes, off: int):
    kind = buf[off]
    if kind == 0:
        first, mult, num = struct.unpack_from("<ddH", buf, off + 1)
        return GeometricBuckets(first, mult, num), off + 1 + 18
    (num,) = struct.unpack_from("<H", buf, off + 1)
    les = np.frombuffer(buf, dtype="<f8", count=num, offset=off + 3)
    return CustomBuckets(tuple(les.tolist())), off + 3 + 8 * num


def detect_drop_rows(rows: np.ndarray) -> np.ndarray:
    """Row indices i>0 where ANY bucket decreased vs row i-1 — a counter
    reset. Per-bucket detection catches partial drops the +Inf-only check
    misses (HistogramVector.scala:427 SectDelta drop sections)."""
    rows = np.asarray(rows)
    if rows.shape[0] < 2:
        return np.zeros(0, dtype=np.int64)
    dropped = (np.diff(rows, axis=0) < 0).any(axis=1)
    return np.nonzero(dropped)[0] + 1


def encode_histograms(scheme, rows: np.ndarray, counter: bool = True,
                      sectioned: bool = True) -> bytes:
    """Encode [num_rows, num_buckets] int64 bucket counts as a 2D-delta vector
    (HistogramVector.scala:378 appendHistogram / DeltaDiffPackSink).

    ``sectioned`` (the default, SectDelta equivalent) additionally records
    the drop-section table so readers get reset positions for free."""
    rows = np.asarray(rows, dtype=np.int64)
    n, nb = rows.shape if rows.size else (0, scheme.num)
    kind = K_HIST_SECT if sectioned else K_HIST_2D
    out = bytearray(struct.pack("<BIB", kind, n, 1 if counter else 0))
    out.extend(_encode_scheme(scheme))
    if sectioned:
        drops = detect_drop_rows(rows) if counter and n else \
            np.zeros(0, dtype=np.int64)
        out.extend(struct.pack("<H", drops.size))
        out.extend(drops.astype("<u4").tobytes())
    if n == 0:
        return bytes(out)
    nbp.pack_delta(rows[0].astype(np.int64), out)
    for t in range(1, n):
        diffs = (rows[t] - rows[t - 1]).astype(np.int64)
        nbp.pack_non_increasing(
            (diffs.astype(np.int64).view(np.uint64)), out)
    return bytes(out)


def decode_histograms_full(buf: bytes):
    """Decode to (scheme, counter_flag, [num_rows, num_buckets] float64,
    drop_rows). For sectioned vectors drop_rows comes from the encoded
    section table; for plain 2D vectors it is None (caller rescans)."""
    kind, n, counter = struct.unpack_from("<BIB", buf, 0)
    if kind not in (K_HIST_2D, K_HIST_SECT):
        raise ValueError(f"not a histogram vector: kind={kind}")
    scheme, off = _decode_scheme(buf, 6)
    drops = None
    if kind == K_HIST_SECT:
        (n_drops,) = struct.unpack_from("<H", buf, off)
        off += 2
        drops = np.frombuffer(buf, dtype="<u4", count=n_drops,
                              offset=off).astype(np.int64)
        off += 4 * n_drops
    nb = scheme.num
    rows = np.zeros((n, nb), dtype=np.int64)
    if n > 0:
        first, off = nbp.unpack_delta(buf, off, nb)
        rows[0] = first
        for t in range(1, n):
            words, off = nbp.unpack_to_words(buf, off, nb)
            diffs = np.array(words, dtype=np.uint64).view(np.int64)
            rows[t] = rows[t - 1] + diffs
    return scheme, bool(counter), rows.astype(np.float64), drops


def decode_histograms(buf: bytes):
    """Decode to (scheme, counter_flag, [num_rows, num_buckets] float64)."""
    scheme, counter, rows, _ = decode_histograms_full(buf)
    return scheme, counter, rows


def hist_scheme_of(buf: bytes):
    """Bucket scheme from a histogram vector's header alone (no payload
    decode) — used when paging persisted chunks back into a partition."""
    scheme, _ = _decode_scheme(buf, 6)
    return scheme


def hist_counter_correction(rows: np.ndarray,
                            drop_rows: Optional[np.ndarray] = None
                            ) -> np.ndarray:
    """Per-bucket reset correction, analogous to
    vectors.counter_correction but on [n, nb] matrices. A reset is any
    row where ANY bucket decreased (partial per-bucket drops count —
    HistogramVector.scala:427 sectioned drop detection); the correction
    adds back the full pre-reset histogram, Prometheus counter-reset
    semantics applied bucket-wise. ``drop_rows`` (from a sectioned
    vector's table) skips re-detection."""
    rows = np.asarray(rows, dtype=np.float64)
    if rows.shape[0] == 0:
        return np.zeros_like(rows)
    if drop_rows is None:
        drop_rows = detect_drop_rows(rows)
    dropped = np.zeros(rows.shape[0], dtype=bool)
    dropped[drop_rows] = True
    drops = np.where(dropped[1:, None], rows[:-1], 0.0)
    corr = np.zeros_like(rows)
    corr[1:] = np.cumsum(drops, axis=0)
    return corr


def quantile(q: float, les: np.ndarray, bucket_values: np.ndarray) -> float:
    """Prometheus histogram_quantile interpolation over one cumulative
    histogram (Histogram.scala:17 quantile; matches Prometheus' bucketQuantile).
    """
    if not 0 <= q <= 1:
        return float("inf") if q > 1 else float("-inf")
    if len(les) < 2 or not np.isposinf(les[-1]):
        if len(les) < 2:
            return float("nan")
    total = bucket_values[-1]
    if total == 0 or np.isnan(total):
        return float("nan")
    rank = q * total
    b = int(np.searchsorted(bucket_values, rank, side="left"))
    b = min(b, len(les) - 1)
    if b == len(les) - 1:
        return float(les[-2])
    if b == 0 and les[0] <= 0:
        return float(les[0])
    bucket_start = 0.0 if b == 0 else float(les[b - 1])
    bucket_end = float(les[b])
    count_start = 0.0 if b == 0 else float(bucket_values[b - 1])
    count_end = float(bucket_values[b])
    if count_end == count_start:
        return bucket_end
    return bucket_start + (bucket_end - bucket_start) * \
        (rank - count_start) / (count_end - count_start)
