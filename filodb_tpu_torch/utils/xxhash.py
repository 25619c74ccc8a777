"""Pure-Python XXHash32, matching the reference's series hashing
(memory/src/main/scala/filodb.memory/BinaryRegion.scala:20-37 — lz4 XXHash32
with seed 0x9747b28c).  Shard routing compatibility depends on these hashes
(coordinator/ShardMapper.scala:122), so results are pinned by tests against
known xxh32 vectors.

Returns *signed* 32-bit ints to mirror JVM ``Int`` semantics, since the
reference's ``combineHash`` (RecordBuilder.scala:638) does Java int overflow
arithmetic.
"""

from __future__ import annotations

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393
_M32 = 0xFFFFFFFF

SEED = 0x9747B28C


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M32
    return (_rotl(acc, 13) * _P1) & _M32


def xxhash32(data: bytes, seed: int = SEED) -> int:
    """XXH32 of ``data``; returns signed 32-bit int (Java Int semantics)."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P1) & _M32
        limit = n - 16
        while i <= limit:
            v1 = _round(v1, int.from_bytes(data[i : i + 4], "little"))
            v2 = _round(v2, int.from_bytes(data[i + 4 : i + 8], "little"))
            v3 = _round(v3, int.from_bytes(data[i + 8 : i + 12], "little"))
            v4 = _round(v4, int.from_bytes(data[i + 12 : i + 16], "little"))
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        h = (h + int.from_bytes(data[i : i + 4], "little") * _P3) & _M32
        h = (_rotl(h, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _P5) & _M32
        h = (_rotl(h, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h - (1 << 32) if h >= (1 << 31) else h


def to_signed32(x: int) -> int:
    x &= _M32
    return x - (1 << 32) if x >= (1 << 31) else x
