"""NibblePack: nibble-granularity packing of groups of 8 u64 words.

Bit-compatible re-implementation of the reference algorithm
(memory/src/main/scala/filodb.memory/format/NibblePack.scala:12; spec in
doc/compression.md "Predictive NibblePacking").  The wire format:

For each group of 8 input u64 words::

    byte 0: bitmask — bit i set if word i is nonzero
    (if bitmask != 0)
    byte 1: nibble word — high 4 bits = (numNibbles - 1),
                          low 4 bits  = trailing zero nibbles
    then: the nonzero words, each stripped of trailing zero nibbles and
          truncated to numNibbles nibbles, bit-packed little-endian back to
          back; final partial u64 written with only ceil(bits/8) bytes.

Three predictors transform values before packing (NibblePack.scala:16,37,70):

- ``pack_non_increasing``: raw u64s (used for chunk-metadata style data).
- ``pack_delta``: positive increasing longs stored as deltas from previous
  (negative deltas clamped to 0).
- ``pack_doubles``: first double stored raw (8 bytes LE), successive values
  XORed against previous bit pattern.

This module is the *interchange* codec; the TPU query path does not run this
bit-twiddling per query — chunks are decoded once into dense device tiles at
flush/upload time (see filodb_tpu_torch.query.tpu).
"""

from __future__ import annotations

import struct

import numpy as np

_U64_MASK = (1 << 64) - 1


class InputTooShort(Exception):
    """Compressed input ended before all values could be unpacked."""


def _nlz64(x: int) -> int:
    """Number of leading zeros of x as u64 (64 for x == 0)."""
    if x == 0:
        return 64
    return 64 - x.bit_length()


def _ntz64(x: int) -> int:
    """Number of trailing zeros of x as u64 (64 for x == 0)."""
    if x == 0:
        return 64
    return (x & -x).bit_length() - 1


def pack8(words, out: bytearray) -> None:
    """Pack 8 u64 words into ``out`` (NibblePack.scala:105 pack8)."""
    bitmask = 0
    for i in range(8):
        if words[i] != 0:
            bitmask |= 1 << i
    out.append(bitmask)
    if bitmask == 0:
        return

    min_lz = 64
    min_tz = 64
    for i in range(8):
        w = words[i]
        lz = _nlz64(w)
        tz = _ntz64(w)
        if lz < min_lz:
            min_lz = lz
        if tz < min_tz:
            min_tz = tz

    trailing_nibbles = min_tz // 4
    num_nibbles = 16 - (min_lz // 4) - trailing_nibbles
    out.append(((num_nibbles - 1) << 4) | trailing_nibbles)

    # Pack nonzero words back to back, numNibbles*4 bits each, little-endian
    # (NibblePack.scala:140 packUniversal).
    trailing_shift = trailing_nibbles * 4
    num_bits = num_nibbles * 4
    out_word = 0
    bit_cursor = 0
    for i in range(8):
        w = words[i]
        if w == 0:
            continue
        remaining = 64 - bit_cursor
        shifted = w >> trailing_shift
        out_word = (out_word | (shifted << bit_cursor)) & _U64_MASK
        if remaining <= num_bits:
            out.extend(out_word.to_bytes(8, "little"))
            out_word = (shifted >> remaining) if remaining < num_bits else 0
        bit_cursor = (bit_cursor + num_bits) % 64
    if bit_cursor > 0:
        out.extend(out_word.to_bytes(8, "little")[: (bit_cursor + 7) // 8])


def unpack8(buf, pos: int, out):
    """Unpack one 8-word group from ``buf`` at ``pos`` into list ``out`` (len 8).

    Returns the new position.  (NibblePack.scala:373 unpack8.)
    """
    n = len(buf)
    if pos >= n:
        raise InputTooShort()
    bitmask = buf[pos]
    if bitmask == 0:
        for i in range(8):
            out[i] = 0
        return pos + 1
    if pos + 1 >= n:
        raise InputTooShort()
    nib = buf[pos + 1]
    num_bits = ((nib >> 4) + 1) * 4
    trailing_zeroes = (nib & 0x0F) * 4
    total_bytes = 2 + (num_bits * bin(bitmask).count("1") + 7) // 8
    mask = _U64_MASK if num_bits >= 64 else (1 << num_bits) - 1
    buf_index = pos + 2
    bit_cursor = 0

    def read_word(idx: int) -> int:
        if idx + 8 <= n:
            return int.from_bytes(buf[idx : idx + 8], "little")
        return int.from_bytes(buf[idx:n], "little")

    in_word = read_word(buf_index)
    buf_index += 8
    for bit in range(8):
        if bitmask & (1 << bit):
            remaining = 64 - bit_cursor
            out_word = (in_word >> bit_cursor) & mask
            if remaining <= num_bits and (buf_index - pos) < total_bytes:
                if buf_index < n:
                    in_word = read_word(buf_index)
                    buf_index += 8
                    if remaining < num_bits:
                        out_word |= (in_word << remaining) & mask
                else:
                    raise InputTooShort()
            out[bit] = (out_word << trailing_zeroes) & _U64_MASK
            bit_cursor = (bit_cursor + num_bits) % 64
        else:
            out[bit] = 0
    return pos + total_bytes


# ---------------------------------------------------------------------------
# Predictor-level pack/unpack on whole arrays
# ---------------------------------------------------------------------------

def pack_non_increasing(values, out: bytearray) -> None:
    """Pack raw u64 values (NibblePack.scala:16 packNonIncreasing)."""
    group = [0] * 8
    i = 0
    for v in values:
        group[i % 8] = int(v) & _U64_MASK
        i += 1
        if i % 8 == 0:
            pack8(group, out)
    if i % 8 != 0:
        for j in range(i % 8, 8):
            group[j] = 0
        pack8(group, out)


def pack_delta(values, out: bytearray) -> None:
    """Pack positive increasing longs as deltas (NibblePack.scala:37 packDelta).

    A value lower than its predecessor is stored as delta 0.
    """
    group = [0] * 8
    last = 0
    i = 0
    for v in values:
        v = int(v)
        delta = v - last if v >= last else 0
        last = v
        group[i % 8] = delta
        i += 1
        if i % 8 == 0:
            pack8(group, out)
    if i % 8 != 0:
        for j in range(i % 8, 8):
            group[j] = 0
        pack8(group, out)


def pack_doubles(values, out: bytearray) -> None:
    """XOR-pack doubles; first value raw LE (NibblePack.scala:70 packDoubles)."""
    values = np.asarray(values, dtype=np.float64)
    if values.size == 0:
        raise ValueError("pack_doubles requires at least one value")
    out.extend(struct.pack("<d", values[0]))
    bits = values.view(np.uint64)
    group = [0] * 8
    last = int(bits[0])
    i = 0
    for k in range(1, values.size):
        b = int(bits[k])
        group[i % 8] = b ^ last
        last = b
        i += 1
        if i % 8 == 0:
            pack8(group, out)
    if i % 8 != 0:
        for j in range(i % 8, 8):
            group[j] = 0
        pack8(group, out)


def unpack_to_words(buf, pos: int, num_values: int):
    """Unpack ``num_values`` raw u64 words; returns (u64 ndarray, new_pos)."""
    out = []
    group = [0] * 8
    left = num_values
    while left > 0:
        pos = unpack8(buf, pos, group)
        take = min(left, 8)
        out.extend(group[:take])
        left -= take
    return np.array(out, dtype=np.uint64), pos


def unpack_delta(buf, pos: int, num_values: int):
    """Unpack delta-packed values back to absolute longs (DeltaSink semantics,
    NibblePack.scala:205).  Returns (np.ndarray[int64], new_pos)."""
    words, pos = unpack_to_words(buf, pos, num_values)
    arr = np.array(words, dtype=np.uint64)
    return np.cumsum(arr.astype(np.int64)), pos


def unpack_double_xor(buf, pos: int, num_values: int):
    """Unpack XOR-packed doubles (DoubleXORSink, NibblePack.scala:225/:352).

    Returns (np.ndarray[float64], new_pos).
    """
    if len(buf) - pos < 8:
        raise InputTooShort()
    first_bits = int.from_bytes(buf[pos : pos + 8], "little")
    pos += 8
    if num_values == 1:
        words = []
    else:
        words, pos = unpack_to_words(buf, pos, num_values - 1)
    bits = np.empty(num_values, dtype=np.uint64)
    bits[0] = first_bits
    if num_values > 1:
        # running XOR: bits[i] = bits[i-1] ^ words[i-1]; XOR-scan via ufunc
        xors = np.array(words, dtype=np.uint64)
        bits[1:] = np.bitwise_xor.accumulate(xors)
        bits[1:] ^= np.uint64(first_bits)
    return bits.view(np.float64).copy(), pos


# ---------------------------------------------------------------------------
# Native (C++) fast path — same wire format, same signatures
# ---------------------------------------------------------------------------
# The Python functions above are the behavioral oracle (and the fallback
# when no compiler exists); when the native codec builds, the public names
# below are rebound to ctypes wrappers. Parity is pinned by
# tests/test_nibblepack.py, which compares both implementations.

pack_non_increasing_py = pack_non_increasing
pack_delta_py = pack_delta
pack_doubles_py = pack_doubles
unpack_to_words_py = unpack_to_words
unpack_delta_py = unpack_delta
unpack_double_xor_py = unpack_double_xor

try:
    from filodb_tpu_torch.native import load_nibblepack as _load_native
    _native = _load_native()
except Exception:       # pragma: no cover — build env without g++
    _native = None

if _native is not None:
    import ctypes as _ct

    _U8P = _ct.POINTER(_ct.c_uint8)
    _U64P = _ct.POINTER(_ct.c_uint64)
    _I64P = _ct.POINTER(_ct.c_int64)
    _F64P = _ct.POINTER(_ct.c_double)

    def _cap(n: int) -> int:
        # worst case per 8-word group: 2 header + 64 payload bytes
        return 8 + ((n + 7) // 8) * 66

    def pack_non_increasing(values, out: bytearray) -> None:
        arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
        buf = np.empty(_cap(arr.size), dtype=np.uint8)
        n = _native.np_pack_non_increasing(
            arr.ctypes.data_as(_U64P), arr.size,
            buf.ctypes.data_as(_U8P))
        out.extend(buf[:n].tobytes())

    def pack_delta(values, out: bytearray) -> None:
        arr = np.ascontiguousarray(np.asarray(values, dtype=np.int64))
        buf = np.empty(_cap(arr.size), dtype=np.uint8)
        n = _native.np_pack_delta(
            arr.ctypes.data_as(_I64P), arr.size,
            buf.ctypes.data_as(_U8P))
        out.extend(buf[:n].tobytes())

    def pack_doubles(values, out: bytearray) -> None:
        arr = np.ascontiguousarray(np.asarray(values, dtype=np.float64))
        if arr.size == 0:
            raise ValueError("pack_doubles requires at least one value")
        buf = np.empty(_cap(arr.size), dtype=np.uint8)
        n = _native.np_pack_doubles(
            arr.ctypes.data_as(_F64P), arr.size,
            buf.ctypes.data_as(_U8P))
        out.extend(buf[:n].tobytes())

    def _in_buf(buf) -> np.ndarray:
        return np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf

    def unpack_to_words(buf, pos: int, num_values: int):
        b = _in_buf(buf)
        out = np.empty(num_values, dtype=np.uint64)
        new_pos = _native.np_unpack_words(
            b.ctypes.data_as(_U8P), b.size, pos, num_values,
            out.ctypes.data_as(_U64P))
        if new_pos < 0:
            raise InputTooShort()
        return out, new_pos

    def unpack_delta(buf, pos: int, num_values: int):
        b = _in_buf(buf)
        out = np.empty(num_values, dtype=np.int64)
        new_pos = _native.np_unpack_delta(
            b.ctypes.data_as(_U8P), b.size, pos, num_values,
            out.ctypes.data_as(_I64P))
        if new_pos < 0:
            raise InputTooShort()
        return out, new_pos

    def unpack_double_xor(buf, pos: int, num_values: int):
        b = _in_buf(buf)
        out = np.empty(num_values, dtype=np.float64)
        new_pos = _native.np_unpack_double_xor(
            b.ctypes.data_as(_U8P), b.size, pos, num_values,
            out.ctypes.data_as(_F64P))
        if new_pos < 0:
            raise InputTooShort()
        return out, new_pos
