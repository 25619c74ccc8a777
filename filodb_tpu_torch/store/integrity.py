"""Storage-integrity rail: per-record checksummed framing, corruption
scanning/resync, and the quarantine sidecar — shared by the WAL
(ingest/stream.py), the chunk/partkey logs and checkpoint files
(store/columnstore.py), and the offline checker (filodb_tpu_torch/fsck.py).

The reference delegates durable-tier atomicity and integrity to
Cassandra; our local durable tier validated records only by struct
plausibility, so a flipped bit mid-log silently stopped replay
indexing and lost every record after it. This module makes corruption
a detected, contained, first-class event:

  * **Frame format** (version 1): every record a writer appends is
    wrapped in a 12-byte little-endian header ::

        magic u16 | version u8 | flags u8 | payload_len u32 | crc u32

    The CRC covers header bytes [2:8] (version, flags, payload_len)
    plus the payload, so a flip in the length field fails the check
    exactly like a flip in the data. ``flags`` bit 0 records the
    checksum algorithm: 0 = CRC32C (Castagnoli — used when a native
    implementation is importable), 1 = zlib CRC-32 (the stdlib
    fallback; C speed, no new dependency). Readers verify with
    whichever algorithm the frame declares, so files written on a host
    with native crc32c read back fine on one without (and vice versa).

  * **Format sniff**: the payload is the UNCHANGED legacy record
    encoding, and the frame magic is distinct from every legacy record
    magic — so a reader peeks one u16 at each record boundary and
    handles framed and unframed (pre-integrity) records in the same
    file. Existing stream dirs survive the upgrade with no migration.

  * **Scanner** (:func:`scan_buffer`): walks a byte range classifying
    it into records, corrupt regions (quarantine + resync at the next
    verifiable boundary), and a tail that is either clean, torn
    (incomplete record — the writer may still be appending; readers
    wait, takeover truncates) or corrupt (bad bytes with no resync
    point yet — more appends may reveal one, fsck can repair).

  * **Quarantine sidecar**: bad byte ranges are copied, before any
    truncation or skip, into a ``quarantine/`` directory next to the
    damaged file with a ``MANIFEST.jsonl`` recording file, offset,
    length and reason — so "skipped" never means "destroyed", and
    repair/forensics has the original bytes.

Every detection increments
``filodb_storage_corruption_total{file_kind,action}``, emits a
structured event on the global ring (obs/events.py) and a trace event
when a trace is active.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from filodb_tpu_torch.obs import events as obs_events
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs import trace as obs_trace

FRAME_MAGIC = 0xF7A3          # distinct from 0xF10D / 0xC4A2 / 0xBE11
FRAME_VERSION = 1
FLAG_ZLIB_CRC = 0x01          # checksum algo: set = zlib CRC-32
FRAME_HDR = struct.Struct("<HBBII")
# a single record (one WAL container / one chunk set) is far below
# this; anything larger in a length field is a corrupt header, not a
# torn tail, so the scanner can resync instead of waiting forever
MAX_PAYLOAD = 64 << 20

_CORRUPTION_HELP = ("Corrupt records detected in durable files, by "
                    "file kind and action taken")
_QUARANTINE_BYTES_HELP = ("Bytes copied to quarantine/ sidecars, by "
                          "file kind")


# -- CRC32C (Castagnoli) ----------------------------------------------------
# native implementations are optional (the container may not ship one);
# the pure-Python table fallback below is only used to VERIFY frames
# that declare crc32c — the write path prefers zlib's C-speed CRC-32
# when no native crc32c is importable, recording the choice in flags.

def _load_native_crc32c() -> Optional[Callable[[bytes, int], int]]:
    try:
        import crc32c as _c           # pypi "crc32c"
        return lambda data, crc=0: _c.crc32c(data, crc)
    except ImportError:
        pass
    try:
        import google_crc32c as _g    # pypi "google-crc32c"
        return lambda data, crc=0: _g.extend(crc, data)
    except ImportError:
        return None


_native_crc32c = _load_native_crc32c()

_CRC32C_POLY = 0x82F63B78
_crc32c_table: List[int] = []


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """Table-based pure-Python CRC32C — correctness fallback for
    verifying frames written with a native crc32c; never on the write
    path (zlib is the no-dependency fast default there)."""
    if not _crc32c_table:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
            _crc32c_table.append(c)
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _crc32c_table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    if _native_crc32c is not None:
        return _native_crc32c(data, crc) & 0xFFFFFFFF
    return _crc32c_py(data, crc)


WRITE_FLAGS = 0 if _native_crc32c is not None else FLAG_ZLIB_CRC
CRC_ALGO = "crc32c" if _native_crc32c is not None else "zlib-crc32"


def _crc_for_flags(flags: int, data: bytes) -> int:
    if flags & FLAG_ZLIB_CRC:
        return zlib.crc32(data) & 0xFFFFFFFF
    return crc32c(data)


# -- frame codec ------------------------------------------------------------

class FrameError(ValueError):
    """A frame that parsed structurally but failed verification."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def encode_frame(payload: bytes, flags: int = None) -> bytes:
    """Wrap one record's bytes in a checksummed frame."""
    if flags is None:
        flags = WRITE_FLAGS
    hdr_tail = struct.pack("<BBI", FRAME_VERSION, flags, len(payload))
    crc = _crc_for_flags(flags, hdr_tail + payload)
    return (struct.pack("<H", FRAME_MAGIC) + hdr_tail
            + struct.pack("<I", crc) + payload)


def decode_frame(buf: bytes, off: int = 0) -> Tuple[Optional[bytes], int]:
    """Decode + verify one frame at ``off``. Returns ``(payload,
    next_off)``, ``(None, off)`` when the frame is incomplete (torn /
    writer mid-append), or raises :class:`FrameError` on a bad
    version, an implausible length, or a checksum mismatch."""
    if off + FRAME_HDR.size > len(buf):
        return None, off
    magic, version, flags, plen, crc = FRAME_HDR.unpack_from(buf, off)
    if magic != FRAME_MAGIC:
        raise FrameError(f"bad frame magic 0x{magic:04x} at {off}")
    if version != FRAME_VERSION:
        raise FrameError(f"unsupported frame version {version} at {off}")
    if plen > MAX_PAYLOAD:
        raise FrameError(f"implausible frame length {plen} at {off}")
    end = off + FRAME_HDR.size + plen
    if end > len(buf):
        return None, off
    body = buf[off + 2:off + 8] + buf[off + FRAME_HDR.size:end]
    if _crc_for_flags(flags, body) != crc:
        raise FrameError(f"frame checksum mismatch at {off}")
    return buf[off + FRAME_HDR.size:end], end


# -- scanning ----------------------------------------------------------------
# legacy_probe(buf, off) -> record length when a plausible legacy
# (unframed) record starts at off; -1 when one starts but is cut off by
# the end of the buffer (torn); 0 when the bytes are not a legacy record.

LegacyProbe = Callable[[bytes, int], int]


@dataclass(frozen=True)
class ScanRecord:
    offset: int            # absolute offset (base + buffer position)
    length: int            # total bytes including any frame header
    payload_off: int       # absolute offset of the inner record bytes
    payload_len: int
    framed: bool


@dataclass(frozen=True)
class CorruptRegion:
    offset: int
    length: int
    reason: str


@dataclass
class ScanResult:
    records: List[ScanRecord] = field(default_factory=list)
    corrupt: List[CorruptRegion] = field(default_factory=list)
    consumed: int = 0            # bytes classified (resume/append point)
    tail_state: str = "clean"    # "clean" | "torn" | "corrupt"
    tail_off: int = 0            # absolute offset where the tail starts
    tail_reason: str = ""


def _frame_at(buf: bytes, off: int) -> int:
    """Length of a fully verified frame at ``off``; -1 torn; 0 not a
    valid frame (resync-candidate rejection)."""
    try:
        payload, end = decode_frame(buf, off)
    except FrameError:
        return 0
    if payload is None:
        return -1
    return end - off


def _resync(buf: bytes, start: int, probe: Optional[LegacyProbe]) -> int:
    """First offset > ``start`` where a verified frame or a plausible
    legacy record begins, or -1 when none exists in the buffer."""
    q = start + 1
    limit = len(buf) - 1
    while q < limit:
        (magic,) = struct.unpack_from("<H", buf, q)
        if magic == FRAME_MAGIC and _frame_at(buf, q) != 0:
            return q
        if probe is not None and probe(buf, q) != 0:
            return q
        q += 1
    return -1


def scan_buffer(buf: bytes, probe: Optional[LegacyProbe] = None,
                base: int = 0) -> ScanResult:
    """Classify ``buf`` (which starts at file offset ``base``) into
    records, corrupt regions, and the tail state. Mixed framed/legacy
    files are handled per record boundary via the magic sniff."""
    res = ScanResult()
    p = 0
    n = len(buf)
    while p < n:
        if p + 2 > n:
            res.tail_state = "torn"
            res.tail_off = base + p
            res.tail_reason = "trailing partial record magic"
            break
        (magic,) = struct.unpack_from("<H", buf, p)
        if magic == FRAME_MAGIC:
            try:
                payload, end = decode_frame(buf, p)
            except FrameError as e:
                payload, end, err = None, p, e.reason
            else:
                err = ""
            if err == "" and payload is None:
                res.tail_state = "torn"
                res.tail_off = base + p
                res.tail_reason = "incomplete frame (writer mid-append?)"
                break
            if err == "":
                res.records.append(ScanRecord(
                    base + p, end - p, base + p + FRAME_HDR.size,
                    len(payload), True))
                p = end
                continue
            if err.startswith("frame checksum mismatch"):
                # header parsed and the frame is complete: trust the
                # declared length for the quarantine span — the next
                # boundary is verified independently below anyway
                plen = FRAME_HDR.unpack_from(buf, p)[3]
                end = p + FRAME_HDR.size + plen
                res.corrupt.append(CorruptRegion(base + p, end - p, err))
                p = end
                continue
            reason = err
        elif probe is not None:
            plen = probe(buf, p)
            if plen > 0:
                res.records.append(ScanRecord(
                    base + p, plen, base + p, plen, False))
                p += plen
                continue
            if plen == -1:
                res.tail_state = "torn"
                res.tail_off = base + p
                res.tail_reason = ("incomplete legacy record "
                                   "(writer mid-append?)")
                break
            reason = f"unrecognized record magic 0x{magic:04x}"
        else:
            reason = f"unrecognized record magic 0x{magic:04x}"
        q = _resync(buf, p, probe)
        if q < 0:
            res.tail_state = "corrupt"
            res.tail_off = base + p
            res.tail_reason = reason + " (no resync point in file)"
            break
        res.corrupt.append(CorruptRegion(base + p, q - p, reason))
        p = q
    else:
        res.tail_off = base + n
    if res.tail_state == "clean":
        res.consumed = n
    else:
        res.consumed = res.tail_off - base
    return res


# -- quarantine sidecar ------------------------------------------------------

def quarantine_dir(path: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(path)),
                        "quarantine")


def quarantine(path: str, file_kind: str, offset: int, data: bytes,
               reason: str, action: str = "quarantined") -> str:
    """Copy a bad byte range to the ``quarantine/`` sidecar next to
    ``path``, append a MANIFEST.jsonl entry, and emit the corruption
    metric + structured event + trace event. Returns the sidecar file
    path. Never raises: containment must not take down the caller
    (a full disk while quarantining still records the event)."""
    import time as _time
    qpath = ""
    try:
        qdir = quarantine_dir(path)
        os.makedirs(qdir, exist_ok=True)
        base = os.path.basename(path)
        qpath = os.path.join(qdir, f"{base}.{offset}.bad")
        with open(qpath, "wb") as f:
            f.write(data)
        entry = {"file": os.path.abspath(path), "kind": file_kind,
                 "offset": int(offset), "length": len(data),
                 "reason": reason, "action": action,
                 "time": _time.time()}
        with open(os.path.join(qdir, "MANIFEST.jsonl"), "a") as f:
            f.write(json.dumps(entry) + "\n")
    except OSError:
        qpath = ""
    record_corruption(file_kind, path, offset, len(data), reason,
                      action=action)
    obs_metrics.GLOBAL_REGISTRY.counter(
        "filodb_storage_quarantined_bytes_total",
        _QUARANTINE_BYTES_HELP).inc(len(data), file_kind=file_kind)
    return qpath


def record_corruption(file_kind: str, path: str, offset: int,
                      length: int, reason: str,
                      action: str = "detected") -> None:
    """Metric + structured event + trace event for one detection —
    the no-sidecar variant (suspected corrupt tails, read-time CRC
    failures whose bytes a separate path quarantines)."""
    obs_metrics.GLOBAL_REGISTRY.counter(
        "filodb_storage_corruption_total", _CORRUPTION_HELP).inc(
        file_kind=file_kind, action=action)
    obs_events.emit("corruption", file_kind=file_kind,
                    file=os.path.abspath(path), offset=int(offset),
                    length=int(length), reason=reason, action=action)
    obs_trace.event("storage.corruption", file_kind=file_kind,
                    offset=int(offset), reason=reason, action=action)


# -- checkpoint envelope -----------------------------------------------------
# checkpoints are small JSON documents, not append-only logs: the
# integrity envelope carries the CRC of the canonical data encoding.

def encode_checkpoint(data: dict) -> bytes:
    canon = json.dumps(data, sort_keys=True, separators=(",", ":"))
    crc = _crc_for_flags(WRITE_FLAGS, canon.encode())
    return json.dumps({"v": 1, "algo": CRC_ALGO,
                       "crc": f"{crc:08x}", "data": data}).encode()


def decode_checkpoint(raw: bytes) -> Tuple[dict, bool]:
    """Parse + verify a checkpoint document. Returns ``(data,
    framed)`` — framed False for legacy bare-dict files (accepted
    unchanged). Raises :class:`FrameError` on damage."""
    try:
        doc = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise FrameError(f"checkpoint is not valid JSON: {e}") from e
    if not isinstance(doc, dict):
        raise FrameError("checkpoint is not a JSON object")
    if "crc" not in doc or "data" not in doc:
        return doc, False                       # legacy bare mapping
    data = doc.get("data")
    if not isinstance(data, dict):
        raise FrameError("checkpoint envelope has no data object")
    canon = json.dumps(data, sort_keys=True, separators=(",", ":"))
    flags = 0 if doc.get("algo") == "crc32c" else FLAG_ZLIB_CRC
    crc = _crc_for_flags(flags, canon.encode())
    if f"{crc:08x}" != str(doc.get("crc")):
        raise FrameError("checkpoint checksum mismatch")
    return data, True
