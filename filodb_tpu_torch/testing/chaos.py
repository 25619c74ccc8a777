"""Chaos-injection harness: drop / delay / error RPCs at named fault
points inside the cluster plane.

The production code calls ``chaos.fire("point", key=value, ...)`` at its
fault points; with no injector installed this is a single attribute read
and return (safe to leave in hot-ish control paths). Tests install an
injector EXPLICITLY — there is deliberately no env-var switch, so a
production deployment can never trip faults by inherited environment
(the reference gets the same effect from Akka's TestKit-only failure
injectors living in src/test).

Fault points wired in this build:

  * ``grpc.call``     — grpcsvc/client.py before every stub dial
                        (ctx: node, addr, method)
  * ``http.peer``     — parallel/cluster.py before every peer HTTP fetch
                        (ctx: node, url)
  * ``ingest.batch``  — ingest/driver.py before a stream batch is
                        applied (ctx: shard, offset)
  * ``ingest.flush``  — ingest/driver.py before a group flush
                        (ctx: shard, group)
  * ``handoff.adopt`` — parallel/membership.py before the adopt
                        request of a planned handoff (ctx: shard, node)
  * ``handoff.await`` — parallel/membership.py on each poll while the
                        draining node waits for the successor to
                        advertise ACTIVE (ctx: shard)
  * ``handoff.transfer`` — parallel/membership.py before each peer
                        ownership-transfer push (ctx: shard, node)
  * ``qos.admit``     — http/server.py before the query-gate admission
                        decision on every query endpoint hit
                        (ctx: tenant, endpoint)
  * ``qos.shed``      — http/server.py when an over-budget tenant
                        enters the brownout degrade ladder, before any
                        rung runs (ctx: tenant, query)

Disk-fault points (the file-I/O fault layer): durable-tier writers
route record bytes through :func:`write` and readers filter loaded
bytes through :func:`filter_read`, so tests can fire ENOSPC/EIO
(``fail`` with an errno-carrying OSError — see :func:`enospc` /
:func:`eio`), short/torn writes (``torn_write``: a prefix lands on
disk, then the write errors), and read-side bit flips (``bit_flip``)
at named points:

  * ``wal.append``    — ingest/stream.py, each framed record write
                        (ctx: path, nbytes)
  * ``wal.fsync``     — ingest/stream.py group-commit fsync
                        (ctx: path)
  * ``wal.read``      — ingest/stream.py, every byte range a reader
                        loads (ctx: path, offset)
  * ``chunklog.write`` / ``chunklog.read``
                      — store/columnstore.py chunk-log records
                        (ctx: dataset, shard[, offset])
  * ``partkeys.write`` / ``partkeys.read``
                      — store/columnstore.py partkey-log records
                        (ctx: dataset, shard)
  * ``checkpoint.write`` / ``checkpoint.read``
                      — store/columnstore.py checkpoint documents
                        (ctx: dataset, shard)

``bit_flip`` also applies on write points — that is how tests write
genuinely corrupt files through the real writers.

Usage:

    inj = ChaosInjector()
    inj.fail("grpc.call", times=2, match=lambda c: c["node"] == "node1")
    inj.delay("http.peer", 0.5)
    inj.fail("wal.append", exc=chaos.enospc, times=3)
    inj.bit_flip("wal.read", times=1)
    with inj:                      # or chaos.install(inj) / uninstall()
        ... run the scenario ...
    assert inj.fired("grpc.call") == 2
"""

from __future__ import annotations

import errno as _errno
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class ChaosError(ConnectionError):
    """Default injected fault. Subclasses ConnectionError (an OSError)
    so the HTTP peer path maps it to TransportError exactly like a real
    refused/reset connection."""


def enospc() -> OSError:
    """A faithful out-of-space error (errno set, like the kernel's)."""
    return OSError(_errno.ENOSPC, "chaos: no space left on device")


def eio() -> OSError:
    """A faithful I/O error (the failing-disk shape)."""
    return OSError(_errno.EIO, "chaos: input/output error")


@dataclass
class _Rule:
    kind: str          # "error" | "delay" | "drop" | "torn" | "bitflip"
    match: Optional[Callable[[Dict], bool]] = None
    times: Optional[int] = None            # None = every matching fire
    exc: Optional[Callable[[], BaseException]] = None
    delay_s: float = 0.0
    keep: float = 0.5         # torn: fraction (<1.0) or bytes to keep
    flip_offset: Optional[int] = None      # bitflip: None = middle byte
    flip_mask: int = 0x01
    hits: int = 0
    field_lock: threading.Lock = field(default_factory=threading.Lock)

    def applies(self, ctx: Dict) -> bool:
        if self.match is not None and not self.match(ctx):
            return False
        with self.field_lock:
            if self.times is not None and self.hits >= self.times:
                return False
            self.hits += 1
            return True


class ChaosInjector:
    """Holds fault rules per point and a log of every fire."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: Dict[str, List[_Rule]] = {}
        self._fired: Dict[str, int] = {}
        self.log: List[Dict] = []

    # -- rule builders -----------------------------------------------------
    def fail(self, point: str,
             exc: Optional[Callable[[], BaseException]] = None,
             times: Optional[int] = None,
             match: Optional[Callable[[Dict], bool]] = None
             ) -> "ChaosInjector":
        """Raise at ``point`` (default: ChaosError, a ConnectionError)."""
        self._add(point, _Rule("error", match, times,
                               exc or (lambda: ChaosError(
                                   f"chaos: injected fault at {point}"))))
        return self

    def drop(self, point: str, times: Optional[int] = None,
             match: Optional[Callable[[Dict], bool]] = None
             ) -> "ChaosInjector":
        """Black-hole the call: a long stall then transport error — the
        'packets dropped, TCP timeout' shape (distinct from fail()'s
        instant connection-refused)."""
        self._add(point, _Rule("drop", match, times))
        return self

    def delay(self, point: str, delay_s: float,
              times: Optional[int] = None,
              match: Optional[Callable[[Dict], bool]] = None
              ) -> "ChaosInjector":
        self._add(point, _Rule("delay", match, times, delay_s=delay_s))
        return self

    def torn_write(self, point: str, keep: float = 0.5,
                   times: Optional[int] = 1,
                   match: Optional[Callable[[Dict], bool]] = None
                   ) -> "ChaosInjector":
        """Short/torn write at a disk point: a prefix of the buffer
        (``keep`` < 1.0 = fraction, >= 1 = bytes) reaches the file,
        then the write raises EIO — the crash-mid-write shape that
        leaves a torn record on disk."""
        self._add(point, _Rule("torn", match, times, keep=keep))
        return self

    def bit_flip(self, point: str, offset: Optional[int] = None,
                 mask: int = 0x01, times: Optional[int] = 1,
                 match: Optional[Callable[[Dict], bool]] = None
                 ) -> "ChaosInjector":
        """Flip bits in the buffer passing a disk point (read side:
        bit rot / a bad sector read; write side: corrupt bytes landing
        on disk). ``offset`` indexes the buffer (negative = from the
        end, None = middle byte); ``mask`` is XORed into that byte."""
        self._add(point, _Rule("bitflip", match, times,
                               flip_offset=offset, flip_mask=mask))
        return self

    def _add(self, point: str, rule: _Rule) -> None:
        with self._lock:
            self._rules.setdefault(point, []).append(rule)

    # -- introspection -----------------------------------------------------
    def fired(self, point: str) -> int:
        """How many times ``point`` was REACHED (whether or not a rule
        triggered) — lets tests assert 'no further dials' after a
        breaker opens."""
        with self._lock:
            return self._fired.get(point, 0)

    # -- disk-point data hooks ---------------------------------------------
    def on_write(self, point: str, data: bytes, ctx: Dict
                 ) -> Tuple[bytes, Optional[BaseException]]:
        """Transform an outbound buffer at a disk write point. Returns
        ``(bytes_to_write, exc_to_raise_after)``: torn writes land a
        prefix THEN error (the crash-mid-write shape), errors land
        nothing, bit flips land corrupt bytes and succeed."""
        with self._lock:
            self._fired[point] = self._fired.get(point, 0) + 1
            self.log.append({"point": point, "nbytes": len(data), **ctx})
            rules = list(self._rules.get(point, ()))
        exc: Optional[BaseException] = None
        for rule in rules:
            if not rule.applies(ctx):
                continue
            if rule.kind == "delay":
                time.sleep(rule.delay_s)
            elif rule.kind == "error":
                return b"", rule.exc()
            elif rule.kind == "torn":
                keep = (int(len(data) * rule.keep) if rule.keep < 1.0
                        else int(rule.keep))
                keep = max(0, min(len(data), keep))
                return data[:keep], eio()
            elif rule.kind == "bitflip":
                data = _flip(data, rule)
            elif rule.kind == "drop":
                time.sleep(rule.delay_s or 2.0)
                return b"", eio()
        return data, exc

    def on_read(self, point: str, data: bytes, ctx: Dict) -> bytes:
        """Transform an inbound buffer at a disk read point (errors
        raise, bit flips corrupt what the reader sees)."""
        with self._lock:
            self._fired[point] = self._fired.get(point, 0) + 1
            self.log.append({"point": point, "nbytes": len(data), **ctx})
            rules = list(self._rules.get(point, ()))
        for rule in rules:
            if not rule.applies(ctx):
                continue
            if rule.kind == "delay":
                time.sleep(rule.delay_s)
            elif rule.kind == "error":
                raise rule.exc()
            elif rule.kind == "bitflip":
                data = _flip(data, rule)
        return data

    # -- the hot hook ------------------------------------------------------
    def on_fire(self, point: str, ctx: Dict) -> None:
        with self._lock:
            self._fired[point] = self._fired.get(point, 0) + 1
            self.log.append({"point": point, **ctx})
            rules = list(self._rules.get(point, ()))
        for rule in rules:
            if not rule.applies(ctx):
                continue
            if rule.kind == "delay":
                time.sleep(rule.delay_s)
            elif rule.kind == "drop":
                # bounded stall standing in for a TCP timeout: long
                # enough that an un-deadlined caller visibly hangs,
                # short enough for test suites
                time.sleep(rule.delay_s or 2.0)
                raise ChaosError(f"chaos: dropped call at {point}")
            else:
                raise rule.exc()

    def __enter__(self) -> "ChaosInjector":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall()


_installed: Optional[ChaosInjector] = None


def install(injector: ChaosInjector) -> ChaosInjector:
    global _installed
    _installed = injector
    return injector


def uninstall() -> None:
    global _installed
    _installed = None


def installed() -> Optional[ChaosInjector]:
    return _installed


def _flip(data: bytes, rule: _Rule) -> bytes:
    if not data:
        return data
    off = rule.flip_offset if rule.flip_offset is not None else len(data) // 2
    if off < 0:
        off += len(data)
    if not 0 <= off < len(data):
        return data
    buf = bytearray(data)
    buf[off] ^= (rule.flip_mask & 0xFF) or 0x01
    return bytes(buf)


def fire(point: str, **ctx) -> None:
    """Production-side hook: no-op unless an injector is installed."""
    inj = _installed
    if inj is not None:
        inj.on_fire(point, ctx)


def write(point: str, fobj, data: bytes, **ctx) -> int:
    """Disk-point write hook: route record bytes to ``fobj.write``
    through the installed injector (no injector: a plain write). Torn
    rules land a prefix then raise; error rules raise before any byte
    lands; bitflip rules land corrupt bytes — through the real
    writer's own code path."""
    inj = _installed
    if inj is None:
        return fobj.write(data)
    out, exc = inj.on_write(point, data, ctx)
    n = fobj.write(out) if out else 0
    if exc is not None:
        raise exc
    return n


def filter_read(point: str, data: bytes, **ctx) -> bytes:
    """Disk-point read hook: pass loaded bytes through the installed
    injector (no injector: identity)."""
    inj = _installed
    if inj is None:
        return data
    return inj.on_read(point, data, ctx)
