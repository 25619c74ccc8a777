"""Ingest-write health: the clean ENOSPC degradation state machine.

Before this module, a full disk surfaced as an unhandled OSError in
whatever thread happened to hit it first — a gateway producer thread
dying mid-connection or an ingestion driver flipping its shard to
ERROR. The failure is environmental and RECOVERABLE (space gets
freed), so it deserves a state, not a stack trace:

  * any write-path ENOSPC/EDQUOT flips the process to **ingest
    read-only**: remote ingest answers 503 + Retry-After, the gateway
    drops (and counts) lines instead of crashing handler threads, and
    flushes retry on their normal cadence — queries keep serving
    throughout.
  * recovery is AUTOMATIC: while read-only, one probe write per
    ``probe_interval_s`` is let through; the first success clears the
    state. No operator restart required after freeing space.

The state is process-global (one disk per process in every supported
deployment) and surfaced in the health body (``ingest_read_only``),
``/metrics`` (``filodb_ingest_read_only`` gauge) and the structured
event ring."""

from __future__ import annotations

import errno
import threading
import time
from typing import Dict, Optional

from filodb_tpu_torch.obs import events as obs_events
from filodb_tpu_torch.obs import metrics as obs_metrics

_RO_HELP = ("1 while ingest is degraded to read-only (write-path "
            "ENOSPC/EDQUOT); queries keep serving")
_OUT_OF_SPACE_ERRNOS = (errno.ENOSPC, getattr(errno, "EDQUOT", errno.ENOSPC))


class IngestReadOnly(RuntimeError):
    """Ingest is degraded to read-only; the HTTP edge maps this to
    503 + Retry-After (recoverable: resubmit after space is freed)."""

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(reason)
        self.retry_after_s = retry_after_s


def is_out_of_space(exc: BaseException) -> bool:
    return (isinstance(exc, OSError)
            and exc.errno in _OUT_OF_SPACE_ERRNOS)


class IngestHealth:
    """Process-wide ingest writability state with rate-limited
    recovery probes. Writers report outcomes (``note_write_error`` /
    ``note_write_ok``); edges consult ``read_only()`` and claim probe
    slots via ``should_probe()``."""

    def __init__(self, probe_interval_s: float = 1.0):
        self.probe_interval_s = float(probe_interval_s)
        self._lock = threading.Lock()
        self._read_only = False
        self._reason = ""
        self._since = 0.0
        self._last_probe_t = 0.0

    def read_only(self) -> bool:
        with self._lock:
            return self._read_only

    def reason(self) -> str:
        with self._lock:
            return self._reason

    def note_write_error(self, exc: BaseException, where: str) -> bool:
        """Report a write-path failure. Returns True when it is the
        out-of-space family (the caller should degrade, not crash);
        other errors are the caller's to handle."""
        if not is_out_of_space(exc):
            return False
        reason = f"{where}: {exc}"
        with self._lock:
            entered = not self._read_only
            self._read_only = True
            self._reason = reason
            if entered:
                self._since = time.monotonic()
        if entered:
            obs_metrics.GLOBAL_REGISTRY.gauge(
                "filodb_ingest_read_only", _RO_HELP).set(1.0)
            obs_events.emit("ingest-read-only", state="entered",
                            where=where, reason=str(exc))
        return True

    def note_write_ok(self) -> None:
        """A write-path success clears the degradation (the probe that
        got through, or any organic write while racing recovery)."""
        with self._lock:
            left = self._read_only
            self._read_only = False
            self._reason = ""
        if left:
            obs_metrics.GLOBAL_REGISTRY.gauge(
                "filodb_ingest_read_only", _RO_HELP).set(0.0)
            obs_events.emit("ingest-read-only", state="recovered")

    def probe_due(self) -> bool:
        """Peek: would a probe be allowed now? (Non-claiming — the
        fast-path 503 check.)"""
        with self._lock:
            if not self._read_only:
                return True
            return (time.monotonic() - self._last_probe_t
                    >= self.probe_interval_s)

    def should_probe(self) -> bool:
        """Claim the probe slot: True at most once per interval while
        read-only (that caller attempts the real write)."""
        with self._lock:
            if not self._read_only:
                return True
            now = time.monotonic()
            if now - self._last_probe_t < self.probe_interval_s:
                return False
            self._last_probe_t = now
            return True

    def retry_after_s(self) -> float:
        return max(1.0, self.probe_interval_s)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"read_only": self._read_only, "reason": self._reason}

    def reject(self) -> IngestReadOnly:
        """The exception the ingest edge raises while degraded."""
        with self._lock:
            reason = self._reason or "ingest is read-only"
        return IngestReadOnly(f"ingest degraded to read-only "
                              f"({reason}); retry after space is freed",
                              retry_after_s=self.retry_after_s())

    def reset(self) -> None:
        """Test hook."""
        with self._lock:
            self._read_only = False
            self._reason = ""
            self._last_probe_t = 0.0


GLOBAL = IngestHealth()
