"""Host/process-level collector for the global metrics registry.

The reference gets process metrics for free from the JVM's Kamon
system-metrics module; a CPython process has to read /proc itself.
Registered as a registry collector (``register_process_collector``), so
every exposition build — the /metrics scrape AND the self-monitoring
registry walk — carries host-level series from day one:

  filodb_process_resident_memory_bytes   RSS from /proc/self/statm
  filodb_process_virtual_memory_bytes    VSZ from /proc/self/statm
  filodb_process_open_fds                open descriptors (/proc/self/fd)
  filodb_process_threads                 live interpreter threads
  filodb_process_gc_collections_total    per-generation GC collections
  filodb_process_uptime_seconds          seconds since process start
  filodb_build_info                      constant 1 with version labels

Everything degrades gracefully off Linux (missing /proc reads emit
nothing rather than failing the scrape)."""

from __future__ import annotations

import gc
import os
import sys
import threading
import time

# process start approximated at first import of the obs layer — the
# server imports it during startup, so the error is milliseconds
_START_MONOTONIC = time.monotonic()

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

# bumped per release line; surfaced as filodb_build_info{version=...}
BUILD_VERSION = "0.11.0"


def _statm():
    try:
        with open("/proc/self/statm") as f:
            parts = f.read().split()
        return int(parts[0]) * _PAGE, int(parts[1]) * _PAGE  # vsz, rss
    except (OSError, ValueError, IndexError):
        return None, None


def _open_fds():
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def collect_process(builder) -> None:
    """The collector body: sample current process state into an
    ExpositionBuilder (called per exposition build)."""
    vsz, rss = _statm()
    if rss is not None:
        builder.sample("filodb_process_resident_memory_bytes", {}, rss,
                       help="Resident set size in bytes "
                            "(/proc/self/statm)")
    if vsz is not None:
        builder.sample("filodb_process_virtual_memory_bytes", {}, vsz,
                       help="Virtual memory size in bytes "
                            "(/proc/self/statm)")
    fds = _open_fds()
    if fds is not None:
        builder.sample("filodb_process_open_fds", {}, fds,
                       help="Open file descriptors (/proc/self/fd)")
    builder.sample("filodb_process_threads", {},
                   threading.active_count(),
                   help="Live Python threads in this process")
    for gen, st in enumerate(gc.get_stats()):
        builder.sample("filodb_process_gc_collections_total",
                       {"generation": str(gen)},
                       int(st.get("collections", 0)), mtype="counter",
                       help="Garbage-collector collections per "
                            "generation")
    builder.sample("filodb_process_uptime_seconds", {},
                   round(time.monotonic() - _START_MONOTONIC, 3),
                   help="Seconds since the obs layer was imported "
                        "(process startup)")
    builder.sample(
        "filodb_build_info",
        {"version": BUILD_VERSION,
         "python": "%d.%d.%d" % sys.version_info[:3]},
        1,
        help="Constant 1; build/runtime identity rides the labels")


def register_process_collector(registry=None) -> None:
    """Idempotently attach the process collector to ``registry``
    (default: the global registry)."""
    from filodb_tpu_torch.obs import metrics as obs_metrics
    reg = registry if registry is not None else obs_metrics.GLOBAL_REGISTRY
    reg.register_collector(collect_process)
