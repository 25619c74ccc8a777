"""Device dispatch profiling: executable-level telemetry for every device
dispatch site (the counterpart of ``filodb_tpu.obs.devprof``).

The registry keys each dispatch by its site (``tilestore``,
``tilestore-batch``, ``packed``) and its dispatch key, the same tuples the
reference's dispatch tables use (``("slide", func, nsteps, st)``,
``("pallas", func, s_bucket, N, nsteps)``, ...), and serves three
surfaces:

  * **/metrics families**, through a collector of the global registry
    (so also self-ingested under ``--self-monitor``)::

      filodb_executable_builds_total{site,bucket}      first sights
      filodb_executable_recompiles_total{site,bucket}  new shape
                                                       signatures under
                                                       a known key
      filodb_executable_flops{site,executable}         analytic cost
      filodb_executable_bytes_accessed{site,executable}
      filodb_executables                               live entries

  * **``&explain=analyze``**: which executables a query's dispatches ran
    (identity and disposition, from the ``executable`` trace events the
    dispatch sites emit), each with its cost.

  * the per-dispatch accounting itself (:func:`note_dispatch`).

What differs from the reference, and why:

  * *No compiled program.* Eager PyTorch compiles nothing ahead of time,
    and a hand-written kernel is built once per process, not per shape.
    So there is no ``ProfiledExecutable`` and no ``build_profiled``:
    every site registers the way the reference's lazy sites do. A key's
    first sight in the process is its ``build`` (with 0 build seconds),
    a repeat with a known shape signature is a hit, and a new shape
    signature under a known key is a recompile.
  * *The cost is analytic.* ``cost_from_compiled`` has no counterpart. A
    site's lazy probe computes FLOPs and bytes accessed from the shapes
    and dtypes of the call (:func:`sig_cost`, or the kernel's own count in
    ``query/kernels.py`` for the two CUDA kernels: the counts the chip
    smoke run's bounds use). The probe holds shapes only, never a tensor,
    and runs when the first ``&explain=analyze`` touches the executable,
    as the reference's lazy probe does. As in the reference, an entry's
    cost is that of the key's FIRST shape signature: a tile evaluator's
    key (``("slide", func, nsteps, st)``) does not name the series count,
    so a later selection of another width reports the first one's cost.
    The two kernels' keys name every dimension their work depends on, so
    their costs are each launch's own.

The dispositions keep the reference's words. In the port they mean:

  * ``build``: the key's first dispatch in this process;
  * ``jit``: a dispatch of a known key with a known shape signature;
  * ``jit-retrace``: a dispatch of a known key with a new shape
    signature (counted as a recompile);
  * ``aot`` (the reference's dispatch through its AOT-compiled program)
    is never emitted by the port.

Per-dispatch accounting is one small critical section, and the
``executable`` trace event is a no-op when the query is untraced.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.obs import trace as obs_trace

# trace event name the dispatch sites emit per dispatch; the analyze
# payload collects these to attribute executables to a query
EXEC_EVENT = "executable"

# cache inventory (graftlint): the profiler's entry table keys purely on
# (site, dispatch key), a pure function of the dispatch's identity
__cache_registry__ = {
    "devprof-executable-profiles": {"keyed": ("site", "executable-key")},
}

_KEY_MAX = 96


def key_str(key: Tuple) -> str:
    """Compact, bounded label form of a dispatch key."""
    s = "/".join(str(x) for x in key)
    return s if len(s) <= _KEY_MAX else s[:_KEY_MAX - 1] + "~"


def shape_bucket(key: Tuple) -> str:
    """The shape-bucket label for recompile counters: the key minus its
    leading family/func atoms collapses to the numeric bucket tuple."""
    nums = [str(x) for x in key if isinstance(x, (int, float))]
    return "x".join(nums) if nums else key_str(key)


def arg_sig(args) -> Tuple:
    """Recursive (shape, dtype) signature of a call's dynamic args: the
    identity under which one dispatch shape repeats."""
    out = []
    for a in args:
        if isinstance(a, (tuple, list)):
            out.append(arg_sig(a))
        else:
            shape = getattr(a, "shape", None)
            dtype = getattr(a, "dtype", None)
            if shape is not None:
                out.append((tuple(shape), str(dtype)))
            else:
                out.append(type(a).__name__)
    return tuple(out)


def _sig_bytes(sig) -> Tuple[int, int]:
    """(bytes, elements) of every tensor in an ``arg_sig``."""
    nbytes = elems = 0
    for a in sig:
        if isinstance(a, tuple) and len(a) == 2 and isinstance(a[1], str):
            shape, dtype = a
            n = 1
            for d in shape:
                n *= int(d)
            dt = getattr(torch, dtype.rsplit(".", 1)[-1], None)
            size = dt.itemsize if isinstance(dt, torch.dtype) else 8
            nbytes += n * size
            elems += n
        elif isinstance(a, tuple):
            b, e = _sig_bytes(a)
            nbytes += b
            elems += e
    return nbytes, elems


def sig_cost(in_sig: Tuple, out_sig: Tuple) -> Dict[str, float]:
    """Analytic cost of a dispatch of torch ops from its shapes and
    dtypes: every input tensor it is handed read once and every output
    written once (``bytes_accessed``), and one operation per output
    element (``flops``, a floor)."""
    in_b, _ = _sig_bytes(in_sig)
    out_b, out_e = _sig_bytes(out_sig)
    return {"flops": float(out_e), "bytes_accessed": float(in_b + out_b)}


class _Entry:
    """One dispatch key's running profile (mutation under the
    profiler's lock)."""

    __slots__ = ("site", "key", "key_s", "bucket", "builds", "hits",
                 "recompiles", "build_s_total", "last_build_s", "cost",
                 "sigs", "lazy_probe", "created_s")

    def __init__(self, site: str, key: Tuple):
        self.site = site
        self.key = key
        self.key_s = key_str(key)
        self.bucket = shape_bucket(key)
        self.builds = 0
        self.hits = 0
        self.recompiles = 0
        self.build_s_total = 0.0
        self.last_build_s = 0.0
        self.cost: Optional[Dict[str, float]] = None
        self.sigs: set = set()
        # () -> cost dict; set by the site at the key's first sight
        self.lazy_probe: Optional[Callable] = None
        self.created_s = time.monotonic()

    def to_json(self) -> Dict[str, object]:
        d = {"site": self.site, "executable": self.key_s,
             "bucket": self.bucket, "builds": self.builds,
             "hits": self.hits, "recompiles": self.recompiles,
             "build_s_total": round(self.build_s_total, 6),
             "last_build_s": round(self.last_build_s, 6)}
        if self.cost is not None:
            d.update(self.cost)
        return d


@guarded_by("_lock", "_entries")
class DeviceProfiler:
    """Process-global registry of dispatch profiles (one per dispatch key
    across the tile evaluators, the packed path and the two kernels)."""

    # safety valve: label cardinality on the cost gauges is bounded by the
    # pow2 shape bucketing, but a pathological workload could still churn
    # keys; past the cap the oldest entries leave the PROFILE only
    MAX_ENTRIES = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, Tuple], _Entry] = {}

    def _entry_locked(self, site: str, key: Tuple) -> _Entry:
        e = self._entries.get((site, key))
        if e is None:
            if len(self._entries) >= self.MAX_ENTRIES:
                oldest = min(self._entries,
                             key=lambda k: self._entries[k].created_s)
                del self._entries[oldest]
            e = _Entry(site, key)
            self._entries[(site, key)] = e
        return e

    def note_build(self, site: str, key: Tuple, seconds: float,
                   cost: Optional[Dict[str, float]] = None,
                   sig: Optional[Tuple] = None,
                   lazy_probe: Optional[Callable] = None) -> bool:
        """Record one build event; returns True when this was a RECOMPILE
        (the entry already had a build)."""
        with self._lock:
            e = self._entry_locked(site, key)
            recompile = e.builds > 0
            e.builds += 1
            e.build_s_total += float(seconds)
            e.last_build_s = float(seconds)
            if cost is not None:
                e.cost = cost
            if sig is not None:
                e.sigs.add(sig)
            if lazy_probe is not None and e.lazy_probe is None \
                    and e.cost is None:
                e.lazy_probe = lazy_probe
            if recompile:
                e.recompiles += 1
        return recompile

    def note_call(self, site: str, key: Tuple,
                  sig: Optional[Tuple] = None) -> bool:
        """Record one dispatch of a known key; returns True when ``sig``
        is NEW for the entry (counted as a recompile)."""
        with self._lock:
            e = self._entry_locked(site, key)
            e.hits += 1
            if sig is not None and sig not in e.sigs:
                e.sigs.add(sig)
                e.recompiles += 1
                return True
        return False

    def set_cost(self, site: str, key: Tuple,
                 cost: Optional[Dict[str, float]]) -> None:
        if cost is None:
            return
        with self._lock:
            self._entry_locked(site, key).cost = cost

    def ensure_cost(self, site: str, key: Tuple
                    ) -> Optional[Dict[str, float]]:
        """Cost numbers of one executable, computed by the entry's lazy
        probe on first demand (an ``&explain=analyze`` request pays the
        probe once per executable; steady serving never does)."""
        with self._lock:
            e = self._entries.get((site, key))
            if e is None:
                return None
            if e.cost is not None or e.lazy_probe is None:
                return e.cost
            probe = e.lazy_probe
        # the probe runs OUTSIDE the lock
        try:
            cost = probe()
        except Exception:   # noqa: BLE001 — a probe must never fail a query
            cost = None
        with self._lock:
            e = self._entries.get((site, key))
            if e is not None:
                e.lazy_probe = None     # one attempt; don't re-pay failures
                if cost is not None and e.cost is None:
                    e.cost = cost
            return cost

    def lookup(self, site: str, key_s: str) -> Optional[Dict]:
        """Entry JSON by (site, rendered key): the analyze path's view
        (trace events carry the rendered key, not the tuple)."""
        with self._lock:
            for (s, _k), e in self._entries.items():
                if s == site and e.key_s == key_s:
                    ensure = (e.site, e.key)
                    break
            else:
                return None
        self.ensure_cost(*ensure)
        with self._lock:
            for (s, _k), e in self._entries.items():
                if s == site and e.key_s == key_s:
                    return e.to_json()
        return None

    def snapshot(self) -> List[Dict[str, object]]:
        with self._lock:
            entries = list(self._entries.values())
        return [e.to_json() for e in sorted(
            entries, key=lambda e: (e.site, e.key_s))]

    def reset(self) -> None:
        """Test hook."""
        with self._lock:
            self._entries.clear()

    # -- /metrics collector ------------------------------------------------
    def collect(self, builder) -> None:
        """Registry collector: executable-level families into the
        exposition (and so into the self-monitoring ingest)."""
        snap = self.snapshot()
        builder.sample("filodb_executables", {}, len(snap),
                       help="Cached device executables with a profile "
                            "entry")
        builds: Dict[Tuple[str, str], int] = {}
        recompiles: Dict[Tuple[str, str], int] = {}
        for e in snap:
            k = (e["site"], e["bucket"])
            builds[k] = builds.get(k, 0) + int(e["builds"])
            recompiles[k] = recompiles.get(k, 0) + int(e["recompiles"])
        for (site, bucket), n in sorted(builds.items()):
            builder.sample("filodb_executable_builds_total",
                           {"site": site, "bucket": bucket}, n,
                           mtype="counter",
                           help="Executable build events (first sight "
                                "of a dispatch key) by site and shape "
                                "bucket")
        for (site, bucket), n in sorted(recompiles.items()):
            if n:
                builder.sample("filodb_executable_recompiles_total",
                               {"site": site, "bucket": bucket}, n,
                               mtype="counter",
                               help="New shape signatures past an "
                                    "executable's first build (shape "
                                    "churn)")
        for e in snap:
            if "flops" not in e and "bytes_accessed" not in e:
                continue
            lbl = {"site": e["site"], "executable": e["executable"]}
            if "flops" in e:
                builder.sample("filodb_executable_flops", lbl,
                               e["flops"],
                               help="Analytic FLOPs of one dispatch of "
                                    "the executable, from its shapes")
            if "bytes_accessed" in e:
                builder.sample("filodb_executable_bytes_accessed", lbl,
                               e["bytes_accessed"],
                               help="Analytic bytes accessed by one "
                                    "dispatch of the executable, from its "
                                    "shapes")


GLOBAL_PROFILER = DeviceProfiler()


def _register_collector() -> None:
    from filodb_tpu_torch.obs import metrics as obs_metrics
    obs_metrics.GLOBAL_REGISTRY.register_collector(GLOBAL_PROFILER.collect)


_register_collector()


def note_dispatch(site: str, key: Tuple, first_seen: bool,
                  probe: Optional[Callable] = None,
                  sig: Optional[Tuple] = None) -> None:
    """Per-dispatch accounting of one site: first sight is the build
    event (``probe``, when given, is the ``() -> cost`` lazy probe), later
    dispatches count as hits, and a new shape signature ``sig`` under a
    known key as a recompile. Emits the identity trace event either
    way."""
    if first_seen:
        GLOBAL_PROFILER.note_build(site, key, 0.0, sig=sig, lazy_probe=probe)
        disposition = "build"
    else:
        retraced = GLOBAL_PROFILER.note_call(site, key, sig)
        disposition = "jit-retrace" if retraced else "jit"
    obs_trace.event(EXEC_EVENT, site=site, key=key_str(key),
                    disposition=disposition)


# ---------------------------------------------------------------------------
# &explain=analyze payload
# ---------------------------------------------------------------------------

def analyze_payload(spans: List[Dict], stages: Dict,
                    batcher_stats: Optional[Dict] = None,
                    qos_info: Optional[Dict] = None,
                    residency: Optional[Dict] = None) -> Dict:
    """The ``&explain=analyze`` envelope: per-stage timings (the spans
    ``&explain=trace`` records), the executables this query's dispatches
    ran (identity, disposition, cost computed on demand), batcher
    occupancy at dispatch, cache dispositions, and the shed/degrade
    decision."""
    execs: Dict[Tuple[str, str], Dict] = {}
    dispatches: List[Dict] = []
    for sp in spans:
        tags = sp.get("tags") or {}
        name = sp.get("name")
        if name == EXEC_EVENT:
            k = (str(tags.get("site", "")), str(tags.get("key", "")))
            e = execs.setdefault(k, {"site": k[0], "executable": k[1],
                                     "dispatches": 0,
                                     "dispositions": []})
            e["dispatches"] += 1
            disp = str(tags.get("disposition", ""))
            if disp and disp not in e["dispositions"]:
                e["dispositions"].append(disp)
        elif name in ("device-dispatch", "device-eval",
                      "batcher-dispatch", "device-sync",
                      "batcher-queue-wait"):
            d = {"span": name, "dur_us": sp.get("dur_us")}
            d.update(tags)
            dispatches.append(d)
    for (site, key_s), e in execs.items():
        entry = GLOBAL_PROFILER.lookup(site, key_s)
        if entry is not None:
            for f in ("builds", "recompiles", "build_s_total",
                      "last_build_s", "flops", "bytes_accessed",
                      "bucket"):
                if f in entry:
                    e[f] = entry[f]
    out: Dict[str, object] = {
        "stages": dict(stages),
        "device": {
            "executables": sorted(execs.values(),
                                  key=lambda e: (e["site"],
                                                 e["executable"])),
            "dispatches": dispatches,
        },
    }
    if batcher_stats is not None:
        out["batcher"] = batcher_stats
    if qos_info is not None:
        out["qos"] = qos_info
    if residency:
        out["residency"] = {
            family: {"shards": dict(shards),
                     "total_bytes": sum(shards.values())}
            for family, shards in residency.items()
        }
    return out
