"""In-process wall-clock sampling profiler (the SimpleProfiler
analogue; the counterpart of ``filodb_tpu.obs.profiler``).

FiloDB ships a built-in sampling profiler that periodically walks every
thread's stack and writes top-method reports
(standalone/SimpleProfiler.java); this module closes the same gap for a
node of the port. A declared thread root wakes at a configurable hz,
walks ``sys._current_frames()``, and attributes each thread's stack to
the ``lint/threads.py`` thread-root registry — so a sample lands on
"http-handler" vs "batcher-executor" vs "ingest-driver" vs
"rules-eval" even when the OS thread name is an unhelpful stdlib
``Thread-17 (process_request_thread)``. Attribution walks frames
outermost-first and matches ``(module, function)`` against every
registered ``@thread_root`` (Python 3.10: there is no
``co_qualname``, so the registry's qualname leaf is the match key),
falling back to thread-name prefix matching for roots whose entry
frame has already returned.

Aggregation is a bounded folded-stack table (flamegraph-ready:
``root;mod.fn;mod.fn2 count`` per line) plus a per-``(root, leaf)``
self-time table. The profiler serves both through
``/debug/profile?seconds=N`` (folded text or JSON top-self-time) and
exports top-N self-time as registry gauges
(``filodb_profile_self_seconds_total{root,func}``) so selfmon makes
the profile a PromQL query.

Cost model: one tick touches every live thread's frame chain — tens of
microseconds at our thread counts — so the default 29 hz duty cycle
stays far under 1%. Everything is OFF by default and the profiler
registers no metric families until started, keeping the default
``/metrics`` byte-identical.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.lint.threads import THREAD_ROOTS, thread_root
from filodb_tpu_torch.obs import metrics as obs_metrics

# sampling clamps: below 1 hz the profile is useless, above 250 hz the
# sampler itself becomes the workload
MIN_HZ, MAX_HZ = 1.0, 250.0
# frames kept per folded stack (innermost truncated past this — deep
# recursion can't balloon the key strings)
MAX_DEPTH = 48
# /debug/profile?seconds=N window clamp (a handler thread blocks for
# the window; keep it bounded)
MAX_WINDOW_S = 30.0

UNATTRIBUTED = "(unattributed)"
OVERFLOW_KEY = "(overflow)"

_TICK_HELP = "Wall seconds per profiler sampling tick"
_TICK_BUCKETS = (0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
                 0.001, 0.0025, 0.005, 0.01, 0.025)


def _root_tables() -> Tuple[Dict[Tuple[str, str], str], List[Tuple[str, str]]]:
    """Attribution tables from the live ``@thread_root`` registry:
    ``(module, function-leaf) -> display name`` for frame matching,
    plus ``(display name, name prefix)`` pairs for the thread-name
    fallback. Rebuilt per tick — the registry only grows at import
    time, but lazily imported modules may register roots after the
    profiler starts."""
    frames: Dict[Tuple[str, str], str] = {}
    names: List[Tuple[str, str]] = []
    for qual, info in THREAD_ROOTS.items():
        leaf = qual.rsplit(".", 1)[-1]
        frames[(info["module"], leaf)] = info["name"]
        names.append((info["name"], info["name"].split("-")[0]))
    return frames, names


@guarded_by("_lock", "_folded", "_self", "_samples", "_attributed",
            "_ticks", "_dropped_stacks", "_started_monotonic")
class SamplingProfiler:
    """Bounded wall-clock sampling profiler (a declared thread root).

    ``start()`` launches the sampler daemon; ``snapshot()`` /
    ``folded_text()`` / ``report()`` read the aggregate; ``window()``
    diffs the aggregate across a wall-clock window for
    ``/debug/profile?seconds=N``; ``sample_burst()`` runs inline
    sampling for the same endpoint when the daemon is off."""

    def __init__(self, hz: float = 29.0, max_stacks: int = 4096,
                 top_n: int = 20):
        self.hz = min(MAX_HZ, max(MIN_HZ, float(hz)))
        self.period_s = 1.0 / self.hz
        self.max_stacks = max(64, int(max_stacks))
        self.top_n = max(1, int(top_n))
        self._lock = threading.Lock()
        # folded stack ("root;mod.fn;...") -> sample count
        self._folded: Dict[str, int] = {}
        # (root, leaf "mod.fn") -> sample count (self time = n/hz)
        self._self: Dict[Tuple[str, str], int] = {}
        self._samples = 0           # thread-stacks sampled
        self._attributed = 0        # ... attributed to a known root
        self._ticks = 0
        self._dropped_stacks = 0    # folded keys refused at max_stacks
        self._started_monotonic: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # metric families are created on start(), not here: a
        # constructed-but-unstarted profiler must leave /metrics
        # byte-identical (histograms always render once registered)
        self._m_self: Optional[obs_metrics.GaugeFamily] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "SamplingProfiler":
        if self.running:
            return self
        reg = obs_metrics.GLOBAL_REGISTRY
        self._m_self = reg.gauge(
            "filodb_profile_self_seconds_total",
            "Sampled wall self-time per thread root and function "
            "(top-N, cumulative since profiler start)")
        self._stop.clear()
        with self._lock:
            self._started_monotonic = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="profiler-sampler")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @thread_root("profiler-sampler")
    def _run(self) -> None:
        # drift-corrected cadence: sleep to the next tick boundary so
        # the duty cycle stays hz * tick_cost regardless of tick cost
        next_t = time.monotonic() + self.period_s
        while not self._stop.wait(max(0.0, next_t - time.monotonic())):
            next_t += self.period_s
            t0 = time.perf_counter()
            try:
                self.tick()
            except Exception:   # noqa: BLE001 — profiling must not die
                pass
            obs_metrics.observe("filodb_profiler_tick_seconds",
                                _TICK_HELP,
                                time.perf_counter() - t0,
                                _TICK_BUCKETS)
            if self._m_self is not None:
                self._export_top()

    # -- one sampling tick -------------------------------------------------
    def tick(self) -> int:
        """Sample every live thread once; returns stacks recorded.
        Public for tests and for inline burst sampling."""
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames_tab, name_tab = _root_tables()
        recorded = []
        for ident, frame in list(sys._current_frames().items()):
            if ident == me:
                continue        # never profile the profiler
            stack: List[Tuple[str, str]] = []
            f = frame
            while f is not None and len(stack) < MAX_DEPTH:
                stack.append((f.f_globals.get("__name__", "?"),
                              f.f_code.co_name))
                f = f.f_back
            if not stack:
                continue
            stack.reverse()     # outermost first (folded order)
            root = None
            top = 0
            for i, key in enumerate(stack):
                hit = frames_tab.get(key)
                if hit is not None:
                    root, top = hit, i
                    break
            if root is None:
                tname = names.get(ident, "")
                for disp, prefix in name_tab:
                    if disp in tname or (prefix and
                                         tname.startswith(prefix)):
                        root = disp
                        break
            if root is None:
                root = UNATTRIBUTED
            folded = root + ";" + ";".join(
                f"{m}.{fn}" for m, fn in stack[top:])
            leaf = "{}.{}".format(*stack[-1])
            recorded.append((folded, root, leaf))
        with self._lock:
            for folded, root, leaf in recorded:
                if folded in self._folded:
                    self._folded[folded] += 1
                elif len(self._folded) < self.max_stacks:
                    self._folded[folded] = 1
                else:
                    self._dropped_stacks += 1
                    key = root + ";" + OVERFLOW_KEY
                    self._folded[key] = self._folded.get(key, 0) + 1
                self._self[(root, leaf)] = \
                    self._self.get((root, leaf), 0) + 1
                self._samples += 1
                if root != UNATTRIBUTED:
                    self._attributed += 1
            self._ticks += 1
        return len(recorded)

    def _export_top(self) -> None:
        """Top-N self-time into the gauge family (computed under the
        lock, set outside it — GaugeFamily has its own lock and the
        canonical order keeps profiler locks leaf-only)."""
        with self._lock:
            top = sorted(self._self.items(), key=lambda kv: -kv[1])
            top = top[:self.top_n]
        m = self._m_self
        if m is None:
            return
        for (root, leaf), n in top:
            m.set(round(n * self.period_s, 6), root=root, func=leaf)

    # -- read side ---------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            dur = (time.monotonic() - self._started_monotonic) \
                if self._started_monotonic is not None else 0.0
            return {"running": self.running, "hz": self.hz,
                    "ticks": self._ticks, "samples": self._samples,
                    "attributed": self._attributed,
                    "attribution_fraction": round(
                        self._attributed / self._samples, 4)
                    if self._samples else 1.0,
                    "distinct_stacks": len(self._folded),
                    "dropped_stacks": self._dropped_stacks,
                    "duration_s": round(dur, 3)}

    def tables(self) -> Tuple[Dict[str, int], Dict[Tuple[str, str], int]]:
        with self._lock:
            return dict(self._folded), dict(self._self)

    def folded_text(self,
                    folded: Optional[Dict[str, int]] = None) -> str:
        """The flamegraph input format: one ``stack count`` line per
        distinct folded stack, sorted for determinism."""
        if folded is None:
            folded, _ = self.tables()
        return "".join(f"{k} {v}\n" for k, v in sorted(folded.items()))

    def report(self, folded: Optional[Dict[str, int]] = None,
               selfs: Optional[Dict[Tuple[str, str], int]] = None,
               window_s: Optional[float] = None) -> Dict[str, object]:
        """JSON top-self-time report over the cumulative aggregate (or
        an explicit windowed slice from :meth:`window`)."""
        if folded is None or selfs is None:
            folded, selfs = self.tables()
        samples = sum(selfs.values())
        attributed = sum(n for (root, _), n in selfs.items()
                         if root != UNATTRIBUTED)
        roots: Dict[str, int] = {}
        for (root, _), n in selfs.items():
            roots[root] = roots.get(root, 0) + n
        top = [{"root": root, "func": leaf, "samples": n,
                "self_seconds": round(n * self.period_s, 6)}
               for (root, leaf), n in
               sorted(selfs.items(), key=lambda kv: (-kv[1], kv[0]))
               [:self.top_n]]
        out = dict(self.snapshot())
        out.update({
            "samples": samples,
            "attributed": attributed,
            "attribution_fraction": round(attributed / samples, 4)
            if samples else 1.0,
            "roots": {k: roots[k] for k in sorted(roots)},
            "top_self": top,
        })
        if window_s is not None:
            out["window_s"] = round(window_s, 3)
        return out

    # -- windowed collection (/debug/profile?seconds=N) --------------------
    def window(self, seconds: float
               ) -> Tuple[Dict[str, int], Dict[Tuple[str, str], int]]:
        """Block for ``seconds`` (clamped) and return the folded/self
        deltas the running sampler accumulated in that window."""
        seconds = min(MAX_WINDOW_S, max(0.0, float(seconds)))
        f0, s0 = self.tables()
        if seconds > 0.0:
            time.sleep(seconds)
        f1, s1 = self.tables()
        folded = {k: v - f0.get(k, 0) for k, v in f1.items()
                  if v - f0.get(k, 0) > 0}
        selfs = {k: v - s0.get(k, 0) for k, v in s1.items()
                 if v - s0.get(k, 0) > 0}
        return folded, selfs

    def sample_burst(self, seconds: float
                     ) -> Tuple[Dict[str, int], Dict[Tuple[str, str], int]]:
        """Inline sampling loop for when the daemon is off: the calling
        (handler) thread IS the sampler for the window, then the burst
        is removed from the cumulative aggregate so an off profiler
        stays empty between requests."""
        seconds = min(MAX_WINDOW_S, max(0.0, float(seconds)))
        f0, s0 = self.tables()
        deadline = time.monotonic() + seconds
        self.tick()
        while time.monotonic() < deadline:
            time.sleep(self.period_s)
            self.tick()
        f1, s1 = self.tables()
        folded = {k: v - f0.get(k, 0) for k, v in f1.items()
                  if v - f0.get(k, 0) > 0}
        selfs = {k: v - s0.get(k, 0) for k, v in s1.items()
                 if v - s0.get(k, 0) > 0}
        with self._lock:
            self._folded, self._self = f0, s0
            self._samples = sum(s0.values())
            self._attributed = sum(n for (r, _), n in s0.items()
                                   if r != UNATTRIBUTED)
        return folded, selfs
