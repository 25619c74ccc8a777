"""The traced run's reading of the device: `torch.profiler` over the
measured window, and host intervals around the device functions whose
roofline the benchmark reports.

The profiler records, on every thread, the card's kernels, copies and
sets, the CUDA runtime calls that launched them (with the launching
thread's system id) and the CPU operations. What the host was doing in an
idle gap comes from the program's own spans; the shapes of the device
functions whose rooflines are reported come from `Probe` intervals that
the harness wraps around a few of the program's functions in traced runs
only (each roofline's file names them), each with its thread's system
id. A kernel belongs to a probe's call when its launch ran on the call's
thread inside the call's interval.
Times are epoch microseconds: the profiler's clock is tied to the host's
by an annotation whose host time is known.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR = "portbench.anchor"


_CONTEXT = threading.local()


class Probe:
    """Host intervals of calls to one program function, each with what
    `describe(args, kwargs, result, context)` says of its shapes; calls
    whose description is None (nothing launched) are not kept. `target` is
    "module:function" or "module:Class.method".

    A probe made with `context=True` keeps no calls: `describe(args,
    kwargs)`, taken as the call starts, is the context that the probes
    called inside it on its thread get (the innermost such; None outside
    any), so that an inner function whose arguments are padded can be
    described by the shapes its caller was given."""

    def __init__(self, target: str, describe: Callable,
                 context: bool = False):
        self.module, _, self.attr = target.partition(":")
        self.describe = describe
        self.context = context
        self.calls: List[dict] = []
        self._lock = threading.Lock()
        self._orig = None

    def install(self) -> None:
        """Wrap the function; a function the program no longer has is left
        alone, and its metric then reads nothing."""
        owner = importlib.import_module(self.module)
        *path, name = self.attr.split(".")
        for part in path:
            owner = getattr(owner, part, None)
            if owner is None:
                return
        orig = getattr(owner, name, None)
        if orig is None:
            return
        self._orig = (owner, name, orig)
        wrapper = self._wrap_context(orig) if self.context \
            else self._wrap_calls(orig)
        setattr(owner, name, functools.wraps(orig)(wrapper))

    def _wrap_context(self, orig):
        def wrapper(*args, **kwargs):
            ctx = self.describe(args, kwargs)
            if ctx is None:
                return orig(*args, **kwargs)
            stack = _CONTEXT.__dict__.setdefault("stack", [])
            stack.append(ctx)
            try:
                return orig(*args, **kwargs)
            finally:
                stack.pop()
        return wrapper

    def _wrap_calls(self, orig):
        def wrapper(*args, **kwargs):
            t0 = time.time_ns()
            out = orig(*args, **kwargs)
            t1 = time.time_ns()
            stack = _CONTEXT.__dict__.get("stack")
            desc = self.describe(args, kwargs, out,
                                 stack[-1] if stack else None)
            if desc is not None:
                with self._lock:
                    self.calls.append({"tid": threading.get_native_id(),
                                       "t0_us": t0 / 1e3, "t1_us": t1 / 1e3,
                                       **desc})
            return out
        return wrapper

    def uninstall(self) -> None:
        if self._orig is not None:
            owner, name, orig = self._orig
            setattr(owner, name, orig)
            self._orig = None


class DeviceTrace:
    """torch.profiler over [start(), stop()], read back as device intervals
    and launches."""

    def __init__(self, scratch_dir: str):
        self.scratch_dir = scratch_dir
        self.prof = None
        self.device: List[Tuple[float, float, str, int]] = []
        self.launch: Dict[int, Tuple[int, float]] = {}

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile
        # every thread's operations, so that the runtime calls of the
        # server's threads carry those threads' system ids
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.start()
        self.anchor_us = time.time_ns() / 1e3
        with record_function(ANCHOR):
            pass

    def stop(self) -> None:
        self.prof.stop()
        path = os.path.join(self.scratch_dir, "devtrace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        self.prof = None
        shift = None
        for e in events:
            if e.get("name") == ANCHOR and e.get("ph") == "X":
                shift = self.anchor_us - float(e["ts"])
        if shift is None:
            raise RuntimeError("the profiler's trace lacks its anchor")
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                t0 = float(e["ts"]) + shift
                self.device.append((t0, t0 + float(e.get("dur", 0.0)),
                                    e.get("name", "?"), corr))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                self.launch[corr] = (int(e.get("tid", -1)),
                                     float(e["ts"]) + shift)
        self.device.sort(key=lambda d: d[0])

    # -- readings over a window [w0, w1] in epoch microseconds -----------

    def clipped(self, w0: float, w1: float):
        for t0, t1, name, corr in self.device:
            a, b = max(t0, w0), min(t1, w1)
            if b > a:
                yield a, b, name, corr

    def union(self, w0: float, w1: float) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for a, b, _, _ in self.clipped(w0, w1):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self, w0: float, w1: float) -> float:
        return sum(b - a for a, b in self.union(w0, w1)) / 1e6

    def top_ops(self, w0: float, w1: float, n: int = 10) -> list:
        by: Dict[str, float] = {}
        for a, b, name, _ in self.clipped(w0, w1):
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def launched_in(self, calls: List[dict], w0: float, w1: float
                    ) -> List[float]:
        """Device seconds of the kernels each call launched: a kernel whose
        runtime launch ran on the call's thread inside its interval."""
        by_tid: Dict[int, List[Tuple[float, float, int]]] = {}
        for i, c in enumerate(calls):
            by_tid.setdefault(c["tid"], []).append((c["t0_us"], c["t1_us"],
                                                    i))
        for v in by_tid.values():
            v.sort()
        starts = {tid: [x[0] for x in v] for tid, v in by_tid.items()}
        out = [0.0] * len(calls)
        for a, b, _, corr in self.clipped(w0, w1):
            tid, ts = self.launch.get(corr, (None, None))
            if tid not in by_tid:
                continue
            j = bisect.bisect_right(starts[tid], ts) - 1
            if j >= 0:
                t0, t1, i = by_tid[tid][j]
                if t0 <= ts <= t1:
                    out[i] += (b - a) / 1e6
        return out

    def idle_gaps(self, w0: float, w1: float, label: Callable[[float], str],
                  n: int = 10) -> list:
        """The n longest gaps with no device activity, each named by what
        the host was doing at its middle."""
        gaps, t = [], w0
        for a, b in self.union(w0, w1):
            if a > t:
                gaps.append((a - t, t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((w1 - t, t, w1))
        gaps.sort(reverse=True)
        return [[label((a + b) / 2), d / 1e6] for d, a, b in gaps[:n]]


def span_labeler(traces: List[dict]) -> Callable[[float], str]:
    """Names an instant (epoch us) by the deepest program span open then
    in any trace, as `query-stage/span`; "no query in flight" when none."""
    spans = []
    for tr in traces:
        by_id = {s["span_id"]: s for s in tr["spans"]}
        for s in tr["spans"]:
            if s.get("dur_us", -1) < 0:
                continue
            depth, p = 0, s.get("parent_id")
            while p in by_id:
                depth, p = depth + 1, by_id[p].get("parent_id")
            spans.append((s["start_us"], s["start_us"] + s["dur_us"], depth,
                          s["name"]))

    def label(t: float) -> str:
        best: Optional[Tuple[int, str]] = None
        for a, b, depth, name in spans:
            if a <= t <= b and (best is None or depth > best[0]):
                best = (depth, name)
        return "host: " + (best[1] if best else "no query in flight")

    return label
