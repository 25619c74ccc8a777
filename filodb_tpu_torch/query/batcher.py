"""Concurrent-query micro-batching and the device-executor thread (the
counterpart of ``filodb_tpu.query.batcher``).

Requests that arrive while the device executor is busy and resolve to
the same batch key are stacked into ONE device dispatch and split back
per request: along the grid axis for the aligned tile evaluators (one
batched evaluation computes B step grids over shared tiles), along the
series axis for the packed path (one launch over the concatenated
[S_total, N] tile with per-row window vectors and per-query segment
offsets).

  * :class:`MicroBatcher` — admission. The first thread to submit a key
    leads its batch. When other query threads are inside the backend at
    the same time, the open batch is queued to the device executor and
    later arrivals join it until the executor picks it up: the
    executor's busy time is the gather window. When the executor is
    idle, a residual window (``gather_window_s``, 1 ms by default) holds
    the batch open. A lone request runs the single-query path inline.
  * :class:`DeviceExecutor` — one thread that owns device submission on
    CUDA. Every thread of the process submits its work on the same
    (default) CUDA stream, so a reader's copy to the host is ordered
    after the batch that wrote the tensor.
  * :class:`SplitResult` — a batch's stacked output. Its one
    device-to-host copy happens on the first reader's thread.

On the CPU the compute of a dispatch runs on the thread that makes it,
so leaders execute inline there (``use_executor`` resolves from the
device) and gather by yielding the interpreter lock a few times.

Telemetry, as the reference records it: a parked member's
``batcher-queue-wait`` and ``device-sync`` spans, a ``batcher-dispatch``
event per dispatch (in the submitter's trace, also on the executor
thread), and the histograms ``filodb_batcher_batch_size`` and
``filodb_batcher_queue_wait_seconds``.

Failure semantics: an exception in a batched dispatch fails every
member. Priority classes (``query/qos.py``) order the executor's queue;
a batch runs at the best class among its members at queue time.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from filodb_tpu_torch.lint.hotpath import hot_path
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.query import qos

_log = logging.getLogger(__name__)

_QWAIT_HELP = ("Wall seconds a query spent parked on the micro-batcher "
               "(executor queueing + residual gather window); 0 for "
               "inline single-query dispatches")
_OCC_HELP = "Members per micro-batch dispatch (batch occupancy)"

# defaults of MicroBatcher's gather_window_s and max_batch
GATHER_WINDOW_S = 1e-3  # residual gather window at an idle executor
MAX_BATCH = 8           # members of one batch at most


class DeviceExecutor:
    """One dedicated thread runs queued closures in ``(priority,
    arrival)`` order: FIFO within a class, a waiting interactive dispatch
    before a waiting background one. Whoever owns it calls :meth:`stop`
    before the process exits."""

    def __init__(self, name: str = "filodb-device-exec"):
        self._q: "queue.PriorityQueue[Tuple[int, int, Optional[Callable[[], None]]]]" \
            = queue.PriorityQueue()
        self._seq = itertools.count()   # FIFO tiebreak within a class
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._started = False
        self._start_lock = threading.Lock()

    def submit(self, fn: Callable[[], None],
               priority: int = qos.PRIORITY_INTERACTIVE) -> None:
        """Enqueue a closure for the executor thread (fire-and-forget:
        result delivery is the closure's business)."""
        with self._start_lock:
            if not self._started:
                self._started = True
                self._thread.start()
        self._q.put((int(priority), next(self._seq), fn))

    def idle(self) -> bool:
        """True when nothing is queued (the executor may still be
        finishing its current closure)."""
        return self._q.empty()

    @thread_root("device-executor")
    def _run(self) -> None:
        while True:
            _prio, _seq, fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:   # closures own delivery; keep serving
                _log.exception("device-executor closure failed")

    def stop(self, timeout: Optional[float] = None) -> None:
        """Drain the queue, end the thread and wait for it (``timeout``
        seconds at most)."""
        if self._started:
            # sorts behind every real priority class: queued work
            # drains before the executor exits
            self._q.put((1 << 30, next(self._seq), None))
            self._thread.join(timeout)


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class SplitResult:
    """Stacked output of one batch, split back per member.

    ``get(i)`` returns member *i*'s numpy slice; the single device-to-host
    copy for the whole batch happens under ``_lock`` on the first caller's
    thread."""

    def __init__(self, stacked, n: int,
                 split: Optional[Callable[[np.ndarray, int], np.ndarray]]
                 = None):
        # graftlint: disable=hbm-residency-budget (transient: one batch's device output, held until the first get() copies it to the host and drops it)
        self._stacked = stacked
        self._n = n
        self._split = split
        self._host: Optional[np.ndarray] = None
        self._lock = threading.Lock()

    @hot_path
    def get(self, i: int) -> np.ndarray:
        with self._lock:
            if self._host is None:
                self._host = _to_host(self._stacked)
                self._stacked = None
        if self._split is not None:
            return self._split(self._host, i)
        return self._host[i]


class BatchStats:
    """The batcher's occupancy and throughput counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.batches = 0            # dispatches run
        self.queries = 0            # member queries admitted
        self.batched_queries = 0    # members of batches with size >= 2
        self.occupancy_sum = 0      # sum of batch sizes
        self.occupancy_max = 0
        self.gather_wait_ns = 0     # total residual gather-window time
        self.by_size: Dict[int, int] = {}
        self.by_priority: Dict[int, int] = {}

    def record(self, size: int, wait_ns: int,
               priority: int = qos.PRIORITY_INTERACTIVE) -> None:
        with self._lock:
            self.batches += 1
            self.queries += size
            if size >= 2:
                self.batched_queries += size
            self.occupancy_sum += size
            self.occupancy_max = max(self.occupancy_max, size)
            self.gather_wait_ns += wait_ns
            self.by_size[size] = self.by_size.get(size, 0) + 1
            self.by_priority[priority] = \
                self.by_priority.get(priority, 0) + size
        obs_metrics.observe("filodb_batcher_batch_size", _OCC_HELP,
                            float(size), obs_metrics.OCCUPANCY_BUCKETS)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            avg = (self.occupancy_sum / self.batches) if self.batches \
                else 0.0
            return {"batches": self.batches, "queries": self.queries,
                    "batched_queries": self.batched_queries,
                    "occupancy_avg": round(avg, 4),
                    "occupancy_max": self.occupancy_max,
                    "gather_wait_ms":
                        round(self.gather_wait_ns / 1e6, 3),
                    "by_size": dict(self.by_size),
                    "by_priority": {
                        qos.PRIORITY_NAMES.get(p, str(p)): n
                        for p, n in self.by_priority.items()}}


class _Pending:
    """One open batch: members join under the batcher lock until the
    executor closes it; the result flows through one shared future.
    ``priority`` is the best (lowest) class among members."""

    __slots__ = ("members", "future", "closed", "opened_ns", "priority")

    def __init__(self, priority: int = qos.PRIORITY_INTERACTIVE) -> None:
        self.members: List[object] = []
        self.future: Future = Future()
        self.closed = False
        self.opened_ns = time.perf_counter_ns()
        self.priority = int(priority)


class MicroBatcher:
    """Gathers concurrent same-key dispatches into one device submission
    (see the module docstring).

    ``submit(key, member, run_batch)`` blocks until the member's result
    is available. ``run_batch(members) -> SplitResult`` executes the whole
    batch; with one member it routes to the single-query path.
    ``use_executor=None`` takes the executor thread on CUDA (``device``
    None means CUDA, as for the backend) and runs inline on the CPU.
    ``gather_window_s`` is the residual gather window at an idle
    executor and ``max_batch`` the most members of one batch (the
    server's ``batch-gather-window-ms`` and ``batch-max``)."""

    def __init__(self, gather_window_s: float = GATHER_WINDOW_S,
                 max_batch: int = MAX_BATCH, enabled: bool = True,
                 use_executor: Optional[bool] = None, device=None):
        self.gather_window_s = float(gather_window_s)
        self.max_batch = max(1, int(max_batch))
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._pending: Dict[object, _Pending] = {}
        self._active = 0        # query threads currently inside the backend
        if use_executor is None:
            use_executor = device is None \
                or torch.device(device).type == "cuda"
        self.use_executor = bool(use_executor)
        self.executor = DeviceExecutor()
        self.stats = BatchStats()

    # -- concurrency tracking --------------------------------------------
    def enter(self) -> None:
        """A query thread entered the backend (one per periodic_samples)."""
        with self._lock:
            self._active += 1

    def exit(self) -> None:
        with self._lock:
            self._active -= 1

    # -- admission --------------------------------------------------------
    @hot_path
    def submit(self, key: object, member: object,
               run_batch: Callable[[Sequence[object]], SplitResult]
               ) -> np.ndarray:
        """Join (or open) the batch for ``key``; returns this member's
        split of the batch result."""
        prio = qos.current_priority()
        if not self.enabled:
            res = run_batch([member])
            self.stats.record(1, 0, prio)
            obs_metrics.observe("filodb_batcher_queue_wait_seconds",
                                _QWAIT_HELP, 0.0)
            return res.get(0)
        idx = None
        with self._lock:
            p = self._pending.get(key)
            if p is not None and not p.closed \
                    and len(p.members) < self.max_batch:
                idx = len(p.members)
                p.members.append(member)
                # a higher-class join promotes the OPEN batch's class (an
                # already-queued entry keeps its position)
                if prio < p.priority:
                    p.priority = prio
            else:
                p = _Pending(priority=prio)
                p.members.append(member)
                concurrent = self._active > 1
                if concurrent:
                    self._pending[key] = p
        if idx is not None:     # follower: park outside the lock
            return self._wait(p, idx)
        if not concurrent:
            # lone request: single-query path, inline
            obs_metrics.observe("filodb_batcher_queue_wait_seconds",
                                _QWAIT_HELP, 0.0)
            return self._execute(key, p, run_batch, queued=False)
        if self.use_executor:
            # leader under concurrency: queue the OPEN batch; arrivals
            # keep joining until the executor picks it up. The trace
            # context hops threads with the closure, so the spans recorded
            # on the executor land in the submitter's trace.
            tctx = obs_trace.capture()
            self.executor.submit(
                lambda: self._execute(key, p, run_batch, queued=True,
                                      tctx=tctx),
                priority=p.priority)
            return self._wait(p, 0)
        # CPU: gather by yielding the interpreter lock a few times, then
        # execute on THIS thread. Best-effort work yields extra rounds so
        # interactive threads overtake it.
        yields = 3 if prio < qos.PRIORITY_BEST_EFFORT else 12
        for _ in range(yields):
            if len(p.members) >= self.max_batch:
                break
            time.sleep(0)
        obs_metrics.observe("filodb_batcher_queue_wait_seconds",
                            _QWAIT_HELP, 0.0)
        return self._execute(key, p, run_batch, queued=False)

    @hot_path
    def _wait(self, p: _Pending, idx: int) -> np.ndarray:
        t0 = time.perf_counter()
        with obs_trace.span("batcher-queue-wait"):
            res = p.future.result()
        obs_metrics.observe("filodb_batcher_queue_wait_seconds",
                            _QWAIT_HELP, time.perf_counter() - t0)
        with obs_trace.span("device-sync"):
            return res.get(idx)

    def _execute(self, key: object, p: _Pending, run_batch,
                 queued: bool, tctx=None) -> Optional[np.ndarray]:
        """Close and run one batch; on the executor thread when
        ``queued`` (the leader parks on the future), inline otherwise;
        ``tctx`` is the submitting thread's trace context."""
        wait_ns = 0
        if queued and self.executor.idle():
            # idle executor: hold the batch open for the residual gather
            # window so a concurrent same-key arrival can still pair
            rem_s = self.gather_window_s \
                - (time.perf_counter_ns() - p.opened_ns) / 1e9
            if rem_s > 0 and len(p.members) < self.max_batch:
                t0 = time.perf_counter_ns()
                time.sleep(rem_s)
                wait_ns = time.perf_counter_ns() - t0
        with self._lock:
            p.closed = True
            if self._pending.get(key) is p:
                del self._pending[key]
            members = list(p.members)
            active = self._active
        try:
            with obs_trace.use(tctx):
                # occupancy at dispatch: members sharing this submission
                # and query threads inside the backend when it closed
                obs_trace.event("batcher-dispatch", size=len(members),
                                active=active, priority=p.priority,
                                queued=queued)
                res = run_batch(members)
        except BaseException as e:  # noqa: BLE001 — fail all members
            self.stats.record(len(members), wait_ns, p.priority)
            p.future.set_exception(e)
            if not queued:
                raise
            return None
        self.stats.record(len(members), wait_ns, p.priority)
        p.future.set_result(res)
        if queued:
            return None
        with obs_trace.span("device-sync"):
            return res.get(0)
