"""Process-sharded serving supervisor of the port: N query-worker
processes, one public port (the counterpart of
``filodb_tpu.standalone.supervisor``).

One Python interpreter owns parse, plan and encode for every connection
of a server (the interpreter lock). This is the FiloDB
coordinator/standalone split done process-native: the supervisor starts
N OS processes, each a full standalone node of the port
(``python -m filodb_tpu_torch.standalone.server``) owning
``shards_for_ordinal(i, N)`` (the ordinal-ownership model of
``parallel/cluster.py``), with PRIVATE plan / results caches and device
tiles, its own micro-batcher and device executor, and its own
``ThreadingHTTPServer`` loop. Every worker opens its own CUDA context on
the card its config's ``device`` names (the config passes through
verbatim); the supervisor itself touches no device.

The pieces:

* **Accept edge** — every worker binds the public port with
  SO_REUSEPORT (the kernel balances connections across worker
  processes); where the platform lacks SO_REUSEPORT the supervisor
  binds ONCE and passes the listening fd to each worker
  (``accept-fd`` + ``pass_fds``), and all workers accept on the shared
  socket. Each worker additionally serves a private port — the peer /
  control plane, where sibling leaf-dispatch, health polling, and the
  supervisor's own probes land deterministically.

* **Control plane** — a loopback JSON-lines bus
  (``standalone/bus.py``). Topology transitions, schema
  invalidations, and watermark/backfill gossip fan out to every
  sibling at sub-millisecond latency, keeping per-process caches
  coherent with membership; the failure-detector health gossip remains
  the backstop. The supervisor broadcasts worker lifecycle hints
  (``worker-exit`` on waitpid — ground truth, no probe needed).

* **Supervision** — the monitor thread reaps crashed workers
  (kill -9 included) and respawns them with the identical config:
  same ordinal, same ports, so sibling routing rides its retry budget
  through the restart window instead of rewiring. Hung workers
  (alive but failing private-port health checks) are killed and
  respawned the same way.

* **Aggregation** — ``/metrics`` merges every worker's exposition with
  a ``worker`` label injected (per-worker batcher occupancy, cache hit
  ratios, qps side by side); ``/debug/traces``, ``/debug/queries``,
  ``/debug/slow_queries``, ``/debug/threads`` and ``/debug/events``
  concatenate worker payloads tagged by worker. Workers stay
  individually scrapeable on their private ports.

* **Shutdown / rolling restart** — graceful stop drains each worker
  through the membership protocol (``POST /admin/drain`` walks
  its shards through make-before-break handoff to the surviving
  siblings) before SIGTERM; ``POST /admin/restart?worker=k&graceful=
  true`` does the same for one worker, whose rejoin defers shards and
  receives them back through the same protocol.

Admission control stays GLOBAL: the configured
``max-inflight-queries`` is split across workers (worker ``i`` gets
``total//N`` plus one of the remainder slots), so a supervisor
deployment admits the same aggregate in-flight work as the
single-process edge it replaces — not N× it. ``results-cache-mb`` is
split the same way, keeping the host's cache byte budget constant.

This module must stay light: it imports neither numpy nor torch — a
supervisor is a process manager plus a text-format aggregator.

    python -m filodb_tpu_torch.standalone.supervisor --config sup.json
        (sup.json: the standalone server's keys plus "serving-workers",
        "supervisor-port", ...; "device": "cpu" runs the workers on the
        CPU)
"""

from __future__ import annotations

import argparse
import json
import os
import select
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.obs.metrics import (ExpositionBuilder,
                                          merge_expositions,
                                          parse_exposition)
from filodb_tpu_torch.standalone.bus import SupervisorBus

SUPERVISOR_DEFAULTS = {
    # worker fleet size; 0 = one worker per core
    "serving-workers": 0,
    # the aggregate admin/metrics edge (0 = ephemeral)
    "supervisor-port": 0,
    # monitor cadence + hung-worker threshold: a worker failing this
    # many consecutive private-port health probes is killed + respawned
    "monitor-interval-s": 0.15,
    "health-check-interval-s": 1.0,
    "health-fail-threshold": 5,
    # min seconds between respawns of one worker (crash-loop brake)
    "restart-backoff-s": 1.0,
    "worker-startup-timeout-s": 180.0,
}

# keys the supervisor consumes itself and must not leak into workers
_SUPERVISOR_ONLY = tuple(SUPERVISOR_DEFAULTS) + ("run-dir",)

# the directory that holds the filodb_tpu_torch package: the workers'
# working directory and the head of their PYTHONPATH, so the supervisor
# starts them from any working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def split_quota(total: int, n: int) -> List[int]:
    """Split a global admission budget across ``n`` workers: worker i
    gets ``total//n`` plus one remainder slot. ``sum == total`` always
    holds when ``total >= n``; a budget smaller than the fleet is
    raised to one slot per worker (a zero-quota worker could never
    answer a query), which is the documented lower bound."""
    total = int(total)
    n = max(1, int(n))
    if total <= 0:
        return [0] * n          # 0 = admission control off
    if total < n:
        return [1] * n
    base, rem = divmod(total, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def worker_config(base: Dict, ordinal: int, num_workers: int,
                  private_ports: List[int], public_port: int,
                  bus_port: int, accept_fd: Optional[int] = None
                  ) -> Dict:
    """Derive worker ``ordinal``'s standalone-server config from the
    supervisor's base config. Each worker is a full multi-node
    cluster member: ordinal shard ownership, the sibling private
    ports as its peer map, a share of the global admission and
    results-cache budgets, and the shared public accept edge."""
    cfg = {k: v for k, v in base.items() if k not in _SUPERVISOR_ONLY}
    cfg["num-nodes"] = num_workers
    cfg["node-ordinal"] = ordinal
    cfg["port"] = private_ports[ordinal]
    cfg["peers"] = {f"node{i}": f"http://127.0.0.1:{p}"
                    for i, p in enumerate(private_ports)}
    cfg["worker-id"] = ordinal
    cfg["bus-port"] = bus_port
    if accept_fd is not None:
        cfg["accept-fd"] = accept_fd
    else:
        cfg["accept-port"] = public_port
    # ONE producer edge per host: the gateway publishes to EVERY
    # shard's stream (two gateways on one log would interleave), so
    # only worker 0 gets it; it follows worker 0 through restarts
    if ordinal != 0:
        cfg["gateway-port"] = None
    quotas = split_quota(int(base.get("max-inflight-queries", 4) or 0),
                         num_workers)
    cfg["max-inflight-queries"] = quotas[ordinal]
    cache_mb = float(base.get("results-cache-mb", 64) or 0)
    cfg["results-cache-mb"] = cache_mb / num_workers
    # tenant QoS budgets are HOST bounds like admission: each worker
    # gets 1/N of every refill rate and bucket depth, so an N-worker
    # fleet charges the same aggregate budget per tenant as the
    # single-process edge it replaces — not N x it. (Rates are floats;
    # an even split loses nothing, unlike the slot split above.)
    if base.get("qos-tenant-rate"):
        cfg["qos-tenant-rate"] = \
            float(base["qos-tenant-rate"]) / num_workers
    if base.get("qos-tenant-burst"):
        cfg["qos-tenant-burst"] = \
            float(base["qos-tenant-burst"]) / num_workers
    overrides = dict(base.get("qos-tenant-overrides") or {})
    if overrides:
        split_ov = {}
        for tenant, ov in overrides.items():
            if isinstance(ov, (list, tuple)):
                split_ov[tenant] = [float(v) / num_workers for v in ov]
            else:
                split_ov[tenant] = float(ov) / num_workers
        cfg["qos-tenant-overrides"] = split_ov
    return cfg


# tenant families summed host-wide on the supervisor's /metrics: the
# per-worker samples already flow through merge_expositions with a
# worker label, but a tenant's shards (and its budget split) spread
# ACROSS workers — the host-level sum is what an operator alerts on.
# Gauges sum correctly here because each is an amount (series counts,
# remaining budget units), not a ratio.
_TENANT_SUM_FAMILIES = (
    "filodb_tenant_time_series_total",
    "filodb_tenant_time_series_active",
    "filodb_tenant_budget_remaining",
    "filodb_tenant_budget_rate",
    "filodb_tenant_cost_charged_total",
    "filodb_tenant_admitted_total",
    "filodb_tenant_throttled_total",
    "filodb_tenant_forced_charges_total",
    "filodb_tenant_degraded_total",
    "filodb_tenant_rejected_total",
)


def aggregate_tenant_families(by_worker: Dict[str, str]) -> str:
    """Host-level per-tenant rollup of the workers' tenant cardinality
    and budget families: same label sets, values summed across the
    fleet, re-emitted as ``filodb_host_tenant_*`` (the per-worker view
    keeps its ``worker`` label via merge_expositions; this is the
    one-series-per-tenant view dashboards and alerts want)."""
    sums: Dict[tuple, float] = {}
    mtypes: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for body in by_worker.values():
        for fam, mtype, name, labels, value in parse_exposition(
                body, help_sink=helps):
            if fam not in _TENANT_SUM_FAMILIES or name != fam:
                continue
            try:
                v = float(value)
            except ValueError:
                continue
            if mtype:       # keep the workers' declared type (the
                mtypes[fam] = mtype  # cardinality gauges end in _total)
            key = (fam, tuple(sorted(labels.items())))
            sums[key] = sums.get(key, 0.0) + v
    if not sums:
        return ""
    b = ExpositionBuilder()
    for (fam, labels) in sorted(sums, key=str):
        host_fam = fam.replace("filodb_tenant_", "filodb_host_tenant_")
        v = sums[(fam, labels)]
        b.sample(host_fam, dict(labels),
                 int(v) if float(v).is_integer() else round(v, 3),
                 mtype=mtypes.get(
                     fam, "counter" if fam.endswith("_total")
                     else "gauge"),
                 help="Host-wide sum of %s across workers" % fam)
    return b.render()


class _Worker:
    """One supervised worker process (bookkeeping only — mutation is
    guarded by the supervisor's lock)."""

    def __init__(self, ordinal: int, cfg_path: str, port: int):
        self.ordinal = ordinal
        self.node_id = f"node{ordinal}"
        self.cfg_path = cfg_path
        self.port = port            # private (peer/control) port
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.health_misses = 0
        self.ready = False
        self.last_spawn = 0.0


@guarded_by("_lock", "_workers", "_stopping")
class Supervisor:
    """Fork, monitor, and aggregate N standalone query workers."""

    def __init__(self, config: Optional[Dict] = None):
        self.config = {**SUPERVISOR_DEFAULTS, **(config or {})}
        n = int(self.config.get("serving-workers", 0) or 0)
        if n <= 0:
            n = os.cpu_count() or 1
        self.num_workers = n
        self._lock = threading.Lock()
        self._workers: Dict[int, _Worker] = {}
        self._stopping = False
        self._stop_evt = threading.Event()
        self.public_port = int(self.config.get("port", 0) or 0) \
            or _free_port()
        self.bus: Optional[SupervisorBus] = None
        self._accept_sock: Optional[socket.socket] = None
        self._monitor: Optional[threading.Thread] = None
        self._admin = None
        self.supervisor_port: Optional[int] = None
        self.run_dir = self.config.get("run-dir")

    def _worker_snapshot(self) -> List[_Worker]:
        with self._lock:
            return sorted(self._workers.values(),
                          key=lambda w: w.ordinal)

    def worker_ports(self) -> List[Dict]:
        return [{"ordinal": w.ordinal, "port": w.port}
                for w in self._worker_snapshot()]

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Supervisor":
        if self.run_dir is None:
            self.run_dir = tempfile.mkdtemp(prefix="filodb-sup-")
        os.makedirs(self.run_dir, exist_ok=True)
        self.bus = SupervisorBus().start()
        # accept edge: prefer per-worker SO_REUSEPORT binds; without
        # platform support, bind once here and pass the fd down
        accept_fd = None
        if not hasattr(socket, "SO_REUSEPORT"):
            self._accept_sock = socket.create_server(
                ("127.0.0.1", self.public_port), backlog=128)
            self._accept_sock.set_inheritable(True)
            accept_fd = self._accept_sock.fileno()
        ports = [_free_port() for _ in range(self.num_workers)]
        for i in range(self.num_workers):
            cfg = worker_config(self.config, i, self.num_workers,
                                ports, self.public_port,
                                self.bus.port, accept_fd=accept_fd)
            cfg_path = os.path.join(self.run_dir, f"worker{i}.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f, indent=2)
            w = _Worker(i, cfg_path, ports[i])
            with self._lock:
                self._workers[i] = w
        for w in self._worker_snapshot():
            self._spawn(w)
        self._start_admin()
        self._monitor = threading.Thread(target=self._monitor_run,
                                         daemon=True,
                                         name="worker-supervisor")
        self._monitor.start()
        return self

    def _spawn(self, w: _Worker) -> None:
        """Start (or restart) one worker process; a side thread waits
        for its machine-readable startup line and broadcasts
        ``worker-up`` when the node is serving."""
        pass_fds = ()
        if self._accept_sock is not None:
            pass_fds = (self._accept_sock.fileno(),)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        # stdout carries the startup line; stderr is inherited, so a
        # worker's traceback lands in the supervisor's log
        proc = subprocess.Popen(
            [sys.executable, "-m", "filodb_tpu_torch.standalone.server",
             "--config", w.cfg_path],
            stdout=subprocess.PIPE, pass_fds=pass_fds, cwd=_ROOT, env=env)
        with self._lock:
            w.proc = proc
            w.ready = False
            w.health_misses = 0
            w.last_spawn = time.monotonic()
        threading.Thread(target=self._await_startup, args=(w, proc),
                         daemon=True,
                         name=f"worker-startup-{w.ordinal}").start()

    @thread_root("worker-startup")
    def _await_startup(self, w: _Worker, proc: subprocess.Popen) -> None:
        deadline = time.monotonic() + float(
            self.config.get("worker-startup-timeout-s", 180.0))
        buf = b""
        while time.monotonic() < deadline and b"\n" not in buf:
            if proc.poll() is not None:
                return              # died during startup; monitor reaps
            r, _, _ = select.select([proc.stdout], [], [], 0.5)
            if r:
                ch = proc.stdout.read1(4096)
                if not ch:
                    return
                buf += ch
        if b"\n" not in buf:
            return
        # keep draining stdout so a chatty worker can never block on a
        # full pipe
        threading.Thread(target=self._drain, args=(proc,), daemon=True,
                         name=f"worker-drain-{w.ordinal}").start()
        with self._lock:
            if w.proc is proc:
                w.ready = True
        if self.bus is not None:
            self.bus.broadcast({"type": "worker-up", "node": w.node_id})

    @thread_root("worker-drain")
    def _drain(self, proc: subprocess.Popen) -> None:
        try:
            while proc.stdout.read1(65536):
                pass
        except (OSError, ValueError):
            pass

    # -- supervision ------------------------------------------------------
    @thread_root("worker-supervisor")
    def _monitor_run(self) -> None:
        interval = float(self.config.get("monitor-interval-s", 0.15))
        health_every = float(self.config.get(
            "health-check-interval-s", 1.0))
        threshold = int(self.config.get("health-fail-threshold", 5))
        backoff = float(self.config.get("restart-backoff-s", 1.0))
        last_health = 0.0
        while not self._stop_evt.wait(interval):
            now = time.monotonic()
            do_health = now - last_health >= health_every
            if do_health:
                last_health = now
            for w in self._worker_snapshot():
                with self._lock:
                    proc, ready = w.proc, w.ready
                    stopping = self._stopping
                if stopping or proc is None:
                    continue
                rc = proc.poll()
                if rc is not None:
                    # ground truth: the process is GONE (crash,
                    # kill -9, OOM). Tell the siblings immediately —
                    # they drop its gossiped watermarks / data-plane
                    # channel — then respawn with the same config.
                    print(f"filodb-torch supervisor: worker {w.ordinal} "
                          f"(pid {proc.pid}) exited with {rc}; respawning",
                          file=sys.stderr, flush=True)
                    if self.bus is not None:
                        self.bus.broadcast({"type": "worker-exit",
                                            "node": w.node_id})
                    wait = backoff - (now - w.last_spawn)
                    if wait > 0 and self._stop_evt.wait(wait):
                        return
                    with self._lock:
                        w.restarts += 1
                    self._spawn(w)
                    continue
                if do_health and ready:
                    if self._healthy(w):
                        with self._lock:
                            w.health_misses = 0
                    else:
                        with self._lock:
                            w.health_misses += 1
                            wedged = w.health_misses >= threshold
                        if wedged:
                            # alive but unresponsive: treat like a
                            # crash (the next loop pass reaps + respawns)
                            print(f"filodb-torch supervisor: worker "
                                  f"{w.ordinal} (pid {proc.pid}) missed "
                                  f"{threshold} health probes in a row; "
                                  f"killing it as hung", file=sys.stderr,
                                  flush=True)
                            try:
                                proc.kill()
                            except OSError:
                                pass

    def _healthy(self, w: _Worker) -> bool:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{w.port}/__health",
                    timeout=2.0) as r:
                return r.status == 200
        except OSError:
            return False

    # -- aggregate admin/metrics edge -------------------------------------
    def _start_admin(self) -> None:
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)
        sup = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _reply(self, code: int, payload, ctype=None) -> None:
                if isinstance(payload, str):
                    body = payload.encode()
                    ctype = ctype or "text/plain; version=0.0.4"
                else:
                    body = json.dumps(payload).encode()
                    ctype = ctype or "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            @thread_root("supervisor-admin")
            def do_GET(self):
                try:
                    code, payload = sup._admin_route(
                        self.path, method="GET")
                except Exception as e:  # noqa: BLE001 — edge survives
                    code, payload = 500, {"status": "error",
                                          "error": str(e)}
                self._reply(code, payload)

            def do_POST(self):
                try:
                    code, payload = sup._admin_route(
                        self.path, method="POST")
                except Exception as e:  # noqa: BLE001 — edge survives
                    code, payload = 500, {"status": "error",
                                          "error": str(e)}
                self._reply(code, payload)

        self._admin = ThreadingHTTPServer(
            ("127.0.0.1", int(self.config.get("supervisor-port", 0)
                              or 0)), Handler)
        self.supervisor_port = self._admin.server_port
        threading.Thread(target=self._admin.serve_forever, daemon=True,
                         name="supervisor-admin").start()

    def _admin_route(self, path: str, method: str = "GET"):
        parsed = urllib.parse.urlparse(path)
        qs = urllib.parse.parse_qs(parsed.query)
        route = parsed.path
        if route in ("/__health", "/__liveness"):
            return 200, self.status()
        if route == "/metrics":
            return 200, self.metrics_text()
        if route in ("/debug/traces", "/debug/queries",
                     "/debug/slow_queries", "/debug/threads",
                     "/debug/events"):
            return 200, self._debug_merge(route, parsed.query)
        if route == "/admin/invalidate" and method == "POST":
            reason = (qs.get("reason") or ["schema"])[0]
            self.bus.broadcast({"type": "schema", "reason": reason,
                                "origin": "supervisor"})
            return 200, {"status": "success",
                         "data": {"reason": reason,
                                  "workers": self.bus.connected_workers()}}
        if route == "/admin/restart" and method == "POST":
            try:
                ordinal = int((qs.get("worker") or [""])[0])
            except ValueError:
                return 400, {"status": "error",
                             "error": "worker must be an ordinal"}
            graceful = (qs.get("graceful") or ["true"])[0].lower() \
                not in ("false", "0", "no")
            out = self.restart_worker(ordinal, graceful=graceful)
            return (200 if out.get("ok") else 500,
                    {"status": "success" if out.get("ok") else "error",
                     "data": out})
        return 404, {"status": "error",
                     "error": f"no route for {route}"}

    def _worker_get(self, w: _Worker, path: str,
                    timeout: float = 5.0) -> Optional[object]:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{w.port}{path}",
                    timeout=timeout) as r:
                body = r.read()
        except OSError:
            return None
        try:
            return json.loads(body)
        except ValueError:
            return body.decode("utf-8", "replace")

    def status(self) -> Dict:
        workers = {}
        with self._lock:
            snap = [(w.ordinal, w.port, w.proc, w.ready, w.restarts)
                    for w in self._workers.values()]
        for ordinal, port, proc, ready, restarts in snap:
            workers[str(ordinal)] = {
                "port": port,
                "alive": proc is not None and proc.poll() is None,
                "pid": proc.pid if proc is not None else None,
                "ready": ready,
                "restarts": restarts,
            }
        return {"status": "healthy", "role": "supervisor",
                "public_port": self.public_port,
                "bus_port": self.bus.port if self.bus else None,
                "bus_connected": (self.bus.connected_workers()
                                  if self.bus else []),
                "workers": workers}

    def metrics_text(self) -> str:
        """The one-target scrape: every worker's exposition with a
        ``worker`` label injected, plus the supervisor's own fleet
        gauges."""
        by_worker: Dict[str, str] = {}
        with self._lock:
            targets = list(self._workers.values())
        for w in targets:
            body = self._worker_get(w, "/metrics")
            if isinstance(body, str):
                by_worker[str(w.ordinal)] = body
        out = merge_expositions(by_worker)
        # host-wide per-tenant rollup (filodb_host_tenant_*): the
        # per-worker tenant families above carry worker labels; this is
        # the summed view a noisy-neighbor alert reads
        out += aggregate_tenant_families(by_worker)
        b = ExpositionBuilder()
        with self._lock:
            snap = [(w.ordinal, w.proc, w.restarts)
                    for w in self._workers.values()]
        b.sample("filodb_supervisor_workers", {}, len(snap),
                 help="Configured worker-process fleet size")
        for ordinal, proc, restarts in snap:
            lbl = {"worker": str(ordinal)}
            b.sample("filodb_supervisor_worker_alive", lbl,
                     1 if proc is not None and proc.poll() is None
                     else 0,
                     help="1 while the worker process is running")
            b.sample("filodb_supervisor_worker_restarts_total", lbl,
                     restarts, mtype="counter",
                     help="Times the supervisor respawned this worker")
        b.sample("filodb_supervisor_bus_connected_workers", {},
                 len(self.bus.connected_workers()) if self.bus else 0,
                 help="Workers currently connected to the control "
                      "plane bus")
        return out + b.render()

    def _debug_merge(self, route: str, query: str) -> Dict:
        """Fan a /debug/* request out to every worker and merge the
        ``data`` lists, each entry tagged with its worker ordinal."""
        merged: List = []
        summaries: Dict[str, object] = {}
        with self._lock:
            targets = list(self._workers.values())
        for w in targets:
            path = route + (f"?{query}" if query else "")
            body = self._worker_get(w, path)
            if not isinstance(body, dict) \
                    or body.get("status") != "success":
                continue
            if "summary" in body:
                summaries[str(w.ordinal)] = body["summary"]
            for entry in body.get("data") or []:
                if isinstance(entry, dict):
                    entry = {**entry, "worker": w.ordinal}
                merged.append(entry)
        out: Dict[str, object] = {"status": "success", "data": merged}
        if summaries:
            out["summary"] = summaries
        return out

    # -- drain / restart / stop -------------------------------------------
    def _drain_worker(self, w: _Worker, timeout_s: float = 60.0) -> bool:
        """Membership drain: the worker's shards hand off
        make-before-break to the surviving siblings."""
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{w.port}/admin/drain", data=b"{}",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                body = json.loads(r.read())
            return body.get("status") == "success" \
                and not (body.get("data") or {}).get("failed")
        except (OSError, ValueError):
            return False

    def restart_worker(self, ordinal: int, graceful: bool = True
                       ) -> Dict:
        """Rolling-restart one worker: drain (planned handoff to the
        siblings), terminate, and let the monitor respawn it; its
        rejoin defers shards and receives them back through the same
        membership protocol."""
        with self._lock:
            w = self._workers.get(int(ordinal))
            proc = w.proc if w is not None else None
        if w is None or proc is None:
            return {"ok": False, "error": f"no worker {ordinal}"}
        drained = self._drain_worker(w) if graceful else None
        try:
            proc.terminate()
        except OSError:
            pass
        return {"ok": True, "worker": int(ordinal), "drained": drained}

    def stop(self, graceful: bool = True,
             drain_timeout_s: float = 60.0) -> None:
        with self._lock:
            self._stopping = True
        self._stop_evt.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        with self._lock:
            workers = sorted(self._workers.values(),
                             key=lambda w: w.ordinal)
        if graceful and len(workers) > 1:
            # drain all but the last live worker through the membership
            # protocol, so every shard's final flush/checkpoint happens
            # under a serving owner (the last worker just stops — its
            # durable state is the restart source)
            for w in workers[:-1]:
                if w.proc is not None and w.proc.poll() is None:
                    self._drain_worker(w, timeout_s=drain_timeout_s)
                    try:
                        w.proc.terminate()
                    except OSError:
                        pass
        for w in workers:
            if w.proc is not None and w.proc.poll() is None:
                try:
                    w.proc.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + 20
        for w in workers:
            if w.proc is None:
                continue
            try:
                w.proc.wait(timeout=max(0.1,
                                        deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                w.proc.kill()
                try:
                    w.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
        if self._admin is not None:
            self._admin.shutdown()
            self._admin.server_close()
        if self.bus is not None:
            self.bus.stop()
        if self._accept_sock is not None:
            try:
                self._accept_sock.close()
            except OSError:
                pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="filodb-torch-supervisor")
    p.add_argument("--config", help="JSON config file (standalone "
                                    "server schema + supervisor keys)")
    p.add_argument("--workers", type=int,
                   help="worker fleet size (default: one per core)")
    p.add_argument("--port", type=int, help="shared public port")
    p.add_argument("--supervisor-port", type=int,
                   help="aggregate admin/metrics port")
    args = p.parse_args(argv)
    config: Dict = {}
    if args.config:
        with open(args.config) as f:
            config.update(json.load(f))
    if args.workers is not None:
        config["serving-workers"] = args.workers
    if args.port is not None:
        config["port"] = args.port
    if args.supervisor_port is not None:
        config["supervisor-port"] = args.supervisor_port
    sup = Supervisor(config).start()
    # machine-readable startup line (harness/dev scripts read this)
    print(json.dumps({
        "port": sup.public_port,
        "supervisor_port": sup.supervisor_port,
        "bus_port": sup.bus.port,
        "workers": sup.worker_ports(),
    }), flush=True)
    print(f"filodb-torch supervisor: {sup.num_workers} workers behind "
          f":{sup.public_port} (admin :{sup.supervisor_port})",
          file=sys.stderr)
    stop_evt = threading.Event()

    def _sig(_signum, _frame):
        stop_evt.set()
    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        while not stop_evt.wait(0.5):
            pass
    finally:
        sup.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
