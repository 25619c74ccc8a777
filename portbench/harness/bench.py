"""One run of one cell: set-up, the measured window, the check, the
readings, and the result's last line.

Set-up, counted in setup_s: the configuration's data drawn from the seed,
the port's FiloServer started in this process and loaded through the
port's own loader, one query of each of the mix's templates (which builds
their tiles and, on the card, the kernels), and the client process started
with its plan. The window: the client's closed loops over loopback HTTP
for `seconds`; the traced run also profiles the card and keeps every
query's spans. After it: memory's peak read, the server stopped, a sample
of the answers drawn from the seed held against the reference.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench.harness import check, devtrace, guard, serve, spec
from portbench.harness.traffic import Mix
from portbench.reference import promql

# answers that refuse the request (admission, overload): failed requests,
# not wrong answers
REFUSALS = (429, 503)
# how long the client waits for an answer sent inside the window
ANSWER_WAIT_S = 60.0
# the latency a failed or refused request counts with: beyond any limit
FAILED_MS = 1e9


class NoDevice(RuntimeError):
    """The cell's chips are not there: the run prints no result."""


class Forbidden(RuntimeError):
    """The measured process loaded JAX or the JAX package."""


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in (0, 1]) of values, inf included."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def _device_info(require_cuda: bool, chips: int) -> Dict:
    import torch
    if not require_cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell "
                       f"asks for {chips}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def _power_limit(log) -> None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
        log(f"card: {out}")
    except (OSError, subprocess.SubprocessError) as e:
        log(f"card: nvidia-smi unavailable ({e})")


class Client:
    """The client process and its line protocol (harness/client.py)."""

    def __init__(self, cpus: Optional[set] = None):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.harness.client"],
            cwd=spec.CHECKOUT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        if cpus:
            os.sched_setaffinity(self.proc.pid, cpus)

    def _send(self, obj) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def _recv(self):
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the client ended early ("
                               f"{self.proc.poll()})")
        return json.loads(line)

    def prepare(self, port: int, path: str, plan: List[list]) -> None:
        self._send({"port": port, "path": path, "clients": plan,
                    "timeout_s": ANSWER_WAIT_S})
        if self.proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the client did not get ready")

    def go(self, t0: float, t1: float) -> None:
        self._send({"go": t0, "until": t1})

    def records(self) -> dict:
        return self._recv()

    def bodies(self, keep: List[list]) -> Dict[str, str]:
        self._send({"keep": keep})
        out = self._recv()["bodies"]
        self.proc.stdin.close()
        self.proc.wait(timeout=60)
        return out

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def _probes(bench: spec.Bench, metrics: List[dict]
            ) -> Dict[str, List[devtrace.Probe]]:
    """The probes of every roofline among a traced run's metrics
    (`roofline.<function>` reads roofline/<function>.py), by function."""
    return {m["name"][len("roofline."):]:
            bench.roofline(m["name"][len("roofline."):]).probes()
            for m in metrics if m["name"].startswith("roofline.")}


class Window:
    """What the measured window left behind."""

    def __init__(self):
        self.t0 = self.t1 = self.setup_s = 0.0
        self.w0_us = self.w1_us = 0.0
        self.records: List[list] = []
        self.client_errors: List[str] = []
        self.traces: List[dict] = []
        self.counters: Dict[str, float] = {}
        self.device: Optional[devtrace.DeviceTrace] = None
        self.probes: Dict[str, List[dict]] = {}


def _set_up(srv, cfg: dict, data: dict, mix: Mix, seed: int, log,
            t_start: float) -> None:
    rows = serve.load(srv, cfg, data)
    log(f"setup: {rows} samples of {len(data['labels'])} series loaded "
        f"at {time.monotonic() - t_start:.1f} s")
    for req in mix.warm(seed):
        status, body = serve.query(srv.port, mix.path, req)
        if status != 200:
            raise RuntimeError(f"warm-up {req['query']!r}: HTTP {status}: "
                               f"{body[:300]!r}")


def _measure(srv, client: Client, seconds: float, trace: bool,
             probes: Dict[str, List[devtrace.Probe]], scratch: str,
             t_start: float) -> Window:
    """The window: the client's loops for `seconds`; in a traced run the
    probes, the profiler and the counters around it, and every query's
    spans after it."""
    win = Window()
    installed = [p for ps in probes.values() for p in ps]
    c0: Dict[str, float] = {}
    if trace:
        for p in installed:
            p.install()
        c0 = serve.counters(srv.port)
        win.device = devtrace.DeviceTrace(scratch)
        win.device.start()
    try:
        win.t0 = time.monotonic() + 0.05
        win.t1 = win.t0 + seconds
        win.w0_us = time.time_ns() / 1e3 + (win.t0 - time.monotonic()) * 1e6
        client.go(win.t0, win.t1)
        win.setup_s = win.t0 - t_start
        time.sleep(max(0.0, win.t1 - time.monotonic()))
        win.w1_us = time.time_ns() / 1e3
        if trace:
            win.device.stop()
            c1 = serve.counters(srv.port)
            win.counters = {k: c1.get(k, 0.0) - c0.get(k, 0.0)
                            for k in set(c0) | set(c1)}
        got = client.records()
    finally:
        for p in installed:
            p.uninstall()
    win.records = [r for r in got["records"] if win.t0 <= r[2] < win.t1]
    win.client_errors = got.get("errors", [])
    if trace:
        traces = [t.to_json() for t in srv.http.tracer.recent(10 ** 9)]
        win.traces = [t for t in traces if any(
            s["name"] == "query" and win.w0_us <= s["start_us"] <= win.w1_us
            for s in t["spans"])]
        win.probes = {fn: [c for p in ps for c in p.calls]
                      for fn, ps in probes.items()}
    return win


def _end_to_end(win: Window, seconds: float) -> Dict[str, float]:
    """Every request sent in the window counts; a failed one as FAILED_MS."""
    lat = [(r[3] - r[2]) * 1e3 if r[4] == 200 else FAILED_MS
           for r in win.records]
    done = sum(1 for r in win.records if r[4] == 200 and r[3] <= win.t1)
    return {"qps": done / seconds,
            "latency_p50_ms": percentile(lat, 0.50) if lat else FAILED_MS,
            "latency_p95_ms": percentile(lat, 0.95) if lat else FAILED_MS,
            "setup_s": win.setup_s}


def _check(win: Window, plan: List[list], mix: Mix, limits: dict,
           client: Client, data: dict, seed: int, log) -> dict:
    """A sample of the window's answers, drawn from the seed, held against
    the reference -> the checks, each number with its limit."""
    rng = np.random.default_rng([seed, 3])
    by_template: Dict[str, List[list]] = {}
    for r in win.records:
        if r[4] == 200:
            by_template.setdefault(plan[r[0]][r[1]]["template"],
                                   []).append(r)
    keep = []
    for name in sorted(by_template):
        rs = by_template[name]
        pick = rng.choice(len(rs), min(len(rs), mix.checked_per_query),
                          replace=False)
        keep += [[rs[i][0], rs[i][1]] for i in sorted(pick)]
    bodies = client.bodies(keep)
    t_ref = time.monotonic()
    series = promql.Series(data["labels"], data["ts"], data["vals"])
    worst, where = 0.0, ""
    for c, i in keep:
        req = plan[c][i]
        g, why = check.check_answer(req, bodies[f"{c}:{i}"].encode(), series)
        if g >= worst:
            worst, where = g, (f"{req['query']} [{req['start']}, "
                               f"{req['end']}]: {why}")
    log(f"window: {len(win.records)} requests sent, reference over "
        f"{len(keep)} answers in {time.monotonic() - t_ref:.1f} s")
    log(f"check: widest gap at {where}")
    for e in win.client_errors:
        log(f"client: {e}")
    unanswered = sum(1 for r in win.records
                     if r[4] != 200 and r[4] not in REFUSALS)
    return {"gap": {"value": worst, "limit": limits["gap"]["limit"]},
            "answers_checked": {"value": len(keep),
                                "limit": len(mix.templates)},
            "unanswered": {"value": unanswered, "limit": 0},
            "client_errors": {"value": len(win.client_errors), "limit": 0}}


def _per_layer(bench: spec.Bench, cell: str, cfg: dict, win: Window,
               card: str, metrics: List[dict], log) -> Dict[str, dict]:
    ctx = {"cell": cell, "cfg": cfg, "bench": bench, "traces": win.traces,
           "window_us": (win.w0_us, win.w1_us), "counters": win.counters,
           "device": win.device, "probes": win.probes, "card": card}
    probe_tids = {c["tid"] for v in win.probes.values() for c in v}
    launch_tids = {t for t, _ in win.device.launch.values()}
    log(f"trace: {len(win.traces)} query traces, "
        f"{len(win.device.device)} device events, "
        f"{len(win.device.launch)} launches from {len(launch_tids)} "
        f"threads, probe calls "
        f"{ {k: len(v) for k, v in win.probes.items()} } on "
        f"{len(probe_tids)} threads, {len(probe_tids & launch_tids)} of "
        f"them launching")
    out = {}
    for m in metrics:
        v = bench.metric_reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(bench: spec.Bench, cell: str, seed: int, seconds: float,
        trace: bool, t_start: float, device: Optional[str] = None,
        require_cuda: bool = True, client_cpus: Optional[set] = None,
        log: Callable[[str], None] = lambda m: print(m, file=sys.stderr,
                                                     flush=True)) -> dict:
    """One run -> the result's object. Raises NoDevice before any work
    when the cell's chips are missing, Forbidden when JAX was loaded.
    `client_cpus`, where given, are the cores the client process keeps
    to."""
    wl = bench.workload(cell)
    dev_info = _device_info(require_cuda, wl["chips"])
    cfg = bench.config(wl["config"])
    mix = Mix(bench.traffic(wl["traffic"]), cfg,
              bench.traffic_module(wl["traffic"]))
    limits = bench.limits(cell)
    metrics = bench.metrics_of(cell, trace)
    if require_cuda:
        _power_limit(log)
    scratch = tempfile.mkdtemp(prefix="portbench-")
    client = srv = None
    try:
        data = bench.datagen(cfg["name"]).generate(cfg, seed)
        client = Client(client_cpus)
        srv = serve.start(cfg, trace, device)
        _set_up(srv, cfg, data, mix, seed, log, t_start)
        plan = mix.plan(seed)
        client.prepare(srv.port, mix.path, plan)
        if require_cuda:
            import torch
            torch.cuda.synchronize()
        gc.collect()
        probes = _probes(bench, metrics) if trace else {}
        win = _measure(srv, client, seconds, trace, probes, scratch,
                       t_start)
        dev_info["memory_peak_bytes"] = 0
        if require_cuda:
            import torch
            dev_info["memory_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(0))
        srv.stop()
        srv = None
        gc.collect()
        if require_cuda:
            torch.cuda.empty_cache()

        checks = _check(win, plan, mix, limits, client, data, seed, log)
        client = None
        correct = (checks["gap"]["value"] <= checks["gap"]["limit"]
                   and all(checks[k]["value"] == 0 for k in
                           ("unanswered", "client_errors"))
                   and checks["answers_checked"]["value"]
                   >= checks["answers_checked"]["limit"])
        result = {"correct": bool(correct), "attempted": len(win.records),
                  "failed": sum(1 for r in win.records if r[4] != 200),
                  "metrics": {}, "device": dev_info}
        if not trace:
            e2e = _end_to_end(win, seconds)
            result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                             "unit": m["unit"]}
                                 for m in metrics}
        else:
            result["metrics"] = _per_layer(bench, cell, cfg, win,
                                           dev_info["kind"], metrics, log)
            if require_cuda:
                w0, w1 = win.w0_us, win.w1_us
                dev_info["busy_s"] = win.device.busy_s(w0, w1)
                dev_info["window_s"] = (w1 - w0) / 1e6
                label = devtrace.span_labeler(win.traces)
                result["breakdown"] = {
                    "device_ops": win.device.top_ops(w0, w1),
                    "idle_gaps": win.device.idle_gaps(w0, w1, label)}
        bad = guard.loaded_forbidden()
        if bad:
            raise Forbidden("the measured process loaded " + ", ".join(bad))
        for name, c in checks.items():
            log(f"check {name} {c['value']!r} limit {c['limit']!r}")
        result["checks"] = checks
        return result
    finally:
        if client is not None:
            client.close()
        if srv is not None:
            srv.stop()
        shutil.rmtree(scratch, ignore_errors=True)


def dumps(result: dict) -> str:
    """The last line: JSON, an infinite number (an answer that cannot be
    compared) as the largest float."""
    def clean(x):
        if isinstance(x, float) and not math.isfinite(x):
            return math.copysign(sys.float_info.max, x)
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        return x
    return json.dumps(clean(result))
