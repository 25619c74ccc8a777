"""Recording rules and alerting of the port (``filodb_tpu_torch.rules``,
``obs/writeback.py`` and their wiring in the HTTP and standalone servers)
against the JAX package's, on the CPU, on the same seeded inputs.

  * the loader: groups, error and warning lists of JSON and YAML rule
    files, valid and broken, and ``--check``'s exit codes and output;
    without PyYAML a YAML file gets the reference's message;
  * the write-back rail: container bytes, direct and durable;
  * the engine under a scripted evaluator and a deterministic clock: the
    alert life cycle (inactive, pending, firing, resolved; no flap on an
    evaluation error), the written samples and the API payloads;
  * the webhook notifier: payloads and retries against a loopback sink;
  * the election: ``note_worker_exit``/``note_worker_up`` sequences give
    the same active flags and election log, and a walk of three engines
    through an evaluator's death and return evaluates every boundary
    exactly once;
  * a port server and a JAX server with the same rules and data, ticked
    at the data's time through ``eval_group_once``: recorded series,
    ALERTS/ALERTS_FOR_STATE, ``/api/v1/rules`` (``explain=analyze``,
    ``debug``), ``/api/v1/alerts`` and the webhook bodies agree, apart
    from durations;
  * two-node clusters of each package with a node stopped, as in
    tests/test_chaos_rules.py: the rule fails and its group's staleness
    rises, the alert does not flap, recording resumes after the restart,
    and without a supervisor every node evaluates.

The servers' wall-clock scheduler thread is ended (``_hold``) before the
ticks, so that only the deterministic ticks evaluate. Tolerances are
tests/test_torch_server.py's: grouped sums of rate rtol 1e-5, rate on
irregular series 4 f64 ulps; everything else exact.
"""

import dataclasses
import http.server
import io
import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import TimeSeriesMemStore as JStore
from filodb_tpu.core.record import PartKey as JPartKey
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.record import ingestion_shard as j_ingestion_shard
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetRef as JRef
from filodb_tpu.core.schemas import PartitionSchema as JPartitionSchema
from filodb_tpu.ingest.stream import encode_container as j_encode
from filodb_tpu.obs import writeback as j_wb
from filodb_tpu.parallel.resilience import RetryPolicy as JRetry
from filodb_tpu.query.model import GridResult as JGrid
from filodb_tpu.rules import engine as j_engine
from filodb_tpu.rules import loader as j_loader
from filodb_tpu.rules import notify as j_notify
from filodb_tpu.rules.__main__ import main as j_main
from filodb_tpu.standalone.server import FiloServer as JServer
from filodb_tpu_torch import state
from filodb_tpu_torch.core.memstore import TimeSeriesMemStore as PStore
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS as P_SCHEMAS
from filodb_tpu_torch.core.schemas import DatasetRef as PRef
from filodb_tpu_torch.ingest.stream import encode_container as p_encode
from filodb_tpu_torch.obs import writeback as p_wb
from filodb_tpu_torch.parallel.resilience import RetryPolicy as PRetry
from filodb_tpu_torch.query.model import GridResult as PGrid
from filodb_tpu_torch.rules import engine as p_engine
from filodb_tpu_torch.rules import loader as p_loader
from filodb_tpu_torch.rules import notify as p_notify
from filodb_tpu_torch.rules.__main__ import main as p_main
from filodb_tpu_torch.standalone import server as psrv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu", "gc-freeze": False}
T0S = 1_600_000_000


@pytest.fixture(scope="module", autouse=True)
def _leave_the_reference_rule_counters_fresh():
    """This file runs the JAX package's rules engine with the group and
    rule names of its own tests (``g``, ``Hot``); the engine counts into
    the process-wide metric registry, which ``tests/test_rules.py``
    reads as fresh when it shares this worker process after this file.
    So the file drops the families it left there (collectors stay)."""
    from filodb_tpu.obs import metrics as j_metrics
    yield
    j_metrics.GLOBAL_REGISTRY.reset()

PKGS = {
    "port": SimpleNamespace(engine=p_engine, loader=p_loader,
                            notify=p_notify, main=p_main, wb=p_wb,
                            Store=PStore, schemas=P_SCHEMAS, Ref=PRef,
                            Grid=PGrid, Retry=PRetry, encode=p_encode),
    "jax": SimpleNamespace(engine=j_engine, loader=j_loader,
                           notify=j_notify, main=j_main, wb=j_wb,
                           Store=JStore, schemas=J_SCHEMAS, Ref=JRef,
                           Grid=JGrid, Retry=JRetry, encode=j_encode),
}


def _both(fn):
    """fn(package namespace) for the port and the JAX package."""
    return fn(PKGS["port"]), fn(PKGS["jax"])


# -- the loader ------------------------------------------------------------

_FULL = {"groups": [
    {"name": "g", "interval": "30s", "dataset": "ds1", "limit": 5,
     "rules": [
         {"record": "job:x:rate5m", "expr": "sum by (job) (rate(x_total[5m]))",
          "labels": {"tier": "gold"}},
         {"record": "job:x:events_total",
          "expr": "sum(increase(x_total[5m]))", "schema": "counter"},
         {"alert": "Hot", "expr": "rate(x_total[5m]) > 1", "for": "2m",
          "labels": {"severity": "page"},
          "annotations": {"summary": "hot: {{ $value }}"}}]},
    {"name": "h", "rules": [{"record": "y:sum", "expr": "sum(y)"}]},
]}
_YAML = """groups:
- name: g
  interval: 15s
  rules:
  - record: a:b
    expr: sum(x)
  - alert: Up
    expr: up == 0
    for: 1m
    annotations:
      summary: "down {{ $labels.instance }}"
"""
RULE_TEXTS = {
    "json-full": json.dumps(_FULL),
    "yaml": _YAML,
    "json-syntax": '{"groups": [{"name": "g", "rules": [',
    "yaml-syntax": "groups:\n- name: g\n  rules: [\n    - record: a\n",
    "validation": json.dumps({"groups": [
        {"name": "g", "interval": "30s", "rules": [
            {"record": "ok:one", "expr": "sum(x)"},
            {"record": "bad name!", "expr": "sum(x)"},
            {"record": "syntax", "expr": "rate(x_total[5m"},
            {"alert": "A", "expr": "x > 1", "schema": "counter"},
            {"record": "r2", "expr": "sum(x)", "for": "1m"},
            {"expr": "sum(x)"},
            {"record": "both", "alert": "both", "expr": "sum(x)"},
            {"record": "r3", "expr": "sum(x)", "bogus": 1}]},
        {"name": "g", "interval": "-5s",
         "rules": [{"record": "ok:two", "expr": "x"}]},
        {"name": "empty", "rules": []}], "extra": 1}),
    "duplicates": json.dumps({"groups": [
        {"name": "g1", "rules": [{"record": "dup:rule", "expr": "sum(x)"}]},
        {"name": "g2", "rules": [
            {"record": "dup:rule", "expr": "sum(y)"},
            {"record": "same:a", "expr": "sum by (a, b) (z)"},
            {"record": "same:b", "expr": "sum  by (b,a)(z)"}]}]}),
    "semantic": json.dumps({"groups": [{"name": "g", "rules": [
        {"record": "g:level", "expr": "sum(queue_depth)",
         "schema": "gauge"},
        {"record": "g:bad_rate", "expr": "rate(g:level[5m])"}]}]}),
    "empty": '{"groups": []}',
    "not-a-mapping": "[1, 2]",
}
with open(os.path.join(REPO, "examples", "rules.yaml")) as _f:
    RULE_TEXTS["examples"] = _f.read()


def _parse(pkg, text):
    errors, warnings = [], []
    groups = pkg.loader.parse_rules_text(text, errors=errors,
                                         warnings=warnings)
    return [dataclasses.asdict(g) for g in groups], errors, warnings


@pytest.mark.parametrize("name", sorted(RULE_TEXTS))
def test_loader_groups_and_findings_match_the_jax_loader(name):
    port, jax_out = _both(lambda p: _parse(p, RULE_TEXTS[name]))
    assert port == jax_out
    groups, errors, _ = port
    if name in ("json-full", "yaml", "examples"):
        assert groups and not errors
    else:
        assert errors


@pytest.mark.parametrize("name", ["json-full", "validation", "empty"])
def test_load_groups_raises_as_the_jax_loader(name):
    obj = json.loads(RULE_TEXTS[name])

    def load(p):
        try:
            return [dataclasses.asdict(g) for g in p.loader.load_groups(obj)]
        except p.loader.RuleLoadError as e:
            return ("raised", e.errors)
    port, jax_out = _both(load)
    assert port == jax_out
    assert (port[0] == "raised") == (name != "json-full")


CHECK_FILES = {"good.json": RULE_TEXTS["json-full"],
               "good.yaml": RULE_TEXTS["yaml"],
               "warn.json": RULE_TEXTS["duplicates"].replace(
                   '"sum(y)"', '"sum(w)"').replace("dup:rule", "d:r", 1),
               "bad.json": RULE_TEXTS["validation"],
               "semantic.json": RULE_TEXTS["semantic"],
               "missing.json": None}


@pytest.mark.parametrize("fname", sorted(CHECK_FILES))
def test_check_exit_codes_and_output_match_the_jax_cli(tmp_path, fname):
    path = tmp_path / fname
    if CHECK_FILES[fname] is not None:
        path.write_text(CHECK_FILES[fname])

    def run(p):
        buf = io.StringIO()
        with redirect_stdout(buf):
            code = p.main(["--check", str(path)])
        return code, buf.getvalue()
    port, jax_out = _both(run)
    assert port == jax_out
    want = {"good.json": 0, "good.yaml": 0, "warn.json": 0}.get(fname, 1)
    assert port[0] == want
    if fname == "warn.json":
        assert "warning" in port[1]


def test_check_without_a_file_is_a_usage_error(capsys):
    assert _both(lambda p: p.main([])) == (2, 2)


def test_check_from_the_command_line(tmp_path):
    path = tmp_path / "rules.json"
    path.write_text(RULE_TEXTS["json-full"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    import subprocess
    proc = subprocess.run(
        [sys.executable, "-m", "filodb_tpu_torch.rules", "--check",
         str(path)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == f"{path}: OK — 2 group(s), 4 rule(s)\n"


@pytest.mark.parametrize("name", ["yaml", "json-full"])
def test_without_pyyaml_yaml_gets_the_reference_message(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "yaml", None)   # import yaml fails
    port, jax_out = _both(lambda p: _parse(p, RULE_TEXTS[name]))
    assert port == jax_out
    if name == "yaml":
        assert port[1] == [
            "PyYAML is not available in this environment; supply the rule "
            "file as JSON ({\"groups\": [...]})"]
    else:
        assert port[0] and not port[1]


# -- the write-back rail ---------------------------------------------------

class _Sink:
    """A shard (``ingest``, ``flush_all``) or a stream (``append``) that
    keeps the bytes of every container it is handed, in the stream's
    record encoding of its package."""

    def __init__(self, encode):
        self.encode, self.bytes, self.flushes = encode, [], 0

    def ingest(self, cont):
        self.bytes.append(self.encode(cont))

    append = ingest

    def flush_all(self):
        self.flushes += 1


def _samples(seed=3, n=300):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        schema = "prom-counter" if i % 3 else "gauge"
        labels = {"_ws_": "__rules__", "_ns_": "node0",
                  "_metric_": f"m{i % 7}:rate5m" if i % 3 == 0
                  else f"c{i % 5}_total", "job": f"job{i % 4}",
                  "instance": f"i{i % 11}"}
        out.append((schema, labels, T0S * 1000 + 60_000 * (i // 20),
                    float(rng.normal(100, 30))))
    out.append(("gauge", {"_metric_": "nan_and_inf", "k": "v"},
                T0S * 1000, float("nan")))
    out.append(("prom-counter", {"_metric_": "x_bucket", "le": "+Inf"},
                T0S * 1000, float("inf")))
    return out


@pytest.mark.parametrize("durable", [False, True], ids=["direct", "durable"])
def test_writeback_containers_are_byte_identical(durable):
    samples = _samples()

    def run(p):
        shard, stream = _Sink(p.encode), _Sink(p.encode)
        wb = p.wb.IngestWriteBack(shard, schemas=p.schemas,
                                  stream=stream if durable else None)
        assert wb.write(samples) == len(samples)
        wb.flush()
        got = stream if durable else shard
        return (got.bytes, shard.flushes, wb.samples_written, wb.durable,
                [p.wb.schema_for_sample(t, n) for t in
                 ("counter", "gauge", "histogram") for n in
                 ("x", "x_total", "x_bucket", "x_count", "x_sum", "rate")])
    port, jax_out = _both(run)
    assert port == jax_out
    assert port[0] and port[1] == (0 if durable else 1)


def test_writeback_into_a_shard_reads_back():
    def run(p):
        store = p.Store(p.schemas)
        shard = store.setup(p.Ref("__rules__"), 0, num_groups=2)
        wb = p.wb.IngestWriteBack(shard)
        wb.write(_samples(n=60))
        wb.flush()
        parts = shard.lookup_partitions([], 0, 1 << 62)
        return sorted(tuple(sorted(dict(x.part_key.labels).items()))
                      for x in parts), shard.ingest_watermark_ms
    port, jax_out = _both(run)
    assert port == jax_out and port[1] > 0


# -- the engine under a scripted evaluator ---------------------------------

class _Scripted:
    """Evaluator: rule expr -> [(labels, value)] at every step of the grid;
    exprs in ``raise_for`` raise. Records every call."""

    def __init__(self, grid_cls):
        self.grid_cls = grid_cls
        self.series, self.calls, self.raise_for = {}, [], set()

    def __call__(self, ds, query, plan, start_ms, step_ms, end_ms):
        self.calls.append((ds, query, start_ms, step_ms, end_ms))
        if query in self.raise_for:
            raise RuntimeError("injected eval failure")
        rows = self.series.get(query, [])
        steps = np.arange(start_ms, end_ms + 1, step_ms, dtype=np.int64)
        values = np.full((len(rows), steps.size), np.nan)
        for i, (_, v) in enumerate(rows):
            values[i, :] = v
        return (self.grid_cls(steps, [dict(lab) for lab, _ in rows], values),
                {"resultCache": "partial", "cachedSteps": steps.size - 1})


class _WriteSpy:
    """A write-back that keeps every sample and flush."""

    def __init__(self):
        self.samples, self.flushes = [], 0

    def write(self, samples):
        samples = list(samples)
        self.samples.extend(samples)
        return len(samples)

    def flush(self):
        self.flushes += 1


class _NotifySpy:
    def __init__(self):
        self.items = []

    def enqueue(self, n):
        self.items.append(n)
        return True

    def stop(self, timeout=None):
        pass


# durations (wall seconds) differ between runs and packages
_DURATIONS = {"evaluationTime", "duration_s", "last_tick_s"}


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _DURATIONS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


HOT = "rate(x_total[1m]) > 1"
REC = "sum by (job) (rate(x_total[1m]))"
# per scenario: the rule's for:, then per tick (seconds after T0S) the
# alert expression's series or "raise"
SCENARIOS = {
    "life-cycle": (20.0, [(0, []), (10, [({"instance": "i0"}, 3.0)]),
                          (20, [({"instance": "i0"}, 3.5)]),
                          (30, [({"instance": "i0"}, 4.0)]),
                          (40, [({"instance": "i0"}, 4.0),
                                ({"instance": "i1"}, 2.0)]),
                          (50, [({"instance": "i1"}, 2.0)]),
                          (60, [])]),
    "for-zero": (0.0, [(0, [({}, 9.0)]), (10, [({}, 9.5)]), (20, [])]),
    "no-flap-on-error": (0.0, [(0, [({"instance": "i0"}, 2.0)]),
                               (10, "raise"), (20, "raise"),
                               (30, [({"instance": "i0"}, 2.5)])]),
    "pending-drops-out": (30.0, [(0, [({"instance": "i0"}, 2.0)]),
                                 (10, []),
                                 (20, [({"instance": "i0"}, 2.0)]),
                                 (30, [({"instance": "i0"}, 2.0)]),
                                 (60, [({"instance": "i0"}, 2.0)])]),
}


def _run_scenario(p, name):
    for_s, ticks = SCENARIOS[name]
    loader = p.loader
    g = loader.RuleGroup("g", 10.0, (
        loader.Rule("job:x:rate1m", REC, "recording",
                    labels=(("tier", "gold"),)),
        loader.Rule("Hot", HOT, "alerting", for_s=for_s,
                    labels=(("severity", "page"),),
                    annotations=(("summary",
                                  "{{ $labels.instance }} at {{ $value }}"),
                                 ))))
    ev, wb, spy = _Scripted(p.Grid), _WriteSpy(), _NotifySpy()
    clock = {"t": float(T0S)}
    eng = p.engine.RulesEngine([g], evaluator=ev, writeback=wb,
                               default_dataset="ts", node="n0",
                               notifier=spy, clock=lambda: clock["t"])
    ev.series[REC] = [({"job": "a"}, 1.25), ({"job": "b"}, 0.5)]
    states = []
    for dt, series in ticks:
        clock["t"] = T0S + dt
        if series == "raise":
            ev.raise_for.add(HOT)
        else:
            ev.raise_for.discard(HOT)
            ev.series[HOT] = series
        eng.eval_group_once(g, T0S + dt)
        states.append(_strip({
            "alerts": eng.alerts_payload(),
            "rules": eng.rules_payload(explain=True),
            "debug": eng.snapshot()}))
    return {"states": states, "samples": wb.samples,
            "flushes": wb.flushes, "notified": spy.items,
            "calls": ev.calls}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_alert_life_cycle_matches_the_jax_engine(name):
    port, jax_out = _both(lambda p: _run_scenario(p, name))
    assert port == jax_out
    walk = [(t["from"], t["to"]) for t in
            port["states"][-1]["alerts"]["transitions"]]
    want = {
        "life-cycle": [("inactive", "pending"), ("pending", "firing"),
                       ("inactive", "pending"), ("firing", "inactive"),
                       ("pending", "inactive")],
        "for-zero": [("inactive", "firing"), ("firing", "inactive")],
        "no-flap-on-error": [("inactive", "firing")],
        "pending-drops-out": [("inactive", "pending"),
                              ("pending", "inactive"),
                              ("inactive", "pending"),
                              ("pending", "firing")],
    }[name]
    assert walk == want
    if name == "no-flap-on-error":
        (rule,) = [r for r in port["states"][1]["rules"]["groups"][0]["rules"]
                   if r["name"] == "Hot"]
        assert rule["health"] == "err" and rule["state"] == "firing"
        assert "injected eval failure" in rule["lastError"]
    # ALERTS/ALERTS_FOR_STATE and the recorded series rode the rail, one
    # flush a tick
    names = {s[1]["_metric_"] for s in port["samples"]}
    assert {"job:x:rate1m", "ALERTS", "ALERTS_FOR_STATE"} <= names
    assert port["flushes"] == len(SCENARIOS[name][1])


def test_recording_rule_samples_and_the_tail_grid_match():
    """A recording rule's samples (labels re-tagged into __rules__, the
    rule's labels applied, the schema by name or by ``schema:``) and the
    evaluation grid (span_steps steps ending at the aligned boundary)."""
    def run(p):
        loader = p.loader
        g = loader.RuleGroup("g", 10.0, (
            loader.Rule("job:x:rate", "rate(x_total[1m])", "recording",
                        labels=(("tier", "gold"),)),
            loader.Rule("job:x:events_total", "sum(increase(x_total[1m]))",
                        "recording", schema="counter"),
            loader.Rule("job:x:level", "sum(x_total)", "recording",
                        schema="gauge")))
        ev, wb = _Scripted(p.Grid), _WriteSpy()
        eng = p.engine.RulesEngine([g], evaluator=ev, writeback=wb,
                                   default_dataset="ts", node="n0",
                                   span_steps=6)
        ev.series["rate(x_total[1m])"] = [
            ({"_metric_": "x_total", "_ws_": "demo", "instance": "i0",
              "tier": "tin"}, 1.5), ({"instance": "i1"}, float("nan"))]
        ev.series["sum(increase(x_total[1m]))"] = [({}, 60.0)]
        ev.series["sum(x_total)"] = [({}, 7.0)]
        eng.eval_group_once(g, T0S + 105)       # unaligned on purpose
        eng.eval_group_once(g, T0S + 115)
        return wb.samples, ev.calls
    port, jax_out = _both(run)
    assert port == jax_out
    samples, calls = port
    assert calls[0][2:] == ((T0S + 50) * 1000, 10_000, (T0S + 100) * 1000)
    assert [s[0] for s in samples[:3]] == ["gauge", "prom-counter", "gauge"]
    assert samples[0][1] == {"_ws_": "__rules__", "_ns_": "n0",
                             "_metric_": "job:x:rate", "instance": "i0",
                             "tier": "gold"}


def test_a_group_over_its_limit_fails_its_rule():
    def run(p):
        g = p.loader.RuleGroup("g", 10.0, (p.loader.Rule(
            "r:x", "sum(x)", "recording"),), limit=1)
        ev = _Scripted(p.Grid)
        eng = p.engine.RulesEngine([g], evaluator=ev, writeback=_WriteSpy())
        ev.series["sum(x)"] = [({"i": "0"}, 1.0), ({"i": "1"}, 2.0)]
        eng.eval_group_once(g, T0S)
        return _strip(eng.rules_payload())
    port, jax_out = _both(run)
    assert port == jax_out
    assert "over the group limit" in \
        port["groups"][0]["rules"][0]["lastError"]


def test_rule_plans_are_cached_rebased_and_invalidated():
    def run(p):
        g = p.loader.RuleGroup("g", 10.0, (p.loader.Rule(
            "r:x", "rate(x_total[1m])", "recording"),))
        ev = _Scripted(p.Grid)
        eng = p.engine.RulesEngine([g], evaluator=ev, writeback=_WriteSpy())
        ev.series["rate(x_total[1m])"] = [({}, 1.0)]
        out = []
        for at in (10, 20, "invalidate", 30):
            if at == "invalidate":
                eng.invalidate_plans("topology")
                continue
            eng.eval_group_once(g, T0S + at)
            le = eng.rules_payload(explain=True)["groups"][0]["rules"][0]
            out.append(le["lastEval"]["stages"]["rulePlanCache"])
        return out, eng.snapshot()["plan_invalidations"]
    port, jax_out = _both(run)
    assert port == jax_out == (["miss", "hit", "miss"], 1)


def test_due_scheduling_claims_then_counts_missed_boundaries():
    def run(p):
        g = p.loader.RuleGroup("g", 10.0, (p.loader.Rule(
            "r:x", "sum(x)", "recording"),))
        ev = _Scripted(p.Grid)
        eng = p.engine.RulesEngine([g], evaluator=ev, writeback=_WriteSpy(),
                                   clock=lambda: float(T0S))
        ev.series["sum(x)"] = [({}, 1.0)]
        ran = [eng.evaluate_due(now_s=T0S + t) for t in (105, 107, 112, 145)]
        missed = {tuple(sorted(lab.items())): v
                  for lab, v in eng._m_missed.series()}
        return ran, [c[4] for c in ev.calls], missed[(("group", "g"),)]
    port, jax_out = _both(run)
    assert port[:2] == jax_out[:2] == (
        [0, 0, 1, 1], [(T0S + 110) * 1000, (T0S + 140) * 1000])
    # the registries are process-global: earlier engines of the same group
    # name may have counted misses too
    assert port[2] >= 2 and jax_out[2] >= 2


# -- the webhook notifier --------------------------------------------------

class _Receiver:
    """A loopback webhook receiver: answers 503 to the first ``fail``
    POSTs, then 200; keeps the bodies it accepted."""

    def __init__(self, fail=0):
        self.fail, self.bodies, self.attempts = fail, [], 0
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length") or 0))
                outer.attempts += 1
                code = 503 if outer.fail > 0 else 200
                if outer.fail > 0:
                    outer.fail -= 1
                else:
                    outer.bodies.append(json.loads(body))
                self.send_response(code)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/hook"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def wait(self, n, timeout=30.0):
        deadline = time.monotonic() + timeout
        while len(self.bodies) < n:
            assert time.monotonic() < deadline, "webhook not delivered"
            time.sleep(0.02)
        return self.bodies

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


NOTIFICATION = {"status": "firing",
                "labels": {"alertname": "Hot", "job": "job2"},
                "annotations": {"summary": "hot at 3.5"}, "value": 3.5,
                "activeAt": float(T0S + 60), "at": float(T0S + 180),
                "group": "g"}


@pytest.mark.parametrize("fail", [0, 2], ids=["healthy", "flaky"])
def test_webhook_payloads_and_retries_match(fail):
    def run(p):
        rcv = _Receiver(fail=fail)
        n = p.notify.WebhookNotifier(
            rcv.url, retry=p.Retry(max_attempts=4, base_delay_s=0.01))
        n.start()
        try:
            assert n.enqueue(dict(NOTIFICATION))
            assert n.enqueue(dict(NOTIFICATION, status="resolved"))
            bodies = rcv.wait(2)
        finally:
            n.stop()
            rcv.close()
        snap = n.snapshot()
        (entry,) = n.breakers.metrics_snapshot().values()
        return (bodies, rcv.attempts, snap["delivered"], snap["failed"],
                entry["retries"], entry["state"])
    port, jax_out = _both(run)
    assert port == jax_out
    bodies, attempts, delivered, failed, retries, breaker = port
    assert [b["status"] for b in bodies] == ["firing", "resolved"]
    assert bodies[0] == {"version": "4", "status": "firing",
                         "receiver": "filodb-rules", "alerts": [{
                             "status": "firing",
                             "labels": NOTIFICATION["labels"],
                             "annotations": NOTIFICATION["annotations"],
                             "value": 3.5, "activeAt": T0S + 60.0}]}
    assert (attempts, delivered, failed, retries, breaker) == \
        (2 + fail, 2, 0, fail, "closed")


def test_a_full_notifier_queue_drops_instead_of_blocking():
    def run(p):
        n = p.notify.WebhookNotifier("http://127.0.0.1:1/none",
                                     queue_size=2)
        return [n.enqueue({"status": "firing"}) for _ in range(3)], \
            n.snapshot()["dropped"]
    assert _both(run) == (([True, True, False], 1),) * 2


def test_a_dead_receiver_exhausts_its_retries():
    def run(p):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()[1]
        n = p.notify.WebhookNotifier(
            f"http://127.0.0.1:{dead}/hook",
            retry=p.Retry(max_attempts=2, base_delay_s=0.01), timeout_s=1.0)
        with pytest.raises(Exception, match="unreachable"):
            n.deliver(dict(NOTIFICATION))
        (entry,) = n.breakers.metrics_snapshot().values()
        return entry
    port, jax_out = _both(run)
    assert port == jax_out == {"attempts": 2, "retries": 1,
                               "exhaustions": 1, "rejections": 0,
                               "state": "closed"}


# -- the election ----------------------------------------------------------

# (seconds after T0S, event, ordinal) applied to engine ordinal 1 of 3
ELECTIONS = {
    "evaluator-dies": [(5, "exit", 0), (30, "up", 0)],
    "two-die": [(5, "exit", 0), (8, "exit", 2), (12, "exit", 1),
                (20, "up", 2), (25, "up", 0)],
    "own-announce": [(3, "up", 1), (5, "exit", 0), (9, "up", 0)],
    "out-of-range": [(4, "up", 7), (6, "exit", 0), (7, "exit", 9)],
}


@pytest.mark.parametrize("announced", [True, False])
@pytest.mark.parametrize("name", sorted(ELECTIONS))
def test_election_sequences_match_the_jax_engine(name, announced):
    def run(p):
        clock = {"t": float(T0S)}
        g = p.loader.RuleGroup("g", 10.0, (p.loader.Rule(
            "r:x", "sum(x)", "recording"),))
        eng = p.engine.RulesEngine(
            [g], evaluator=_Scripted(p.Grid), writeback=_WriteSpy(),
            worker_id=1, num_workers=3, announced=announced,
            clock=lambda: clock["t"])
        flags = [(eng.snapshot()["active"], eng.evaluator_ordinal())]
        for dt, ev, ordinal in ELECTIONS[name]:
            clock["t"] = T0S + dt
            (eng.note_worker_exit if ev == "exit"
             else eng.note_worker_up)(ordinal)
            flags.append((eng.snapshot()["active"], eng.evaluator_ordinal()))
        snap = eng.snapshot()
        return flags, snap["election_log"], snap["alive_ordinals"], \
            snap["announced"]
    port, jax_out = _both(run)
    assert port == jax_out


def _walk(p):
    """Three engines (ordinals 0-2) polled every second from T0S for
    200 s; ordinal 0 dies at +103 (the others learn it at +105) and a new
    ordinal 0 starts at +151, announced to all at +152 -> (evaluated
    boundaries in order with their evaluator, election logs)."""
    clock = {"t": float(T0S)}
    g = p.loader.RuleGroup("g", 10.0, (p.loader.Rule(
        "r:x", "sum(x)", "recording"),))
    ran = []

    def mk(ordinal, announced=True):
        def evaluator(ds, query, plan, s, st, e):
            ran.append((e // 1000 - T0S, ordinal))
            return p.Grid(np.arange(s, e + 1, st), [{}],
                          np.ones((1, (e - s) // st + 1))), {}
        return p.engine.RulesEngine(
            [g], evaluator=evaluator, writeback=_WriteSpy(),
            worker_id=ordinal, num_workers=3, announced=announced,
            clock=lambda: clock["t"])
    live = {k: mk(k) for k in range(3)}
    logs = []
    for t in range(0, 201):
        clock["t"] = T0S + t
        if t == 103:
            logs.append(live.pop(0).snapshot()["election_log"])
        if t == 105:
            for e in live.values():
                e.note_worker_exit(0)
        if t == 151:
            live[0] = mk(0, announced=False)
        if t == 152:
            for e in live.values():
                e.note_worker_up(0)
        for k in sorted(live):
            live[k].evaluate_due(now_s=T0S + t)
    logs += [live[k].snapshot()["election_log"] for k in sorted(live)]
    return ran, logs


def test_failover_walk_misses_and_duplicates_no_tick():
    port, jax_out = _both(_walk)
    assert port == jax_out
    ran, _ = port
    boundaries = [b for b, _ in ran]
    # the first due check of each engine only claims its boundary
    assert boundaries == list(range(10, 201, 10))
    assert {b: o for b, o in ran} == {
        b: (0 if b <= 100 or b >= 160 else 1) for b in boundaries}


def test_without_a_supervisor_every_node_evaluates():
    """worker-id None: ordinal 0 and announced, whatever num-nodes says
    (the reference's behaviour, kept)."""
    def run(p):
        g = p.loader.RuleGroup("g", 10.0, (p.loader.Rule(
            "r:x", "sum(x)", "recording"),))
        out = []
        for announced in (True, False):
            eng = p.engine.RulesEngine(
                [g], evaluator=_Scripted(p.Grid), writeback=_WriteSpy(),
                worker_id=None, num_workers=2, announced=announced)
            snap = eng.snapshot()
            out.append((snap["active"], snap["ordinal"],
                        snap["alive_ordinals"], eng.evaluator_ordinal()))
        return out
    port, jax_out = _both(run)
    assert port == jax_out == [(True, 0, [0], 0)] * 2


# -- servers of both packages, ticked at the data's time -------------------

T0 = T0S * 1000
DT = 10_000
N = 120
STEP_S = 60
# the first tick boundary (a multiple of the 60 s interval) with a full
# 5 m window of data, and the 8 boundaries ticked
B1 = (T0S + 600 + STEP_S - 1) // STEP_S * STEP_S
TICKS = [B1 + STEP_S * k for k in range(8)]
# past the data's end and its 5 m window: every alert resolves
B_GONE = (T0S + N * DT // 1000 + 300 + STEP_S) // STEP_S * STEP_S
# the alert threshold between job1's and job2's group rates (about 0.65
# and 0.98 per second)
THRESHOLD = 0.8


def _rows(seed=11, S=12, S_irr=6):
    """Counters whose job k grows at about (k + 1) x 0.1/s a series, and
    irregular counters, as (labels, ts ms, values) triples."""
    rng = np.random.default_rng(seed)
    ctr, irr = [], []
    for i in range(S):
        k = i % 4
        ts = T0 + np.arange(N) * DT + rng.integers(-2000, 2000, N)
        v = 1e6 + np.cumsum(rng.uniform(0, 2 * (k + 1), N))
        if i == 5:
            v[N // 2:] -= v[N // 2 - 1]           # a counter reset
        ctr.append(({"_metric_": "http_requests_total", "_ws_": "demo",
                     "_ns_": "App-0", "job": f"job{k}",
                     "instance": f"i{i}"}, ts, v))
    for i in range(S_irr):
        ts = np.unique(T0 + np.arange(N) * DT
                       + rng.integers(-6000, 6000, N))
        irr.append(({"_metric_": "irregular_total", "_ws_": "demo",
                     "_ns_": "App-0", "job": f"job{i % 2}",
                     "instance": f"k{i}"}, ts,
                    np.cumsum(rng.uniform(0, 3, ts.size))))
    return ctr, irr


def _load_jax(srv, rows, schema):
    builders = {}
    sch = J_SCHEMAS.by_name(schema)
    for lab, ts, vals in rows:
        pk = JPartKey.make(sch, lab)
        sh = j_ingestion_shard(pk.shard_key_hash(JPartitionSchema()),
                               pk.part_hash(), 1, 4)
        if sh not in srv.owned_shards:
            continue
        b = builders.setdefault(sh, JBuilder(J_SCHEMAS))
        for t, v in zip(ts, vals):
            b.add_sample(schema, lab, int(t), float(v))
    for sh, b in builders.items():
        for c in b.containers():
            srv.store.ingest(srv.ref, sh, c)
    srv.store.flush_all(srv.ref)


def _load_port(srv, rows, schema):
    from filodb_tpu_torch.core.record import PartKey, ingestion_shard
    from filodb_tpu_torch.core.schemas import PartitionSchema
    sch = P_SCHEMAS.by_name(schema)
    by_shard = {}
    for lab, ts, vals in rows:
        pk = PartKey.make(sch, lab)
        sh = ingestion_shard(pk.shard_key_hash(PartitionSchema()),
                             pk.part_hash(), 1, 4)
        by_shard.setdefault(sh, []).append((lab, ts, vals))
    for sh, part in sorted(by_shard.items()):
        if sh in srv.owned_shards:
            state.load_series(srv.store.get_shard(srv.ref, sh), part,
                              schema, True)


def _load(srv, rows):
    ctr, irr = rows
    load = _load_port if isinstance(srv, psrv.FiloServer) else _load_jax
    load(srv, ctr, "prom-counter")
    load(srv, irr, "prom-counter")


RULES = {"groups": [
    {"name": "job-rates", "interval": "60s", "rules": [
        {"record": "job:http_requests:rate5m",
         "expr": "sum by (job) (rate(http_requests_total[5m]))"}]},
    {"name": "irregular", "interval": "60s", "rules": [
        {"record": "irregular:rate5m", "expr": "rate(irregular_total[5m])"}]},
    {"name": "alerts", "interval": "60s", "rules": [
        {"alert": "JobRequestRateHigh",
         "expr": f"sum by (job) (rate(http_requests_total[5m])) > "
                 f"{THRESHOLD}",
         "for": "2m", "labels": {"severity": "page"},
         "annotations": {"summary": "{{ $labels.job }} at {{ $value }}"}}]},
]}


def _hold(srv):
    """End the server's wall-clock scheduler thread (its stop event set
    and the thread joined): from here only deterministic ticks evaluate;
    the notifier and the collectors keep running."""
    eng = srv.rules
    eng._stop_evt.set()
    eng._thread.join(30)
    assert not eng.alive


def _tick(srv, at_s):
    return [srv.rules.eval_group_once(g, at_s) for g in srv.rules.groups]


def _get(port, path, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params, doseq=True)
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _close(a, b, path=""):
    """Equal structure; floats within the grouped tolerance (rtol 1e-5);
    durations skipped."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            if k not in _DURATIONS:
                _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert np.isclose(a, b, rtol=1e-5, atol=1e-9), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _close_text(a, b):
    """An annotation that ends in a value: the words equal, the number
    within the grouped tolerance."""
    wa, wb = a.split(), b.split()
    assert wa[:-1] == wb[:-1], (a, b)
    assert np.isclose(float(wa[-1]), float(wb[-1]), rtol=1e-5), (a, b)


def _alerts_close(pa, ja):
    """Alert lists alike: the summary annotation by _close_text, the
    rest by _close."""
    assert len(pa) == len(ja)
    for u, v in zip(pa, ja):
        u, v = json.loads(json.dumps(u)), json.loads(json.dumps(v))
        su = u.get("annotations", {}).pop("summary", None)
        sv = v.get("annotations", {}).pop("summary", None)
        assert (su is None) == (sv is None)
        if su is not None:
            _close_text(su, sv)
        _close(u, v)


def _split_alerts(payload):
    """Pops the alert lists out of a /api/v1/rules payload -> the lists."""
    return [r.pop("alerts", []) for g in payload["data"]["groups"]
            for r in g["rules"]]


@pytest.fixture(scope="module")
def rule_servers():
    """A port server and a JAX server with RULES, self-monitoring off, each
    notifying its own loopback receiver, both held and ticked at TICKS,
    then once at B_GONE -> (port, jax, receivers, per-tick explain
    payloads)."""
    rows = _rows()
    rcv = [_Receiver(), _Receiver()]
    base = {"num-shards": 4, "port": 0, "grpc-port": None,
            "gc-freeze": False, "rules": RULES}
    # each held as soon as it has started: its scheduler thread polls first
    # after 0.25 s, and that poll only claims the wall-clock boundary
    port = psrv.FiloServer({**base, "device": "cpu",
                            "rules-webhook-url": rcv[0].url}).start()
    _hold(port)
    jax_srv = JServer({**base, "rules-webhook-url": rcv[1].url}).start()
    _hold(jax_srv)
    explains = []
    try:
        for srv in (port, jax_srv):
            _load(srv, rows)
        for at in TICKS:
            got = []
            for srv in (port, jax_srv):
                out = _tick(srv, at)
                assert all(o["ok"] for o in out), out
                got.append(_get(srv.port, "/api/v1/rules",
                                explain="analyze")[1])
            explains.append(got)
        yield port, jax_srv, rcv, explains
    finally:
        port.stop()
        jax_srv.stop()
        for r in rcv:
            r.close()


def test_recorded_series_match_the_jax_server(rule_servers):
    port, jax_srv, _, _ = rule_servers
    for q, tol in (("job:http_requests:rate5m", 1e-5),
                   ("irregular:rate5m", None)):
        (pc, pd), (jc, jd) = (_get(s.port,
                                   "/promql/__rules__/api/v1/query_range",
                                   query=q, start=TICKS[0], end=TICKS[-1],
                                   step=STEP_S) for s in (port, jax_srv))
        assert pc == jc == 200
        pr, jr = pd["data"]["result"], jd["data"]["result"]
        assert [e["metric"] for e in pr] == [e["metric"] for e in jr]
        assert len(pr) == (4 if tol else 6)
        for pe, je in zip(pr, jr):
            pv = np.asarray(pe["values"], np.float64)
            jv = np.asarray(je["values"], np.float64)
            assert list(pv[:, 0]) == list(jv[:, 0]) == TICKS
            if tol:
                np.testing.assert_allclose(pv[:, 1], jv[:, 1], rtol=tol)
            else:
                ulps = np.abs(pv[:, 1] - jv[:, 1]) / np.spacing(
                    np.maximum(np.abs(pv[:, 1]), np.abs(jv[:, 1])))
                assert (ulps <= 4).all(), (pe["metric"], ulps)
        assert pr[0]["metric"]["_ws_"] == "__rules__"


def test_alert_state_series_match_the_jax_server(rule_servers):
    port, jax_srv, _, _ = rule_servers
    for q in ('ALERTS{alertstate="pending"}', 'ALERTS{alertstate="firing"}',
              "ALERTS_FOR_STATE"):
        (pc, pd), (jc, jd) = (_get(s.port,
                                   "/promql/__rules__/api/v1/query_range",
                                   query=q, start=TICKS[0], end=TICKS[-1],
                                   step=STEP_S) for s in (port, jax_srv))
        assert pc == jc == 200
        assert pd["data"] == jd["data"], q
        jobs = sorted(e["metric"]["job"] for e in pd["data"]["result"])
        assert jobs == ["job2", "job3"], (q, jobs)
    firing = pd = _get(port.port, "/promql/__rules__/api/v1/query_range",
                       query='ALERTS{alertstate="firing"}',
                       start=TICKS[0], end=TICKS[-1], step=STEP_S)[1]
    # pending at ticks 1-2, firing from tick 3 (for: 2m at 60 s)
    assert [float(t) for t, _ in
            firing["data"]["result"][0]["values"]] == TICKS[2:]
    del pd


def test_explain_shows_a_cold_tick_then_partial_hits(rule_servers):
    _, _, _, explains = rule_servers
    for k, (pd, jd) in enumerate(explains):
        for x, y in zip(_split_alerts(pd), _split_alerts(jd)):
            _alerts_close(x, y)
        _close(pd, jd)
        for g in pd["data"]["groups"]:
            for r in g["rules"]:
                st = r["lastEval"]["stages"]
                assert st["resultCache"] == ("miss" if k == 0
                                             else "partial"), (k, r)
                assert st["cachedSteps"] == (0 if k == 0 else 7)
                assert st["rulePlanCache"] == ("miss" if k == 0 else "hit")


def test_rules_and_alerts_apis_match_the_jax_server(rule_servers):
    port, jax_srv, _, _ = rule_servers
    for path, params in (("/api/v1/rules", {}),
                         ("/api/v1/rules", {"explain": "analyze"}),
                         ("/api/v1/rules", {"debug": "1"}),
                         ("/api/v1/alerts", {})):
        (pc, pd), (jc, jd) = (_get(s.port, path, **params)
                              for s in (port, jax_srv))
        assert pc == jc == 200
        if path == "/api/v1/alerts":
            _alerts_close(pd["data"].pop("alerts"), jd["data"].pop("alerts"))
        else:
            for x, y in zip(_split_alerts(pd), _split_alerts(jd)):
                _alerts_close(x, y)
        _close(pd, jd)
    _, alerts = _get(port.port, "/api/v1/alerts")
    firing = sorted(a["labels"]["job"] for a in alerts["data"]["alerts"]
                    if a["state"] == "firing")
    assert firing == ["job2", "job3"]


def test_webhook_bodies_and_resolution_match_the_jax_server(rule_servers):
    port, jax_srv, rcv, _ = rule_servers
    pb, jb = rcv[0].wait(2), rcv[1].wait(2)
    assert sorted(b["alerts"][0]["labels"]["job"] for b in pb) == \
        ["job2", "job3"]
    # past the data: the firing alerts resolve, the state series stop
    for srv in (port, jax_srv):
        assert all(o["ok"] for o in _tick(srv, B_GONE))
    pb, jb = rcv[0].wait(4), rcv[1].wait(4)

    def key(b):
        return b["status"], b["alerts"][0]["labels"]["job"]
    pb, jb = sorted(pb, key=key), sorted(jb, key=key)
    assert [key(b) for b in pb] == [key(b) for b in jb] == [
        ("firing", "job2"), ("firing", "job3"), ("resolved", "job2"),
        ("resolved", "job3")]
    _alerts_close([b["alerts"][0] for b in pb], [b["alerts"][0] for b in jb])
    for srv in (port, jax_srv):
        _, alerts = _get(srv.port, "/api/v1/alerts")
        assert alerts["data"]["alerts"] == []
        walk = [(t["from"], t["to"])
                for t in alerts["data"]["transitions"]
                if t["labels"]["job"] == "job2"]
        assert walk == [("inactive", "pending"), ("pending", "firing"),
                        ("firing", "inactive")]


def test_rule_families_ride_metrics_as_in_the_jax_server(rule_servers):
    port, jax_srv, _, _ = rule_servers

    def fams(srv):
        text = srv.http.build_exposition().render()
        return {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE filodb_rule")
                or ln.startswith("# TYPE filodb_alert")}
    assert fams(port) == fams(jax_srv)
    assert {"filodb_rule_evals_total", "filodb_rule_group_ticks_total",
            "filodb_rule_samples_written_total",
            "filodb_alert_transitions_total"} <= fams(port)


def test_lint_sees_the_rules_schemas():
    """promlint on user queries reads the recording rules' ``schema:``:
    rate() over a rule declared a gauge warns in both servers."""
    rules = {"groups": [{"name": "g", "interval": "60s", "rules": [
        {"record": "g:level", "expr": "sum(heap_usage)",
         "schema": "gauge"}]}]}
    base = {"port": 0, "grpc-port": None, "gc-freeze": False,
            "rules": rules}
    port = psrv.FiloServer({**base, "device": "cpu"}).start()
    jax_srv = JServer(base).start()
    try:
        out = []
        for srv in (port, jax_srv):
            _hold(srv)
            out.append(_get(srv.port,
                            "/promql/timeseries/api/v1/query_range",
                            query="rate(g:level[5m])", start=T0S,
                            end=T0S + 600, step=60, lint="strict"))
    finally:
        port.stop()
        jax_srv.stop()
    (pc, pd), (jc, jd) = out
    assert pc == jc and pd == jd
    assert pc == 400 and "promlint" in pd["error"]


def test_a_rules_file_and_the_cli_flags_start_the_engine(tmp_path,
                                                          monkeypatch):
    path = tmp_path / "rules.yaml"
    path.write_text(_YAML)
    srv = psrv.FiloServer({"port": 0, "grpc-port": None, **CPU,
                           "rules-file": str(path)}).start()
    try:
        assert [g.name for g in srv.rules.groups] == ["g"]
        assert srv.rules.alive and srv.http.rules is srv.rules
        assert "__rules__" in srv.http.shards_by_dataset
    finally:
        srv.stop()
    assert not srv.rules.alive
    seen = {}

    class _Stop(Exception):
        pass

    def fake_server(config):
        seen.update(config)
        raise _Stop
    monkeypatch.setattr(psrv, "FiloServer", fake_server)
    with pytest.raises(_Stop):
        psrv.main(["--rules-file", str(path), "--self-monitor", "--device",
                   "cpu"])
    assert seen == {"rules-file": str(path), "self-monitor": True,
                    "device": "cpu"}


def test_the_rules_engine_runs_on_cuda_unless_told():
    """The server with rules builds its backend on CUDA by default: on a
    host without a card start() raises before any engine exists."""
    srv = psrv.FiloServer({"port": 0, "rules": RULES, "self-monitor": True})
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        srv.start()
    assert srv.rules is None and srv.selfmon is None


# -- two-node clusters with a node stopped ---------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CHAOS_RULES = {"groups": [{"name": "chaos", "interval": "60s", "rules": [
    {"record": "chaos:requests:rate5m",
     "expr": "sum(rate(http_requests_total[5m]))"},
    {"alert": "ChaosData", "expr": "sum(rate(http_requests_total[5m])) > 0",
     "labels": {"severity": "page"}}]}]}


def _cluster_config(ports, ordinal):
    return {"num-shards": 4, "num-nodes": 2, "node-ordinal": ordinal,
            "port": ports[ordinal], "grpc-port": None, "gc-freeze": False,
            "peers": {f"node{i}": f"http://127.0.0.1:{p}"
                      for i, p in enumerate(ports)},
            # detection never reacts: the rule's fan-out meets the dead peer
            "failure-detect-interval-s": 300.0,
            "query-timeout-s": 5.0, "peer-retry-attempts": 1,
            "peer-retry-base-delay-s": 0.01,
            "breaker-failure-threshold": 1_000_000,
            "rules": CHAOS_RULES}


def _staleness(srv):
    """The chaos group's staleness gauge: the registry collector sets it
    while one exposition builds, the next one renders it."""
    srv.http.build_exposition()
    for ln in srv.http.build_exposition().render().splitlines():
        if ln.startswith("filodb_rule_group_staleness_seconds") \
                and 'group="chaos"' in ln:
            return float(ln.rsplit(" ", 1)[1])
    return None


def _chaos_walk(cls, extra):
    """node0 and node1 (both with CHAOS_RULES, held); ticks at TICKS[0:2]
    healthy, node1 stopped, ticks at TICKS[2:4], node1 restarted on its
    port with its data, tick at TICKS[4] -> the readings."""
    rows = _rows()
    ports = [_free_port(), _free_port()]
    nodes = []
    for i in range(2):
        nodes.append(cls({**_cluster_config(ports, i), **extra}).start())
        _hold(nodes[-1])
    out = {"active": [(n.rules.snapshot()["active"],
                       n.rules.evaluator_ordinal()) for n in nodes]}
    try:
        for n in nodes:
            _load(n, rows)
        a = nodes[0]

        def tick(at):
            (res,) = _tick(a, at)
            rs = {r["name"]: r for r in
                  a.rules.rules_payload()["groups"][0]["rules"]}
            return (res["ok"], rs["chaos:requests:rate5m"]["health"],
                    rs["ChaosData"]["state"])
        out["ticks"] = [tick(at) for at in TICKS[:2]]
        stale_ok = _staleness(a)
        nodes[1].stop()
        nodes[1] = None
        out["ticks"] += [tick(at) for at in TICKS[2:4]]
        stale_err = _staleness(a)
        out["stale_rose"] = stale_err > stale_ok
        err = a.rules.rules_payload()["groups"][0]["rules"][0]["lastError"]
        out["error_named"] = bool(err)
        nodes[1] = cls({**_cluster_config(ports, 1), **extra}).start()
        _hold(nodes[1])
        _load(nodes[1], rows)
        out["ticks"] += [tick(TICKS[4])]
        out["stale_fell"] = _staleness(a) < stale_err
        out["transitions"] = [
            (t["from"], t["to"])
            for t in a.rules.alerts_payload()["transitions"]]
        # the ticks that wrote a sample: a 30 s count at each boundary
        _, cnt = _get(a.port, "/promql/__rules__/api/v1/query_range",
                      query="count_over_time(chaos:requests:rate5m[30s])",
                      start=TICKS[0], end=TICKS[4], step=STEP_S)
        (series,) = cnt["data"]["result"]
        out["recorded_at"] = [float(t) for t, _ in series["values"]]
        _, rec = _get(a.port, "/promql/__rules__/api/v1/query_range",
                      query="chaos:requests:rate5m", start=TICKS[0],
                      end=TICKS[4], step=STEP_S)
        (series,) = rec["data"]["result"]
        out["recorded"] = [float(v) for t, v in series["values"]
                           if float(t) in out["recorded_at"]]
    finally:
        for n in nodes:
            if n is not None:
                n.stop()
    return out


def test_rules_ride_out_a_stopped_node_as_the_jax_cluster():
    port = _chaos_walk(psrv.FiloServer, {"device": "cpu"})
    jax_out = _chaos_walk(JServer, {})
    for k in ("active", "ticks", "stale_rose", "error_named", "stale_fell",
              "transitions", "recorded_at"):
        assert port[k] == jax_out[k], k
    np.testing.assert_allclose(port["recorded"], jax_out["recorded"],
                               rtol=1e-5)
    # without a supervisor both nodes take ordinal 0 and evaluate
    assert port["active"] == [(True, 0), (True, 0)]
    assert port["ticks"] == [(True, "ok", "firing")] * 2 \
        + [(False, "err", "firing")] * 2 + [(True, "ok", "firing")]
    assert port["stale_rose"] and port["error_named"] and port["stale_fell"]
    # the alert never flapped; recording skipped the failed ticks and
    # resumed after the restart
    assert port["transitions"] == [("inactive", "firing")]
    assert port["recorded_at"] == [TICKS[0], TICKS[1], TICKS[4]]
