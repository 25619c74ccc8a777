"""The port's process-sharded serving tier (``standalone/supervisor.py``,
``standalone/bus.py`` and the worker wiring of ``standalone/server.py``)
against the JAX package's.

  * the supervisor's pure functions (``split_quota``, ``worker_config``,
    ``aggregate_tenant_families``) give the JAX package's outputs on the
    same inputs;
  * the bus fans events out to every other worker, breaks the
    apply-republish loop, and speaks the JAX package's wire in both
    directions;
  * one worker in this process: the shared public port, its bus events
    (schema invalidation, worker-up, topology, watermark gossip) and its
    /metrics families;
  * a fleet of worker processes on the CPU over one small stream corpus:
    a 1-worker fleet's answers are the golden ones, and a 2-worker fleet
    answers byte for byte the same through its public port and both
    private ports, with the results cache off and on; the merged
    /metrics and /debug routes; /admin/invalidate; kill -9 of worker 0,
    its respawn and the rule evaluator's hand-over to worker 1 and back.

Every wait polls a condition under a deadline; no test asserts a
wall-clock duration or counts wall-clock rule ticks.
"""

import contextlib
import io
import json
import os
import select
import signal
import socket
import subprocess
import sys
import time
import urllib.parse
import urllib.request

import pytest

from filodb_tpu.standalone import bus as j_bus
from filodb_tpu.standalone import supervisor as j_sup
from filodb_tpu_torch import cli
from filodb_tpu_torch.standalone import bus as p_bus
from filodb_tpu_torch.standalone import server as psrv
from filodb_tpu_torch.standalone import supervisor as p_sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_600_000_000
N_SAMPLES = 50
N_INSTANCES = 4
NUM_SHARDS = 4
DEADLINE_S = 120.0

# one recording rule, at an interval no test waits for: it exists to show
# which worker is the elected evaluator
RULES = {"groups": [{"name": "fo", "interval": "1h", "rules": [
    {"record": "fo:tick:value", "expr": "time()"}]}]}


def _poll(fn, what: str, timeout: float = DEADLINE_S, interval=0.1):
    """fn() -> (ok, last) until ok, under a deadline -> last."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            ok, last = fn()
        except (OSError, ValueError) as e:
            ok, last = False, repr(e)
        if ok:
            return last
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}: {last!r}")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- the supervisor's pure functions against the JAX package's -------------

SPLITS = [(6, 4), (8, 4), (4, 4), (7, 3), (0, 4), (2, 4), (5, 1), (9, 2)]


@pytest.mark.parametrize("total,n", SPLITS,
                         ids=[f"{t}-over-{n}" for t, n in SPLITS])
def test_split_quota_matches_the_reference(total, n):
    got = p_sup.split_quota(total, n)
    assert got == j_sup.split_quota(total, n)
    assert len(got) == n
    if total >= n:
        assert sum(got) == total        # the aggregate bound holds


# name -> (base config, workers, accept fd)
BASES = {
    "derivation": ({"num-shards": 8, "max-inflight-queries": 6,
                    "results-cache-mb": 64, "gateway-port": 0,
                    "serving-workers": 4, "supervisor-port": 0,
                    "run-dir": "/x", "stream-dir": "/s"}, 4, None),
    "qos": ({"num-shards": 8, "qos-tenant-rate": 100.0,
             "qos-tenant-burst": 1000.0,
             "qos-tenant-overrides": {"abuser": 40.0, "vip": [80.0, 400.0]}},
            4, None),
    "qos-off": ({"num-shards": 8}, 4, None),
    "rules": ({"num-shards": 4, "rules": RULES, "rules-eval-span-steps": 4,
               "rules-webhook-url": "http://127.0.0.1:1/hook",
               "max-inflight-queries": 8}, 2, None),
    "self-monitor": ({"num-shards": 4, "self-monitor": True,
                      "self-monitor-interval-s": 2.5, "serving-workers": 2,
                      "supervisor-port": 0, "run-dir": "/x"}, 2, None),
    "fd-fallback": ({"num-shards": 4}, 2, 13),
    "device-cpu": ({"num-shards": 4, "device": "cpu"}, 2, None),
    "device-cuda": ({"num-shards": 4, "device": "cuda:0"}, 2, None),
}


@pytest.mark.parametrize("case", sorted(BASES))
def test_worker_config_matches_the_reference(case):
    base, n, fd = BASES[case]
    ports = [9001 + i for i in range(n)]
    cfgs = [p_sup.worker_config(base, i, n, ports, 8080, 7000, accept_fd=fd)
            for i in range(n)]
    assert cfgs == [j_sup.worker_config(base, i, n, ports, 8080, 7000,
                                        accept_fd=fd) for i in range(n)]
    for i, cfg in enumerate(cfgs):
        # every derived key is one the port's server honours
        assert not set(cfg) - set(psrv.DEFAULTS), set(cfg) - set(
            psrv.DEFAULTS)
        assert cfg["worker-id"] == cfg["node-ordinal"] == i
        assert ("accept-fd" in cfg) == (fd is not None) \
            == ("accept-port" not in cfg)
        if "device" in base:
            assert cfg["device"] == base["device"]     # verbatim
    quotas = [c["max-inflight-queries"] for c in cfgs]
    assert quotas == p_sup.split_quota(base.get("max-inflight-queries", 4),
                                       n)


_TENANT_W0 = """\
# HELP filodb_tenant_time_series_total Per-tenant series count
# TYPE filodb_tenant_time_series_total gauge
filodb_tenant_time_series_total{_ws_="demo",_ns_="App-0"} 40
# HELP filodb_tenant_budget_remaining Per-tenant token-bucket balance
# TYPE filodb_tenant_budget_remaining gauge
filodb_tenant_budget_remaining{tenant="abuser"} 25.0
# HELP filodb_tenant_throttled_total Budget charges refused
# TYPE filodb_tenant_throttled_total counter
filodb_tenant_throttled_total{tenant="abuser"} 3
# HELP filodb_plan_cache_hits_total Plan-cache hits
# TYPE filodb_plan_cache_hits_total counter
filodb_plan_cache_hits_total 7
"""
_TENANT_W1 = """\
# HELP filodb_tenant_time_series_total Per-tenant series count
# TYPE filodb_tenant_time_series_total gauge
filodb_tenant_time_series_total{_ws_="demo",_ns_="App-0"} 24
# HELP filodb_tenant_budget_remaining Per-tenant token-bucket balance
# TYPE filodb_tenant_budget_remaining gauge
filodb_tenant_budget_remaining{tenant="abuser"} -10.5
# HELP filodb_tenant_throttled_total Budget charges refused
# TYPE filodb_tenant_throttled_total counter
filodb_tenant_throttled_total{tenant="abuser"} 5
"""
TENANT_INPUTS = {"two-workers": {"0": _TENANT_W0, "1": _TENANT_W1},
                 "one-worker": {"0": _TENANT_W0}, "none": {}}


@pytest.mark.parametrize("case", sorted(TENANT_INPUTS))
def test_aggregate_tenant_families_matches_the_reference(case):
    by_worker = TENANT_INPUTS[case]
    got = p_sup.aggregate_tenant_families(by_worker)
    assert got == j_sup.aggregate_tenant_families(by_worker)
    if case == "two-workers":
        assert ('filodb_host_tenant_time_series_total'
                '{_ns_="App-0",_ws_="demo"} 64') in got
        assert "plan_cache" not in got      # tenant families only


# -- the control-plane bus ----------------------------------------------------

PKG = {"port": p_bus, "jax": j_bus}
# (hub, client a, client b): the port alone, and every way the two
# packages meet on the wire
BUS_MIXES = {"port": ("port", "port", "port"),
             "port-clients-on-a-jax-hub": ("jax", "port", "port"),
             "jax-clients-on-a-port-hub": ("port", "jax", "jax"),
             "mixed-clients": ("port", "port", "jax")}


@pytest.mark.parametrize("mix", sorted(BUS_MIXES))
def test_bus_fans_out_to_the_other_workers_not_the_sender(mix):
    hub_pkg, a_pkg, b_pkg = (PKG[k] for k in BUS_MIXES[mix])
    hub = hub_pkg.SupervisorBus().start()
    got_a, got_b = [], []
    a = a_pkg.BusClient(hub.port, 0, "node0").on(
        "schema", got_a.append).start()
    b = b_pkg.BusClient(hub.port, 1, "node1").on(
        "schema", got_b.append).start()
    try:
        assert a_pkg.wait_connected(a) and b_pkg.wait_connected(b)
        _poll(lambda: (hub.connected_workers() == [0, 1],
                       hub.connected_workers()), "both hellos")
        a.publish({"type": "schema", "reason": "col-added"})
        _poll(lambda: (len(got_b) == 1, got_b), "b's event")
        assert got_b[0] == {"type": "schema", "reason": "col-added",
                            "origin": "node0"}
        hub.broadcast({"type": "schema", "reason": "operator"})
        _poll(lambda: (len(got_a) == 1 and len(got_b) == 2,
                       (got_a, got_b)), "the broadcast")
        # the sender never heard its own event
        assert got_a == [{"type": "schema", "reason": "operator"}]
        assert a.metrics_snapshot() == {"published": 1, "applied": 1,
                                        "reconnects": 0, "connected": 1}
    finally:
        hub.stop()      # first: the JAX client's reader wakes on the EOF
        a.stop()
        b.stop()


@pytest.mark.parametrize("hub_pkg", ["port", "jax"])
def test_bus_apply_suppresses_republish(hub_pkg):
    """A handler that publishes in reaction to an applied event (as the
    mapper subscriber does) must not echo it back onto the bus."""
    hub = PKG[hub_pkg].SupervisorBus().start()
    got_b = []
    a = p_bus.BusClient(hub.port, 0, "node0")
    a.on("topology", lambda ev: a.publish(
        {"type": "topology", "shard": 0, "status": "active"})).start()
    b = p_bus.BusClient(hub.port, 1, "node1").on(
        "topology", got_b.append).start()
    try:
        assert p_bus.wait_connected(a) and p_bus.wait_connected(b)
        _poll(lambda: (hub.connected_workers() == [0, 1],
                       hub.connected_workers()), "both hellos")
        seen0 = hub.events_seen
        b.publish({"type": "topology", "shard": 0, "status": "active"})
        _poll(lambda: (a.applied >= 1, a.applied), "a applied it")
        # a marker from b after the applied event: once it is through the
        # hub, an echo of a's reaction would have been counted before it
        b.publish({"type": "marker"})
        _poll(lambda: (hub.events_seen - seen0 >= 2,
                       hub.events_seen - seen0), "the marker")
        assert hub.events_seen - seen0 == 2
        assert got_b == [] and a.metrics_snapshot()["published"] == 0
    finally:
        hub.stop()      # first: the JAX client's reader wakes on the EOF
        a.stop()
        b.stop()


# -- the supervisor object ----------------------------------------------------

def test_supervisor_starts_and_stops_with_no_worker_serving(tmp_path):
    """A worker that dies during start-up (num-shards 3 is no power of two)
    is reaped and respawned with backoff; the supervisor's own routes keep
    answering and stop() ends cleanly."""
    sup = p_sup.Supervisor({"serving-workers": 1, "port": 0,
                            "device": "cpu",
                            "run-dir": str(tmp_path / "run"),
                            "restart-backoff-s": 30.0, "num-shards": 3})
    sup.start()
    try:
        _poll(lambda: (not sup.status()["workers"]["0"]["alive"],
                       sup.status()), "the worker to die")
        st = sup.status()
        assert st["status"] == "healthy" and st["role"] == "supervisor"
        assert st["workers"]["0"]["ready"] is False
        lines = sup.metrics_text().splitlines()
        assert "filodb_supervisor_workers 1" in lines
        assert 'filodb_supervisor_worker_alive{worker="0"} 0' in lines
        # no worker serves: the merged inventory is an empty success
        code, body = sup._admin_route("/debug/threads")
        assert code == 200 and body == {"status": "success", "data": []}
        code, _ = sup._admin_route("/no/such/route")
        assert code == 404
    finally:
        sup.stop(graceful=False)
    assert sup.status()["workers"]["0"]["alive"] is False


def test_debug_routes_merge_the_workers_tagged():
    sup = p_sup.Supervisor({"serving-workers": 2, "port": 0})
    sup._workers = {0: p_sup._Worker(0, "w0.json", 1),
                    1: p_sup._Worker(1, "w1.json", 2)}
    canned = {1: {"status": "success", "summary": {"stored": 1},
                  "data": [{"kind": "corruption-detected", "shard": 0}]},
              2: {"status": "success",
                  "data": [{"kind": "ingest-read-only", "shard": 3}]}}
    seen = []
    sup._worker_get = lambda w, path: (seen.append(path) or canned[w.port])
    for route in ("/debug/events", "/debug/traces", "/debug/queries",
                  "/debug/slow_queries"):
        seen.clear()
        code, body = sup._admin_route(route + "?limit=10")
        assert code == 200 and body["status"] == "success"
        assert {(e["kind"], e["worker"]) for e in body["data"]} == {
            ("corruption-detected", 0), ("ingest-read-only", 1)}
        assert body["summary"] == {"0": {"stored": 1}}
        assert seen == [route + "?limit=10"] * 2    # the query passes on
    # a worker's failure is skipped, never merged as data
    canned[2] = {"status": "error", "error": "boom"}
    _, body = sup._admin_route("/debug/events")
    assert [e["worker"] for e in body["data"]] == [0]


# -- one worker in this process -----------------------------------------------

def _http(port, path, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params, doseq=True)
    with urllib.request.urlopen(url, timeout=DEADLINE_S) as r:
        return r.read()


def _metric(text: str, name: str):
    """Value of an unlabelled sample (or one of its label sets) -> float
    or None."""
    for ln in text.splitlines():
        if ln.startswith(name + " ") or ln.startswith(name + "{"):
            return float(ln.rsplit(" ", 1)[1])
    return None


def test_a_worker_serves_the_public_port_and_applies_bus_events():
    hub = p_bus.SupervisorBus().start()
    pub = _free_port()
    srv = psrv.FiloServer({
        "port": 0, "device": "cpu", "gc-freeze": False, "grpc-port": None,
        "worker-id": 0, "accept-port": pub, "bus-port": hub.port,
        "bus-watermark-interval-s": 0.05, "rules": RULES}).start()
    gossip = []
    sib = p_bus.BusClient(hub.port, 1, "node1").on(
        "watermarks", gossip.append).start()
    try:
        srv.seed_dev_data(n_samples=40, n_instances=2,
                          start_ms=T0 * 1000)
        assert srv.accept_port == pub
        _poll(lambda: (hub.connected_workers() == [0, 1],
                       hub.connected_workers()), "the worker's hello")
        q = dict(query="rate(http_requests_total[5m])", start=T0 + 300,
                 end=T0 + 390, step=60, cache="false")
        bodies = [json.loads(_http(p, "/promql/timeseries/api/v1/"
                                   "query_range", **q))
                  for p in (srv.port, pub)]
        assert bodies[0]["data"] == bodies[1]["data"]
        assert bodies[0]["data"]["result"]
        text = _http(srv.port, "/metrics").decode()
        assert _metric(text, "filodb_worker_ordinal") == 0
        assert _metric(text, "filodb_bus_connected") == 1
        # standing by until the supervisor announces it
        assert srv.rules.snapshot()["active"] is False
        hub.broadcast({"type": "worker-up", "node": "node0"})
        _poll(lambda: (srv.rules.snapshot()["active"],
                       srv.rules.snapshot()), "worker-up to announce it")
        hub.broadcast({"type": "schema", "reason": "bus-test"})
        _poll(lambda: ('reason="bus-test"' in _http(
            srv.port, "/metrics").decode(), None), "the invalidation")
        # a sibling's transition naming this worker is dropped (it is the
        # ground truth for its own shards, ROADMAP C.21); one naming
        # another node converges the local mapper
        sib.publish({"type": "topology", "shard": 3, "status": "down",
                     "node": "node0"})
        sib.publish({"type": "topology", "shard": 2, "status": "recovery",
                     "node": "node1"})
        _poll(lambda: (srv.mapper.node_of(2) == "node1",
                       srv.mapper.node_of(2)), "the sibling's transition")
        assert srv.mapper.status(2).value == "recovery"
        assert srv.mapper.status(3).value == "active"
        assert srv.mapper.node_of(3) == "node0"
        _poll(lambda: (any(ev.get("origin") == "node0" for ev in gossip),
                       len(gossip)), "the worker's watermark gossip")
        applied = _metric(_http(srv.port, "/metrics").decode(),
                          "filodb_bus_events_applied_total")
        assert applied >= 3
    finally:
        hub.stop()
        sib.stop()
        srv.stop()


def test_internal_shards_are_not_advertised_as_user_shards():
    """ROADMAP C.19: worker 1's internal shards (``__rules__`` and
    ``__selfmon__``, numbered by its ordinal) stay out of its health
    body's shard gossip, so worker 0, restarting beside it, does not read
    them as a claim on user shard 1 and defer that shard."""
    from filodb_tpu_torch.parallel.membership import probe_peer_claims
    srv = psrv.FiloServer({
        "port": 0, "device": "cpu", "gc-freeze": False, "grpc-port": None,
        "num-nodes": 2, "node-ordinal": 1, "worker-id": 1,
        "peers": {"node0": f"http://127.0.0.1:{_free_port()}"},
        "rules": RULES, "self-monitor": True,
        "self-monitor-interval-s": 3600}).start()
    try:
        internal = {ds: [s.shard_num for s in lst] for ds, lst
                    in srv.http.shards_by_dataset.items()
                    if ds.startswith("__")}
        assert internal == {"__rules__": [1], "__selfmon__": [1]}
        health = json.loads(_http(srv.port, "/__health"))
        assert set(health["shards"]) == {"2", "3"}
        assert set(health["watermarks"]) <= {"2", "3"}
        assert probe_peer_claims(
            {"node1": f"http://127.0.0.1:{srv.port}"}, [0, 1]) == {}
    finally:
        srv.stop()


# -- a fleet of worker processes on the CPU -----------------------------------

QUERY = dict(query='rate({_metric_=~"heap_usage|http_requests_total"}[5m])',
             start=T0 + 300, end=T0 + (N_SAMPLES - 1) * 10, step=60)


def _write_corpus(stream_dir: str) -> None:
    """Gauges and counters of the dev producer, appended to the four
    shards' durable streams (the workers replay them)."""
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.gateway.producer import TestTimeseriesProducer
    from filodb_tpu_torch.ingest import LogIngestionStream
    prod = TestTimeseriesProducer(DEFAULT_SCHEMAS, num_shards=NUM_SHARDS)
    streams = {sh: LogIngestionStream(
        os.path.join(stream_dir, f"shard={sh}", "stream.log"),
        DEFAULT_SCHEMAS) for sh in range(NUM_SHARDS)}
    for builders in (prod.gauges(T0 * 1000, N_SAMPLES, N_INSTANCES),
                     prod.counters(T0 * 1000, N_SAMPLES, N_INSTANCES)):
        for sh, b in builders.items():
            for c in b.containers():
                streams[sh].append(c)
    for s in streams.values():
        s.close()


def _base_cfg(root, workers: int) -> dict:
    return {
        "num-shards": NUM_SHARDS, "port": _free_port(), "device": "cpu",
        "serving-workers": workers, "supervisor-port": 0,
        "run-dir": os.path.join(root, f"run{workers}"),
        "data-dir": os.path.join(root, "data"),
        "stream-dir": os.path.join(root, "streams"),
        "flush-interval-s": 0.4,
        # the settled corpus fully chunk-resident: the evaluation path,
        # and so the response bytes, are the same whether one process
        # reads the chunks or a sibling fetches them
        "max-chunks-size": 25,
        "query-sample-limit": 0, "query-series-limit": 0,
        "grpc-port": None, "max-inflight-queries": 6,
        "failure-detect-interval-s": 0.3, "rules": RULES,
    }


def _spawn_supervisor(root, cfg: dict):
    path = os.path.join(root, f"sup{cfg['serving-workers']}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    # started from another directory: the supervisor gives its workers
    # the package's root as their working directory; the supervisor's
    # and the workers' standard error go to the fleet's log
    with open(os.path.join(root, "fleet.log"), "ab") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "filodb_tpu_torch.standalone.supervisor",
             "--config", path], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=log)
    buf = b""
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline and b"\n" not in buf:
        r, _, _ = select.select([proc.stdout], [], [], 1.0)
        if r:
            ch = proc.stdout.read1(4096)
            if not ch:
                raise RuntimeError("the supervisor died during start-up")
            buf += ch
    if b"\n" not in buf:
        proc.kill()
        raise TimeoutError("no startup line from the supervisor")
    return proc, json.loads(buf.split(b"\n", 1)[0])


def _stop(proc) -> int:
    proc.terminate()
    try:
        return proc.wait(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise


def _data_bytes(raw: bytes) -> bytes:
    """The data section of a response, verbatim (the stats tail carries
    timings and the cache disposition, which differ between requests)."""
    body, sep, _tail = raw.partition(b',"stats":')
    assert sep, raw[:200]
    return body


def _answer(port, **extra) -> bytes:
    return _http(port, "/promql/timeseries/api/v1/query_range",
                 **{**QUERY, **extra})


def _wait_full(port, want_series: int) -> None:
    def probe():
        body = json.loads(_answer(port, cache="false"))
        n = len(body.get("data", {}).get("result", ()))
        return (body.get("status") == "success" and "partial" not in body
                and n >= want_series), n
    _poll(probe, f"all series through :{port}", interval=0.3)


def _rules_active(port):
    return _metric(_http(port, "/metrics").decode(), "filodb_rules_active")


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The golden answers of a 1-worker fleet, then a running 2-worker
    fleet over the same directories."""
    root = str(tmp_path_factory.mktemp("fleet"))
    _write_corpus(os.path.join(root, "streams"))
    want = 2 * N_INSTANCES
    proc1, line1 = _spawn_supervisor(root, _base_cfg(root, 1))
    try:
        _wait_full(line1["port"], want)
        # a full rotation of the flush groups: every chunk persisted
        time.sleep(3.0)
        golden = _data_bytes(_answer(line1["port"], cache="false"))
        _answer(line1["port"])                      # fills the cache
        assert _data_bytes(_answer(line1["port"])) == golden
    finally:
        assert _stop(proc1) == 0
    proc, line = _spawn_supervisor(root, _base_cfg(root, 2))
    try:
        ports = [w["port"] for w in line["workers"]]
        for p in ports:
            _wait_full(p, want)
        _poll(lambda: (all(_data_bytes(_answer(p, cache="false")) == golden
                           for p in (line["port"], *ports)), None),
              "every entry point converged on the golden answer",
              interval=0.5)
        yield {"root": root, "proc": proc, "line": line, "ports": ports,
               "golden": golden}
    finally:
        if proc.poll() is None:
            _stop(proc)


ENTRIES = ["public", "worker0", "worker1"]


def _entry(fleet, name: str) -> int:
    return fleet["line"]["port"] if name == "public" \
        else fleet["ports"][int(name[-1])]


@pytest.mark.parametrize("cache", ["off", "on"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_fleet_answers_byte_identical_to_one_worker(fleet, entry, cache):
    port = _entry(fleet, entry)
    if cache == "off":
        got = _answer(port, cache="false")
    else:
        _answer(port)                               # fills the cache
        got = _answer(port)
    assert _data_bytes(got) == fleet["golden"]


def test_fleet_derives_the_worker_configs(fleet):
    cfgs = []
    for i in range(2):
        with open(os.path.join(fleet["root"], "run2",
                               f"worker{i}.json")) as f:
            cfgs.append(json.load(f))
    # the global admission budget is split, not multiplied
    assert [c["max-inflight-queries"] for c in cfgs] == [3, 3]
    assert [c["device"] for c in cfgs] == ["cpu", "cpu"]
    assert [c["accept-port"] for c in cfgs] == [fleet["line"]["port"]] * 2


def test_fleet_health_and_merged_metrics(fleet):
    sup = fleet["line"]["supervisor_port"]
    health = json.loads(_http(sup, "/__health"))
    assert health["bus_connected"] == [0, 1]
    assert all(w["alive"] and w["ready"] and w["restarts"] == 0
               for w in health["workers"].values())
    _poll(lambda: ([_rules_active(p) for p in fleet["ports"]] == [1, 0],
                   [_rules_active(p) for p in fleet["ports"]]),
          "worker 0 elected")
    for p in fleet["ports"]:
        text = _http(p, "/metrics").decode()
        assert _metric(text, "filodb_bus_connected") == 1
        assert _metric(text, "filodb_bus_events_applied_total") > 0
    # each worker learns its sibling's watermarks over the bus
    _poll(lambda: (all(json.loads(_http(p, "/__health")).get("watermarks")
                       for p in fleet["ports"]), None), "watermark gossip")
    lines = _http(sup, "/metrics").decode().splitlines()
    for w in (0, 1):
        assert f'filodb_worker_ordinal{{worker="{w}"}} {w}' in lines
        assert any(ln.startswith("filodb_device_execute_seconds_count{")
                   and f'worker="{w}"' in ln for ln in lines), w
    assert "filodb_supervisor_workers 2" in lines
    assert "filodb_supervisor_bus_connected_workers 2" in lines
    assert sum(ln.startswith("# TYPE filodb_plan_cache_entries ")
               for ln in lines) == 1


def test_fleet_merges_debug_routes(fleet):
    sup = fleet["line"]["supervisor_port"]
    for p in fleet["ports"]:
        body = json.loads(_answer(p, cache="false", explain="trace"))
        assert "device-dispatch" in {s["name"]
                                     for s in body["trace"]["spans"]}
    traces = json.loads(_http(sup, "/debug/traces"))
    assert {e["worker"] for e in traces["data"]} == {0, 1}
    assert set(traces["summary"]) == {"0", "1"}
    for route in ("/debug/queries", "/debug/slow_queries", "/debug/events"):
        assert json.loads(_http(sup, route))["status"] == "success"
    # both workers' thread inventories, each entry tagged by its worker
    threads = json.loads(_http(sup, "/debug/threads"))
    assert threads["status"] == "success"
    for w in (0, 1):
        names = {e["name"] for e in threads["data"] if e["worker"] == w}
        assert {"http-handler", "accept-edge", "bus-client",
                "device-executor", "main-idle"} <= names, (w, names)
        live = {e["name"] for e in threads["data"]
                if e["worker"] == w and e["live_threads"]}
        assert {"bus-client", "accept-edge"} <= live, (w, live)


def test_fleet_admin_invalidate_reaches_every_worker(fleet):
    req = urllib.request.Request(
        f"http://127.0.0.1:{fleet['line']['supervisor_port']}"
        "/admin/invalidate?reason=fleet-schema", data=b"{}", method="POST")
    with urllib.request.urlopen(req, timeout=DEADLINE_S) as r:
        out = json.loads(r.read())
    assert out["status"] == "success" and out["data"]["workers"] == [0, 1]
    _poll(lambda: (all('reason="fleet-schema"' in _http(p, "/metrics").decode()
                       for p in fleet["ports"]), None),
          "the invalidation on both workers")


def test_cli_query_range_through_the_public_port(fleet):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--host", f"http://127.0.0.1:{fleet['line']['port']}",
                  "query-range", QUERY["query"], "--start",
                  str(QUERY["start"]), "--end", str(QUERY["end"]),
                  "--step", str(QUERY["step"])])
    out = json.loads(buf.getvalue())
    want = json.loads(fleet["golden"] + b"}")
    assert out["status"] == "success"
    assert out["data"] == want["data"]


def test_fleet_kill9_respawns_and_hands_the_evaluator_over(fleet):
    sup, ports = fleet["line"]["supervisor_port"], fleet["ports"]
    _poll(lambda: ([_rules_active(p) for p in ports] == [1, 0], None),
          "worker 0 elected")
    pid0 = json.loads(_http(sup, "/__health"))["workers"]["0"]["pid"]
    os.kill(pid0, signal.SIGKILL)

    def restarts():
        ws = json.loads(_http(sup, "/__health"))["workers"]
        return ws["0"]["restarts"] == 1, ws
    ws = _poll(restarts, "the respawn of worker 0")
    assert ws["1"]["restarts"] == 0 and ws["0"]["pid"] != pid0
    # worker-exit over the bus: worker 1 takes the evaluation over
    _poll(lambda: (_rules_active(ports[1]) == 1, None),
          "worker 1 elected after worker 0's exit")
    _poll(lambda: (json.loads(_http(sup, "/__health"))["workers"]["0"]
                   ["ready"], None), "worker 0 ready again")
    # worker-up: worker 0 takes it back, worker 1 steps down
    _poll(lambda: ([_rules_active(p) for p in ports] == [1, 0],
                   [_rules_active(p) for p in ports]),
          "worker 0 elected again")
    _poll(lambda: (_data_bytes(_answer(ports[0], cache="false"))
                   == fleet["golden"], None),
          "worker 0's answer after the respawn", interval=0.5)
    # SIGTERM: worker 0 drains into worker 1, both stop, the supervisor
    # exits 0 and no worker outlives it
    assert _stop(fleet["proc"]) == 0
    for pid in (ws["0"]["pid"], ws["1"]["pid"]):
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
