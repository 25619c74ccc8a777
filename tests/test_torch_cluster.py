"""The port as a cluster of nodes (``filodb_tpu_torch.parallel.cluster``,
the planner's remote shard groups and pushdown, ``parallel.discovery``)
against the JAX package's cluster, on the CPU.

  * two in-process port nodes and two in-process JAX nodes hold the same
    data, each node its own ordinal shards; the same cross-node queries
    enter every node over HTTP, and the port's answers match the JAX
    node's from both entry points, over the gRPC plane;
  * a same-metric join with no ``on`` is pushed down to both nodes
    (checked in the plan tree and in the answer);
  * buddy failover keeps answers complete through a node loss, and
    ``partitions`` forwards a workspace's query to its cluster, as in
    tests/test_multiprocess.py and tests/test_federation.py;
  * discovery with fake resolvers, as in tests/test_discovery.py;
  * a peer started with ``python -m filodb_tpu_torch.standalone.server
    --config`` and then SIGKILLed: its shards go DOWN on the survivor and
    a restart restores them;
  * ``&timeout=`` and ``&allow_partial=`` on the remote paths answer as
    the JAX package's do.

Tolerances are tests/test_torch_server.py's: per-series rate on aligned
tiles 8 f32 ulps, grouped sums rtol 1e-5, rate on irregular series 4 f64
ulps, order statistics bit-equal, histogram_quantile (numpy in both)
rtol 1e-12. The pushed-down join divides two rates of 8 f32 ulps each:
16 f32 ulps.
"""

import json
import os
import select
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from filodb_tpu.core.record import PartKey as JPartKey
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.record import ingestion_shard as j_ingestion_shard
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import PartitionSchema as JPartitionSchema
from filodb_tpu.parallel import discovery as jdisc
from filodb_tpu.promql import parser as jparser
from filodb_tpu.standalone.server import FiloServer as JServer
from filodb_tpu_torch import state
from filodb_tpu_torch.core.record import PartKey, ingestion_shard
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, PartitionSchema
from filodb_tpu_torch.parallel import discovery as pdisc
from filodb_tpu_torch.promql import parser as pparser
from filodb_tpu_torch.standalone import server as psrv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_600_000_000_000
DT = 10_000
N = 120
TAIL = 12
START = T0 // 1000 + 600
FLUSHED_END = (T0 + (N - 5) * DT) // 1000
TAIL_END = (T0 + (N + TAIL - 2) * DT) // 1000
CPU = {"device": "cpu", "gc-freeze": False}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(port, path, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params, doseq=True)
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _poll(fn, timeout=60.0, interval=0.05):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            ok, last = fn()
            if ok:
                return last
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(interval)
    raise TimeoutError(f"poll timed out; last={last!r}")


def _rows(seed=5, S=12, S_irr=6):
    """(counters, counter tails, irregular counters) as (labels, ts ms,
    values) triples."""
    rng = np.random.default_rng(seed)
    ctr, tail, irr = [], [], []
    for i in range(S):
        ts = T0 + np.arange(N + TAIL) * DT + rng.integers(-2000, 2000,
                                                          N + TAIL)
        v = 1e9 + np.cumsum(rng.uniform(0, 5, N + TAIL))
        lab = {"_metric_": "http_requests_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 3}", "instance": f"i{i}"}
        ctr.append((lab, ts[:N], v[:N]))
        tail.append((lab, ts[N:], v[N:]))
    for i in range(S_irr):
        ts = np.unique(T0 + np.arange(N) * DT
                       + rng.integers(-6000, 6000, N))
        lab = {"_metric_": "irregular_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 2}", "instance": f"k{i}"}
        irr.append((lab, ts, np.cumsum(rng.uniform(0, 3, ts.size))))
    return ctr, tail, irr


def _load_port(srv, rows, schema, flush):
    """Rows of the shards this port node owns, routed as the gateway
    routes them."""
    sch = DEFAULT_SCHEMAS.by_name(schema)
    by_shard = {}
    for lab, ts, vals in rows:
        pk = PartKey.make(sch, lab)
        sh = ingestion_shard(pk.shard_key_hash(PartitionSchema()),
                             pk.part_hash(), 1, 4)
        by_shard.setdefault(sh, []).append((lab, ts, vals))
    for sh, part in sorted(by_shard.items()):
        if sh in srv.owned_shards:
            state.load_series(srv.store.get_shard(srv.ref, sh), part,
                              schema, flush)


def _load_jax(srv, rows, schema, flush):
    """The same rows through the JAX package's own ingest."""
    sch = J_SCHEMAS.by_name(schema)
    builders = {}
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
    if flush:
        srv.store.flush_all(srv.ref)


def _start_pair(cls, extra, data=True, fd_interval=0.1):
    """Two nodes of one package, each owning its ordinal shards, with
    the dev data and the rows of _rows() on them."""
    ports = [_free_port(), _free_port()]
    peers = {f"node{i}": f"http://127.0.0.1:{p}"
             for i, p in enumerate(ports)}
    base = {"num-shards": 4, "num-nodes": 2, "peers": peers,
            "query-sample-limit": 0, "query-series-limit": 0,
            "failure-detect-interval-s": fd_interval,
            "failure-detect-threshold": 2, "gc-freeze": False, **extra}
    nodes = []
    for i in range(2):
        srv = cls({**base, "node-ordinal": i, "port": ports[i]}).start()
        nodes.append(srv)
        if not data:
            continue
        srv.seed_dev_data(n_samples=N, n_instances=4, start_ms=T0)
        ctr, tail, irr = _rows()
        load = _load_port if cls is psrv.FiloServer else _load_jax
        load(srv, ctr, "prom-counter", True)
        load(srv, irr, "prom-counter", True)
        load(srv, tail, "prom-counter", False)      # the unflushed tail
    return nodes


def _stop(nodes):
    for srv in nodes:
        if srv is not None:
            srv.stop()


@pytest.fixture(scope="module")
def clusters():
    """(port node0, port node1), (JAX node0, JAX node1), every node's
    gRPC address learned by its peer through the health-body gossip."""
    port = _start_pair(psrv.FiloServer, {"device": "cpu"})
    jax_nodes = _start_pair(JServer, {})
    _poll(lambda: (all(s.http.grpc_peers for s in port + jax_nodes),
                   None))
    yield port, jax_nodes
    _stop(port)
    _stop(jax_nodes)


def _f32_ulps(a, b):
    mag = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.abs(a - b) / np.spacing(mag).astype(np.float64)


def _f64_ulps(a, b):
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


TOLERANCES = {
    "grouped": lambda a, b: np.allclose(a, b, rtol=1e-5, atol=1e-7),
    "f32x8": lambda a, b: (_f32_ulps(a, b) <= 8).all(),
    "f32x16": lambda a, b: (_f32_ulps(a, b) <= 16).all(),
    "f64x4": lambda a, b: (_f64_ulps(a, b) <= 4).all(),
    "exact": lambda a, b: np.array_equal(a, b),
    "numpy": lambda a, b: np.allclose(a, b, rtol=1e-12, atol=0.0),
}


def _assert_result_match(pd, jd, tol):
    assert pd["status"] == jd["status"] == "success"
    assert pd["data"]["resultType"] == jd["data"]["resultType"]
    pr, jr = pd["data"]["result"], jd["data"]["result"]
    assert [e["metric"] for e in pr] == [e["metric"] for e in jr]
    assert len(pr) > 0
    for pe, je in zip(pr, jr):
        pv, jv = np.asarray(pe["values"]), np.asarray(je["values"])
        np.testing.assert_array_equal(pv[:, 0].astype(np.float64),
                                      jv[:, 0].astype(np.float64))
        a, b = pv[:, 1].astype(np.float64), jv[:, 1].astype(np.float64)
        assert TOLERANCES[tol](a, b), (pe["metric"], tol, a, b)
    assert pd["stats"]["seriesScanned"] == jd["stats"]["seriesScanned"]
    assert pd["stats"]["samplesScanned"] == jd["stats"]["samplesScanned"]
    assert ("partial" in pd) == ("partial" in jd)


CROSS_QUERIES = [
    ("rate(http_requests_total[5m])", TAIL_END, "f32x8"),
    ("sum by (job) (rate(http_requests_total[5m]))", FLUSHED_END,
     "grouped"),
    ("rate(irregular_total[5m])", FLUSHED_END, "f64x4"),
    ("max_over_time(heap_usage[5m])", FLUSHED_END, "exact"),
    ("histogram_quantile(0.9, rate(http_request_latency[5m]))",
     FLUSHED_END, "numpy"),
]


@pytest.mark.parametrize("entry", [0, 1], ids=["node0", "node1"])
@pytest.mark.parametrize("query,end,tol", CROSS_QUERIES,
                         ids=[q.split("(")[0] + f"-{i}" for i, (q, _, _)
                              in enumerate(CROSS_QUERIES)])
def test_cross_node_answers_match_the_jax_cluster(clusters, entry, query,
                                                  end, tol):
    port, jax_nodes = clusters
    peer = port[1 - entry]
    before = peer.grpc_server.fetch_raw_served
    params = dict(query=query, start=START, end=end, step=60,
                  cache="false")
    pc, pd = _get(port[entry].port, "/promql/timeseries/api/v1/query_range",
                  **params)
    jc, jd = _get(jax_nodes[entry].port,
                  "/promql/timeseries/api/v1/query_range", **params)
    assert pc == jc == 200
    _assert_result_match(pd, jd, tol)
    # the peer's shards came over the gRPC plane, never downgraded
    assert peer.grpc_server.fetch_raw_served > before
    assert port[entry].http.plane_fallbacks.total == 0
    # both entry points see every node's series
    oc, od = _get(port[1 - entry].port,
                  "/promql/timeseries/api/v1/query_range", **params)
    assert [e["metric"] for e in od["data"]["result"]] == \
        [e["metric"] for e in pd["data"]["result"]]


def test_metadata_fans_out_to_the_peer_as_the_jax_cluster(clusters):
    port, jax_nodes = clusters
    key = lambda d: json.dumps(d, sort_keys=True)  # noqa: E731
    for path, params in (
            ("/promql/timeseries/api/v1/series",
             {"match[]": "http_requests_total"}),
            ("/promql/timeseries/api/v1/label/instance/values", {}),
            ("/api/v1/cardinality/timeseries",
             {"prefix": "demo", "depth": "3"})):
        for entry in (0, 1):
            pc, pd = _get(port[entry].port, path, **params)
            jc, jd = _get(jax_nodes[entry].port, path, **params)
            assert pc == jc == 200
            assert sorted(map(key, pd["data"])) == \
                sorted(map(key, jd["data"]))
    # each node alone serves a strict subset of the series
    _, full = _get(port[0].port, "/promql/timeseries/api/v1/series",
                   **{"match[]": "http_requests_total"})
    _, local = _get(port[0].port, "/promql/timeseries/api/v1/series",
                    **{"match[]": "http_requests_total", "__local__": "1"})
    assert 0 < len(local["data"]) < len(full["data"])


JOIN = ('rate(http_requests_total{_ws_="demo",_ns_="App-0"}[5m]) / '
        'rate(http_requests_total{_ws_="demo",_ns_="App-0"}[10m])')


def test_same_metric_join_is_pushed_down_to_both_nodes(clusters):
    port, jax_nodes = clusters
    start, end = START, TAIL_END
    pplan = pparser.parse_query_range(JOIN, pparser.TimeStepParams(
        start, 60, end))
    jplan = jparser.parse_query_range(JOIN, jparser.TimeStepParams(
        start, 60, end))
    pex = port[0].http.make_planner("timeseries").materialize(pplan)
    jex = jax_nodes[0].http.make_planner("timeseries").materialize(jplan)
    assert type(pex).__name__ == type(jex).__name__ == "ConcatExec"
    assert [type(c).__name__ for c in pex.children] == \
        [type(c).__name__ for c in jex.children] == \
        ["LocalEngineExec", "GrpcRemoteExec"]
    assert "GrpcRemoteExec(node=node1" in pex.plan_tree()
    before = port[1].grpc_server.exec_served
    params = dict(query=JOIN, start=start, end=end, step=60, cache="false")
    pc, pd = _get(port[0].port, "/promql/timeseries/api/v1/query_range",
                  **params)
    jc, jd = _get(jax_nodes[0].port,
                  "/promql/timeseries/api/v1/query_range", **params)
    assert pc == jc == 200
    assert port[1].grpc_server.exec_served == before + 1
    # a pushed-down join's stats count only the entry node's own leg in
    # both packages; the values and labels are what must agree
    pd["stats"] = jd["stats"]
    _assert_result_match(pd, jd, "f32x16")


# -- buddy failover and federation -----------------------------------------

def _instances(port, query='{_metric_=~"heap_usage|http_requests_total"}'):
    _, body = _get(port, "/promql/timeseries/api/v1/query", query=query,
                   time=FLUSHED_END)
    return {(r["metric"].get("__name__"), r["metric"].get("instance"))
            for r in body["data"]["result"]}


@pytest.mark.parametrize("cls", [psrv.FiloServer, JServer],
                         ids=["port", "jax"])
def test_buddy_failover_serves_down_shards(cls):
    ports = [_free_port(), _free_port(), _free_port()]
    peers = {"node0": f"http://127.0.0.1:{ports[0]}",
             "node1": f"http://127.0.0.1:{ports[1]}"}
    extra = {"device": "cpu"} if cls is psrv.FiloServer else {}
    base = {"num-shards": 4, "num-nodes": 2, "peers": peers,
            "query-sample-limit": 0, "query-series-limit": 0,
            "failure-detect-interval-s": 0.1,
            "failure-detect-threshold": 2, "gc-freeze": False,
            "grpc-port": None, **extra}
    cfgs = [{**base, "node-ordinal": 0, "port": ports[0],
             "buddy-peers": {"node1": f"http://127.0.0.1:{ports[2]}"}},
            {**base, "node-ordinal": 1, "port": ports[1]},
            # node1's buddy replica: same ordinal shards and data, no
            # peers of its own
            {**base, "node-ordinal": 1, "port": ports[2], "peers": {}}]
    nodes = []
    try:
        for cfg in cfgs:
            srv = cls(cfg).start()
            srv.seed_dev_data(n_samples=N, n_instances=4, start_ms=T0)
            nodes.append(srv)
        full = _instances(ports[0])
        assert len(full) == 8
        nodes[1].stop()
        nodes[1] = None
        _poll(lambda: (nodes[0].detector.is_down("node1"), None))
        # the buddy serves node1's DOWN shards: the answer stays complete
        assert _instances(ports[0]) == full
    finally:
        _stop(nodes)


def _federated(cls):
    """Cluster B owns workspace 'prod'; cluster A serves 'demo' and
    forwards prod queries to B (tests/test_federation.py's layout)."""
    from filodb_tpu.gateway.producer import TestTimeseriesProducer as JProd
    from filodb_tpu.gateway.producer import ingest_builders as j_ingest
    from filodb_tpu_torch.gateway.producer import (TestTimeseriesProducer,
                                                   ingest_builders)
    extra = {"device": "cpu", "grpc-port": None} \
        if cls is psrv.FiloServer else {"grpc-port": None}
    prod, ingest = (TestTimeseriesProducer, ingest_builders) \
        if cls is psrv.FiloServer else (JProd, j_ingest)
    b = cls({"num-shards": 2, "port": 0, "query-sample-limit": 0,
             "query-series-limit": 0, "gc-freeze": False, **extra}).start()
    schemas = DEFAULT_SCHEMAS if cls is psrv.FiloServer else J_SCHEMAS
    producer = prod(schemas, num_shards=2, ws="prod")
    ingest(b.store, b.ref, producer.counters(T0, 60, 3))
    b.store.flush_all(b.ref)
    a = cls({"num-shards": 2, "port": 0,
             "partitions": {"prod": f"http://127.0.0.1:{b.port}"},
             "local-partitions": ["demo"], "query-sample-limit": 0,
             "query-series-limit": 0, "gc-freeze": False, **extra}).start()
    a.seed_dev_data(n_samples=60, n_instances=2, start_ms=T0)
    return a, b


def test_partitions_forward_a_workspace_to_its_cluster_as_the_jax_one():
    port, jax = _federated(psrv.FiloServer), _federated(JServer)
    try:
        q = dict(query='sum(rate(http_requests_total{_ws_="prod"}[5m]))',
                 start=T0 // 1000 + 300, end=T0 // 1000 + 500, step=60)
        out = []
        for a, b in (port, jax):
            code, body = _get(a.port, "/promql/timeseries/api/v1/"
                              "query_range", **q)
            assert code == 200
            # the answer of cluster B itself
            _, direct = _get(b.port, "/promql/timeseries/api/v1/"
                             "query_range", **q)
            assert body["data"] == direct["data"]
            out.append(body)
        _assert_result_match(out[0], out[1], "grouped")
        tsp = pparser.TimeStepParams(T0 // 1000 + 300, 60,
                                     T0 // 1000 + 500)
        planner = port[0].http.make_planner("timeseries")
        for ws, forwarded in (("prod", True), ("demo", False)):
            plan = pparser.parse_query_range(
                f'rate(http_requests_total{{_ws_="{ws}"}}[5m])', tsp)
            name = type(planner.materialize(plan)).__name__
            assert (name == "PromQlRemoteExec") == forwarded, (ws, name)
        # with a gRPC address for the partition, the hop rides gRPC
        planner.grpc_partitions = {"prod": "127.0.0.1:1"}
        plan = pparser.parse_query_range(
            'rate(http_requests_total{_ws_="prod"}[5m])', tsp)
        assert type(planner.materialize(plan)).__name__ == "GrpcRemoteExec"
    finally:
        _stop(port + jax)


# -- discovery -------------------------------------------------------------

DISCOVERY = [
    {"mode": "explicit-list", "peers": {"node0": "http://a:1"}},
    {"mode": "dns-srv", "srv-name": "_f._tcp.x"},
    {"mode": "consul", "url": "http://consul:8500/", "service": "filodb",
     "scheme": "https"},
]


def _srv_resolver(name):
    return [("10.0.0.3", 7102), ("10.0.0.1", 7101), ("10.0.0.3", 7102),
            ("10.0.0.2", 7101)]


def _consul(url):
    assert url == "http://consul:8500/v1/catalog/service/filodb"
    return [{"ServiceAddress": "10.0.1.9", "ServicePort": 80,
             "Address": "x"},
            {"ServiceAddress": "", "Address": "10.0.1.2",
             "ServicePort": 81}]


@pytest.mark.parametrize("cfg", DISCOVERY,
                         ids=[c["mode"] for c in DISCOVERY])
def test_discovery_resolves_as_the_jax_package(cfg):
    got = pdisc.discover_peers(cfg, srv_resolver=_srv_resolver,
                               consul_fetcher=_consul)
    want = jdisc.discover_peers(cfg, srv_resolver=_srv_resolver,
                                consul_fetcher=_consul)
    assert got == want and got
    with pytest.raises(ValueError):
        pdisc.discover_peers({"mode": "zookeeper"})


def test_server_bootstraps_its_ordinal_through_discovery(monkeypatch):
    monkeypatch.setattr(pdisc, "_default_srv_resolver",
                        lambda name: [("127.0.0.1", 7101),
                                      ("127.0.0.1", 7102)])
    cfg = {"num-shards": 4, "port": 0, "grpc-port": None,
           "failure-detect-interval-s": 60.0, **CPU,
           "discovery": {"mode": "dns-srv", "srv-name": "_f._tcp.x"}}
    srv = psrv.FiloServer({**cfg, "advertise-url":
                           "http://127.0.0.1:7102"}).start()
    try:
        assert srv.node_id == "node1"
        assert srv.config["num-nodes"] == 2
        assert srv.config["peers"] == {"node0": "http://127.0.0.1:7101"}
        assert sorted(srv.owned_shards) == [2, 3]
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="advertise-url"):
        psrv.FiloServer({**cfg, "advertise-url":
                         "http://10.9.9.9:1"}).start()


# -- a peer process: SIGKILL, DOWN, restart --------------------------------

def _spawn(cfg, tmp_path, name):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"    # the suite's workers share the cores
    return subprocess.Popen(
        [sys.executable, "-m", "filodb_tpu_torch.standalone.server",
         "--config", str(path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)


def _wait_ready(proc, timeout=120.0):
    deadline = time.monotonic() + timeout
    buf = b""
    while time.monotonic() < deadline:
        r, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not r:
            assert proc.poll() is None, "server died during start-up"
            continue
        ch = proc.stdout.read1(4096)
        assert ch, "stdout closed"
        buf += ch
        if b"\n" in buf:
            return json.loads(buf.split(b"\n", 1)[0])
    raise TimeoutError("no start-up line")


def _statuses(port):
    _, body = _get(port, "/api/v1/cluster/timeseries/status")
    return {s["shard"]: s["status"] for s in body["data"]}


def test_a_sigkilled_peer_goes_down_and_a_restart_restores_it(tmp_path):
    p0, p1 = _free_port(), _free_port()
    peers = {"node0": f"http://127.0.0.1:{p0}",
             "node1": f"http://127.0.0.1:{p1}"}
    base = {"num-shards": 4, "num-nodes": 2, "peers": peers,
            "query-sample-limit": 0, "query-series-limit": 0,
            "failure-detect-interval-s": 0.1, "failure-detect-threshold": 2,
            "device": "cpu"}
    node1 = {**base, "node-ordinal": 1, "port": p1, "seed-dev-data": True,
             "seed-start-ms": T0, "seed-samples": N, "seed-instances": 4}
    proc = _spawn(node1, tmp_path, "node1")
    a = None
    try:
        line = _wait_ready(proc)
        assert line["port"] == p1 and line["grpc_port"] > 0
        a = psrv.FiloServer({**base, "node-ordinal": 0, "port": p0,
                             "gc-freeze": False}).start()
        a.seed_dev_data(n_samples=N, n_instances=4, start_ms=T0)
        full = _poll(lambda: ((lambda s: (len(s) == 8, s))(
            _instances(p0))))
        # node1's gRPC address is learned from its health body
        addr = f"127.0.0.1:{line['grpc_port']}"
        _poll(lambda: (a.http.grpc_peers == {"node1": addr},
                       a.http.grpc_peers))
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        _poll(lambda: ((lambda st: (st[2] == st[3] == "down", st))(
            _statuses(p0))), timeout=30)
        # the survivor answers from its own shards, flagged partial
        _, body = _get(p0, "/promql/timeseries/api/v1/query",
                       query='{_metric_=~"heap_usage|http_requests_total"}',
                       time=FLUSHED_END)
        assert "shards 2,3 are down with no replica; results are partial" \
            in body["warnings"]
        local = _instances(p0)
        assert 0 < len(local) < len(full) and local < full
        assert "node1" not in a.http.grpc_peers
        # a restart on the same port and data: the shards come back
        proc = _spawn(node1, tmp_path, "node1b")
        line = _wait_ready(proc)
        _poll(lambda: ((lambda st: (all(v == "active"
                                        for v in st.values()), st))(
            _statuses(p0))), timeout=30)
        _poll(lambda: ((lambda s: (s == full, s))(_instances(p0))))
        # and the restarted peer's new gRPC port replaced the dead one
        addr = f"127.0.0.1:{line['grpc_port']}"
        _poll(lambda: (a.http.grpc_peers == {"node1": addr},
                       a.http.grpc_peers))
        assert a.http.plane_fallbacks.total == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if a is not None:
            a.stop()


# -- the deadline and allow_partial on the remote paths --------------------

@pytest.fixture(scope="module")
def lonely():
    """{peer kind: (port node, JAX node)}: each node is node0 of a
    two-node cluster whose node1 either refuses connections or accepts
    them and never answers. The detectors poll too rarely to notice, so
    the peer's shards stay ACTIVE in the map and every query dials it."""
    hanging = socket.socket()
    hanging.bind(("127.0.0.1", 0))
    hanging.listen(64)
    peers = {"refused": f"http://127.0.0.1:{_free_port()}",
             "hanging": f"http://127.0.0.1:{hanging.getsockname()[1]}"}
    out = {}
    for kind, url in peers.items():
        out[kind] = []
        for cls, extra in ((psrv.FiloServer, {"device": "cpu"}),
                           (JServer, {})):
            srv = cls({"num-shards": 4, "num-nodes": 2, "node-ordinal": 0,
                       "port": 0, "peers": {"node1": url},
                       "failure-detect-interval-s": 300.0,
                       "peer-retry-attempts": 1, "gc-freeze": False,
                       "query-sample-limit": 0, **extra}).start()
            srv.seed_dev_data(n_samples=N, n_instances=4, start_ms=T0)
            out[kind].append(srv)
    yield out
    for nodes in out.values():
        _stop(nodes)
    hanging.close()


REMOTE_PARAMS = [
    ("refused", {}, 400),
    ("refused", {"allow_partial": "true"}, 200),
    # the deadline clips the hop to a peer that never answers (the
    # per-call timeout is 60 s)
    ("hanging", {"timeout": "500ms"}, 400),
    ("hanging", {"timeout": "500ms", "allow_partial": "true"}, 200),
]


@pytest.mark.parametrize("peer,extra,code", REMOTE_PARAMS,
                         ids=["fail-fast", "allow-partial", "timeout",
                              "timeout-allow-partial"])
def test_deadline_and_allow_partial_act_on_remote_paths_as_the_reference(
        lonely, peer, extra, code):
    params = dict(query="sum(rate(http_requests_total[5m]))", start=START,
                  end=FLUSHED_END, step=60, cache="false", **extra)
    out = []
    for srv in lonely[peer]:
        t0 = time.monotonic()
        out.append(_get(srv.port, "/promql/timeseries/api/v1/query_range",
                        **params))
        assert time.monotonic() - t0 < 10.0
    (pc, pd), (jc, jd) = out
    assert pc == jc == code, (pd, jd)
    assert pd["status"] == jd["status"]
    if code != 200:
        assert pd["errorType"] == jd["errorType"]
        assert pd["error"] == jd["error"]
        return
    assert pd["partial"] is jd["partial"] is True
    assert pd["warnings"] == jd["warnings"]
    assert pd["warnings"][0].startswith(
        "partial result: shards [2,3] on node1 unavailable")
    _assert_result_match(pd, jd, "grouped")
