"""The port's gRPC data plane (``filodb_tpu_torch.grpcsvc``) and plan wires
against the JAX package's, on the CPU.

  * wire bytes: raw requests and replies, exec requests and replies and
    series (histograms included) encode to the same bytes in both
    packages, and each package decodes the other's frames;
  * plan wires: ``plan_to_wire`` bytes and ``plan_to_promql`` text of the
    same parsed queries are equal, and each package reads the other's
    plan wire back into its own plan;
  * ``FetchRaw`` and ``Exec`` over real grpcio: the port's client and
    server against each other and against the JAX package's, in both
    directions, answering as the JAX node does;
  * errors cross the wire as the reference's do;
  * a reply larger than grpcio's default 4 MiB receive limit travels over
    gRPC in the port with no downgrade to HTTP (ROADMAP C.15), while the
    reference's client downgrades it to the HTTP JSON plane.

Answers of the two query engines are compared with the tolerances of
tests/test_torch_server.py (per-series rate on aligned tiles: 8 f32 ulps;
grouped sums: rtol 1e-5, atol 1e-7).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from filodb_tpu.core.index import ColumnFilter as JFilter
from filodb_tpu.core.record import PartKey as JPartKey
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.record import ingestion_shard as j_ingestion_shard
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import PartitionSchema as JPartitionSchema
from filodb_tpu.grpcsvc import (GrpcQueryServer as JGrpcServer,
                                GrpcRemoteExec as JRemoteExec,
                                GrpcShardGroup as JShardGroup)
from filodb_tpu.grpcsvc import wire as jwire
from filodb_tpu.obs import trace as jtrace
from filodb_tpu.promql import parser as jparser
from filodb_tpu.query import planparser as jplanparser
from filodb_tpu.query import planwire as jplanwire
from filodb_tpu.query.model import GridResult as JGrid
from filodb_tpu.query.model import RawSeries as JSeries
from filodb_tpu.query.model import QueryStats as JStats
from filodb_tpu.standalone.server import FiloServer as JServer
from filodb_tpu_torch import state
from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.grpcsvc import (GrpcQueryServer, GrpcRemoteExec,
                                      GrpcShardGroup, PlaneFallbacks, wire)
from filodb_tpu_torch.grpcsvc.client import MAX_MESSAGE_BYTES
from filodb_tpu_torch.promql import parser as pparser
from filodb_tpu_torch.query import planparser, planwire
from filodb_tpu_torch.query.model import (GridResult, QueryError,
                                          QueryStats, RawSeries,
                                          StaleRoutingError)
from filodb_tpu_torch.standalone import server as psrv

torch.set_num_threads(1)

T0 = 1_600_000_000_000
DT = 10_000
N = 120
CPU = {"device": "cpu", "gc-freeze": False}


def _f32_ulps(a, b):
    mag = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.abs(a - b) / np.spacing(mag).astype(np.float64)


TOLERANCES = {
    "grouped": lambda a, b: np.allclose(a, b, rtol=1e-5, atol=1e-7),
    "f32x8": lambda a, b: (_f32_ulps(a, b) <= 8).all(),
}


def _load_jax(srv, rows, schema, flush):
    """The JAX package's own ingest, routed by its ``ingestion_shard``
    (as tests/test_torch_server.py loads it)."""
    sch = J_SCHEMAS.by_name(schema)
    builders = {}
    for lab, ts, vals in rows:
        pk = JPartKey.make(sch, lab)
        shard = j_ingestion_shard(pk.shard_key_hash(JPartitionSchema()),
                                  pk.part_hash(), 1, 4)
        b = builders.setdefault(shard, JBuilder(J_SCHEMAS))
        for t, v in zip(ts, vals):
            b.add_sample(schema, lab, int(t), float(v))
    for shard, b in builders.items():
        for c in b.containers():
            srv.store.ingest(srv.ref, shard, c)
    if flush:
        srv.store.flush_all(srv.ref)


def _series_arrays(seed=0, hist=False):
    """(labels, ts, values, les, drops, snap, chunk_len) of one series,
    from a seed."""
    rng = np.random.default_rng(seed)
    ts = T0 + np.arange(N, dtype=np.int64) * DT + rng.integers(-2000, 2000,
                                                               N)
    labels = {"_metric_": "lat" if hist else "reqs_total", "_ws_": "demo",
              "_ns_": "App-0", "instance": f"i{seed}"}
    if hist:
        vals = np.cumsum(rng.uniform(0, 2, (N, 4)), axis=0)
        les = np.array([0.1, 1.0, 10.0, np.inf])
        drops = np.array([7, 21], dtype=np.int64)
    else:
        vals = 1e9 + np.cumsum(rng.uniform(0, 5, N))
        vals[N // 2:] -= vals[N // 2 - 1]            # a counter reset
        les = drops = None
    snap = ("nodeA", "timeseries", 1, 7 + seed, 3, 1, int(ts[0]),
            int(ts[-1]))
    return labels, ts, vals, les, drops, snap, N - 10


def _both_series(seed=0, hist=False):
    labels, ts, vals, les, drops, snap, clen = _series_arrays(seed, hist)
    kw = dict(labels=dict(labels), ts=ts.copy(), values=vals.copy(),
              is_counter=True, bucket_les=les, hist_drop_rows=drops,
              snapshot_key=snap, chunk_len=clen)
    return RawSeries(**kw), JSeries(**kw)


def _assert_same_series(a, b):
    assert dict(a.labels) == dict(b.labels)
    np.testing.assert_array_equal(a.ts, b.ts)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.is_counter == b.is_counter
    assert a.chunk_len == b.chunk_len
    assert a.snapshot_key == b.snapshot_key
    for x, y in ((a.bucket_les, b.bucket_les),
                 (a.hist_drop_rows, b.hist_drop_rows)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("hist", [False, True], ids=["scalar", "hist"])
def test_series_bytes_equal_the_jax_package(hist):
    ps, js = _both_series(3, hist)
    pb, jb = wire.encode_series(ps), jwire.encode_series(js)
    assert pb == jb
    _assert_same_series(wire.decode_series(jb), js)
    _assert_same_series(jwire.decode_series(pb), ps)


RAW_REQUESTS = [
    dict(column=None, shards=None),
    dict(column="count", shards=[2, 3], span_snap=False, deadline_ms=1234,
         trace_ctx="abc-def-1", tenant="acme", priority=2),
]


@pytest.mark.parametrize("kw", RAW_REQUESTS, ids=["plain", "every-field"])
def test_raw_request_bytes_equal_the_jax_package(kw):
    flt = [("_metric_", "eq", "reqs_total"), ("job", "re", "a|b"),
           ("instance", "neq", "i0")]
    pb = wire.encode_raw_request("timeseries",
                                 [ColumnFilter(*f) for f in flt],
                                 T0, T0 + 600_000, **kw)
    jb = jwire.encode_raw_request("timeseries", [JFilter(*f) for f in flt],
                                  T0, T0 + 600_000, **kw)
    assert pb == jb
    pr, jr = wire.decode_raw_request(jb), jwire.decode_raw_request(pb)
    assert [tuple(vars(f).values()) for f in pr.pop("filters")] == \
        [tuple(vars(f).values()) for f in jr.pop("filters")]
    assert pr == jr


@pytest.mark.parametrize("error", ["", "remote boom"], ids=["ok", "error"])
def test_raw_reply_bytes_equal_the_jax_package(error):
    pairs = [_both_series(i, hist=i == 2) for i in range(3)]
    spans = b'[{"name":"peer-fetch-raw"}]'
    pb = wire.encode_raw_response([p for p, _ in pairs], error=error,
                                  trace_spans=spans)
    jb = jwire.encode_raw_response([j for _, j in pairs], error=error,
                                   trace_spans=spans)
    assert pb == jb
    (ps, pe, pt), (js, je, jt) = (wire.decode_raw_response(jb),
                                  jwire.decode_raw_response(pb))
    assert (pe, pt) == (je, jt) == (error, spans)
    for a, b in zip(ps, js):
        _assert_same_series(a, b)


EXEC_REQUESTS = [
    dict(),
    dict(local_only=False, plan_wire=b'{"__p__":"x"}', deadline_ms=99,
         trace_ctx="t-p-1", no_cache=True, expect_shards=[0, 2],
         tenant="acme", priority=1),
]


@pytest.mark.parametrize("kw", EXEC_REQUESTS, ids=["plain", "every-field"])
def test_exec_request_bytes_equal_the_jax_package(kw):
    args = ("timeseries", "sum(rate(reqs_total[5m]))", T0, 60_000,
            T0 + 600_000)
    pb, jb = wire.encode_exec_request(*args, **kw), \
        jwire.encode_exec_request(*args, **kw)
    assert pb == jb
    assert wire.decode_exec_request(jb) == jwire.decode_exec_request(pb)


def _grids(hist: bool):
    rng = np.random.default_rng(11)
    steps = T0 + np.arange(12, dtype=np.int64) * 60_000
    vals = rng.normal(size=(3, 12))
    vals[1, 4] = np.nan
    keys = [{"job": f"j{i}"} for i in range(3)]
    hv = les = None
    if hist:
        hv = rng.uniform(size=(3, 12, 4))
        les = np.array([0.1, 1.0, 10.0, np.inf])
    kw = dict(hist_values=hv, bucket_les=les, partial=True,
              warnings=["shards 2 are down"])
    return (GridResult(steps, [dict(k) for k in keys], vals.copy(), **kw),
            JGrid(steps, [dict(k) for k in keys], vals.copy(), **kw))


@pytest.mark.parametrize("hist", [False, True], ids=["scalar", "hist"])
def test_exec_reply_bytes_equal_the_jax_package(hist):
    pg, jg = _grids(hist)
    ps, js = QueryStats(), JStats()
    for st in (ps, js):
        st.series_scanned, st.samples_scanned = 3, 360
        st.warnings.append("peer warning")
    pb = wire.encode_exec_response(pg, stats=ps, trace_spans=b"[]")
    jb = jwire.encode_exec_response(jg, stats=js, trace_spans=b"[]")
    assert pb == jb
    a, b = wire.decode_exec_response(jb), jwire.decode_exec_response(pb)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
    assert wire.encode_exec_response(None, error="bad") == \
        jwire.encode_exec_response(None, error="bad")


PLAN_QUERIES = [
    "rate(http_requests_total[5m])",
    'sum by (job) (rate(http_requests_total{_ws_="demo",job=~"a|b"}[5m]))',
    "rate(http_requests_total[5m]) / rate(http_requests_total[10m])",
    "topk(3, max_over_time(queue_depth[10m] offset 1m))",
    'histogram_quantile(0.9, sum by (le) (rate(lat_bucket[5m])))',
    "quantile_over_time(0.5, queue_depth[5m]) > 3",
    "avg_over_time(queue_depth[30m:1m])",
    'label_replace(up, "x", "$1", "job", "(.*)")',
    "sum(rate(http_requests_total[5m])) without (instance) * 2",
    "time() - 10",
]


@pytest.mark.parametrize("q", PLAN_QUERIES)
def test_plan_wire_and_promql_text_equal_the_jax_package(q):
    start, step, end = T0 // 1000, 60, T0 // 1000 + 1800
    pp = pparser.parse_query_range(q, pparser.TimeStepParams(start, step,
                                                             end))
    jp = jparser.parse_query_range(q, jparser.TimeStepParams(start, step,
                                                             end))
    pw, jw = planwire.plan_to_wire(pp), jplanwire.plan_to_wire(jp)
    assert pw == jw
    assert planwire.plan_from_wire(jw) == pp
    assert jplanwire.plan_from_wire(pw) == jp
    assert planparser.plan_to_promql(pp) == jplanparser.plan_to_promql(jp)


# -- FetchRaw and Exec over real grpcio ------------------------------------

def _jax_counter_rows(seed=5, S=8):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(S):
        ts = T0 + np.arange(N) * DT + rng.integers(-2000, 2000, N)
        v = 1e9 + np.cumsum(rng.uniform(0, 5, N))
        lab = {"_metric_": "http_requests_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 2}", "instance": f"i{i}"}
        rows.append((lab, ts, v))
    return rows


@pytest.fixture(scope="module")
def nodes():
    """A port node and a JAX node with the same data (dev data plus
    jittered counters), each with its gRPC service on an ephemeral
    port."""
    port = psrv.FiloServer({"num-shards": 4, "port": 0, **CPU}).start()
    jax_srv = JServer({"num-shards": 4, "port": 0,
                       "gc-freeze": False}).start()
    rows = _jax_counter_rows()
    for srv in (port, jax_srv):
        srv.seed_dev_data(n_samples=N, n_instances=4, start_ms=T0)
    state.load_into_store(port.store, port.ref, rows, "prom-counter", True,
                          num_shards=4, spread=1)
    _load_jax(jax_srv, rows, "prom-counter", True)
    yield port, jax_srv
    port.stop()
    jax_srv.stop()


def _addr(srv):
    return f"127.0.0.1:{srv.grpc_server.port}"


FETCH = (("_metric_", "eq", "http_requests_total"),)


def _fetch(group_cls, flt_cls, srv, shards):
    grp = group_cls("peer", _addr(srv), "timeseries", shards)
    got = grp.fetch_raw([flt_cls(*f) for f in FETCH], T0, T0 + N * DT,
                        None, full=True)
    return sorted(got, key=lambda s: s.labels["instance"])


@pytest.mark.parametrize("client", ["port", "jax"])
@pytest.mark.parametrize("server", ["port", "jax"])
def test_fetch_raw_answers_as_the_jax_node(nodes, client, server):
    port, jax_srv = nodes
    srv = port if server == "port" else jax_srv
    grp_cls, flt = (GrpcShardGroup, ColumnFilter) if client == "port" \
        else (JShardGroup, JFilter)
    before = srv.grpc_server.rpcs_served
    got = _fetch(grp_cls, flt, srv, [0, 1, 2, 3])
    assert srv.grpc_server.rpcs_served == before + 1
    want = _fetch(JShardGroup, JFilter, jax_srv, [0, 1, 2, 3])
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        assert dict(a.labels) == dict(b.labels)
        np.testing.assert_array_equal(a.ts, b.ts)
        np.testing.assert_array_equal(a.values, b.values)
        assert a.chunk_len == b.chunk_len
        # node-scoped snapshot keys: the serving node's id rides them
        assert a.snapshot_key[1:] == b.snapshot_key[1:]


EXEC_QUERIES = [
    ("rate(http_requests_total[5m])", "f32x8"),
    ("sum by (job) (rate(http_requests_total[5m]))", "grouped"),
]


def _exec(cls, srv, q):
    start, end = T0 + 600_000, T0 + (N - 5) * DT // 60_000 * 60_000
    return cls(q, start, 60_000, end, "peer", _addr(srv), "timeseries",
               local_only=False).execute()


@pytest.mark.parametrize("client", ["port", "jax"])
@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("q,tol", EXEC_QUERIES, ids=["rate", "grouped"])
def test_exec_answers_as_the_jax_node(nodes, client, server, q, tol):
    port, jax_srv = nodes
    srv = port if server == "port" else jax_srv
    got = _exec(GrpcRemoteExec if client == "port" else JRemoteExec, srv, q)
    want = _exec(JRemoteExec, jax_srv, q)
    np.testing.assert_array_equal(got.steps, want.steps)
    order = lambda g: sorted(range(len(g.keys)),  # noqa: E731
                             key=lambda i: sorted(g.keys[i].items()))
    gi, wi = order(got), order(want)
    assert [got.keys[i] for i in gi] == [want.keys[i] for i in wi]
    a, b = got.values[gi], want.values[wi]
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    assert TOLERANCES[tol](a[ok], b[ok])


@pytest.mark.parametrize("server", ["port", "jax"])
def test_errors_cross_the_wire_as_the_reference(nodes, server):
    port, jax_srv = nodes
    srv = port if server == "port" else jax_srv
    bad = GrpcRemoteExec("this is not promql(", T0, 60_000, T0 + 600_000,
                         "peer", _addr(srv), "timeseries")
    with pytest.raises(QueryError, match="remote node peer"):
        bad.execute()
    grp = GrpcShardGroup("peer", _addr(srv), "nosuchds", None)
    with pytest.raises(QueryError, match="nosuchds not set up"):
        grp.fetch_raw([ColumnFilter(*FETCH[0])], T0, T0 + DT, None)
    # a local-only hop naming a shard the node does not serve bounces
    # with the stale-routing sentinel, never a silent subset
    srv.http.shards_by_dataset["timeseries"] = [
        s for s in srv.store.shards(srv.ref) if s.shard_num != 3]
    try:
        stale = GrpcRemoteExec("up", T0, 60_000, T0 + 600_000, "peer",
                               _addr(srv), "timeseries", local_only=True,
                               expect_shards=[2, 3])
        with pytest.raises(StaleRoutingError) as ei:
            stale.execute()
        assert ei.value.owners == {3: srv.node_id}
    finally:
        srv.http.shards_by_dataset["timeseries"] = srv.store.shards(
            srv.ref)


def test_raw_leaf_endpoint_answers_as_the_jax_node(nodes):
    """POST /api/v1/raw/{ds}, the HTTP leaf plane: the same series, with
    base64 arrays the two packages encode alike."""
    port, jax_srv = nodes
    body = json.dumps({"filters": [list(f) for f in FETCH],
                       "start_ms": T0, "end_ms": T0 + N * DT,
                       "column": None, "shards": [0, 1, 2, 3]}).encode()
    out = []
    for srv in nodes:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/api/v1/raw/timeseries",
            data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            payload = json.loads(r.read())
        assert payload["status"] == "success"
        for d in payload["data"]:
            d.pop("snap")           # node-scoped
        out.append(sorted(payload["data"],
                          key=lambda d: d["labels"]["instance"]))
    assert out[0] == out[1] and len(out[0]) == 12


# -- a reply above grpcio's default 4 MiB ----------------------------------

class _LeafStub:
    """The part of the HTTP server a gRPC service reads, answering every
    leaf fetch with fixed series."""

    node_id = "big"
    query_timeout_s = 30.0

    def __init__(self, series):
        self.series = series
        self.shards_by_dataset = {"timeseries": []}

    def leaf_select(self, ds, filters, start_ms, end_ms, column, shards,
                    span_snap=True, stats=None, deadline=None):
        return list(self.series)


BIG_S, BIG_N = 8, 100_000


def _big_series(cls):
    rng = np.random.default_rng(4)
    return [cls(labels={"_metric_": "big", "instance": f"i{i}"},
                ts=T0 + np.arange(BIG_N, dtype=np.int64) * DT,
                values=rng.uniform(0, 1e6, BIG_N), is_counter=False)
            for i in range(BIG_S)]


def test_a_reply_above_4_mib_travels_over_grpc_in_the_port():
    series = _big_series(RawSeries)
    frame = wire.encode_raw_response(series)
    assert 4 << 20 < len(frame) < MAX_MESSAGE_BYTES
    srv = GrpcQueryServer(_LeafStub(series), port=0).start()
    fallbacks = PlaneFallbacks()
    try:
        # the HTTP fallback URL points nowhere: a downgrade would fail
        grp = GrpcShardGroup("big", f"127.0.0.1:{srv.port}", "timeseries",
                             None, http_fallback="http://127.0.0.1:9",
                             fallbacks=fallbacks)
        got = grp.fetch_raw([ColumnFilter("_metric_", "eq", "big")], T0,
                            T0 + BIG_N * DT, None)
    finally:
        srv.stop()
    assert fallbacks.total == 0 and fallbacks.snapshot() == {}
    assert srv.fetch_raw_served == 1 and srv.rpcs_served == 1
    assert len(got) == BIG_S
    for a, b in zip(got, series):
        np.testing.assert_array_equal(a.values, b.values)


class _GridPlanner:
    """A planner answering every Exec with one fixed grid."""

    def __init__(self, grid):
        self.grid, self.stats = grid, QueryStats()

    def execute(self, plan):
        return self.grid


class _ExecStub(_LeafStub):
    def __init__(self, grid):
        super().__init__([])
        self.grid = grid

    def make_planner(self, ds, local_dispatch=False, deadline=None,
                     no_result_cache=False):
        return _GridPlanner(self.grid)


def test_an_exec_reply_above_4_mib_travels_over_grpc_in_the_port():
    """A pushed-down join's per-series grid at full width (half of 8,192
    series x 469 steps in f64) is about 15 MB."""
    rng = np.random.default_rng(6)
    steps = T0 + np.arange(469, dtype=np.int64) * 60_000
    grid = GridResult(steps, [{"instance": f"i{i}"} for i in range(2048)],
                      rng.uniform(0, 1e3, (2048, 469)))
    frame = wire.encode_exec_response(grid)
    assert 4 << 20 < len(frame) < MAX_MESSAGE_BYTES
    srv = GrpcQueryServer(_ExecStub(grid), port=0).start()
    fallbacks = PlaneFallbacks()
    try:
        ex = GrpcRemoteExec("up", int(steps[0]), 60_000, int(steps[-1]),
                            "big", f"127.0.0.1:{srv.port}", "timeseries",
                            local_only=False,
                            http_fallback="http://127.0.0.1:9",
                            fallbacks=fallbacks)
        got = ex.execute()
    finally:
        srv.stop()
    assert fallbacks.total == 0 and srv.exec_served == 1
    np.testing.assert_array_equal(got.values, grid.values)
    assert got.keys == grid.keys


def test_the_reference_downgrades_a_reply_above_4_mib_to_http():
    """The fault the port repairs: the reference's channel keeps
    grpcio's 4 MiB receive limit, so the same reply fails with
    RESOURCE_EXHAUSTED, is retried, and goes to the HTTP JSON plane; the
    only sign is a ``plane-fallback`` trace event."""
    series = _big_series(JSeries)
    srv = JGrpcServer(_LeafStub(series), port=0).start()
    jax_http = JServer({"num-shards": 1, "port": 0, "grpc-port": None,
                        "gc-freeze": False}).start()
    tr = jtrace.Trace()
    try:
        grp = JShardGroup("big", f"127.0.0.1:{srv.port}", "timeseries",
                          None, http_fallback=f"http://127.0.0.1:"
                                              f"{jax_http.port}")
        with jtrace.activate(tr):
            got = grp.fetch_raw([JFilter("_metric_", "eq", "big")], T0,
                                T0 + BIG_N * DT, None)
    finally:
        srv.stop()
        jax_http.stop()
    names = [s["name"] for s in tr.spans_json()]
    assert "plane-fallback" in names
    assert srv.rpcs_served >= 1
    # the HTTP node holds no such series: the downgraded fetch came back
    # empty, with no error
    assert got == []


def test_a_grpc_port_without_grpcio_raises_naming_grpcio(monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_grpc(name, *a, **kw):
        if name == "grpc" or name.startswith("grpc."):
            raise ImportError("No module named 'grpc'")
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_grpc)
    srv = psrv.FiloServer({"port": 0, **CPU})
    with pytest.raises(ImportError, match="grpcio"):
        srv.start()
    # it fails before it builds a backend or binds a port
    assert srv.http is None and srv.backend is None
