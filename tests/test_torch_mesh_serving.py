"""Mesh serving in the port's server and planner, on the CPU (the
counterpart of ``tests/test_mesh_serving.py``, with the planner's mesh
lowering shapes of ``tests/test_planner.py``, the histogram case of
``tests/test_histograms.py`` and the limit budget of
``tests/test_guardrails.py``).

Two port servers over identically seeded stores, one plain and one with
``mesh-enabled`` under 8 partitions of the CPU (``FILODB_MESH_PARTITIONS``,
the counterpart of the reference tests' 8 virtual XLA devices):
per-series answers byte-identical in their data sections; the grouped
shapes within 1e-12 relative of the numpy f64 aggregation of the plain
server's per-series answers (the mesh sums the same f32 rates in f64,
the plain server through the group-sum kernel's plain version). The
scatter-gather shapes against the engine's oracle at 1/2/4/8 partitions
(rtol 1e-8, the reference test's); the histogram sum within 1e-9."""

import json
import os
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from filodb_tpu_torch.core.memstore import TimeSeriesMemStore, TimeSeriesShard
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.gateway.producer import (TestTimeseriesProducer,
                                               ingest_builders)
from filodb_tpu_torch.memory.histogram import CustomBuckets
from filodb_tpu_torch.obs import devprof
from filodb_tpu_torch.parallel.mesh import (PARTITIONS_ENV, MeshExecutor,
                                            make_mesh)
from filodb_tpu_torch.parallel.resilience import Deadline, DeadlineExceeded
from filodb_tpu_torch.parallel.shardmapper import (ShardMapper,
                                                   assign_shards_evenly)
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.model import QueryLimits
from filodb_tpu_torch.query.planner import (LocalEngineExec,
                                            MeshAggregateExec, MeshTileExec,
                                            QueryPlanner)
from filodb_tpu_torch.standalone.server import FiloServer

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

REF = DatasetRef("timeseries")
T0 = 1_600_000_000
CPU = torch.device("cpu")


def _plan(q, start=T0 + 600, end=T0 + 3000, step=60):
    return parse_query_range(q, TimeStepParams(start, step, end))


# ---------------------------------------------------------------------------
# e2e: mesh on vs off over HTTP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """Two servers over identically seeded stores: mesh-tile serving on
    (8 partitions of the CPU) vs plain single-device."""
    srvs = []
    saved = os.environ.get(PARTITIONS_ENV)
    os.environ[PARTITIONS_ENV] = "8"
    try:
        for mesh in (False, True):
            srv = FiloServer({"num-shards": 2, "grpc-port": None, "port": 0,
                              "mesh-enabled": mesh, "results-cache-mb": 0,
                              "device": "cpu", "gc-freeze": False}).start()
            srv.seed_dev_data(n_samples=60, n_instances=3,
                              start_ms=T0 * 1000)
            srvs.append(srv)
    finally:
        if saved is None:
            os.environ.pop(PARTITIONS_ENV, None)
        else:
            os.environ[PARTITIONS_ENV] = saved
    yield srvs
    for s in srvs:
        s.stop()


def _get(port, path, **params):
    qs = urllib.parse.urlencode(params)
    url = f"http://127.0.0.1:{port}{path}?{qs}"
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def _data(raw: bytes) -> str:
    return json.dumps(json.loads(raw)["data"], sort_keys=True)


def _range(srv, q, **extra):
    return _get(srv.port, "/promql/timeseries/api/v1/query_range", query=q,
                start=T0 + 300, end=T0 + 500, step=60, **extra)


QUERIES = [
    "rate(http_requests_total[5m])",
    "increase(http_requests_total[5m])",
    "delta(heap_usage[5m])",
    "sum_over_time(heap_usage[5m])",
    "avg_over_time(heap_usage[2m])",
    "max(rate(http_requests_total[5m]))",
    "topk(2, rate(http_requests_total[5m]))",
]


@pytest.mark.parametrize("q", QUERIES)
def test_mesh_on_off_data_byte_identity(pair, q):
    plain, meshed = pair
    assert meshed.backend.mesh_eval is not None
    assert _data(_range(plain, q)) == _data(_range(meshed, q)), q


GROUPED = {
    "sum(rate(http_requests_total[5m])) by (instance)": "sum",
    "avg(rate(http_requests_total[5m])) by (instance)": "avg",
    "count(rate(http_requests_total[5m]))": "count",
    "sum(rate(http_requests_total[5m]))": "sum",
}


def _rows(raw):
    return {tuple(sorted(r["metric"].items())):
            np.array([float(v) for _, v in r["values"]])
            for r in json.loads(raw)["data"]["result"]}


@pytest.mark.parametrize("q", sorted(GROUPED))
def test_mesh_grouped_matches_the_oracle(pair, q):
    """The grouped shapes off the resident collective: the numpy f64
    aggregation of the plain server's per-series rates (bit for bit the
    mesh's own, test above) within 1e-12."""
    plain, meshed = pair
    agg = GROUPED[q]
    per = _rows(_range(plain, "rate(http_requests_total[5m])"))
    got = _rows(_range(meshed, q))
    by = "instance" if "by (instance)" in q else None
    groups = {}
    for key, v in per.items():
        g = tuple((k, x) for k, x in key if k == by) if by else ()
        groups.setdefault(g, []).append(v)
    assert set(got) == set(groups)
    for g, rows in groups.items():
        m = np.vstack(rows)
        want = {"sum": m.sum(0), "avg": m.mean(0),
                "count": np.full(m.shape[1], float(len(rows)))}[agg]
        np.testing.assert_allclose(got[g], want, rtol=1e-12, atol=0)


def test_mesh_instant_query_matches(pair):
    """Instant queries ride the mesh too (the tilestore instant shape):
    byte for byte the plain server's."""
    plain, meshed = pair
    params = dict(query="rate(http_requests_total[5m])", time=T0 + 400)
    path = "/promql/timeseries/api/v1/query"
    a = json.loads(_get(plain.port, path, **params))["data"]
    b = json.loads(_get(meshed.port, path, **params))["data"]
    assert a["result"] and a == b


def test_mesh_dispatches_actually_happened(pair):
    _plain, meshed = pair
    _range(meshed, "rate(http_requests_total[5m])")
    assert meshed.backend.mesh_dispatches >= 1
    snap = meshed.backend.mesh_eval.snapshot()
    assert snap["placements"] >= 1 and snap["devices"] == 8
    assert meshed.mesh_executor.ndev == 8


def test_mesh_executables_attributed_per_device_count(pair):
    """The sharded dispatches show under the ``mesh-tiles`` site with the
    mesh shape (8 partitions) in their keys, and the scatter-gather under
    ``mesh``, each with its analytic cost in ``&explain=analyze``."""
    _plain, meshed = pair
    az = json.loads(_range(meshed, "rate(http_requests_total[5m])",
                           cache="false", explain="analyze"))["analyze"]
    tiles = [e for e in az["device"]["executables"]
             if e["site"] == "mesh-tiles"]
    assert tiles and all("(8, 1, 8)" in e["executable"] for e in tiles)
    assert all("bytes_accessed" in e for e in tiles)
    paths = {d.get("path") for d in az["device"]["dispatches"]
             if d["span"] == "device-dispatch"}
    assert "mesh-aligned" in paths
    az = json.loads(_range(meshed, "max(rate(http_requests_total[5m]))",
                           cache="false", explain="analyze"))["analyze"]
    assert [e for e in az["device"]["executables"] if e["site"] == "mesh"
            and e["executable"].endswith("/8")]
    assert any(e["site"] == "mesh-tiles"
               for e in devprof.GLOBAL_PROFILER.snapshot())


def test_the_grouped_route_launches_no_group_sum(pair):
    _plain, meshed = pair
    az = json.loads(_range(
        meshed, "sum(rate(http_requests_total[5m])) by (instance)",
        cache="false", explain="analyze"))["analyze"]
    sites = {e["executable"].split("/")[0]
             for e in az["device"]["executables"]}
    assert "mesh-grouped-pair" in sites and "groupsum" not in sites


# ---------------------------------------------------------------------------
# plan lowering
# ---------------------------------------------------------------------------

def test_planner_lowers_tilestore_shapes_to_mesh_tile_exec(pair):
    _plain, meshed = pair
    planner = meshed.http.make_planner("timeseries")
    for q in ("rate(http_requests_total[5m])",
              "sum_over_time(heap_usage[5m])",
              "sum(rate(http_requests_total[5m])) by (instance)"):
        assert isinstance(planner.materialize(_plan(q)), MeshTileExec), q
    # min/max and topk take the scatter-gather collective, order
    # statistics stay local
    for q in ("max(rate(http_requests_total[5m]))",
              "topk(2, rate(http_requests_total[5m]))"):
        assert isinstance(planner.materialize(_plan(q)),
                          MeshAggregateExec), q
    assert isinstance(planner.materialize(
        _plan("quantile_over_time(0.9, heap_usage[5m])")), LocalEngineExec)
    tree = planner.materialize(
        _plan("rate(http_requests_total[5m])")).plan_tree()
    assert tree.startswith("MeshTileExec(shape=rate")


def test_planner_without_mesh_eval_keeps_local(pair):
    plain, _meshed = pair
    planner = plain.http.make_planner("timeseries")
    for q in ("rate(http_requests_total[5m])",
              "max(rate(http_requests_total[5m]))"):
        assert isinstance(planner.materialize(_plan(q)), LocalEngineExec)


@pytest.mark.parametrize("q", ["rate(http_requests_total[5m])",
                               "max(rate(http_requests_total[5m]))"])
def test_the_deadline_acts_on_both_mesh_execs(pair, q):
    """&timeout= (the per-query deadline) acts on MeshTileExec and
    MeshAggregateExec as on the remote paths (ROADMAP C.12)."""
    _plain, meshed = pair
    planner = meshed.http.make_planner("timeseries",
                                       deadline=Deadline.after(0.0))
    ex = planner.materialize(_plan(q))
    assert isinstance(ex, (MeshTileExec, MeshAggregateExec))
    with pytest.raises(DeadlineExceeded):
        ex.execute()


# ---------------------------------------------------------------------------
# scatter-gather shapes vs the engine's oracle at 1/2/4/8 partitions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    store = TimeSeriesMemStore(DEFAULT_SCHEMAS)
    for sh in range(8):
        store.setup(REF, sh)
    producer = TestTimeseriesProducer(DEFAULT_SCHEMAS, num_shards=8,
                                      spread=1)
    ingest_builders(store, REF, producer.counters(T0 * 1000, 360, 6))
    ingest_builders(store, REF, producer.gauges(T0 * 1000, 360, 6))
    ingest_builders(store, REF, producer.histograms(
        T0 * 1000, 360, 3, metric="request_latency"))
    store.flush_all(REF)
    mapper = ShardMapper(8)
    assign_shards_evenly(mapper, ["node0"])
    for s in range(8):
        mapper.activate(s)
    return store, mapper


def _held_to(got, want, q, rtol):
    gmap = {tuple(sorted(k.items())): i for i, k in enumerate(got.keys)}
    assert len(gmap) == want.num_series, q
    for i, k in enumerate(want.keys):
        j = gmap[tuple(sorted(k.items()))]
        if want.is_hist():
            np.testing.assert_allclose(
                got.hist_values[j], want.hist_values[i], rtol=rtol,
                equal_nan=True, err_msg=q)
        else:
            np.testing.assert_allclose(got.values[j], want.values[i],
                                       rtol=rtol, equal_nan=True,
                                       err_msg=q)


@pytest.mark.parametrize("ndev,tp", [(1, 1), (2, 1), (4, 2), (8, 2)])
@pytest.mark.parametrize("q", [
    "topk(2, rate(http_requests_total[5m]))",
    "sum(rate(http_requests_total[5m])) by (instance)",
    "min(sum_over_time(heap_usage[2m])) by (instance)",
    "sum(rate(request_latency[5m])) by (instance)",     # histogram
])
def test_mesh_aggregate_matches_oracle_across_device_counts(
        cluster, ndev, tp, q):
    store, mapper = cluster
    shards = store.shards(REF)
    mesh = make_mesh(ndev // tp, tp, [CPU] * ndev)
    planner = QueryPlanner(shards, shard_mapper=mapper,
                           mesh_executor=MeshExecutor(mesh), spread=1)
    mat = planner.materialize(_plan(q))
    assert isinstance(mat, MeshAggregateExec), q
    got = mat.execute()
    want = QueryEngine(shards).execute(_plan(q))
    assert want.num_series > 0, q
    if "request_latency" in q:
        assert got.is_hist() and want.is_hist()
    _held_to(got, want, q, 1e-8)


def _hist_shard(n=360, reset_at=200, num_series=3):
    """The reference histogram test's world: cumulative buckets
    (0.5, 2, 8, +Inf) per series, a reset at sample ``reset_at``."""
    les = (0.5, 2.0, 8.0, float("inf"))
    shard = TimeSeriesShard(REF, DEFAULT_SCHEMAS, 0)
    scheme = CustomBuckets(les)
    b = RecordBuilder(DEFAULT_SCHEMAS)
    for s in range(num_series):
        labels = {"_metric_": "req_latency", "_ws_": "demo",
                  "_ns_": "App-0", "instance": f"i{s}"}
        base = np.array([1, 3, 7, 10]) * (s + 1)
        for t in range(n):
            k = t - reset_at if t >= reset_at else t
            counts = (base * (k + 1)).astype(np.int64)
            total = int(counts[-1])
            b.add_sample("prom-histogram", labels,
                         T0 * 1000 + 5_000 + t * 10_000, total * 0.05,
                         float(total), (scheme, counts))
    for c in b.containers():
        shard.ingest(c)
    return shard


@pytest.mark.parametrize("ndev", [2, 8])
def test_mesh_sum_rate_hist_matches_oracle(ndev):
    """sum(rate(hist[w])) by bucket expansion on the mesh, across a
    counter reset (the host applies the any-bucket reset correction)."""
    shard = _hist_shard()
    plan = parse_query_range("sum(rate(req_latency[5m]))",
                             TimeStepParams(T0 + 600, 60, T0 + 3000))
    planner = QueryPlanner([shard], mesh_executor=MeshExecutor(
        make_mesh(ndev, 1, [CPU] * ndev)))
    ex = planner.materialize(plan)
    assert isinstance(ex, MeshAggregateExec)
    got = ex.execute()
    want = QueryEngine([shard]).execute(plan)
    assert got.is_hist() and want.is_hist()
    np.testing.assert_array_equal(got.bucket_les, want.bucket_les)
    assert got.num_series == want.num_series == 1
    np.testing.assert_allclose(got.hist_values[0], want.hist_values[0],
                               rtol=1e-9, equal_nan=True)


def _limit_shard(n=400):
    shard = TimeSeriesShard(REF, DEFAULT_SCHEMAS, 0)
    b = RecordBuilder(DEFAULT_SCHEMAS)
    for s in range(3):
        c = {"_metric_": "reqs_total", "_ws_": "demo", "_ns_": "App-0",
             "instance": f"i{s}"}
        for t in range(n):
            b.add_sample("prom-counter", c, T0 * 1000 + t * 10_000,
                         float((t + 1) * (s + 1)))
    for cont in b.containers():
        shard.ingest(cont)
    return shard


def test_mesh_limit_budget_is_per_query():
    """A reused planner with a mesh executor does not accumulate scanned
    samples across queries into the limit check."""
    plan = parse_query_range("sum(rate(reqs_total[5m]))",
                             TimeStepParams(T0 + 600, 60, T0 + 1800))
    planner = QueryPlanner([_limit_shard()], mesh_executor=MeshExecutor(
        make_mesh(2, 1, [CPU] * 2)), limits=QueryLimits(sample_limit=2000))
    assert isinstance(planner.materialize(plan), MeshAggregateExec)
    for _ in range(5):      # each query scans ~1080 samples; 5x > limit
        out = planner.materialize(plan).execute()
        assert out.num_series == 1


# ---------------------------------------------------------------------------
# cross-flush refresh, end to end
# ---------------------------------------------------------------------------

def test_mesh_results_track_ingest_across_flush(pair):
    """New samples ingested and flushed after the placement was built
    show in mesh-served answers exactly as in the plain server's (the
    refresh appends in place or re-places: no stale serving)."""
    plain, meshed = pair
    for srv in (plain, meshed):
        srv.seed_dev_data(n_samples=20, n_instances=3,
                          start_ms=(T0 + 600) * 1000)
    params = dict(query="rate(http_requests_total[5m])",
                  start=T0 + 550, end=T0 + 750, step=60, cache="false")
    path = "/promql/timeseries/api/v1/query_range"
    for _ in range(30):
        a = _get(plain.port, path, **params)
        b = _get(meshed.port, path, **params)
        if _data(a) == _data(b):
            break
        time.sleep(0.5)
    assert _data(a) == _data(b)
