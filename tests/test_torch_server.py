"""The port's standalone server and Prometheus HTTP API against the JAX
package's, in one process, over real sockets.

Both servers run with four shards and identical data: ``seed_dev_data``
(360 samples, 4 instances, a fixed start) plus jittered counters with an
unflushed tail, counters of irregular cadence and integer gauges with an
unflushed tail, loaded into the port through ``state.load_into_store``
and into the JAX package through its own ingest, both routed by
``ingestion_shard``. The same HTTP requests go to both, and the answers
must have the same JSON structure, labels and timestamps, with values
within the tolerance of each function family (tests/test_torch_engine.py
and tests/test_torch_functions.py state them):

  * grouped sums, averages and counts of rate (fused group-sum): rtol
    1e-5, atol 1e-7;
  * per-series rate on aligned tiles: 8 f32 ulps (twice the f32
    epilogue's budget);
  * rate on irregular series (the packed path): 4 f64 ulps;
  * max_over_time: bit-equal;
  * avg_over_time: rtol 2e-9, atol 2e-9 (twice the oracle tolerance);
  * histogram_quantile and the instant scalar over max_over_time, which
    both packages evaluate in the same numpy code: rtol 1e-12.
"""

import json
import os
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
from filodb_tpu.lint import capacity as j_capacity
from filodb_tpu.standalone.server import FiloServer as JServer
from filodb_tpu_torch import state
from filodb_tpu_torch.lint import capacity as p_capacity
from filodb_tpu_torch.standalone import server as psrv

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_600_000_000_000
DT = 10_000
N = 360
TAIL = 30
START = T0 // 1000 + 600
FLUSHED_END = (T0 + (N - 5) * DT) // 1000       # seconds
TAIL_END = (T0 + (N + TAIL - 2) * DT) // 1000
# the port's servers in this process: on the CPU, and without the
# start-up gc.freeze(), which would retune the collector of the whole test
# process
CPU = {"device": "cpu", "gc-freeze": False}


def _rows(seed=5, S=16, S_irr=8):
    """(counter rows, counter tails, irregular rows, gauge rows, gauge
    tails) as (labels, ts ms, values) triples."""
    rng = np.random.default_rng(seed)
    ctr, ctr_tail, irr, gauge, gauge_tail = [], [], [], [], []
    for i in range(S):
        ts = T0 + np.arange(N + TAIL) * DT + rng.integers(-2000, 2000,
                                                          N + TAIL)
        v = 1e9 + np.cumsum(rng.uniform(0, 5, N + TAIL))
        if i == 3:
            v[N // 2:] -= v[N // 2 - 1]          # counter reset
        lab = {"_metric_": "http_requests_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 4}", "instance": f"i{i}"}
        ctr.append((lab, ts[:N], v[:N]))
        ctr_tail.append((lab, ts[N:], v[N:]))
    for i in range(S_irr):
        ts = np.unique(T0 + np.arange(N) * DT
                       + rng.integers(-6000, 6000, N))
        v = np.cumsum(rng.uniform(0, 3, ts.size))
        lab = {"_metric_": "irregular_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 2}", "instance": f"k{i}"}
        irr.append((lab, ts, v))
    for i in range(S):
        ts = T0 + np.arange(N + TAIL) * DT + rng.integers(-2000, 2000,
                                                          N + TAIL)
        d = np.where(rng.random(N + TAIL) < 0.3, 0,
                     rng.integers(-15, 16, N + TAIL))
        v = (1000 + np.cumsum(d)).astype(np.float64)
        lab = {"_metric_": "queue_depth", "_ws_": "demo", "_ns_": "App-0",
               "job": f"job{i % 4}", "instance": f"g{i}"}
        gauge.append((lab, ts[:N], v[:N]))
        gauge_tail.append((lab, ts[N:], v[N:]))
    return ctr, ctr_tail, irr, gauge, gauge_tail


def _load_jax(srv, rows, schema, flush):
    """The JAX package's own ingest: per-shard RecordBuilders routed by
    its ``ingestion_shard``, then a flush of the whole store."""
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


@pytest.fixture(scope="module")
def servers():
    port = psrv.FiloServer({"num-shards": 4, "port": 0, **CPU}).start()
    # gc-freeze off: the reference's startup would retune the collector of
    # the whole test process
    jax_srv = JServer({"num-shards": 4, "port": 0,
                       "gc-freeze": False}).start()
    assert jax_srv.backend is not None
    ctr, ctr_tail, irr, gauge, gauge_tail = _rows()
    loads = ((ctr, "prom-counter", True), (irr, "prom-counter", True),
             (gauge, "gauge", True),
             # the tails last: a flush would encode them into chunks
             (ctr_tail, "prom-counter", False),
             (gauge_tail, "gauge", False))
    for srv in (port, jax_srv):
        srv.seed_dev_data(n_samples=N, n_instances=4, start_ms=T0)
    for rows, schema, flush in loads:
        state.load_into_store(port.store, port.ref, rows, schema, flush,
                              num_shards=4, spread=1)
        _load_jax(jax_srv, rows, schema, flush)
    yield port, jax_srv
    port.stop()
    jax_srv.stop()


def _get(srv, path, **params):
    url = f"http://127.0.0.1:{srv.port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _both(servers, path, **params):
    (pc, pb), (jc, jb) = (_get(s, path, **params) for s in servers)
    assert pc == jc, (pb, jb)
    return pc, json.loads(pb), json.loads(jb)


def _f32_ulps(a, b):
    mag = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.abs(a - b) / np.spacing(mag).astype(np.float64)


def _f64_ulps(a, b):
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


TOLERANCES = {
    "grouped": lambda a, b: np.allclose(a, b, rtol=1e-5, atol=1e-7),
    "f32x8": lambda a, b: (_f32_ulps(a, b) <= 8).all(),
    "f64x4": lambda a, b: (_f64_ulps(a, b) <= 4).all(),
    "exact": lambda a, b: np.array_equal(a, b),
    "prefix": lambda a, b: np.allclose(a, b, rtol=2e-9, atol=2e-9),
    "numpy": lambda a, b: np.allclose(a, b, rtol=1e-12, atol=0.0),
}


def _assert_result_match(pd, jd, tol: str):
    """Same envelope, result type, series labels and timestamps; values
    within ``tol``."""
    assert pd["status"] == jd["status"] == "success"
    assert pd["data"]["resultType"] == jd["data"]["resultType"]
    kind = pd["data"]["resultType"]
    pr, jr = pd["data"]["result"], jd["data"]["result"]
    if kind == "scalar":
        assert pr[0] == jr[0]
        assert TOLERANCES[tol](np.float64(pr[1]), np.float64(jr[1]))
        return
    assert [e["metric"] for e in pr] == [e["metric"] for e in jr]
    assert len(pr) > 0
    field = "values" if kind == "matrix" else "value"
    for pe, je in zip(pr, jr):
        pv = np.asarray(pe[field] if kind == "matrix" else [pe[field]])
        jv = np.asarray(je[field] if kind == "matrix" else [je[field]])
        np.testing.assert_array_equal(pv[:, 0].astype(np.float64),
                                      jv[:, 0].astype(np.float64))
        a, b = pv[:, 1].astype(np.float64), jv[:, 1].astype(np.float64)
        assert TOLERANCES[tol](a, b), (pe["metric"], tol, a, b)
    assert pd["stats"]["seriesScanned"] == jd["stats"]["seriesScanned"]
    assert pd["stats"]["samplesScanned"] == jd["stats"]["samplesScanned"]


RANGE_QUERIES = [
    ("rate(http_requests_total[5m])", TAIL_END, "f32x8"),
    ("sum by (job) (rate(http_requests_total[5m]))", FLUSHED_END,
     "grouped"),
    ("avg by (job) (rate(http_requests_total[5m]))", FLUSHED_END,
     "grouped"),
    ("count by (job) (rate(http_requests_total[5m]))", FLUSHED_END,
     "grouped"),
    ("avg_over_time(queue_depth[5m])", TAIL_END, "prefix"),
    ("max_over_time(queue_depth[5m])", TAIL_END, "exact"),
    ("rate(irregular_total[5m])", FLUSHED_END, "f64x4"),
    ("histogram_quantile(0.9, rate(http_request_latency[5m]))",
     FLUSHED_END, "numpy"),
]


@pytest.mark.parametrize("query,end,tol", RANGE_QUERIES,
                         ids=[q for q, _, _ in RANGE_QUERIES])
def test_query_range_matches_the_jax_server(servers, query, end, tol):
    code, pd, jd = _both(servers, "/promql/timeseries/api/v1/query_range",
                         query=query, start=START, end=end, step=60,
                         cache="false")
    assert code == 200
    _assert_result_match(pd, jd, tol)


INSTANT_QUERIES = [
    ("sum by (job) (rate(http_requests_total[5m]))", "grouped", "vector"),
    ("scalar(sum(max_over_time(queue_depth[5m])))", "numpy", "scalar"),
]


@pytest.mark.parametrize("query,tol,kind", INSTANT_QUERIES,
                         ids=[k for _, _, k in INSTANT_QUERIES])
def test_instant_query_matches_the_jax_server(servers, query, tol, kind):
    code, pd, jd = _both(servers, "/promql/timeseries/api/v1/query",
                         query=query, time=FLUSHED_END)
    assert code == 200
    assert pd["data"]["resultType"] == kind
    _assert_result_match(pd, jd, tol)


METADATA = [
    ("/promql/timeseries/api/v1/labels", {}),
    ("/promql/timeseries/api/v1/label/job/values", {}),
    ("/promql/timeseries/api/v1/label/_metric_/values", {}),
    ("/promql/timeseries/api/v1/series",
     {"match[]": "irregular_total{job=\"job1\"}"}),
    ("/api/v1/cluster/timeseries/status", {}),
    # the shards' cardinality trackers, through TsCardinalities
    ("/api/v1/cardinality/timeseries", {"prefix": "demo", "depth": "3"}),
]


@pytest.mark.parametrize("path,params", METADATA,
                         ids=[p.rsplit("/", 2)[-2] + "/"
                              + p.rsplit("/", 1)[-1] for p, _ in METADATA])
def test_metadata_matches_the_jax_server(servers, path, params):
    code, pd, jd = _both(servers, path, **params)
    assert code == 200
    assert pd == jd
    assert pd["data"]


def test_health_matches_the_jax_server(servers):
    code, pd, jd = _both(servers, "/__health")
    assert code == 200
    for key in ("status", "shards", "watermarks", "backfill_epochs",
                "down_peers", "ingest_read_only", "integrity",
                "topo_epoch"):
        assert pd[key] == jd[key], key


ERRORS = [
    # a PromQL parse error is no QueryError: the reference's edge answers
    # it 500 "internal", and the port answers as the reference does
    ("/promql/timeseries/api/v1/query_range",
     {"query": "sum(rate(", "start": START, "end": FLUSHED_END,
      "step": 60}, 500),
    ("/promql/timeseries/api/v1/query_range",
     {"start": START, "end": FLUSHED_END, "step": 60}, 400),
    ("/promql/timeseries/api/v1/query_range",
     {"query": "up", "start": FLUSHED_END, "end": START, "step": 60}, 400),
    ("/promql/nosuch/api/v1/query_range",
     {"query": "up", "start": START, "end": FLUSHED_END, "step": 60}, 400),
    ("/promql/nosuch/api/v1/labels", {}, 400),
    ("/no/such/route", {}, 404),
    ("/promql/timeseries/api/v1/nosuch", {}, 404),
]


@pytest.mark.parametrize("path,params,code", ERRORS,
                         ids=["parse-error", "missing-query",
                              "end-before-start", "unknown-dataset",
                              "unknown-dataset-labels", "unknown-route",
                              "unknown-api"])
def test_errors_match_the_jax_server(servers, path, params, code):
    got, pd, jd = _both(servers, path, **params)
    assert got == code
    assert pd["status"] == jd["status"] == "error"
    assert pd["errorType"] == jd["errorType"]


def _metric_value(srv, family: str) -> float:
    _, body = _get(srv, "/metrics")
    for line in body.decode().splitlines():
        if line.startswith(family + " "):
            return float(line.split()[1])
    raise AssertionError(f"{family} not in /metrics")


def test_repeated_query_is_served_from_the_results_cache(servers):
    port = servers[0]
    q = dict(query="sum by (job) (rate(http_requests_total[5m]))",
             start=START, end=FLUSHED_END - 600, step=60)
    hits0 = _metric_value(port, "filodb_result_cache_hits_total")
    _, first = _get(port, "/promql/timeseries/api/v1/query_range", **q)
    _, second = _get(port, "/promql/timeseries/api/v1/query_range", **q)
    first, second = json.loads(first), json.loads(second)
    assert second["stats"]["timings"]["resultCache"] == "hit"
    assert _metric_value(port, "filodb_result_cache_hits_total") \
        == hits0 + 1
    assert first["data"] == second["data"]
    # the escape hatch bypasses the cache and reaches the engine again
    _, third = _get(port, "/promql/timeseries/api/v1/query_range",
                    cache="false", **q)
    third = json.loads(third)
    assert third["stats"]["timings"]["resultCache"] == "bypass"
    assert third["data"] == first["data"]


def test_metrics_carry_the_backend_and_cache_families(servers):
    port = servers[0]
    _get(port, "/promql/timeseries/api/v1/query_range",
         query="rate(http_requests_total[5m])", start=START,
         end=FLUSHED_END, step=60)
    for fam in ("filodb_tile_builds_total", "filodb_tile_cache_entries",
                "filodb_batcher_queries_total", "filodb_batcher_enabled",
                "filodb_plan_cache_entries", "filodb_result_cache_bytes",
                "filodb_admission_max_inflight"):
        _metric_value(port, fam)
    assert _metric_value(port, "filodb_tile_builds_total") >= 1
    assert _metric_value(port, "filodb_batcher_queries_total") >= 1
    # dispatch-key reuse, as the reference's compiled-executable reuse
    assert _metric_value(port, "filodb_exec_cache_misses_total") >= 1
    assert _metric_value(port, "filodb_exec_cache_entries") >= 1
    _metric_value(port, "filodb_exec_cache_hits_total")


def test_sample_limit_answers_422(servers):
    srv = psrv.FiloServer({"num-shards": 4, "port": 0, **CPU,
                           "query-sample-limit": 1000}).start()
    try:
        srv.seed_dev_data(n_samples=N, n_instances=4, start_ms=T0)
        code, body = _get(srv, "/promql/timeseries/api/v1/query_range",
                          query="rate(http_requests_total[5m])",
                          start=START, end=FLUSHED_END, step=60)
        assert code == 422
        assert json.loads(body)["errorType"] == "query_limit"
    finally:
        srv.stop()


ANALYZE = [
    ("query_range", {"query": "rate(http_requests_total[5m])",
                     "start": START, "end": TAIL_END, "step": 60}),
    ("query", {"query": "sum by (job) (rate(http_requests_total[5m]))",
               "time": FLUSHED_END}),
]


@pytest.mark.parametrize("route,params", ANALYZE,
                         ids=[r for r, _ in ANALYZE])
def test_explain_analyze_answers_with_the_reference_envelope(
        servers, route, params):
    """``&explain=analyze`` answers with the reference's envelope keys and
    stage keys, and its ``data`` is the answer without ``explain``."""
    path = f"/promql/timeseries/api/v1/{route}"
    code, pd, jd = _both(servers, path, explain="analyze", cache="false",
                         **params)
    assert code == 200
    # the residency section follows each process-wide registry of live
    # sharded stores, which other test files may have left filled
    assert set(pd["analyze"]) - {"residency"} == \
        set(jd["analyze"]) - {"residency"} >= {
            "stages", "device", "batcher", "qos"}
    for az, cap in ((pd["analyze"], p_capacity),
                    (jd["analyze"], j_capacity)):
        assert ("residency" in az) == bool(cap.residency_snapshot())
    assert set(pd["analyze"]["stages"]) == set(jd["analyze"]["stages"])
    assert set(pd["analyze"]["device"]) == {"executables", "dispatches"}
    assert pd["analyze"]["device"]["executables"]
    code, plain = _get(servers[0], path, cache="false", **params)
    assert code == 200
    assert json.loads(plain)["data"] == pd["data"]


PROFILER_ON = {"profiler-enabled": True, "profiler-hz": 50.0,
               "profiler-max-stacks": 128, "profiler-top-n": 5}


@pytest.mark.parametrize("key", sorted(PROFILER_ON))
def test_profiler_config_keys_are_honoured(key):
    """The sampling profiler's keys (ROADMAP A.9) take effect: each reaches
    the profiler that profiler-enabled starts."""
    assert key in psrv.DEFAULTS and key not in psrv.REFUSED
    srv = psrv.FiloServer({"port": 0, "profiler-enabled": True,
                           key: PROFILER_ON[key], **CPU}).start()
    try:
        prof = srv.http.profiler
        assert prof is not None and prof.running
        got = {"profiler-enabled": prof.running, "profiler-hz": prof.hz,
               "profiler-max-stacks": prof.max_stacks,
               "profiler-top-n": prof.top_n}
        assert got[key] == PROFILER_ON[key]
    finally:
        srv.stop()
    assert not prof.running


def test_stop_releases_the_backend_and_its_device_tiles():
    """A stopped server keeps no device memory alive: the rules engine and
    the self-monitoring loop take their collectors out of the global
    metric registry, so nothing reaches the server once its owner drops
    it, and the backend it built drops its cached tiles at once (the
    holder of ROADMAP C.23)."""
    import gc
    import weakref
    cfg = {"port": 0, "self-monitor": True, "self-monitor-interval-s": 3600,
           "rules": {"groups": [{"name": "g", "interval": "1h", "rules": [
               {"record": "job:x:rate5m",
                "expr": "sum by (job) (rate(http_requests_total[5m]))"}]}]}}
    srv = psrv.FiloServer({**cfg, **CPU}).start()
    srv.seed_dev_data(n_samples=N, n_instances=4, start_ms=T0)
    code, _ = _get(srv, "/promql/timeseries/api/v1/query_range",
                   query="sum by (job) (rate(http_requests_total[5m]))",
                   start=START, end=FLUSHED_END, step=60)
    assert code == 200
    be = srv.backend
    (entry,) = be._tile_cache.values()
    tile_ref = weakref.ref(entry.tiles)
    be_ref = weakref.ref(be)
    del entry
    srv.stop()
    assert len(be._tile_cache) == 0
    del be
    gc.collect()
    assert tile_ref() is None           # released by stop() itself
    del srv
    gc.collect()
    assert be_ref() is None


def test_the_raw_leaf_route_is_ported():
    """POST /api/v1/raw/{ds} (the peer leaf plane) no longer answers 501:
    a bodyless request gets the reference's 400."""
    port = psrv.FiloServer({"num-shards": 4, "port": 0, **CPU}).start()
    jax_srv = JServer({"num-shards": 4, "port": 0, "grpc-port": None,
                       "gc-freeze": False}).start()
    try:
        (pc, pb), (jc, jb) = (_get(s, "/api/v1/raw/timeseries")
                              for s in (port, jax_srv))
        assert pc == jc == 400
        assert json.loads(pb) == json.loads(jb)
    finally:
        port.stop()
        jax_srv.stop()


OFF_ROUTES = [("/api/v1/rules", 200), ("/api/v1/alerts", 200),
              ("/debug/profile", 404), ("/api/v1/ingest/influx", 404),
              ("/admin/drain", 400)]


@pytest.mark.parametrize("path,code", OFF_ROUTES,
                         ids=[p for p, _ in OFF_ROUTES])
def test_routes_of_features_off_answer_as_the_reference(path, code):
    srv = psrv.FiloServer({"num-shards": 4, "port": 0, **CPU}).start()
    jax_srv = JServer({"num-shards": 4, "port": 0, "grpc-port": None,
                       "gc-freeze": False}).start()
    try:
        # /admin/drain on a node without peers: both build their
        # membership manager, and both refuse to drain
        (pc, pb), (jc, jb) = (_get(s, path) for s in (srv, jax_srv))
        assert pc == jc == code
        assert json.loads(pb) == json.loads(jb)
    finally:
        srv.stop()
        jax_srv.stop()


# a value that turns each formerly refused key's feature on (A.11's
# keys, refused until the mesh was ported, now honoured)
REFUSED_ON = {"mesh-enabled": True, "mesh-tile-serving": True}
# mesh tile serving turns on only together with the mesh
ON_WITH = {"mesh-tile-serving": {"mesh-enabled": True}}


@pytest.mark.parametrize("key", sorted(REFUSED_ON))
def test_unported_config_keys_are_refused(key, monkeypatch):
    """No key is refused any more (the test keeps the name it had while
    these keys were refused): A.11's keys build the mesh (here 2
    partitions of the CPU) and, with tile serving, the backend's
    resident sharded tile evaluator."""
    from filodb_tpu_torch.parallel import mesh as pmesh

    assert psrv.REFUSED == {}
    assert psrv.DEFAULTS[key] == J_DEFAULTS[key]
    monkeypatch.setenv(pmesh.PARTITIONS_ENV, "2")
    srv = psrv.FiloServer({key: REFUSED_ON[key], **ON_WITH.get(key, {}),
                           "port": 0, "grpc-port": None, **CPU}).start()
    try:
        assert srv.mesh_executor is not None
        assert srv.mesh_executor.ndev == 2
        assert srv.http.mesh_executor is srv.mesh_executor
        assert srv.backend.mesh_eval is not None
        assert srv.backend.mesh_eval.ndev == 2
    finally:
        srv.stop()


# a value that turns each supervisor key on (ROADMAP A.1.5: honoured)
SUPERVISOR_ON = {"worker-id": 0, "accept-port": 9000,
                 "accept-host": "127.0.0.2", "accept-fd": 3,
                 "bus-port": 9001, "bus-watermark-interval-s": 0.5}


@pytest.mark.parametrize("key", sorted(SUPERVISOR_ON))
def test_supervisor_config_keys_are_honoured(key):
    assert set(SUPERVISOR_ON) == SUPERVISOR_KEYS
    assert not set(SUPERVISOR_ON) & (set(psrv.REFUSED) | set(psrv.INERT))
    srv = psrv.FiloServer({key: SUPERVISOR_ON[key], "device": "cpu"})
    assert srv.config[key] == SUPERVISOR_ON[key]


def test_config_keys_at_their_off_values_are_accepted():
    off = {"data-dir": None, "gateway-port": None, "grpc-port": None,
           "mesh-enabled": False, "mesh-tile-serving": True,
           "raw-retention-s": None, "peers": {}, "num-nodes": 1,
           "worker-id": None, "accept-fd": None, "rules": None}
    psrv.FiloServer({**off, "device": "cpu"})


def test_no_cuda_device_and_no_device_named_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = psrv.FiloServer({"port": 0})
    with pytest.raises(RuntimeError, match="CUDA"):
        srv.start()
    assert srv.http is None and srv.backend is None


BATCH_KNOBS = [
    ({}, (1e-3, 8, True)),
    ({"batch-gather-window-ms": 3.0, "batch-max": 5,
      "batch-enabled": False}, (3e-3, 5, False)),
]


@pytest.mark.parametrize("knobs,want", BATCH_KNOBS, ids=["default", "set"])
def test_batcher_knobs_reach_the_micro_batcher(knobs, want):
    srv = psrv.FiloServer({"port": 0, **CPU, **knobs}).start()
    try:
        b = srv.backend.batcher
        assert (b.gather_window_s, b.max_batch, b.enabled) == want
        assert b.use_executor is False      # inline leaders on the CPU
    finally:
        srv.stop()


def test_main_prints_the_startup_line_first():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "filodb_tpu_torch.standalone.server",
         "--port", "0", "--device", "cpu", "--seed-dev-data"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    try:
        line = json.loads(proc.stdout.readline())
        assert set(line) == {"port", "gateway_port", "grpc_port"}
        # the gRPC plane is on by default, on an ephemeral port, as in
        # the reference
        assert line["port"] > 0 and line["grpc_port"] > 0
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{line['port']}/promql/timeseries"
                        "/api/v1/label/_metric_/values", timeout=10) as r:
                    data = json.loads(r.read())["data"]
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.2)
        assert "heap_usage" in data
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.fixture(scope="module")
def qos_servers():
    """Both servers with one tenant on a budget far below any query's
    estimated cost, over the dev data."""
    cfg = {"num-shards": 4, "port": 0,
           "qos-tenant-overrides": {"abuser": [0.001, 1.0]}}
    port = psrv.FiloServer({**cfg, **CPU}).start()
    jax_srv = JServer({**cfg, "grpc-port": None,
                       "gc-freeze": False}).start()
    for srv in (port, jax_srv):
        srv.seed_dev_data(n_samples=N, n_instances=4, start_ms=T0)
    yield port, jax_srv
    port.stop()
    jax_srv.stop()


@pytest.mark.parametrize("tenant,code", [("abuser", 429), ("other", 200)])
def test_tenant_budgets_shed_as_the_reference(qos_servers, tenant, code):
    got, pd, jd = _both(qos_servers, "/promql/timeseries/api/v1/query_range",
                        query="sum(rate(http_requests_total[5m]))",
                        start=START, end=FLUSHED_END, step=60,
                        tenant=tenant)
    assert got == code
    assert pd["status"] == jd["status"]
    if code == 429:
        assert pd["errorType"] == jd["errorType"] == "throttled"
    else:
        _assert_result_match(pd, jd, "grouped")
    _, body = _get(qos_servers[0], "/metrics")
    assert f'filodb_tenant_budget_remaining{{tenant="abuser"}}'.encode() \
        in body


# -- config keys (every key of the reference's DEFAULTS lands somewhere) ---

J_DEFAULTS = sys.modules[JServer.__module__].DEFAULTS
# the keys of gRPC (ROADMAP A.1.3) and of multi-node membership (A.1.4):
# honoured, with the reference's defaults
CLUSTER_KEYS = {
    "grpc-port", "grpc-peers", "grpc-partitions", "num-nodes",
    "node-ordinal", "peers", "discovery", "advertise-url", "buddy-peers",
    "partitions", "local-partitions", "failure-detect-interval-s",
    "failure-detect-threshold", "shard-reassign-grace-s",
    "elastic-membership", "handoff-timeout-s", "peer-fanout-workers",
    "peer-retry-attempts", "peer-retry-base-delay-s",
    "breaker-failure-threshold", "breaker-reset-s", "query-timeout-s",
}
# the keys of recording rules (ROADMAP A.1.6) and self-monitoring (A.1.7):
# honoured, with the reference's defaults
RULES_KEYS = {"rules", "rules-file", "rules-eval-span-steps",
              "rules-webhook-url", "self-monitor", "self-monitor-interval-s",
              "self-monitor-flush-ticks"}
# the supervisor's keys (A.1.5): honoured, with the reference's defaults
SUPERVISOR_KEYS = {"worker-id", "accept-port", "accept-host", "accept-fd",
                   "bus-port", "bus-watermark-interval-s"}
# downsampling's keys (A.10): honoured, with the reference's defaults
DOWNSAMPLE_KEYS = {"raw-retention-s", "downsample-resolutions",
                   "flush-downsample"}
# the mesh's keys (A.11): honoured, with the reference's defaults
MESH_KEYS = {"mesh-enabled", "mesh-tile-serving"}


@pytest.mark.parametrize("key", sorted(J_DEFAULTS))
def test_every_reference_config_key_is_honoured_refused_or_listed(key):
    places = [key in psrv.DEFAULTS, key in psrv.REFUSED, key in psrv.INERT]
    assert places.count(True) == 1, (key, places)
    if key in (CLUSTER_KEYS | RULES_KEYS | SUPERVISOR_KEYS | DOWNSAMPLE_KEYS
               | MESH_KEYS):
        assert key in psrv.DEFAULTS
        assert psrv.DEFAULTS[key] == J_DEFAULTS[key]
    if key in psrv.REFUSED:
        assert psrv.REFUSED[key].startswith("A.")
    if key in psrv.INERT:
        assert "(" in psrv.INERT[key]     # names its ROADMAP item
    # the reference's default value is accepted
    srv = psrv.FiloServer({key: J_DEFAULTS[key], **CPU})
    if key in psrv.DEFAULTS:
        assert srv.config[key] == J_DEFAULTS[key]


def test_gc_freeze_and_gil_switch_interval_are_applied(monkeypatch):
    import gc
    calls = []
    monkeypatch.setattr(gc, "freeze", lambda: calls.append("freeze"))
    monkeypatch.setattr(sys, "setswitchinterval",
                        lambda s: calls.append(("switch", s)))
    srv = psrv.FiloServer({"port": 0, "device": "cpu",
                           "gil-switch-interval-ms": 2}).start()
    srv.stop()
    assert calls == [("switch", 0.002), "freeze"]
    calls.clear()
    srv = psrv.FiloServer({"port": 0, **CPU}).start()
    srv.stop()
    assert calls == []


# the gauge of live sharded stores: each package's collector renders it
# while its process-wide residency registry is not empty, which stores
# other test files left alive on the same worker process may keep it
RESIDENCY_FAMILY = "filodb_device_memory_bytes"


def _families(srv):
    """The /metrics families of ``srv``, less the residency gauge, held
    apart to its own package's registry: present if and only if that
    registry held a store just before or just after the scrape."""
    cap = p_capacity if isinstance(srv, psrv.FiloServer) else j_capacity
    before = bool(cap.residency_snapshot())
    _, body = _get(srv, "/metrics")
    fams = {ln.split()[2] for ln in body.decode().splitlines()
            if ln.startswith("# TYPE ")}
    after = bool(cap.residency_snapshot())
    assert (RESIDENCY_FAMILY in fams) in (before, after), (before, after)
    return fams - {RESIDENCY_FAMILY}


# families of the reference with no counterpart in the port -> why: none
# since the port accounts its dispatch keys (the exec-cache families) and
# profiles them (obs/devprof.py)
ABSENT_FAMILIES: set = set()
# families whose presence follows what the PROCESS has dispatched (the
# device profiler's table is process-global in both packages) and, for
# the cost gauges, costed: the reference costs its tile executables at
# their ahead-of-time build, the port at the first &explain=analyze that
# touches each (obs/devprof.py). Compared apart from the rest.
PROFILE_FAMILIES = {
    "filodb_executable_builds_total", "filodb_executable_recompiles_total",
    "filodb_executable_flops", "filodb_executable_bytes_accessed"}
# a family the reference keeps showing once any server of the process ran
# its self-monitoring loop: a stopped SelfMonitor's collector stays in the
# reference's process-global registry, where the port's leaves it at stop
# (the holder of ROADMAP C.23)
STALE_REFERENCE_FAMILIES = {"filodb_selfmon_last_tick_age_seconds"}
# the device profiler's families every server shows, in both packages
DEVICE_PROFILE_FAMILIES = {
    "filodb_executables", "filodb_exec_cache_entries",
    "filodb_exec_cache_hits_total", "filodb_exec_cache_misses_total"}
# families of the port the reference lacks -> why: the count of gRPC
# downgrades to the HTTP plane (ROADMAP C.15)
EXTRA_FAMILIES = {"filodb_grpc_plane_fallbacks_total"}
DEFAULT_ON_FAMILIES = {
    # the gRPC plane and membership, on at the defaults
    "filodb_grpc_rpcs_served_total", "filodb_peer_fanout_workers",
    "filodb_shard_handoff_started_total",
    "filodb_stale_routing_bounces_total",
    "filodb_tenant_metering_interval_seconds",
    "filodb_tenant_metering_snapshots_total",
    "filodb_tenant_metering_last_snapshot_age_seconds",
    "filodb_process_resident_memory_bytes", "filodb_process_open_fds",
    "filodb_process_threads", "filodb_process_gc_collections_total",
    "filodb_process_uptime_seconds", "filodb_build_info",
    "filodb_decode_cache_bytes",
}


def _reset_registries():
    """Drop the families earlier work in this process left in both
    packages' global registries (collectors stay registered)."""
    from filodb_tpu.obs import metrics as j_metrics
    from filodb_tpu_torch.obs import metrics as p_metrics
    j_metrics.GLOBAL_REGISTRY.reset()
    p_metrics.GLOBAL_REGISTRY.reset()


def test_metric_families_match_the_jax_server_at_the_defaults():
    _reset_registries()
    srv = psrv.FiloServer({"port": 0, **CPU}).start()
    jax_srv = JServer({"port": 0, "gc-freeze": False}).start()
    try:
        pf, jf = _families(srv), _families(jax_srv)
    finally:
        srv.stop()
        jax_srv.stop()
    assert pf - PROFILE_FAMILIES == (jf - ABSENT_FAMILIES - PROFILE_FAMILIES
                                     - STALE_REFERENCE_FAMILIES) \
        | EXTRA_FAMILIES
    assert (DEFAULT_ON_FAMILIES | DEVICE_PROFILE_FAMILIES) <= pf


# families of the rules engine, its notifier and the self-monitoring loop
RULES_ON_FAMILIES = {
    "filodb_rules_active", "filodb_rule_group_interval_seconds",
    "filodb_rule_group_rules", "filodb_selfmon_alive",
    "filodb_selfmon_interval_seconds", "filodb_selfmon_ticks_total",
    "filodb_selfmon_samples_ingested_total",
    "filodb_selfmon_series_last_tick", "filodb_selfmon_tick_seconds",
    "filodb_selfmon_last_tick_age_seconds",
}


def test_metric_families_match_the_jax_server_with_rules_and_self_monitor():
    _reset_registries()
    cfg = {"port": 0, "self-monitor": True,
           "rules": {"groups": [{"name": "g", "interval": "1h", "rules": [
               {"record": "job:x:rate5m",
                "expr": "sum by (job) (rate(http_requests_total[5m]))"},
               {"alert": "Hot", "expr": "up == 0"}]}]}}
    srv = psrv.FiloServer({**cfg, **CPU}).start()
    jax_srv = JServer({**cfg, "gc-freeze": False}).start()
    try:
        for s in (srv, jax_srv):
            s.selfmon.collect_once()
        pf, jf = _families(srv), _families(jax_srv)
    finally:
        srv.stop()
        jax_srv.stop()
    assert pf - PROFILE_FAMILIES == \
        (jf - ABSENT_FAMILIES - PROFILE_FAMILIES) | EXTRA_FAMILIES
    assert (DEFAULT_ON_FAMILIES | RULES_ON_FAMILIES) <= pf


# spans of the reference with no counterpart in the port -> why:
#   kernel-build: an XLA evaluator build per dispatch-table key; eager
#     PyTorch builds none (the port's dispatches carry the device
#     profiler's ``executable`` event, as the reference's do)
ABSENT_SPANS = {"kernel-build"}
# families that appear once a query ran: the same build, timed
ABSENT_QUERY_FAMILIES = {"filodb_kernel_build_seconds"}
# the device telemetry a query records in both packages (ROADMAP C.18)
DEVICE_QUERY_FAMILIES = {
    "filodb_device_execute_seconds", "filodb_batcher_batch_size",
    "filodb_batcher_queue_wait_seconds"}


def _span_shape(trace):
    """Span names, and the path tags of the device dispatches."""
    names = {sp["name"] for sp in trace["spans"]}
    paths = sorted(sp.get("tags", {}).get("path", "")
                   for sp in trace["spans"]
                   if sp["name"] in ("device-eval", "device-dispatch"))
    return names, paths


@pytest.mark.parametrize("query,end", [
    ("rate(http_requests_total[5m])", TAIL_END),
    ("rate(irregular_total[5m])", FLUSHED_END)],
    ids=["aligned-and-tail", "packed"])
def test_a_traced_query_records_the_reference_spans_and_families(
        servers, query, end):
    """After one traced query the port's span names (device-eval, pack,
    device-dispatch with its path, batcher-dispatch, device-sync) and its
    /metrics families equal the JAX server's, less the listed absences."""
    _reset_registries()
    got, pd, jd = _both(servers, "/promql/timeseries/api/v1/query_range",
                        query=query, start=START, end=end, step=60,
                        explain="trace", cache="false")
    assert got == 200
    (pn, pp), (jn, jp) = _span_shape(pd["trace"]), _span_shape(jd["trace"])
    assert {"device-eval", "device-dispatch", "batcher-dispatch",
            "device-sync", "executable"} <= pn
    assert pn == jn - ABSENT_SPANS
    assert pp == jp
    pf, jf = (_families(s) for s in servers)
    assert DEVICE_QUERY_FAMILIES | {"filodb_executable_builds_total"} <= pf
    assert pf - PROFILE_FAMILIES == (jf - ABSENT_FAMILIES - PROFILE_FAMILIES
                                     - ABSENT_QUERY_FAMILIES
                                     - STALE_REFERENCE_FAMILIES) \
        | EXTRA_FAMILIES


# -- the write path: both servers with data-dir, stream-dir and gateway ---

W_N = 60                 # samples per series, 10 s apart
W_END = (T0 + (W_N - 1) * DT) // 1000


def _influx_lines(seed=9, S=8, S_irr=4):
    """Influx lines of jittered counters, irregular counters, integer
    gauges and histograms; values printed with repr, timestamps in ns."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(S):
        ts = T0 + np.arange(W_N) * DT + rng.integers(-2000, 2000, W_N)
        v = 1e9 + np.cumsum(rng.uniform(0, 5, W_N))
        for t, x in zip(ts, v):
            lines.append(f"http_requests_total,job=job{i % 4},"
                         f"instance=i{i} counter={float(x)!r} "
                         f"{int(t) * 10**6}")
    for i in range(S_irr):
        ts = np.unique(T0 + np.arange(W_N) * DT
                       + rng.integers(-6000, 6000, W_N))
        v = np.cumsum(rng.uniform(0, 3, ts.size))
        for t, x in zip(ts, v):
            lines.append(f"irregular_total,job=job{i % 2},instance=k{i} "
                         f"counter={float(x)!r} {int(t) * 10**6}")
    for i in range(S // 2):
        v = 1000 + np.cumsum(rng.integers(-15, 16, W_N))
        for k, x in enumerate(v):
            lines.append(f"queue_depth,job=job{i % 2},instance=g{i} "
                         f"gauge={float(x)!r} {(T0 + k * DT) * 10**6}")
    for k in range(W_N):
        c = np.cumsum(rng.integers(0, 3, 4)) + 3 * k
        lines.append(f"lat,job=job0 sum={0.5 * k!r},count={float(c[-1])!r},"
                     f"0.1={float(c[0])!r},0.5={float(c[1])!r},"
                     f"1={float(c[2])!r},+Inf={float(c[3])!r} "
                     f"{(T0 + k * DT) * 10**6}")
    return lines


def _post(srv, path, body: bytes, ctype="text/plain"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=body, method="POST",
        headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_ingested(srv, deadline_s=60):
    """Until every driver has applied every record of its stream."""
    deadline = time.monotonic() + deadline_s
    while any(d.recovered_to < 0 or d.next_offset < d.stream.end_offset()
              for d in srv.drivers.values()):
        assert time.monotonic() < deadline, "ingest did not catch up"
        time.sleep(0.02)


@pytest.fixture(scope="module")
def ingest_servers(tmp_path_factory):
    """Both servers, each on its own data-dir and stream-dir with its
    gateway, given the same lines: the first half POSTed in two bodies,
    the rest through the TCP gateway."""
    root = tmp_path_factory.mktemp("write-path")
    # no timed flush: both servers keep the same split of chunks (the
    # tiles) and write buffers (the packed path) while they are compared
    # (and the gRPC plane off in both: the write path is compared here)
    cfg = {"num-shards": 4, "port": 0, "gateway-port": 0,
           "stream-group-commit-ms": 0, "flush-interval-s": 3600,
           "grpc-port": None}
    port = psrv.FiloServer({**cfg, **CPU,
                            "data-dir": str(root / "p-data"),
                            "stream-dir": str(root / "p-stream")}).start()
    jax_srv = JServer({**cfg, "gc-freeze": False,
                       "data-dir": str(root / "j-data"),
                       "stream-dir": str(root / "j-stream")}).start()
    lines = _influx_lines()
    half = len(lines) // 2
    posts = []
    for srv in (port, jax_srv):
        posts.append([_post(srv, "/api/v1/ingest/influx",
                            "\n".join(part).encode())
                      for part in (lines[:half // 2],
                                   ["# comment", "bad line"]
                                   + lines[half // 2:half])])
    from filodb_tpu_torch.gateway.server import send_lines
    for srv in (port, jax_srv):
        send_lines("127.0.0.1", srv.gateway.port, lines[half:])
    for srv in (port, jax_srv):
        deadline = time.monotonic() + 60
        while srv.gateway.lines_ingested < len(lines):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        _wait_ingested(srv)
    yield port, jax_srv, posts, lines
    port.stop()
    jax_srv.stop()


def test_influx_posts_are_acknowledged_alike(ingest_servers):
    _, _, (pposts, jposts), lines = ingest_servers
    assert [c for c, _ in pposts] == [c for c, _ in jposts] == [200, 200]
    assert [json.loads(b) for _, b in pposts] \
        == [json.loads(b) for _, b in jposts]
    assert json.loads(pposts[1][1])["data"]["rejected"] == 1


WRITE_QUERIES = [
    ("sum by (job) (rate(http_requests_total[5m]))", "grouped"),
    ("avg by (job) (rate(http_requests_total[5m]))", "grouped"),
    ("rate(http_requests_total[5m])", "f32x8"),
    ("rate(irregular_total[5m])", "f64x4"),
    ("max_over_time(queue_depth[5m])", "exact"),
    ("histogram_quantile(0.9, rate(lat[5m]))", "numpy"),
]


@pytest.mark.parametrize("query,tol", WRITE_QUERIES,
                         ids=[q for q, _ in WRITE_QUERIES])
def test_ingested_data_answers_as_the_jax_server(ingest_servers, query,
                                                 tol):
    code, pd, jd = _both(ingest_servers[:2],
                         "/promql/timeseries/api/v1/query_range",
                         query=query, start=T0 // 1000 + 300, end=W_END,
                         step=60, cache="false")
    assert code == 200
    _assert_result_match(pd, jd, tol)


def _read_body(matchers, start_ms=T0, end_ms=T0 + W_N * DT):
    from filodb_tpu_torch.http import remote_read as rr
    return rr.snappy_compress(rr.encode_read_request(
        [{"matchers": matchers, "start_ms": start_ms, "end_ms": end_ms}]))


READS = [
    [("__name__", "eq", "http_requests_total")],
    [("__name__", "eq", "irregular_total"), ("job", "eq", "job1")],
    [("__name__", "re", "queue_depth|irregular_total")],
]


@pytest.mark.parametrize("matchers", READS, ids=["counters", "one-job",
                                                 "regex"])
def test_remote_read_bodies_are_byte_identical(ingest_servers, matchers):
    from filodb_tpu_torch.http import remote_read as rr
    body = _read_body(matchers)
    (pc, pb), (jc, jb) = (
        _post(s, "/promql/timeseries/api/v1/read", body,
              "application/x-protobuf") for s in ingest_servers[:2])
    assert pc == jc == 200
    assert pb == jb
    (series,) = rr.decode_read_response(rr.snappy_decompress(pb))
    assert len(series) > 0 and all(len(s) > 0 for _, s in series)


# the write path's own families: appends and fsyncs of a clean run (the
# fixture runs no flush), and the per-shard stats and gauges of the server
WRITE_FAMILIES = {"filodb_ingest_append_seconds",
                  "filodb_ingest_fsync_seconds",
                  "filodb_rows_ingested", "filodb_chunks_persisted",
                  "filodb_partitions_paged_in", "filodb_decode_cache_bytes",
                  "filodb_ingest_watermark_ms"}


def test_write_path_metric_families_match(ingest_servers):
    """The server families agree; of the process-wide registry's, those
    of the write path (the query path's histograms differ by backend and
    by what else this process ran)."""
    pf, jf = (_families(s) for s in ingest_servers[:2])
    assert WRITE_FAMILIES <= pf & jf
    assert pf - jf == set()


def test_a_repeat_query_after_ingest_is_not_served_stale(ingest_servers):
    """The results cache serves a full hit only up to every shard's
    ingest watermark: new samples in a cached range show in the repeat."""
    port, jax_srv = ingest_servers[:2]
    q = dict(query="sum by (job) (rate(http_requests_total[5m]))",
             start=T0 // 1000 + 300, end=W_END + 120, step=60)
    extra = []
    for i in range(8):
        for k in range(W_N, W_N + 12):
            extra.append(f"http_requests_total,job=job{i % 4},instance=i{i}"
                         f" counter={1e9 + 10 * k!r} "
                         f"{(T0 + k * DT) * 10**6}")
    out = {}
    for srv in (port, jax_srv):
        _, first = _get(srv, "/promql/timeseries/api/v1/query_range", **q)
        code, _ = _post(srv, "/api/v1/ingest/influx",
                        "\n".join(extra).encode())
        assert code == 200
        _wait_ingested(srv)
        _, again = _get(srv, "/promql/timeseries/api/v1/query_range", **q)
        _, fresh = _get(srv, "/promql/timeseries/api/v1/query_range",
                        cache="false", **q)
        first, again, fresh = (json.loads(b) for b in (first, again, fresh))
        # the stitched answer's cached head and recomputed tail are
        # evaluations of their own: equal within the grouped tolerance
        assert _grids_close(again, fresh)
        assert not _grids_close(again, first)
        out[srv] = again
    _assert_result_match(out[port], out[jax_srv], "grouped")


def _grids_close(a, b):
    ra, rb = a["data"]["result"], b["data"]["result"]
    if [e["metric"] for e in ra] != [e["metric"] for e in rb]:
        return False
    for ea, eb in zip(ra, rb):
        va = np.asarray(ea["values"], np.float64)
        vb = np.asarray(eb["values"], np.float64)
        if va.shape != vb.shape or not np.array_equal(va[:, 0], vb[:, 0]) \
                or not TOLERANCES["grouped"](va[:, 1], vb[:, 1]):
            return False
    return True


def test_stop_leaves_no_write_path_thread_running(tmp_path):
    import threading
    before = set(threading.enumerate())
    srv = psrv.FiloServer({"num-shards": 2, "port": 0, **CPU,
                           "gateway-port": 0,
                           "data-dir": str(tmp_path / "data"),
                           "stream-dir": str(tmp_path / "stream")}).start()
    started = [t for t in threading.enumerate() if t not in before]
    # grpcio names its server loop thread itself ("Thread-N (_serve)")
    grpc_loop = [t.name for t in started if t.name.endswith("(_serve)")]
    names = sorted(t.name for t in started if t.name not in grpc_loop)
    assert names == ["accept-edge", "gateway-server", "ingest-shard-0",
                     "ingest-shard-1", "tenant-metering"], names
    assert len(grpc_loop) == 1, grpc_loop
    srv.stop()
    for t in started:
        t.join(timeout=30)
        assert not t.is_alive(), t.name


# -- crash: SIGKILL after the acknowledgement, restart on the same dirs ---

def _start_sub(data, stream, cfg_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "filodb_tpu_torch.standalone.server",
         "--device", "cpu", "--port", "0", "--data-dir", data,
         "--stream-dir", stream, "--gateway-port", "0",
         "--config", cfg_path],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    line = json.loads(proc.stdout.readline())
    assert line["gateway_port"] is not None and line["port"] > 0

    class _Addr:
        port = line["port"]
    deadline = time.monotonic() + 120
    while True:
        try:
            code, body = _get(_Addr, "/__health")
            if code == 200 and set(json.loads(body)["shards"].values()) \
                    == {"active"}:
                return proc, _Addr
        except OSError:
            pass
        assert time.monotonic() < deadline, "shards did not go active"
        time.sleep(0.1)


def test_acknowledged_samples_survive_sigkill_and_restart(tmp_path):
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w") as f:
        # fsync per append; a flush every 3 stream records, so the crash
        # leaves part of the data in the column store and part only in
        # the stream logs
        json.dump({"num-shards": 2, "groups-per-shard": 2,
                   "stream-group-commit-ms": 0, "flush-every-records": 3,
                   "flush-interval-s": 3600}, f)
    data, stream = str(tmp_path / "data"), str(tmp_path / "stream")
    rng = np.random.default_rng(4)
    want = {}
    bodies = []
    for b in range(4):
        lines = []
        for i in range(6):
            for k in range(b * 15, b * 15 + 15):
                v = float(rng.integers(0, 10**6)) / 8
                want.setdefault(f"i{i}", []).append((T0 + k * DT, v))
                lines.append(f"acked_total,instance=i{i} counter={v!r} "
                             f"{(T0 + k * DT) * 10**6}")
        bodies.append("\n".join(lines).encode())
    proc, addr = _start_sub(data, stream, cfg_path)
    try:
        for body in bodies:
            code, _ = _post(addr, "/api/v1/ingest/influx", body)
            assert code == 200
    finally:
        proc.kill()
        proc.wait(timeout=30)
    proc, addr = _start_sub(data, stream, cfg_path)
    try:
        from filodb_tpu_torch.http import remote_read as rr
        code, body = _post(addr, "/promql/timeseries/api/v1/read",
                           _read_body([("__name__", "eq", "acked_total")]),
                           "application/x-protobuf")
        assert code == 200
        (series,) = rr.decode_read_response(rr.snappy_decompress(body))
        got = {lab["instance"]: [(t, v) for t, v in s]
               for lab, s in series}
        assert got == want
        # the instant selector at the sample cadence returns each sample
        code, body = _get(addr, "/promql/timeseries/api/v1/query_range",
                          query="acked_total", start=T0 // 1000,
                          end=(T0 + 59 * DT) // 1000, step=10,
                          cache="false")
        assert code == 200
        res = json.loads(body)["data"]["result"]
        got = {e["metric"]["instance"]: [(int(float(t) * 1000), float(v))
                                         for t, v in e["values"]]
               for e in res}
        assert got == want
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# -- downsampling: each key on wires its module, as in the reference ------
# (last in the file: the JAX server's queries here compile new shapes, and
# its device profiler's recompile family would then show in the metric
# family comparisons above)

DS_RES = 300_000
DS_T0 = (T0 // DS_RES) * DS_RES
DS_N = 720                      # 2 h at 10 s, 5 s past period boundaries
DS_GRID = (DS_T0 // 1000 + 1800, 600, (DS_T0 + DS_N * DT) // 1000)
DS_QUERIES = ("min_over_time(ds_gauge[10m])",
              "max by (job) (max_over_time(ds_gauge[10m]))")


def _ds_rows():
    rows = []
    for s in range(8):
        t = DS_T0 + 5_000 + np.arange(DS_N) * DT
        rows.append(({"_metric_": "ds_gauge", "_ws_": "demo",
                      "_ns_": "App-0", "job": f"job{s % 2}",
                      "instance": f"i{s}"}, t,
                     50.0 + 40.0 * np.sin(np.arange(DS_N) / 7.0 + s)))
    return rows


def _retention_s():
    """Raw retention from the wall clock that puts the raw/ds boundary
    half a step past the grid's third step: the wall clock moves far less
    than half a step while a test runs, so both servers (and both tiers'
    plans) see the same boundary."""
    start, step, _ = DS_GRID
    return int(time.time()) - (start + 3 * step + step // 2)


@pytest.mark.parametrize("key", ["flush-downsample", "raw-retention-s"])
def test_downsample_config_keys_wire_the_tier(key, tmp_path):
    """``flush-downsample`` gives every shard a FlushDownsampler that fills
    the ds datasets as chunks flush; ``raw-retention-s`` gives the planner
    a DownsampledTimeSeriesStore (fed here by each package's batch job).
    Either way a query reaching past retention is stitched from both tiers
    and answers over HTTP bit for bit as the reference server does."""
    from filodb_tpu.downsample import DownsamplerJob as JJob
    from filodb_tpu_torch.downsample import (DownsampledTimeSeriesStore,
                                             DownsamplerJob)
    from filodb_tpu_torch.downsample.flush import FlushDownsampler
    from filodb_tpu_torch.query.planner import StitchExec
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    cfg = {"num-shards": 4, "port": 0, "grpc-port": None,
           "raw-retention-s": _retention_s(),
           "flush-downsample": key == "flush-downsample"}
    port = psrv.FiloServer({**cfg, **CPU,
                            "data-dir": str(tmp_path / "p")}).start()
    jax_srv = JServer({**cfg, "gc-freeze": False,
                       "data-dir": str(tmp_path / "j")}).start()
    try:
        rows = _ds_rows()
        state.load_into_store(port.store, port.ref, rows, "gauge", True,
                              num_shards=4, spread=1)
        _load_jax(jax_srv, rows, "gauge", True)
        shards = port.store.shards(port.ref)
        if key == "flush-downsample":
            jshards = jax_srv.store.shards(jax_srv.ref)
            assert all(isinstance(s.flush_downsampler, FlushDownsampler)
                       for s in shards)
            assert [s.flush_downsampler.samples_emitted for s in shards] \
                == [s.flush_downsampler.samples_emitted for s in jshards]
            assert sum(s.flush_downsampler.samples_emitted
                       for s in shards) > 0
        else:
            assert all(s.flush_downsampler is None for s in shards)
            for n in range(4):
                DownsamplerJob(port.store.column_store,
                               device="cpu").run("timeseries", n)
                JJob(jax_srv.store.column_store).run("timeseries", n)
        ds_store = port.http.ds_store_by_dataset["timeseries"]
        assert isinstance(ds_store, DownsampledTimeSeriesStore)
        assert port.http.raw_retention_ms == cfg["raw-retention-s"] * 1000
        start, step, end = DS_GRID
        for q in DS_QUERIES:
            plan = parse_query_range(q, TimeStepParams(start, step, end))
            ex = port.http.make_planner("timeseries").materialize(plan)
            assert isinstance(ex, StitchExec), q
            assert ex.ds_exec is not None and ex.raw_exec is not None
            code, pd, jd = _both((port, jax_srv),
                                 "/promql/timeseries/api/v1/query_range",
                                 query=q, start=start, end=end, step=step)
            assert code == 200, (pd, jd)
            _assert_result_match(pd, jd, "exact")
    finally:
        port.stop()
        jax_srv.stop()
