"""Device dispatch profiling (``filodb_tpu_torch/obs/devprof.py``) and
``&explain=analyze``, held against the JAX package's
(``tests/test_devprof.py``).

Covers the profiler's bookkeeping (builds, hits, new shape signatures as
recompiles, the lazy cost probe), the /metrics collector's families, the
analyze envelope built from the same spans by both packages, and, over a
live port server beside a live JAX server loaded with the same seeded
data: the envelope's stage keys and dispatch spans, the executables'
identities and dispatch counts, the analytic bytes of the two kernel
sites against the counts written out from their shapes, and answers
that stay byte for byte the same without ``explain``.

Where the two packages take different routes on the CPU, the query is
listed in ``ROUTE_DIFFERENCES`` with the reason.
"""

import json
import math
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
from filodb_tpu.obs import devprof as j_devprof
from filodb_tpu.obs import metrics as j_metrics
from filodb_tpu.query import tpu as j_tpu
from filodb_tpu.standalone.server import FiloServer as JServer
from filodb_tpu_torch import state
from filodb_tpu_torch.lint import capacity as p_capacity
from filodb_tpu_torch.obs import devprof
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.query import kernels as kn
from filodb_tpu_torch.query import tilestore as tst
from filodb_tpu_torch.standalone import server as psrv

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

T0 = 1_600_000_000_000
DT = 10_000
N = 120
TAIL = 12
START = T0 // 1000 + 600
FLUSHED_END = (T0 + (N - 5) * DT) // 1000       # seconds
TAIL_END = (T0 + (N + TAIL - 2) * DT) // 1000


def _reset_profile():
    """Empty the device profile AND the dispatch keys seen: a key's next
    dispatch is then its build, whatever another test file dispatched
    earlier on this worker process."""
    devprof.GLOBAL_PROFILER.reset()
    tst.reset_exec_stats()


# ---------------------------------------------------------------------------
# unit: profiler bookkeeping
# ---------------------------------------------------------------------------

def test_arg_sig_and_key_forms():
    a = np.zeros((4, 8), np.float64)
    b = np.int64(7)
    sig = devprof.arg_sig(((a, a), b))
    assert sig == ((((4, 8), "float64"), ((4, 8), "float64")),
                   ((), "int64"))
    assert sig == j_devprof.arg_sig(((a, a), b))
    t = torch.zeros((4, 8), dtype=torch.float32)
    assert devprof.arg_sig((t,)) == (((4, 8), "torch.float32"),)
    for key in (("slide", "rate", 4, 6), ("x",),
                ("pallas", "rate", 4096, 512, 128)):
        assert devprof.key_str(key) == j_devprof.key_str(key)
        assert devprof.shape_bucket(key) == j_devprof.shape_bucket(key)
    assert devprof.key_str(("slide", "rate", 4, 6)) == "slide/rate/4/6"
    assert devprof.shape_bucket(("slide", "rate", 4, 6)) == "4x6"
    assert devprof.shape_bucket(("x",)) == "x"


def test_profiler_build_hit_recompile_counters():
    snaps = []
    for mod in (devprof, j_devprof):
        p = mod.DeviceProfiler()
        assert p.note_build("s", ("k", 1), 0.5, sig=("a",)) is False
        assert p.note_build("s", ("k", 1), 0.2) is True       # recompile
        assert p.note_call("s", ("k", 1), sig=("a",)) is False  # known
        assert p.note_call("s", ("k", 1), sig=("b",)) is True   # churn
        (e,) = p.snapshot()
        assert e["builds"] == 2 and e["hits"] == 2
        assert e["recompiles"] == 2     # one rebuild + one new signature
        assert e["build_s_total"] == pytest.approx(0.7)
        snaps.append(p.snapshot())
    assert snaps[0] == snaps[1]


def test_profiler_lazy_cost_probe_runs_once():
    p = devprof.DeviceProfiler()
    calls = []

    def probe():
        calls.append(1)
        return kn.window_extract_cost(8, 16, 3, 4)
    p.note_build("s", ("k",), 0.0, lazy_probe=probe)
    c1 = p.ensure_cost("s", ("k",))
    c2 = p.ensure_cost("s", ("k",))
    assert len(calls) == 1
    assert c1 == c2 and set(c1) == {"flops", "bytes_accessed"}
    # a probe that fails costs nothing and is not retried
    p.note_build("s", ("bad",), 0.0, lazy_probe=lambda: 1 / 0)
    assert p.ensure_cost("s", ("bad",)) is None
    assert p.ensure_cost("s", ("bad",)) is None


def test_profiler_collector_families():
    p = devprof.DeviceProfiler()
    p.note_build("tilestore", ("slide", "rate", 4, 6), 0.1,
                 cost={"flops": 12.0, "bytes_accessed": 34.0})
    p.note_build("tilestore", ("slide", "rate", 4, 6), 0.1)  # recompile
    b = obs_metrics.ExpositionBuilder()
    p.collect(b)
    text = b.render()
    assert ('filodb_executable_builds_total{bucket="4x6",'
            'site="tilestore"} 2') in text
    assert ('filodb_executable_recompiles_total{bucket="4x6",'
            'site="tilestore"} 1') in text
    assert ('filodb_executable_flops{executable="slide/rate/4/6",'
            'site="tilestore"} 12.0') in text
    assert ('filodb_executable_bytes_accessed{executable='
            '"slide/rate/4/6",site="tilestore"} 34.0') in text
    assert "filodb_executables 1" in text
    # the same samples as the reference's collector (HELP texts differ:
    # the port's costs are analytic)
    jp = j_devprof.DeviceProfiler()
    jp.note_build("tilestore", ("slide", "rate", 4, 6), 0.1,
                  cost={"flops": 12.0, "bytes_accessed": 34.0})
    jp.note_build("tilestore", ("slide", "rate", 4, 6), 0.1)
    jb = j_metrics.ExpositionBuilder()
    jp.collect(jb)

    def samples(t):
        return [ln for ln in t.splitlines() if not ln.startswith("#")]
    assert samples(text) == samples(jb.render())


def _events(fn):
    """Run ``fn`` under a live trace; the ``executable`` events' tags."""
    tr = obs_trace.Trace(node="n0")
    with obs_trace.activate(tr):
        fn()
    return [sp["tags"] for sp in tr.spans_json()
            if sp["name"] == devprof.EXEC_EVENT]


def test_a_new_shape_under_a_known_key_is_a_recompile():
    """The counterpart of the reference's AOT-and-fallback test: no
    compiled program, so a key's first dispatch is its build, a repeat a
    hit, and a new shape signature under the same key a recompile, with
    the reference's disposition words."""
    _reset_profile()                          # a first sight in this test
    key = ("dbl", 8, "unit-test")
    x8, x16 = torch.ones(8), torch.ones(16)
    tags = _events(lambda: [
        tst.note_exec("t", key, (x8,), x8 * 2.0),
        tst.note_exec("t", key, (x8,), x8 * 2.0),
        tst.note_exec("t", key, (x16,), x16 * 2.0)])
    assert [t["disposition"] for t in tags] == ["build", "jit",
                                                "jit-retrace"]
    assert {t["key"] for t in tags} == {"dbl/8/unit-test"}
    snap = {(e["site"], e["executable"]): e
            for e in devprof.GLOBAL_PROFILER.snapshot()}
    e = snap[("t", "dbl/8/unit-test")]
    assert e["builds"] == 1 and e["hits"] == 2
    assert e["recompiles"] == 1           # the 16-wide signature
    # the lazy probe prices the FIRST signature: 8 f32 in, 8 f32 out
    cost = devprof.GLOBAL_PROFILER.ensure_cost("t", key)
    assert cost == {"flops": 8.0, "bytes_accessed": 64.0}


def test_sig_cost_counts_each_tensor_once():
    ins = devprof.arg_sig((torch.zeros((4, 8), dtype=torch.int64),
                           (torch.zeros(3, dtype=torch.float32),
                            np.zeros(5, np.int32)), 7))
    outs = devprof.arg_sig((torch.zeros((2, 5), dtype=torch.float64),))
    assert devprof.sig_cost(ins, outs) == {
        "flops": 10.0, "bytes_accessed": float(32 * 8 + 3 * 4 + 5 * 4
                                               + 10 * 8)}


SPANS = [
    {"name": "executable", "dur_us": 0,
     "tags": {"site": "tilestore", "key": "fast/rate/4",
              "disposition": "build"}},
    {"name": "executable", "dur_us": 0,
     "tags": {"site": "tilestore", "key": "fast/rate/4",
              "disposition": "aot"}},
    {"name": "device-dispatch", "dur_us": 1200,
     "tags": {"path": "aligned", "batch": 2}},
    {"name": "batcher-dispatch", "dur_us": 0,
     "tags": {"size": 2, "active": 3, "priority": 0}},
    {"name": "parse", "dur_us": 10, "tags": {}},
]


def test_analyze_payload_attribution():
    outs = []
    tst.reset_exec_stats()
    for mod in (devprof, j_devprof):
        mod.GLOBAL_PROFILER.reset()
        mod.GLOBAL_PROFILER.note_build(
            "tilestore", ("fast", "rate", 4), 0.25,
            cost={"flops": 99.0, "bytes_accessed": 11.0})
        outs.append(mod.analyze_payload(
            SPANS, {"qosShed": "stale"},
            batcher_stats={"occupancy_avg": 1.5},
            qos_info={"tenant": "t"}))
    out = outs[0]
    (e,) = out["device"]["executables"]
    assert e["executable"] == "fast/rate/4"
    assert e["dispatches"] == 2
    assert sorted(e["dispositions"]) == ["aot", "build"]
    assert e["flops"] == 99.0 and e["bytes_accessed"] == 11.0
    names = [d["span"] for d in out["device"]["dispatches"]]
    assert "device-dispatch" in names and "batcher-dispatch" in names
    assert "parse" not in names
    assert out["stages"]["qosShed"] == "stale"
    assert out["batcher"]["occupancy_avg"] == 1.5
    assert out["qos"]["tenant"] == "t"
    assert "residency" not in out          # no snapshot passed
    assert outs[0] == outs[1]
    _reset_profile()
    j_devprof.GLOBAL_PROFILER.reset()


def test_analyze_payload_residency_section():
    res_in = {"shardstore-resident-channels": {"1": 20480, "2": 40960}}
    out = devprof.analyze_payload([], {}, residency=res_in)
    res = out["residency"]["shardstore-resident-channels"]
    assert res["shards"] == {"1": 20480, "2": 40960}
    assert res["total_bytes"] == 61440
    assert "residency" not in devprof.analyze_payload([], {}, residency={})
    assert out == j_devprof.analyze_payload([], {}, residency=res_in)


# ---------------------------------------------------------------------------
# e2e: &explain=analyze over a live port server beside a JAX server
# ---------------------------------------------------------------------------

def _rows(seed=11, S=8, S_irr=4):
    """(counter rows, counter tails, irregular rows) as (labels, ts ms,
    values) triples."""
    rng = np.random.default_rng(seed)
    ctr, tail, irr = [], [], []
    for i in range(S):
        ts = T0 + np.arange(N + TAIL) * DT + rng.integers(-2000, 2000,
                                                          N + TAIL)
        v = 1e9 + np.cumsum(rng.uniform(0, 5, N + TAIL))
        lab = {"_metric_": "http_requests_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 4}", "instance": f"i{i}"}
        ctr.append((lab, ts[:N], v[:N]))
        tail.append((lab, ts[N:], v[N:]))
    for i in range(S_irr):
        ts = np.unique(T0 + np.arange(N) * DT
                       + rng.integers(-6000, 6000, N))
        v = np.cumsum(rng.uniform(0, 3, ts.size))
        lab = {"_metric_": "irregular_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 2}", "instance": f"k{i}"}
        irr.append((lab, ts, v))
    return ctr, tail, irr


def _load_jax(srv, rows, flush):
    """The JAX package's own ingest, routed by its ``ingestion_shard``."""
    sch = J_SCHEMAS.by_name("prom-counter")
    builders = {}
    for lab, ts, vals in rows:
        pk = JPartKey.make(sch, lab)
        shard = j_ingestion_shard(pk.shard_key_hash(JPartitionSchema()),
                                  pk.part_hash(), 1, 4)
        b = builders.setdefault(shard, JBuilder(J_SCHEMAS))
        for t, v in zip(ts, vals):
            b.add_sample("prom-counter", lab, int(t), float(v))
    for shard, b in builders.items():
        for c in b.containers():
            srv.store.ingest(srv.ref, shard, c)
    if flush:
        srv.store.flush_all(srv.ref)


@pytest.fixture(scope="module")
def servers():
    # the reference takes its Pallas kernels in interpret mode on the CPU
    # only with these flags, so both packages take the same routes
    flags = (j_tpu.PALLAS_RATE_INTERPRET, j_tpu.FUSED_GROUPSUM_INTERPRET)
    j_tpu.PALLAS_RATE_INTERPRET = j_tpu.FUSED_GROUPSUM_INTERPRET = True
    port = psrv.FiloServer({"num-shards": 4, "port": 0, "device": "cpu",
                            "gc-freeze": False, "grpc-port": None}).start()
    jax_srv = JServer({"num-shards": 4, "port": 0, "gc-freeze": False,
                       "grpc-port": None}).start()
    ctr, tail, irr = _rows()
    for rows, flush in ((ctr, True), (irr, True), (tail, False)):
        state.load_into_store(port.store, port.ref, rows, "prom-counter",
                              flush, num_shards=4, spread=1)
        _load_jax(jax_srv, rows, flush)
    _reset_profile()
    try:
        yield port, jax_srv
    finally:
        port.stop()
        jax_srv.stop()
        (j_tpu.PALLAS_RATE_INTERPRET,
         j_tpu.FUSED_GROUPSUM_INTERPRET) = flags


def _get_raw(port, path="query_range", **params):
    qs = urllib.parse.urlencode(params)
    url = (f"http://127.0.0.1:{port}/promql/timeseries/api/v1/"
           f"{path}?{qs}")
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.read()


def _analyze(srv, query, end, **extra):
    return json.loads(_get_raw(srv.port, query=query, start=START, end=end,
                               step=60, cache="false", explain="analyze",
                               **extra))


def test_analyze_tilestore_path(servers):
    body = _analyze(servers[0], "rate(http_requests_total[5m])",
                    FLUSHED_END)
    az = body["analyze"]
    assert set(az) >= {"stages", "device", "batcher", "qos"}
    execs = az["device"]["executables"]
    ts_execs = [e for e in execs if e["site"].startswith("tilestore")]
    assert ts_execs, f"no tilestore executables in {execs}"
    e = ts_execs[0]
    assert e["dispositions"]            # the dispatch's disposition
    assert e["builds"] >= 1
    assert "flops" in e and "bytes_accessed" in e
    assert az["stages"]["resultCache"] in ("off", "miss", "hit",
                                           "partial", "bypass")
    assert "parseMs" in az["stages"]
    # the trace itself still attaches (analyze extends explain=trace)
    assert "trace" in body and body["trace"]["num_spans"] > 0


def test_analyze_tilestore_path_whatever_ran_before(servers):
    """The first sight of a dispatch key is process-wide: a file that ran
    earlier on the same worker and dispatched the same key left it seen,
    and its next dispatch was a hit with no build in the profile. With
    the reset hook the analyze path reports its build each time: twice,
    with a dispatch of the same key in between."""
    for _ in range(2):
        _get_raw(servers[0].port, query="rate(http_requests_total[5m])",
                 start=START, end=FLUSHED_END, step=60, cache="false")
        assert any(site == "tilestore" for site, _key in tst._EXEC_KEYS)
        _reset_profile()
        test_analyze_tilestore_path(servers)


def test_analyze_packed_path(servers):
    body = json.loads(_get_raw(
        servers[0].port, query="min_over_time(http_requests_total[3m])",
        start=START, end=FLUSHED_END, step=67, cache="false",
        explain="analyze"))
    execs = body["analyze"]["device"]["executables"]
    packed = [e for e in execs if e["site"] == "packed"]
    assert packed, f"no packed executables in {execs}"
    e = packed[0]
    assert e["dispositions"]
    assert "flops" in e and "bytes_accessed" in e
    # batcher occupancy at dispatch recorded
    dispatch_spans = [d for d in body["analyze"]["device"]["dispatches"]
                      if d["span"] == "batcher-dispatch"]
    assert dispatch_spans and "size" in dispatch_spans[0]


def test_analyze_instant_path(servers):
    body = json.loads(_get_raw(
        servers[0].port, "query", query="rate(http_requests_total[5m])",
        time=FLUSHED_END, cache="false", explain="analyze"))
    assert "analyze" in body and "stages" in body["analyze"]
    assert "staticCostBound" in body["analyze"]["stages"]


def test_no_analyze_responses_stay_canonical(servers):
    """Without explain, the response carries neither analyze nor trace
    keys and stays on the canonical compact-encoding fast path."""
    raw = _get_raw(servers[0].port, query="rate(http_requests_total[5m])",
                   start=START, end=FLUSHED_END, step=60)
    parsed = json.loads(raw)
    assert "analyze" not in parsed and "trace" not in parsed
    assert raw == json.dumps(parsed, separators=(",", ":")).encode()


def test_recompile_counter_rides_metrics(servers):
    # the queries above dispatched (and analyze costed) executables: the
    # profile's families are on /metrics
    url = f"http://127.0.0.1:{servers[0].port}/metrics"
    with urllib.request.urlopen(url, timeout=60) as r:
        text = r.read().decode()
    assert "filodb_executable_builds_total{" in text
    assert "filodb_executables " in text
    assert "filodb_executable_flops{" in text
    assert "filodb_executable_bytes_accessed{" in text
    assert "filodb_exec_cache_misses_total " in text


ANALYZE_QUERIES = [
    ("rate(http_requests_total[5m])", FLUSHED_END),
    ("rate(http_requests_total[5m])", TAIL_END),
    ("rate(irregular_total[5m])", FLUSHED_END),
    ("max_over_time(http_requests_total[5m])", FLUSHED_END),
    ("avg_over_time(http_requests_total[5m])", FLUSHED_END),
    ("irate(http_requests_total[5m])", FLUSHED_END),
    ("sum by (job) (rate(http_requests_total[5m]))", FLUSHED_END),
]
# queries whose executables differ between the packages on the CPU ->
# what the port lists that the reference does not, and why
ROUTE_DIFFERENCES = {
    # both run the fused group-sum (the reference's Pallas kernel in
    # interpret mode, the port's plain version of its CUDA kernel), but
    # the reference dispatches its kernel outside any dispatch table, so
    # its analyze lists no executable for it; the port accounts the
    # launch under its own key
    "sum by (job) (rate(http_requests_total[5m]))": "groupsum",
}


def _exec_ids(az):
    return sorted((e["site"], e["executable"], e["dispatches"])
                  for e in az["device"]["executables"])


def _residency_section(snapshot):
    """The ``residency`` section an analyze built from ``snapshot`` (a
    package's ``residency_snapshot()``) carries, None when it has none."""
    return {family: {"shards": dict(shards),
                     "total_bytes": sum(shards.values())}
            for family, shards in snapshot.items()} or None


def _analyze_beside_residency(srv, capacity, query, end):
    """``srv``'s analyze of ``query``, and the residency sections its own
    package's registry (``capacity.residency_snapshot()``) gave just
    before and just after it."""
    before = _residency_section(capacity.residency_snapshot())
    az = _analyze(srv, query, end)["analyze"]
    return az, (before, _residency_section(capacity.residency_snapshot()))


def _assert_residency_of_its_own_package(az, sections):
    """The residency section is the process's registry of live sharded
    stores, which other test files on the same worker may have left
    filled: present if and only if that registry is not empty at the
    call, and equal to it."""
    assert az.get("residency") in sections, (az.get("residency"), sections)


def _compare_analyze_with_the_jax_server(servers, query, end):
    """Same stage keys, the same dispatch spans and the same executables
    (identity and dispatch count) as the reference's analyze of the same
    query over the same data; each side's residency section held to its
    own package's registry."""
    for srv in servers:
        _analyze(srv, query, end)
    (pa, p_res), (ja, j_res) = (
        _analyze_beside_residency(s, cap, query, end)
        for s, cap in zip(servers, (p_capacity, j_capacity)))
    _assert_residency_of_its_own_package(pa, p_res)
    _assert_residency_of_its_own_package(ja, j_res)
    assert set(pa) - {"residency"} == set(ja) - {"residency"}
    assert set(pa["stages"]) == set(ja["stages"])
    assert sorted(d["span"] for d in pa["device"]["dispatches"]) == \
        sorted(d["span"] for d in ja["device"]["dispatches"])
    diff = ROUTE_DIFFERENCES.get(query)
    got = _exec_ids(pa)
    if diff is not None:
        assert [g for g in got if g[1].startswith(diff + "/")]
        got = [g for g in got if not g[1].startswith(diff + "/")]
    assert got == _exec_ids(ja)
    for e in pa["device"]["executables"]:
        assert e["dispositions"] == ["jit"], e   # warm: a known key
    return pa, ja


@pytest.mark.parametrize("query,end", ANALYZE_QUERIES,
                         ids=[f"{q}@{e}" for q, e in ANALYZE_QUERIES])
def test_analyze_matches_the_jax_server(servers, query, end):
    """The two analyzes agree (``_compare_analyze_with_the_jax_server``).
    Each server answers the query once first: the reference's first
    dispatch of a tile executable adds a ``build`` event beside the
    call's own."""
    _compare_analyze_with_the_jax_server(servers, query, end)


def _aligned(mod, S=8, N=64):
    """Dense aligned tiles of ``mod`` (either package's tilestore)."""
    ts = np.arange(N, dtype=np.float64)[None, :] * DT + np.zeros((S, 1))
    kw = {"device": "cpu"} if mod is tst else {}
    return mod.AlignedTiles([{"i": str(i)} for i in range(S)], 0, DT,
                            np.ones((S, N), bool), ts,
                            np.cumsum(np.ones((S, N)), axis=1), **kw)


@pytest.fixture
def live_sharded_stores():
    """A live reference ShardedTiles and a live port one, as test files
    that ran earlier on the same worker process leave them: both
    process-wide residency registries are then filled."""
    import jax

    from filodb_tpu.parallel.mesh import make_mesh as j_make_mesh
    from filodb_tpu.parallel.shardstore import ShardedTiles as JSharded
    from filodb_tpu.query import tilestore as j_tst
    from filodb_tpu_torch.parallel.mesh import make_mesh
    from filodb_tpu_torch.parallel.shardstore import ShardedTiles

    stores = (JSharded(j_make_mesh(2, 1, jax.devices()[:2]),
                       _aligned(j_tst)),
              ShardedTiles(make_mesh(2, 1, [torch.device("cpu")] * 2),
                           _aligned(tst)))
    assert j_capacity.residency_snapshot() and p_capacity.residency_snapshot()
    yield stores


PLANTED = ANALYZE_QUERIES[:2] + ANALYZE_QUERIES[-1:]


@pytest.mark.parametrize("query,end", PLANTED,
                         ids=[f"{q}@{e}" for q, e in PLANTED])
def test_analyze_matches_the_jax_server_beside_live_sharded_stores(
        servers, live_sharded_stores, query, end):
    """A busy test run's order of files, reproduced: with sharded stores
    alive in both packages, each analyze carries its own package's
    residency section and the comparison holds."""
    pa, ja = _compare_analyze_with_the_jax_server(servers, query, end)
    assert "residency" in pa and "residency" in ja
    assert "shardstore-resident-channels" in pa["residency"]


@pytest.mark.parametrize("query,end", ANALYZE_QUERIES[:4],
                         ids=[f"{q}@{e}" for q, e in ANALYZE_QUERIES[:4]])
def test_analyze_leaves_the_answer_bit_for_bit(servers, query, end):
    port = servers[0].port
    plain = json.loads(_get_raw(port, query=query, start=START, end=end,
                                step=60, cache="false"))
    az = _analyze(servers[0], query, end)
    assert json.dumps(az["data"]) == json.dumps(plain["data"])


def _groupsum_bytes(S_pad, T, G, dspan, hi_mode, lo_mode):
    """The group-sum's bytes written out from its shapes: the boundary
    rows (T + dspan of the merged kc/kl run, T more for each side that
    reads the alternate family) of 3 int32 planes over S_pad series, the
    [n_s, 8, 512] f32 base, the [S_pad, G] f32 one-hot, two [T, G] f32
    outputs."""
    rows = T + dspan + T * ((hi_mode != kn.GS_CUR) + (lo_mode != kn.GS_CUR))
    return rows * S_pad * 12 + (S_pad // 512) * 8 * 512 * 4 \
        + S_pad * G * 4 + 2 * T * G * 4


def _extract_bytes(S, N_, T):
    """The boundary extract's bytes from its shapes: S x N int32 relative
    times, 3 f32 payload channels at both boundaries of each of S x T
    windows, and the outputs: counts and both boundary times (int32), both
    boundaries' 3 channels (f32)."""
    return S * N_ * 4 + S * T * 2 * 3 * 4 + S * T * (3 * 4 + 2 * 3 * 4)


@pytest.mark.parametrize("query,prefix", [
    ("sum by (job) (rate(http_requests_total[5m]))", "groupsum/"),
    ("rate(irregular_total[5m])", "pallas/")], ids=["groupsum", "extract"])
def test_kernel_site_bytes_equal_the_count_from_shapes(servers, query,
                                                       prefix):
    az = _analyze(servers[0], query, FLUSHED_END)["analyze"]
    execs = [e for e in az["device"]["executables"]
             if e["executable"].startswith(prefix)]
    assert execs
    for e in execs:
        parts = e["executable"].split("/")
        if prefix == "groupsum/":
            S_pad, T, G, st, dspan, hi, lo = map(int, parts[2:])
            want = _groupsum_bytes(S_pad, T, G, dspan, hi, lo)
            ops = T * S_pad * (40 + 4 * G)
        else:
            S, N_, T = map(int, parts[2:])
            want = _extract_bytes(S, N_, T)
            ops = 2 * S * T * math.ceil(math.log2(N_ + 1))
        assert e["bytes_accessed"] == float(want), e
        assert e["flops"] == float(ops), e
