"""Self-monitoring of the port (``filodb_tpu_torch.obs.selfmon`` and its
wiring in the standalone server) against the JAX package's, on the CPU.

  * ``collect_once(now_ms)`` over the same exposition writes the same
    container bytes into ``__selfmon__``, with and without a worker label,
    directly and through a stream;
  * a port server and a JAX server with ``self-monitor`` on (the loop's
    interval far beyond the test, so only deterministic ticks run): the
    same ``__selfmon__`` answers for the loop's own counter, and its rate
    within 8 f32 ulps of the JAX server's (aligned tiles, f32 epilogue)
    and rtol 1e-5 of a numpy oracle on the raw samples; the loop's
    liveness gauges on ``/metrics``, and the reserved tenant never shed
    under a budget that sheds every other query;
  * with a stream-dir the samples go through the internal stream and its
    driver, and a restart replays them.
"""

import json
import os
import shutil
import time
import urllib.error
import urllib.parse
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from filodb_tpu.ingest.stream import encode_container as j_encode
from filodb_tpu.obs import metrics as j_metrics
from filodb_tpu.obs import selfmon as j_selfmon
from filodb_tpu.standalone.server import FiloServer as JServer
from filodb_tpu_torch.ingest.stream import encode_container as p_encode
from filodb_tpu_torch.obs import metrics as p_metrics
from filodb_tpu_torch.obs import selfmon as p_selfmon
from filodb_tpu_torch.standalone import server as psrv

torch.set_num_threads(1)

T0 = 1_600_000_000_000
TICK_MS = 5_000
TICKS = 24
PKGS = {"port": SimpleNamespace(selfmon=p_selfmon, metrics=p_metrics,
                                encode=p_encode),
        "jax": SimpleNamespace(selfmon=j_selfmon, metrics=j_metrics,
                               encode=j_encode)}


def _both(fn):
    return fn(PKGS["port"]), fn(PKGS["jax"])


class _Sink:
    """A shard or a stream keeping each container's stream encoding."""

    def __init__(self, encode):
        self.encode, self.bytes, self.flushes = encode, [], 0

    def ingest(self, cont):
        self.bytes.append(self.encode(cont))

    append = ingest

    def flush_all(self):
        self.flushes += 1


def _source(p):
    """A fixed exposition: counters, gauges, a histogram, a labelled
    family, an infinite and a NaN sample, and a duplicate series."""
    def build():
        b = p.metrics.ExpositionBuilder()
        b.sample("filodb_queries_total", {"dataset": "ts"}, 42,
                 mtype="counter", help="q")
        b.sample("filodb_queries_total", {"dataset": "ts"}, 43,
                 mtype="counter", help="q")          # dropped: duplicate
        b.sample("filodb_inflight", {}, 3, help="g")
        b.sample("filodb_ratio", {"k": "a b"}, 0.125, help="g")
        b.sample("filodb_nan", {}, float("nan"), help="g")
        b.sample("filodb_inf", {}, "+Inf", help="g")
        b.sample("filodb_text", {}, "not-a-number", help="g")
        h = p.metrics.Histogram("filodb_lat_seconds", "h",
                                buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        b.histogram(h, {"route": "q"})
        return b
    return build


@pytest.mark.parametrize("durable", [False, True], ids=["direct", "durable"])
@pytest.mark.parametrize("worker", [None, 3], ids=["standalone", "worker"])
def test_collect_once_writes_the_same_containers(worker, durable):
    def run(p):
        shard, stream = _Sink(p.encode), _Sink(p.encode)
        sm = p.selfmon.SelfMonitor(
            _source(p), shard, stream=stream if durable else None,
            interval_s=3600, node="node7", worker_id=worker,
            flush_every_ticks=2)
        counts = [sm.collect_once(now_ms=T0 + k * TICK_MS)
                  for k in range(3)]
        snap = sm.snapshot()
        got = stream if durable else shard
        return (got.bytes, shard.flushes, counts, snap["ticks"],
                snap["samples_ingested"], snap["series_last_tick"])
    port, jax_out = _both(run)
    assert port == jax_out
    assert port[1] == (0 if durable else 1)      # flush every 2nd tick
    assert port[2] == [port[2][0]] * 3 and port[2][0] > 0


def test_a_raising_source_counts_an_error_and_the_loop_goes_on():
    def run(p):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("source down")
            return _source(p)()
        sm = p.selfmon.SelfMonitor(flaky, _Sink(p.encode), interval_s=0.01)
        sm.start()
        deadline = time.monotonic() + 30
        while sm.snapshot()["ticks"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        sm.stop()
        snap = sm.snapshot()
        return snap["errors"], snap["alive"]
    assert _both(run) == ((1, False), (1, False))


# -- servers of both packages -----------------------------------------------

def _get(port, path, **params):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _reset_registries():
    j_metrics.GLOBAL_REGISTRY.reset()
    p_metrics.GLOBAL_REGISTRY.reset()


# every tenant but the reserved ones is budgeted far below any query
CONFIG = {"num-shards": 2, "port": 0, "grpc-port": None,
          "gc-freeze": False, "self-monitor": True,
          "self-monitor-interval-s": 3600.0,
          "qos-tenant-rate": 0.001, "qos-tenant-burst": 1.0}


@pytest.fixture(scope="module")
def selfmon_servers():
    _reset_registries()
    port = psrv.FiloServer({**CONFIG, "device": "cpu"}).start()
    jax_srv = JServer(CONFIG).start()
    try:
        for srv in (port, jax_srv):
            srv.seed_dev_data(n_samples=60, n_instances=2, start_ms=T0)
            for k in range(TICKS):
                srv.selfmon.collect_once(now_ms=T0 + k * TICK_MS)
        yield port, jax_srv
    finally:
        port.stop()
        jax_srv.stop()


def _selfmon_range(srv, query, step=TICK_MS // 1000):
    """A range query over __selfmon__ as the reserved tenant (the
    dataset does not pick the tenant: &tenant= does)."""
    code, body = _get(srv.port, "/promql/__selfmon__/api/v1/query_range",
                      query=query, start=T0 // 1000,
                      end=(T0 + (TICKS - 1) * TICK_MS) // 1000, step=step,
                      tenant="__selfmon__")
    return code, json.loads(body)


def _oracle_rate(ts_ms, vals, ends_ms, window_ms):
    """Prometheus rate over [end - window, end] per end, from the raw
    samples (no resets here): extrapolated to the window's edges unless a
    gap exceeds 1.1 x the average interval, as the reference does."""
    out = []
    for end in ends_ms:
        m = (ts_ms >= end - window_ms) & (ts_ms <= end)
        t, v = ts_ms[m], vals[m]
        if t.size < 2:
            out.append(np.nan)
            continue
        sampled = (t[-1] - t[0]) / 1000.0
        avg = sampled / (t.size - 1)
        ds = (t[0] - (end - window_ms)) / 1000.0
        de = (end - t[-1]) / 1000.0
        delta = v[-1] - v[0]
        dzero = sampled * v[0] / delta if delta > 0 else np.inf
        ds = min(ds, dzero)
        ext = sampled + (ds if ds < 1.1 * avg else avg / 2) \
            + (de if de < 1.1 * avg else avg / 2)
        out.append(delta * ext / sampled / (window_ms / 1000.0))
    return np.asarray(out)


def test_selfmon_ticks_answer_as_the_jax_server(selfmon_servers):
    (pc, pd), (jc, jd) = (_selfmon_range(s, "filodb_selfmon_ticks_total")
                          for s in selfmon_servers)
    assert pc == jc == 200
    assert pd["data"] == jd["data"]
    (series,) = pd["data"]["result"]
    assert series["metric"] == {"__name__": "filodb_selfmon_ticks_total",
                                "_ws_": "__selfmon__", "_ns_": "node0"}
    # a tick ingests the registry as it stands, before counting itself:
    # the counter has no series before the first tick ends
    assert [float(v) for _, v in series["values"]] == \
        [float(k) for k in range(1, TICKS)]


def test_selfmon_rate_matches_the_jax_server_and_the_oracle(selfmon_servers):
    q = "rate(filodb_selfmon_ticks_total[30s])"
    (pc, pd), (jc, jd) = (_selfmon_range(s, q) for s in selfmon_servers)
    assert pc == jc == 200
    (pe,), (je,) = pd["data"]["result"], jd["data"]["result"]
    assert pe["metric"] == je["metric"]
    pv = np.asarray(pe["values"], np.float64)
    jv = np.asarray(je["values"], np.float64)
    np.testing.assert_array_equal(pv[:, 0], jv[:, 0])
    # a regular series: aligned tiles and the f32 epilogue in both
    mag = np.maximum(np.abs(pv[:, 1]), np.abs(jv[:, 1])).astype(np.float32)
    ulps = np.abs(pv[:, 1] - jv[:, 1]) / np.spacing(mag).astype(np.float64)
    assert (ulps <= 8).all(), ulps
    ts = T0 + np.arange(1, TICKS) * TICK_MS
    want = _oracle_rate(ts, np.arange(1, TICKS, dtype=np.float64),
                        (pv[:, 0] * 1000).astype(np.int64), 30_000)
    np.testing.assert_allclose(pv[:, 1], want, rtol=1e-5)


def test_selfmon_liveness_rides_metrics(selfmon_servers):
    for srv in selfmon_servers:
        _, body = _get(srv.port, "/metrics")
        lines = body.decode().splitlines()
        assert "filodb_selfmon_alive 1" in lines
        assert "filodb_selfmon_interval_seconds 3600.0" in lines
        assert any(ln.startswith("filodb_selfmon_last_tick_age_seconds ")
                   for ln in lines)
        assert any(ln.startswith("filodb_selfmon_ticks_total ")
                   for ln in lines)


def test_the_reserved_tenant_is_never_shed(selfmon_servers):
    """Every ordinary tenant sheds (429) under the tiny default budget;
    the __selfmon__ tenant charges FORCED and answers, in both."""
    user, internal = [], []
    for srv in selfmon_servers:
        code, _ = _get(srv.port, "/promql/timeseries/api/v1/query_range",
                       query="sum(rate(http_requests_total[5m]))",
                       start=T0 // 1000 + 300, end=T0 // 1000 + 590,
                       step=10, tenant="someone")
        user.append(code)
        code, _ = _selfmon_range(srv, "filodb_selfmon_ticks_total")
        internal.append(code)
    assert user == [429, 429]
    assert internal == [200, 200]


def test_stop_ends_the_loop():
    srv = psrv.FiloServer({**CONFIG, "device": "cpu",
                           "self-monitor-interval-s": 0.05}).start()
    try:
        deadline = time.monotonic() + 30
        while srv.selfmon.snapshot()["ticks"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert srv.selfmon.alive
    finally:
        srv.stop()
    assert not srv.selfmon.alive


def _durable_ticks(cls, extra, root):
    """A server with data-dir and stream-dir: 6 ticks through the internal
    stream, the driver caught up, then a restart on the same directories
    -> (answer before, answer after the restart)."""
    cfg = {**CONFIG, **extra, "data-dir": os.path.join(root, "data"),
           "stream-dir": os.path.join(root, "stream")}
    out = []
    for restart in (False, True):
        srv = cls(cfg).start()
        try:
            if not restart:
                for k in range(6):
                    srv.selfmon.collect_once(now_ms=T0 + k * TICK_MS)
            drv = srv._selfmon_driver
            deadline = time.monotonic() + 60
            while drv.next_offset < drv.stream.end_offset() \
                    or drv.recovered_to < 0:
                assert time.monotonic() < deadline, "replay stalled"
                time.sleep(0.02)
            code, body = _get(
                srv.port, "/promql/__selfmon__/api/v1/query_range",
                query="filodb_selfmon_ticks_total", start=T0 // 1000,
                end=(T0 + 5 * TICK_MS) // 1000, step=5, tenant="__selfmon__")
            assert code == 200
            out.append(json.loads(body)["data"])
        finally:
            srv.stop()
    return out


def test_durable_selfmon_replays_after_a_restart(tmp_path):
    _reset_registries()
    port = _durable_ticks(psrv.FiloServer, {"device": "cpu"},
                          str(tmp_path / "port"))
    _reset_registries()
    jax_out = _durable_ticks(JServer, {}, str(tmp_path / "jax"))
    assert port == jax_out
    before, after = port
    assert before == after
    (series,) = before["result"]
    assert [float(v) for _, v in series["values"]] == \
        [float(k) for k in range(1, 6)]
    assert os.path.exists(tmp_path / "port" / "stream" / "selfmon"
                          / "shard=0" / "stream.log")
    shutil.rmtree(tmp_path, ignore_errors=True)
