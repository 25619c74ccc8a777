"""The whole request in the port's trace: the ``request`` root span with
the admission wait before the query and the response's write after it,
the admission-wait histogram, thread CPU time on every live span, and the
spans inside a query's execution (``aggregate``, ``h2d``, ``d2h``,
``tile-build``, the fast path's ``encode``)."""

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from filodb_tpu_torch import state
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.standalone import server as psrv

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

CPU = {"device": "cpu", "gc-freeze": False, "num-shards": 4, "port": 0}
T0 = 1_600_000_000_000
DT = 10_000
N = 240
TAIL = 30
START = T0 // 1000 + 600
FLUSHED_END = (T0 + (N - 5) * DT) // 1000
TAIL_END = (T0 + (N + TAIL - 2) * DT) // 1000
RANGE = "/promql/timeseries/api/v1/query_range"
# an aligned counter selection whose last steps read the unflushed tail
# (the packed path), and an irregular one that only the packed path serves
ALIGNED = "max by (job) (rate(http_requests_total[5m]))"
PACKED = "max by (job) (rate(irregular_total[5m]))"


def _get(srv, path, **params):
    url = f"http://127.0.0.1:{srv.port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _metric(srv, name):
    _, body = _get(srv, "/metrics")
    for ln in body.decode().splitlines():
        if ln.startswith(name + " "):
            return float(ln.split()[1])
    raise AssertionError(f"{name} not in /metrics")


def _by_name(trace_json):
    out = {}
    for s in trace_json["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def _end(s):
    return s["start_us"] + s["dur_us"]


def _retained(srv, pred):
    """The retained trace whose spans by name satisfy ``pred``, once its
    ``request`` span has closed (just after the response's last byte)."""
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        for tr in srv.http.tracer.recent(1000):
            d = tr.to_json()
            names = _by_name(d)
            if "request" in names and pred(names):
                return d
        time.sleep(0.01)
    raise AssertionError("no such retained trace")


def _of_query(query):
    return lambda names: any(s.get("tags", {}).get("query") == query
                             for s in names.get("query", ()))


def _rows(seed=11, S=8, S_irr=4):
    rng = np.random.default_rng(seed)
    ctr, ctr_tail, irr = [], [], []
    for i in range(S):
        ts = T0 + np.arange(N + TAIL) * DT + rng.integers(-2000, 2000,
                                                          N + TAIL)
        v = 1e6 + np.cumsum(rng.uniform(0, 5, N + TAIL))
        lab = {"_metric_": "http_requests_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 2}", "instance": f"i{i}"}
        ctr.append((lab, ts[:N], v[:N]))
        ctr_tail.append((lab, ts[N:], v[N:]))
    for i in range(S_irr):
        ts = np.unique(T0 + np.arange(N) * DT
                       + rng.integers(-6000, 6000, N))
        lab = {"_metric_": "irregular_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 2}", "instance": f"k{i}"}
        irr.append((lab, ts, np.cumsum(rng.uniform(0, 3, ts.size))))
    return ctr, ctr_tail, irr


@pytest.fixture(scope="module")
def loaded():
    srv = psrv.FiloServer({**CPU, "trace-enabled": True,
                           "trace-sample-rate": 1.0}).start()
    ctr, ctr_tail, irr = _rows()
    for rows, flush in ((ctr, True), (irr, True), (ctr_tail, False)):
        state.load_into_store(srv.store, srv.ref, rows, "prom-counter",
                              flush, num_shards=4, spread=1)
    yield srv
    srv.stop()


# -- the admission wait ------------------------------------------------------

def _hold_slot(srv, monkeypatch):
    """Make a query carrying ``&hold=1`` keep its admission slot until
    the returned event is set; -> (entered, release)."""
    entered, release = threading.Event(), threading.Event()
    orig = srv.http._query_range

    def stub(engine, qs, ds, tctx=None):
        if "hold" in qs:
            entered.set()
            assert release.wait(30)
            return 200, {"status": "success",
                         "data": {"resultType": "matrix", "result": []}}
        return orig(engine, qs, ds, tctx=tctx)

    monkeypatch.setattr(srv.http, "_query_range", stub)
    return entered, release


def _in_thread(fn):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", fn()))
    t.start()
    return t, out


@pytest.fixture
def gated():
    srv = psrv.FiloServer({**CPU, "trace-enabled": True,
                           "trace-sample-rate": 1.0,
                           "max-inflight-queries": 1}).start()
    yield srv
    srv.stop()


def test_the_admission_wait_opens_the_request_trace_before_the_query(
        gated, monkeypatch):
    srv = gated
    entered, release = _hold_slot(srv, monkeypatch)
    holder, held = _in_thread(lambda: _get(
        srv, RANGE, query="up", start=START, end=START + 60, hold=1))
    assert entered.wait(30)
    n0 = _metric(srv, "filodb_admission_wait_seconds_count")
    s0 = _metric(srv, "filodb_admission_wait_seconds_sum")
    q = "sum(rate(http_requests_total[5m]))"
    waiter, got = _in_thread(lambda: _get(
        srv, RANGE, query=q, start=START, end=START + 600, step=60))
    time.sleep(0.3)
    t_release_us = time.time_ns() // 1000
    release.set()
    holder.join(30)
    waiter.join(30)
    assert held["r"][0] == 200 and got["r"][0] == 200
    d = _retained(srv, _of_query(q))
    names = _by_name(d)
    (req,), (aw,), (qs,) = names["request"], names["admission-wait"], \
        names["query"]
    assert req["parent_id"] is None
    assert req["tags"] == {"path": RANGE, "status": 200}
    assert aw["parent_id"] == req["span_id"]
    assert qs["parent_id"] == req["span_id"]
    assert aw["tags"] == {"inflight": 1, "outcome": "admitted"}
    # it waited at least from its ask until the slot was given back, and
    # closed before the query opened
    assert aw["dur_us"] >= t_release_us - aw["start_us"] >= 100_000
    assert _end(aw) <= qs["start_us"]
    (rsp,) = names["respond"]
    assert rsp["parent_id"] == req["span_id"]
    assert rsp["tags"]["bytes"] == len(got["r"][1])
    assert qs["start_us"] + qs["dur_us"] <= rsp["start_us"]
    assert req["start_us"] <= aw["start_us"] and _end(rsp) <= _end(req)
    assert d["duration_us"] == req["dur_us"]
    # one admitted wait, of that length
    assert _metric(srv, "filodb_admission_wait_seconds_count") == n0 + 1
    assert _metric(srv, "filodb_admission_wait_seconds_sum") - s0 == \
        pytest.approx(aw["dur_us"] / 1e6, abs=0.05)


def test_a_wait_past_the_limit_is_a_timeout_and_answers_429(monkeypatch):
    srv = psrv.FiloServer({**CPU, "trace-enabled": True,
                           "trace-sample-rate": 1.0,
                           "max-inflight-queries": 1,
                           "admission-wait-s": 0.2}).start()
    try:
        entered, release = _hold_slot(srv, monkeypatch)
        holder, _ = _in_thread(lambda: _get(
            srv, RANGE, query="up", start=START, end=START + 60, hold=1))
        assert entered.wait(30)
        n0 = _metric(srv, "filodb_admission_wait_seconds_count")
        t0 = _metric(srv, "filodb_admission_wait_timeouts_total")
        code, body = _get(srv, RANGE, query="up", start=START,
                          end=START + 60)
        release.set()
        holder.join(30)
        assert code == 429
        assert json.loads(body)["errorType"] == "throttled"
        d = _retained(srv, lambda names: names["request"][0][
            "tags"]["status"] == 429)
        names = _by_name(d)
        assert d["retained"] == "error"
        assert "query" not in names
        (req,), (aw,) = names["request"], names["admission-wait"]
        assert req["tags"] == {"path": RANGE, "status": 429}
        assert aw["tags"] == {"inflight": 1, "outcome": "timeout"}
        assert aw["dur_us"] >= 190_000
        assert _metric(srv, "filodb_admission_wait_timeouts_total") == \
            t0 + 1
        assert _metric(srv, "filodb_admission_wait_seconds_count") == n0
    finally:
        srv.stop()


def test_untraced_requests_start_no_trace(gated):
    srv = gated
    srv.http.tracer.enabled = False
    before = srv.http.tracer.started
    for path in (RANGE, "/metrics", "/__health"):
        assert _get(srv, path, query="up", start=START,
                    end=START + 60)[0] == 200
    assert srv.http.tracer.started == before
    srv.http.tracer.enabled = True
    assert _get(srv, "/metrics")[0] == 200
    assert srv.http.tracer.started == before


# -- thread CPU time ---------------------------------------------------------

def test_cpu_us_is_the_threads_cpu_time_inside_the_span():
    assert obs_trace.span("idle") is obs_trace._NOOP
    tr = obs_trace.Trace()
    with obs_trace.activate(tr):
        with obs_trace.span("busy"):
            t_end = time.perf_counter() + 0.1
            x = 0
            while time.perf_counter() < t_end:
                x += 1
        with obs_trace.span("sleep"):
            time.sleep(0.1)
        obs_trace.event("mark")
    assert obs_trace.span("idle") is obs_trace._NOOP
    busy, sleep, mark = tr.spans_json()
    assert busy["cpu_us"] <= busy["dur_us"]
    # close to the wall time around a busy loop (the rest is the time the
    # thread was off its core on a shared machine) ...
    assert busy["cpu_us"] >= 0.5 * busy["dur_us"]
    # ... and near 0 around a sleep
    assert sleep["dur_us"] >= 100_000 and sleep["cpu_us"] < 10_000
    assert "cpu_us" not in mark
    back = [obs_trace.Span.from_json(d).to_json()
            for d in (busy, sleep, mark)]
    assert back == [busy, sleep, mark]
    otlp = obs_trace.otlp_payload([tr])["resourceSpans"][0][
        "scopeSpans"][0]["spans"]
    attrs = {s["name"]: {a["key"]: a["value"] for a in
                         s.get("attributes", ())} for s in otlp}
    assert attrs["busy"]["filodb.cpu_us"] == {
        "intValue": str(busy["cpu_us"])}
    assert "filodb.cpu_us" not in attrs["mark"]


# -- the spans inside a query ----------------------------------------------

def _traced(srv, query, end):
    code, body = _get(srv, RANGE, query=query, start=START, end=end,
                      step=60, explain="trace", cache="false")
    assert code == 200, body
    return _by_name(json.loads(body)["trace"])


@pytest.mark.parametrize("query,end,path", [
    (ALIGNED, TAIL_END, "aligned"), (PACKED, FLUSHED_END, "packed")],
    ids=["aligned", "packed"])
def test_a_query_records_aggregate_h2d_d2h_and_a_tile_miss_tile_build(
        loaded, query, end, path):
    first = _traced(loaded, query, end)
    again = _traced(loaded, query, end)
    for names in (first, again):
        assert names["device-eval"][0]["tags"]["path"] == path
        (agg,) = names["aggregate"]
        assert agg["tags"] == {"op": "max", "groups": 2}
        (ex,) = names["execute"]
        assert ex["start_us"] <= agg["start_us"] and _end(agg) <= _end(ex)
        for name in ("h2d", "d2h"):
            assert names[name], name
            for s in names[name]:
                assert s["tags"]["bytes"] > 0
        # the copies sit inside a dispatch or its sync
        ids = {s["span_id"]: s["name"] for v in names.values() for s in v}
        for s in names["h2d"] + names["d2h"]:
            assert ids[s["parent_id"]] in ("device-dispatch",
                                           "device-sync"), s
        # the explain payload is built before the write
        assert "request" not in names and "respond" not in names
    # the first query of a selection builds its tiles; the next hits them
    (tb,) = first["tile-build"]
    assert tb["tags"]["series"] == (8 if path == "aligned" else 4)
    assert (tb["tags"]["bytes"] > 0) == (path == "aligned")
    assert "tile-build" not in again


def test_the_fast_path_opens_an_encode_span_after_execute(loaded):
    q = "rate(http_requests_total[5m])"
    code, body = _get(loaded, RANGE, query=q, start=START, end=FLUSHED_END,
                      step=60)
    assert code == 200 and "trace" not in json.loads(body)
    names = _by_name(_retained(loaded, _of_query(q)))
    (qs,), (ex,), (enc,) = names["query"], names["execute"], names["encode"]
    assert enc["parent_id"] == qs["span_id"]
    assert _end(ex) <= enc["start_us"] and _end(enc) <= _end(qs)
    assert enc["cpu_us"] <= enc["dur_us"]
