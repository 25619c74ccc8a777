"""Each per-layer reader on synthetic spans, counter deltas and device
intervals; each returns nothing where it finds nothing to read."""

import json
import os

import pytest

from conftest import BENCH_JSON
from portbench.harness import devtrace, spec


def span(name, start, dur, sid, parent=None, **tags):
    return {"name": name, "span_id": sid, "parent_id": parent,
            "start_us": start, "dur_us": dur, "tags": tags}


def query_trace(t0, select_us, exec_end, query_end, dispatch=()):
    spans = [span("query", t0, query_end, "q"),
             span("execute", t0 + 100, exec_end - 100, "x", "q"),
             span("select-series", t0 + 200, select_us, "s", "x")]
    spans += [span("device-dispatch", t0 + 300, d, f"d{i}", "x")
              for i, d in enumerate(dispatch)]
    return {"spans": spans}


def device(events, launches=None):
    d = devtrace.DeviceTrace("/nonexistent")
    d.device = sorted(events)
    d.launch = launches or {}
    return d


def ctx(**kw):
    bench = spec.Bench(BENCH_JSON)
    base = {"traces": [], "counters": {}, "device": None, "probes": {},
            "window_us": (0.0, 1e6), "card": "NVIDIA H100 80GB HBM3",
            "bench": bench, "cfg": bench.config("tsbs-devops-cpu")}
    base.update(kw)
    return base


def read(name, **kw):
    return spec.Bench(BENCH_JSON).metric_reader(name).read(ctx(**kw))


def test_every_per_layer_metric_has_a_reader():
    with open(BENCH_JSON) as f:
        doc = json.load(f)
    for m in doc["per_layer"]:
        assert os.path.exists(os.path.join(spec.PKG_DIR, "metrics",
                                           m["name"] + ".py"))


def test_span_readers_average_per_query():
    traces = [query_trace(0, 4_000, 10_000, 13_000, dispatch=(1_000, 500)),
              query_trace(50_000, 2_000, 20_000, 21_000)]
    assert read("select_ms", traces=traces) == pytest.approx(3.0)
    # the query span's stretch after execute: 3 ms and 1 ms
    assert read("encode_ms", traces=traces) == pytest.approx(2.0)
    # only the query that dispatched: 1.5 ms
    assert read("dispatch_ms", traces=traces) == pytest.approx(1.5)
    for name in ("select_ms", "encode_ms", "dispatch_ms"):
        assert read(name, traces=[]) is None
    assert read("dispatch_ms", traces=traces[1:]) is None


def test_counter_readers_take_shares_of_deltas():
    c = {"filodb_result_cache_hits_total": 2.0,
         "filodb_result_cache_partial_hits_total": 3.0,
         "filodb_result_cache_misses_total": 15.0,
         "filodb_tile_cache_hits_total": 30.0,
         "filodb_tile_builds_total": 10.0,
         "filodb_batcher_queries_total": 12.0,
         "filodb_batcher_batches_total": 8.0}
    assert read("resultcache_hit_share", counters=c) == pytest.approx(25.0)
    assert read("tile_cache_hit_share", counters=c) == pytest.approx(75.0)
    assert read("batch_occupancy", counters=c) == pytest.approx(1.5)
    for name in ("resultcache_hit_share", "tile_cache_hit_share",
                 "batch_occupancy"):
        assert read(name, counters={}) is None


def test_idle_share_is_the_window_less_the_union_of_device_intervals():
    dev = device([(100.0, 300.0, "k", 1), (200.0, 400.0, "k", 2),
                  (900_000.0, 2e6, "copy", 3)])
    # busy 300 us + 100,000 us of 1 s
    assert read("device_idle_share", device=dev) == pytest.approx(
        100.0 * (1 - 0.1003))
    assert read("device_idle_share") is None


def test_window_roofline_counts_only_the_kernels_a_call_launched():
    b = spec.Bench(BENCH_JSON)
    cfg = b.config("tsbs-devops-cpu")
    t0 = cfg["start_ms"]
    call = {"tid": 7, "t0_us": 1_000.0, "t1_us": 2_000.0,
            "parts": [(512, [(t0, t0 + 3_600_000, 3_600_000, 12)])]}
    nbytes, _ = b.roofline("window_eval").call_bytes_ops(call, cfg)
    t = nbytes / 3.35e12 * 1e6          # us at the roofline
    dev = device([(5_000.0, 5_000.0 + 4 * t, "k", 1),
                  (6_000.0, 6_000.0 + 100 * t, "k", 2),
                  (7_000.0, 7_000.0 + 100 * t, "k", 3)],
                 launches={1: (7, 1_500.0), 2: (8, 1_500.0),
                           3: (7, 2_500.0)})
    got = read("roofline.window_eval", device=dev,
               probes={"window_eval": [call]})
    assert got == pytest.approx(25.0, rel=1e-6)


def test_idle_gaps_are_named_by_the_deepest_open_span():
    dev = device([(0.0, 100.0, "k", 1), (600.0, 700.0, "k", 2)])
    traces = [{"spans": [span("query", 50, 600, "q"),
                         span("select-series", 200, 300, "s", "q")]}]
    gaps = dev.idle_gaps(0.0, 1_000.0, devtrace.span_labeler(traces))
    assert gaps[0] == ["host: select-series", pytest.approx(500e-6)]
    assert gaps[1] == ["host: no query in flight", pytest.approx(300e-6)]
