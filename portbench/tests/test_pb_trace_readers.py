"""The readers of the admission wait and of the selection's thread CPU time
on synthetic counter deltas and spans; each returns nothing where it finds
nothing to read (as on a program that records neither)."""

import pytest

from conftest import BENCH_JSON
from portbench.harness import spec


def span(name, start, dur, sid, parent=None, cpu=None):
    s = {"name": name, "span_id": sid, "parent_id": parent,
         "start_us": start, "dur_us": dur}
    if cpu is not None:
        s["cpu_us"] = cpu
    return s


def read(name, **kw):
    bench = spec.Bench(BENCH_JSON)
    ctx = {"traces": [], "counters": {}, "device": None, "probes": {},
           "window_us": (0.0, 1e6), "card": "NVIDIA H100 80GB HBM3",
           "bench": bench, "cfg": bench.config("tsbs-devops-cpu")}
    ctx.update(kw)
    return bench.metric_reader(name).read(ctx)


def test_admission_wait_is_the_histograms_mean_over_the_window():
    c = {"filodb_admission_wait_seconds_sum": 4.5,
         "filodb_admission_wait_seconds_count": 20.0,
         "filodb_admission_wait_timeouts_total": 3.0}
    assert read("admission_wait_ms", counters=c) == pytest.approx(225.0)


@pytest.mark.parametrize("counters", [
    {},
    {"filodb_admission_wait_seconds_sum": 0.0,
     "filodb_admission_wait_seconds_count": 0.0},
    {"filodb_admission_inflight": 4.0,
     "filodb_admission_wait_timeouts_total": 2.0}],
    ids=["no-counters", "count-did-not-move", "parent-families-only"])
def test_admission_wait_reads_nothing_without_admitted_waits(counters):
    assert read("admission_wait_ms", counters=counters) is None


def test_select_cpu_averages_each_querys_selection_cpu():
    traces = [
        {"spans": [span("query", 0, 90_000, "q", cpu=40_000),
                   span("select-series", 100, 30_000, "s1", "q",
                        cpu=9_000),
                   span("select-series", 40_000, 20_000, "s2", "q",
                        cpu=3_000)]},
        # a query that selected nothing counts as 0, as in select_ms
        {"spans": [span("query", 0, 5_000, "q", cpu=4_000)]},
        # spans of no query (a peer's) are left out
        {"spans": [span("select-series", 0, 8_000, "s", cpu=8_000)]},
    ]
    # (12 ms + 0 ms) / 2 queries
    assert read("select_cpu_ms", traces=traces) == pytest.approx(6.0)
    # and it never exceeds select_ms over the same queries
    assert read("select_cpu_ms", traces=traces) <= read(
        "select_ms", traces=traces)


def test_select_cpu_reads_nothing_where_no_span_measured_cpu():
    no_cpu = [{"spans": [span("query", 0, 90_000, "q"),
                         span("select-series", 100, 30_000, "s", "q")]}]
    assert read("select_cpu_ms", traces=no_cpu) is None
    assert read("select_cpu_ms", traces=[]) is None
    assert read("select_ms", traces=no_cpu) == pytest.approx(30.0)
