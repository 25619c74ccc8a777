"""The selection memo: each partition keeps, per column, the record
``select_raw_series`` builds from it (labels, the decode cache's arrays,
``chunk_len``, snapshot key, histogram buckets and drops) until a write
changes what ``read_full`` returns. A hit answers what a fresh store's
first read answers; every write path invalidates; limits, read-only
arrays, a writer racing readers, and whole HTTP answers served twice."""

import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from filodb_tpu_torch import state
from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.core.memstore import (TimeSeriesPartition,
                                            TimeSeriesShard)
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.memory.histogram import CustomBuckets
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.query.engine import (SELECT_MEMO_HITS,
                                           SELECT_MEMO_MISSES,
                                           select_raw_series)
from filodb_tpu_torch.query.model import (QueryLimitError, QueryLimits,
                                          QueryStats)
from filodb_tpu_torch.standalone import server as psrv
from filodb_tpu_torch.store.columnstore import FlatFileColumnStore

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

T0 = 1_600_000_000_000
DT = 10_000
N = 130             # flushed rows a series: 4 chunks of at most 40
TAIL = 7            # unflushed rows a series
CHUNK = 40
LES = (0.5, 2.0, 8.0, float("inf"))

SELECTIONS = {
    "eq-gauge": [ColumnFilter.eq("_metric_", "heap")],
    "regex-gauge-and-counter": [ColumnFilter.regex("_metric_",
                                                   "heap|req_total")],
    "eq-counter": [ColumnFilter.eq("_metric_", "req_total")],
    "eq-histogram": [ColumnFilter.eq("_metric_", "lat")],
}
SPANS = {
    "whole": (T0 - 1, T0 + (N + TAIL) * DT),
    # both ends on a sample: the window is inclusive at each
    "bounded": (T0 + 30 * DT, T0 + 100 * DT),
    # the ends of int64: the first sample key would leave it
    "int64-extremes": (-(1 << 63), (1 << 63) - 1),
}


def _labels(metric, i):
    return {"_metric_": metric, "_ws_": "demo", "_ns_": "App-0",
            "host": f"h{i}"}


def _plain_rows(seed=5):
    """(gauges, counters) as (labels, ts, values), N + TAIL rows each."""
    rng = np.random.default_rng(seed)
    ts = T0 + np.arange(N + TAIL) * DT
    gauges = [(_labels("heap", i), ts, rng.uniform(0, 100, ts.size))
              for i in range(5)]
    counters = []
    for i in range(4):
        v = np.cumsum(rng.uniform(0, 5, ts.size))
        if i == 1:
            v[N // 2:] -= v[N // 2 - 1]            # a reset
        counters.append((_labels("req_total", i), ts, v))
    return gauges, counters


def _hist_containers(rows):
    b = RecordBuilder(DEFAULT_SCHEMAS)
    scheme = CustomBuckets(LES)
    for s in range(3):
        base = np.array([1, 3, 7, 10]) * (s + 1)
        for t in rows:
            k = t - N // 2 if t >= N // 2 else t         # a reset
            counts = (base * (k + 1)).astype(np.int64)
            b.add_sample("prom-histogram", _labels("lat", s), T0 + t * DT,
                         int(counts[-1]) * 0.05, float(counts[-1]),
                         (scheme, counts))
    return b.containers()


def _store(root=None):
    """One shard: gauges, counters and histograms, N rows flushed into
    chunks, TAIL rows in the write buffers; persisted under ``root``."""
    cs = FlatFileColumnStore(str(root)) if root is not None else None
    shard = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0,
                            max_chunk_rows=CHUNK, column_store=cs)
    gauges, counters = _plain_rows()
    for lo, hi, flush in ((0, N, True), (N, N + TAIL, False)):
        for rows, schema in ((gauges, "gauge"),
                             (counters, "prom-counter")):
            state.load_series(shard, [(lab, ts[lo:hi], v[lo:hi])
                                      for lab, ts, v in rows], schema,
                              False)
        for c in _hist_containers(range(lo, hi)):
            shard.ingest(c)
        if flush:
            shard.flush_all()
    assert all(p._buf_rows == TAIL for p in shard.partitions.values())
    return shard


def _memo_counts():
    reg = obs_metrics.GLOBAL_REGISTRY
    return tuple(sum(v for _, v in reg.counter(*c).series())
                 for c in (SELECT_MEMO_HITS, SELECT_MEMO_MISSES))


def _select(shard, filters, span=SPANS["whole"], full=True, limits=None):
    """-> (series, stats, memo hits, memo misses) of one selection."""
    h0, m0 = _memo_counts()
    stats = QueryStats()
    out = select_raw_series([shard], filters, *span, stats=stats,
                            full=full, limits=limits)
    h1, m1 = _memo_counts()
    return out, stats, h1 - h0, m1 - m0


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.labels == y.labels
        np.testing.assert_array_equal(x.ts, y.ts)
        np.testing.assert_array_equal(x.values, y.values)
        assert x.values.dtype == y.values.dtype
        assert (x.is_counter, x.chunk_len, x.snapshot_key) == \
            (y.is_counter, y.chunk_len, y.snapshot_key)
        for p, q in ((x.bucket_les, y.bucket_les),
                     (x.hist_drop_rows, y.hist_drop_rows)):
            assert (p is None) == (q is None)
            if p is not None:
                np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("full", [True, False], ids=["full", "span"])
@pytest.mark.parametrize("span", sorted(SPANS))
@pytest.mark.parametrize("sel", sorted(SELECTIONS))
def test_a_hit_returns_what_a_fresh_stores_first_read_returns(sel, span,
                                                              full):
    filters = SELECTIONS[sel]
    warm = _store()
    first, st1, h1, m1 = _select(warm, filters, SPANS[span], full)
    again, st2, h2, m2 = _select(warm, filters, SPANS[span], full)
    fresh, st3, h3, m3 = _select(_store(), filters, SPANS[span], full)
    assert len(first) > 0
    assert (h1, m1) == (0, len(first))
    assert (h2, m2) == (len(first), 0)
    assert (h3, m3) == (0, len(first))
    _assert_same(again, fresh)
    _assert_same(first, fresh)
    for st in (st1, st2):
        assert (st.series_scanned, st.samples_scanned) == \
            (st3.series_scanned, st3.samples_scanned)
    lo, hi = SPANS[span]
    assert st3.samples_scanned == sum(
        int(((s.ts >= lo) & (s.ts <= hi)).sum()) for s in fresh)
    if sel == "eq-histogram":
        assert all(s.bucket_les is not None for s in fresh)
        assert all((s.hist_drop_rows is not None) == full for s in fresh)


def _one_gauge_row(labels, k=N + TAIL):
    b = RecordBuilder(DEFAULT_SCHEMAS)
    b.add_sample("gauge", labels, T0 + k * DT, 42.0)
    return b.containers()[0]


def _evict(shard):
    shard.flush_all()
    assert shard.evict_partitions(cutoff_ts=T0 + (N + TAIL + 1) * DT) > 0


def _release(shard):
    for p in shard.partitions.values():
        p.release_caches()


def _racing(shard, before=lambda p: None, after=lambda p: None):
    """A row into every gauge (so each record is built again), then one
    selection whose first ``read_full`` runs between ``before`` and
    ``after`` (writes racing the read that builds a record)."""
    for i in range(5):
        shard.ingest(_one_gauge_row(_labels("heap", i)))
    orig = TimeSeriesPartition._read_full
    calls = []

    def read(part, ci):
        if calls:
            return orig(part, ci)
        calls.append(part)
        before(part)
        try:
            return orig(part, ci)
        finally:
            after(part)

    TimeSeriesPartition._read_full = read
    try:
        _select(shard, SELECTIONS["eq-gauge"])
    finally:
        TimeSeriesPartition._read_full = orig
    assert calls


class _HookedChunks(list):
    """A partition's chunk list that runs ``hook`` once, right after the
    next append: inside ``switch_buffers``' publish, between the new chunk
    and the emptied write buffer."""

    def __init__(self, chunks, hook):
        super().__init__(chunks)
        self.hook = hook

    def append(self, info):
        super().append(info)
        hook, self.hook = self.hook, None
        if hook is not None:
            hook()


def _select_inside_a_flush(shard):
    """A flush with a selection started between one gauge's chunk append
    and its buffer reset, then TAIL rows into every gauge's tail: that
    gauge's chunk count and buffered rows then read as the racing
    selection could have seen them mid-publish."""
    part = next(p for p in shard.partitions.values()
                if p.part_key.label_map == _labels("heap", 0))
    racer = threading.Thread(
        target=lambda: _select(shard, SELECTIONS["eq-gauge"]))

    def hook():
        racer.start()
        racer.join(0.3)     # it runs until it waits for the partition

    part.chunks = _HookedChunks(part.chunks, hook)
    shard.flush_all()
    racer.join()
    assert part.chunks.hook is None and part._buf_rows == 0
    for k in range(N + TAIL, N + 2 * TAIL):
        for i in range(5):
            shard.ingest(_one_gauge_row(_labels("heap", i), k))
    assert part._buf_rows == TAIL


# event -> (prepare before the records are built, the write, the matched
# series it should make miss: None for all)
EVENTS = {
    "ingest-into-a-tail": (
        None, lambda s: s.ingest(_one_gauge_row(_labels("heap", 0))), 1),
    "flush": (None, lambda s: s.flush_all(), None),
    "new-matching-partition": (
        None, lambda s: s.ingest(_one_gauge_row(_labels("heap", 9))), 1),
    "eviction-and-page-in": (lambda s: s.flush_all(), _evict, None),
    "release-caches": (lambda s: s.flush_all(), _release, None),
    "trim-decode-caches": (lambda s: s.flush_all(),
                           lambda s: s.trim_decode_caches(1), None),
    # a row lands after the read and before the record is stored
    "ingest-during-a-read": (None, lambda s: _racing(s, after=lambda p: (
        s.ingest(_one_gauge_row(p.part_key.label_map, N + TAIL + 1)))), 1),
    "selection-inside-a-flush": (None, _select_inside_a_flush, None),
    # the read sees the evicted (empty) partition, paged in again before
    # the record is stored with the chunk count it had before
    "eviction-and-page-in-during-a-read": (
        lambda s: s.flush_all(),
        lambda s: _racing(s, before=lambda p: _evict(s),
                          after=lambda p: s._ensure_loaded(p)), None),
}


@pytest.mark.parametrize("event", sorted(EVENTS))
def test_every_write_path_invalidates_the_records_it_changes(event,
                                                             tmp_path):
    prepare, write, missed = EVENTS[event]
    filters = SELECTIONS["eq-gauge"]
    a, b = _store(tmp_path / "a"), _store(tmp_path / "b")
    for s in (a, b):
        if prepare is not None:
            prepare(s)
    before, _, _, _ = _select(a, filters)
    assert _select(a, filters)[2] == len(before)          # all hits
    for s in (a, b):
        write(s)
    got, st, hits, misses = _select(a, filters)
    want, st_want, _, _ = _select(b, filters)
    _assert_same(got, want)
    assert (st.series_scanned, st.samples_scanned) == \
        (st_want.series_scanned, st_want.samples_scanned)
    assert misses == (len(got) if missed is None else missed)
    assert hits == len(got) - misses
    # every series holds every row its partition holds
    held = {frozenset(dict(p.part_key.labels).items()):
            sum(c.num_rows for c in p.chunks) + p._buf_rows
            for p in a.partitions.values()}
    assert [s.ts.size for s in got] == \
        [held[frozenset(s.labels.items())] for s in got]
    if event == "new-matching-partition":
        assert len(got) == len(before) + 1


@pytest.mark.parametrize("kind", ["series", "samples"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "span"])
def test_a_limit_breach_raises_the_same_error_on_a_hit_and_a_miss(kind,
                                                                  full):
    filters = SELECTIONS["regex-gauge-and-counter"]
    limits = (QueryLimits(series_limit=5) if kind == "series"
              else QueryLimits(sample_limit=3 * (N + TAIL) + 10))
    shard = _store()
    errors, counts = [], []
    for _ in range(2):
        h0, m0 = _memo_counts()
        with pytest.raises(QueryLimitError) as e:
            _select(shard, filters, full=full, limits=limits)
        h1, m1 = _memo_counts()
        errors.append(str(e.value))
        counts.append((h1 - h0, m1 - m0))
    assert errors[0] == errors[1]
    assert "so far" in errors[0] or kind == "series"
    assert counts[0][0] == 0 and counts[0][1] > 0
    assert counts[1] == (counts[0][1], 0)


@pytest.mark.parametrize("sel", sorted(SELECTIONS))
def test_memoized_arrays_cannot_be_written_in_place(sel):
    shard = _store()
    _select(shard, SELECTIONS[sel])
    got, _, hits, _ = _select(shard, SELECTIONS[sel])
    assert hits == len(got) > 0
    for s in got:
        arrays = [s.ts, s.values, s.bucket_les, s.hist_drop_rows]
        for a in arrays:
            if a is None:
                continue
            assert not a.flags.writeable
            with pytest.raises(ValueError):
                a[..., :1] = 0


@pytest.mark.parametrize("writes", ["rows", "runs"])
def test_readers_racing_a_writer_never_pair_a_chunk_count_with_a_new_tail(
        writes):
    """One writer appends rows (one at a time, or in runs) and flushes
    now and then; four readers select the whole series meanwhile. Every
    answer is a prefix of what was written, its ``chunk_len`` the rows of
    the first ``num_chunks`` chunks of its snapshot key; once the writer
    stops, the next selection sees every row (no record outlives its
    write)."""
    shard = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0,
                            max_chunk_rows=16)
    labels = _labels("heap", 0)
    filters = [ColumnFilter.eq("_metric_", "heap")]
    total = 1500
    stop = threading.Event()
    failures = []

    def writer():
        try:
            k = 0
            while k < total:
                n = 1 if writes == "rows" else min(5, total - k)
                ts = T0 + np.arange(k, k + n) * DT
                state.load_series(shard, [(labels, ts,
                                           ts.astype(np.float64))],
                                  "gauge", flush=False)
                k += n
                if k % 37 < n:
                    shard.flush_all()
        except Exception as e:      # noqa: BLE001 — reported below
            failures.append(f"writer: {e!r}")
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                for s in select_raw_series([shard], filters, T0 - 1,
                                           T0 + total * DT, full=True):
                    n = s.ts.size
                    want = T0 + np.arange(n) * DT
                    if not np.array_equal(s.ts, want) \
                            or not np.array_equal(s.values, want):
                        failures.append(f"not a prefix: {n} rows")
                    part = shard.partitions[s.snapshot_key[2]]
                    n_chunks = s.snapshot_key[3]
                    rows = sum(c.num_rows for c in part.chunks[:n_chunks])
                    if s.chunk_len != rows or s.chunk_len > n:
                        failures.append(
                            f"chunk_len {s.chunk_len} with {n_chunks} "
                            f"chunks of {rows} rows, {n} rows in all")
        except Exception as e:      # noqa: BLE001 — reported below
            failures.append(f"reader: {e!r}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert failures == []
    (s,) = select_raw_series([shard], filters, T0 - 1, T0 + total * DT,
                             full=True)
    assert s.ts.size == total
    assert s.chunk_len == sum(c.num_rows for c in
                              shard.partitions[s.snapshot_key[2]].chunks)


# -- whole answers over HTTP -------------------------------------------------

HOSTS = 8
METRICS = ["cpu_usage_user", "cpu_usage_system", "cpu_usage_idle",
           "cpu_usage_nice", "cpu_usage_iowait", "cpu_usage_irq",
           "cpu_usage_softirq", "cpu_usage_steal", "cpu_usage_guest",
           "cpu_usage_guest_nice"]
SAMPLES = 8 * 360               # 8 h at 10 s
RANGE = "/promql/timeseries/api/v1/query_range"
END_S = (T0 + (SAMPLES - 7) * DT) // 1000
# the benchmark's tsbs-mix templates, filled for this data
TEMPLATES = {
    "double-groupby-1": (
        "avg(avg_over_time(cpu_usage_user{}[1h])) by (__name__, hostname)",
        6 * 3600, 3600),
    "cpu-max-all-8": (
        "max(max_over_time({__name__=~'cpu_(" + "|".join(
            m[len("cpu_"):] for m in METRICS) + ")', hostname=~'"
        + "|".join(f"host_{i}" for i in range(0, HOSTS, 2))
        + "'}[1h])) by (__name__)", 5 * 3600, 3600),
    "single-groupby-1-1-12": (
        "max(max_over_time(cpu_usage_user{hostname='host_3'}[1m])) "
        "by (__name__)", 6 * 3600, 60),
}


@pytest.fixture(scope="module")
def tsbs_server():
    srv = psrv.FiloServer({"device": "cpu", "gc-freeze": False,
                           "num-shards": 4, "port": 0,
                           "trace-enabled": True,
                           "trace-sample-rate": 1.0}).start()
    rng = np.random.default_rng(3)
    ts = T0 + np.arange(SAMPLES) * DT
    rows = [({"_metric_": m, "_ws_": "tsbs", "_ns_": "devops",
              "hostname": f"host_{h}"}, ts,
             np.clip(50 + np.cumsum(rng.normal(0, 1, SAMPLES)), 0, 100))
            for m in METRICS for h in range(HOSTS)]
    state.load_into_store(srv.store, srv.ref, rows, "gauge", True,
                          num_shards=4,
                          spread=int(srv.config["default-spread"]))
    yield srv
    srv.stop()


def _get(srv, path, **params):
    url = f"http://127.0.0.1:{srv.port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _metric(srv, name):
    _, body = _get(srv, "/metrics")
    for ln in body.decode().splitlines():
        if ln.startswith(name + " "):
            return float(ln.split()[1])
    raise AssertionError(f"{name} not in /metrics")


def _select_span_tags(srv, query, after_us):
    """memo_hits / memo_misses of the newest traced select-series of
    ``query`` that started after ``after_us``."""
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        for tr in srv.http.tracer.recent(1000):
            d = tr.to_json()
            if not any(s["name"] == "query"
                       and s.get("tags", {}).get("query") == query
                       and s["start_us"] >= after_us for s in d["spans"]):
                continue
            sel = [s for s in d["spans"] if s["name"] == "select-series"]
            if sel:
                return (sum(s["tags"]["memo_hits"] for s in sel),
                        sum(s["tags"]["memo_misses"] for s in sel),
                        sum(s["tags"]["series"] for s in sel))
        time.sleep(0.01)
    raise AssertionError("no traced select-series for the query")


@pytest.mark.parametrize("template", sorted(TEMPLATES))
def test_an_answer_served_again_from_the_records_is_byte_identical(
        tsbs_server, template):
    """The second answer (results cache bypassed, every series a memo hit)
    is the first's bytes, ``stats`` included up to its ``timings`` (wall
    clock and the plan cache's hit, which differ between any two
    answers); the counters on /metrics and the ``select-series`` span's
    tags count the hits."""
    query, range_s, step = TEMPLATES[template]
    params = dict(query=query, start=END_S - range_s, end=END_S, step=step,
                  cache="false")
    bodies = []
    for _ in range(2):
        h0 = _metric(tsbs_server, SELECT_MEMO_HITS[0])
        m0 = _metric(tsbs_server, SELECT_MEMO_MISSES[0])
        t0_us = time.time_ns() // 1000
        status, body = _get(tsbs_server, RANGE, **params)
        assert status == 200, body[:300]
        bodies.append(body)
        dh = _metric(tsbs_server, SELECT_MEMO_HITS[0]) - h0
        dm = _metric(tsbs_server, SELECT_MEMO_MISSES[0]) - m0
        assert (dh, dm) == _select_span_tags(tsbs_server, query, t0_us)[:2]
    head = [b.split(b',"timings":')[0] for b in bodies]
    assert head[0] == head[1]
    assert b'"stats":{"seriesScanned":' in head[1]
    assert b'"result":[{' in head[1]
    hits, misses, series = _select_span_tags(tsbs_server, query, t0_us)
    assert (hits, misses) == (series, 0) and series > 0
