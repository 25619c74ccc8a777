"""The serving fast path of the port on the CPU: concurrent queries through
``TorchBackend`` and the JAX package's ``TpuBackend``, the tile cache's
stale-serve across a flush with its one background rebuild per key, the
cache's lock under concurrent selections, and the selection identity of
span-bounded (leaf-dispatch) snapshot keys.

Tolerances: port against the numpy oracle rtol 1e-9, atol 1e-9 (the f32
counter evaluators rtol 1e-5, as tests/test_torch_engine.py); port against
JAX as tests/test_torch_functions.py states them (the prefix-sum family at
twice the oracle tolerance, as its engine test)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from filodb_tpu.query.model import RangeParams as JRange
from filodb_tpu.query.model import RawSeries as JRaw
from filodb_tpu.query.tpu import TpuBackend
from filodb_tpu_torch import state
from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.query import qos
from filodb_tpu_torch.query import rangefn as rf
from filodb_tpu_torch.query.backend import TorchBackend
from filodb_tpu_torch.query.batcher import MicroBatcher
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.model import RangeParams, RawSeries

from test_torch_functions import PREFIX_FAMILY, _check_jax

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

BASE = 1_600_000_000_000
DT = 10_000
STEP = 60_000


# ---------------------------------------------------------------------------
# concurrent queries through both backends
# ---------------------------------------------------------------------------

def _rows(regular, S=6, n=300, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(S):
        if regular:
            ts = BASE + np.arange(n, dtype=np.int64) * DT \
                + rng.integers(-2000, 2001, n)
        else:
            ts = BASE + np.cumsum(rng.integers(5_000, 15_000, n))
        out.append((ts.astype(np.int64), np.cumsum(rng.uniform(0, 4, n))))
    return out


def _grid(k, nsteps=20):
    start = BASE + 600_000 + k * STEP
    return start, start + (nsteps - 1) * STEP


def _burst(backend, series, params, func, window):
    """One query per grid, all released together by a barrier -> the
    answers in grid order."""
    outs = [None] * len(params)
    errs = []
    barrier = threading.Barrier(len(params))

    def worker(k):
        barrier.wait()
        try:
            outs[k] = backend.periodic_samples(series, params[k], func,
                                               window).values
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)
    ths = [threading.Thread(target=worker, args=(k,))
           for k in range(len(params))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(120)
        assert not t.is_alive()
    assert errs == []
    return outs


@pytest.mark.parametrize("func, regular", [
    ("rate", True), ("avg_over_time", True), ("rate", False),
    ("max_over_time", False), ("sum_over_time", False)])
def test_concurrent_queries_through_both_backends(func, regular):
    rows = _rows(regular)
    keys = [{"i": str(i)} for i in range(len(rows))]
    snap = [("ds", 0, i, 3, 0) for i in range(len(rows))]
    port = [RawSeries(k, t, v, is_counter=True, snapshot_key=s,
                      chunk_len=t.size)
            for k, (t, v), s in zip(keys, rows, snap)]
    ref = [JRaw(k, t, v, is_counter=True, snapshot_key=s, chunk_len=t.size)
           for k, (t, v), s in zip(keys, rows, snap)]
    grids = [_grid(k) for k in range(8)]
    be = TorchBackend(device="cpu",
                      batcher=MicroBatcher(use_executor=True))
    jbe = TpuBackend()
    try:
        got = _burst(be, port, [RangeParams(a, STEP, b) for a, b in grids],
                     func, 300_000)
        want = _burst(jbe, ref, [JRange(a, STEP, b) for a, b in grids],
                      func, 300_000)
    finally:
        be.batcher.executor.stop(10)
        jbe.batcher.executor.stop()
    assert be.batcher.stats.snapshot()["queries"] == 8
    f32 = func == "rate" and regular
    for (a, b), g, w in zip(grids, got, want):
        oracle = np.vstack([rf.evaluate(func, t, v, a, STEP, b, 300_000)
                            for t, v in rows])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(oracle))
        np.testing.assert_allclose(g, oracle, rtol=1e-5 if f32 else 1e-9,
                                   atol=1e-9)
        if f32:
            ok = ~np.isnan(g)
            mag = np.maximum(np.abs(g[ok]), np.abs(w[ok])).astype(np.float32)
            assert (np.abs(g[ok] - w[ok])
                    <= 8 * np.spacing(mag).astype(np.float64)).all()
        elif func in PREFIX_FAMILY:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=2e-9, atol=2e-9)
        else:
            _check_jax(func, g, w)


# ---------------------------------------------------------------------------
# stale-serve across a flush
# ---------------------------------------------------------------------------

N = 240
TAIL = 30
S = 12


def _shard_rows(seed=8):
    """Jittered counters (one reset) as (labels, ts, values) with N + 2
    TAIL samples: N flushed, then a TAIL-sample write-buffer tail, then a
    TAIL-sample tail ingested later."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(S):
        ts = BASE + np.arange(N + 2 * TAIL) * DT \
            + rng.integers(-2000, 2001, N + 2 * TAIL)
        v = 1e6 + np.cumsum(rng.uniform(0, 5, N + 2 * TAIL))
        if i == 5:
            v[N // 2:] -= v[N // 2 - 1]
        rows.append(({"_metric_": "http_requests_total", "_ws_": "demo",
                      "_ns_": "App-0", "job": f"job{i % 3}",
                      "instance": f"i{i}"}, ts, v))
    return rows


def _shard():
    rows = _shard_rows()
    shard = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0)
    state.load_series(shard, [(lab, t[:N], v[:N]) for lab, t, v in rows])
    state.load_series(shard, [(lab, t[N:N + TAIL], v[N:N + TAIL])
                              for lab, t, v in rows], flush=False)
    return shard, rows


START = BASE // 1000 + 600
FLUSHED_END = (BASE + (N - 5) * DT) // 1000
LATE_END = (BASE + (N + 2 * TAIL - 2) * DT) // 1000
RATE_Q = "rate(http_requests_total[5m])"
GROUP_Q = "sum by (job) (rate(http_requests_total[5m]))"


def _run(engine, q, end):
    return engine.execute(parse_query_range(q, TimeStepParams(START, 60,
                                                              end)))


def _check(got, want):
    assert [dict(k) for k in got.keys] == [dict(k) for k in want.keys]
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(want.values))
    np.testing.assert_allclose(got.values, want.values, rtol=1e-5, atol=1e-9)


def _counters(be):
    return (be.tile_builds, be.tile_hits, be.fused_aggs,
            be.packed_dispatches)


def _flush_new_tail(shard, rows):
    """Ingest the later tail and flush: every partition's chunk count
    changes, so the selection's snapshot keys do."""
    state.load_series(shard, [(lab, t[N + TAIL:], v[N + TAIL:])
                              for lab, t, v in rows], flush=False)
    shard.flush_all()


def _drain(executor):
    """Wait until everything queued on the executor before now has run
    (background work sorts FIFO within its class)."""
    done = threading.Event()
    executor.submit(done.set, priority=qos.PRIORITY_BEST_EFFORT)
    assert done.wait(60)


def test_stale_serve_across_a_flush():
    shard, rows = _shard()
    be = TorchBackend(device="cpu")
    engine = QueryEngine([shard], backend=be)
    oracle = QueryEngine([shard])
    gate = threading.Event()
    try:
        # before the flush: the fused group sum builds the tiles
        _check(_run(engine, GROUP_Q, FLUSHED_END),
               _run(oracle, GROUP_Q, FLUSHED_END))
        assert _counters(be)[:3] == (1, 0, 1)
        _flush_new_tail(shard, rows)
        # hold the executor so the rebuild stays queued behind the gate
        be.batcher.executor.submit(gate.wait)
        before = _counters(be)
        stale = _run(engine, RATE_Q, LATE_END)
        _check(stale, _run(oracle, RATE_Q, LATE_END))
        builds, hits, fused, packed = _counters(be)
        # the previous snapshot's tiles served: no inline build, and the
        # steps past the stale entry's coverage took the packed path
        assert (builds, hits) == (before[0], before[1] + 1)
        assert packed == before[3] + 1
        assert len(be._tile_refreshing) == 1
        # more queries while the rebuild waits: stale serves, still one
        # rebuild queued for the key
        outs = _burst_engine(shard, be, 4)
        for got in outs:
            _check(got, stale)
        assert be.tile_builds == before[0] and len(be._tile_refreshing) == 1
        # the fused group sum declines under the stale entry; the engine's
        # fallback over the same selection equals the oracle
        _check(_run(engine, GROUP_Q, LATE_END),
               _run(oracle, GROUP_Q, LATE_END))
        assert be.fused_aggs == fused
    finally:
        gate.set()
        _drain(be.batcher.executor)
    # the rebuild landed: the fresh key is cached, one build more
    assert be.tile_builds == before[0] + 1
    assert be._tile_refreshing == set()
    assert len(be._tile_cache) == 2 and len(be._tile_ident) == 1
    fresh_key = next(iter(be._tile_ident.values()))
    assert fresh_key == list(be._tile_cache)[-1]
    packed = be.packed_dispatches
    again = _run(engine, RATE_Q, LATE_END)
    _check(again, stale)
    _check(again, _run(oracle, RATE_Q, LATE_END))
    assert be.tile_builds == before[0] + 1
    assert be.packed_dispatches == packed      # all steps on the tiles
    _check(_run(engine, GROUP_Q, LATE_END),
           _run(oracle, GROUP_Q, LATE_END))
    assert be.fused_aggs == fused + 1
    be.batcher.executor.stop(10)


def _burst_engine(shard, be, n):
    outs = [None] * n
    errs = []
    barrier = threading.Barrier(n)

    def worker(k):
        barrier.wait()
        try:
            outs[k] = _run(QueryEngine([shard], backend=be), RATE_Q,
                           LATE_END)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)
    ths = [threading.Thread(target=worker, args=(k,)) for k in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(120)
        assert not t.is_alive()
    assert errs == []
    return outs


def test_without_a_batcher_the_flush_rebuilds_inline():
    shard, rows = _shard()
    be = TorchBackend(device="cpu", batcher=None)
    engine = QueryEngine([shard], backend=be)
    oracle = QueryEngine([shard])
    _check(_run(engine, GROUP_Q, FLUSHED_END),
           _run(oracle, GROUP_Q, FLUSHED_END))
    _flush_new_tail(shard, rows)
    hits = be.tile_hits
    _check(_run(engine, RATE_Q, LATE_END), _run(oracle, RATE_Q, LATE_END))
    assert be.tile_builds == 2 and be.tile_hits == hits
    _check(_run(engine, GROUP_Q, LATE_END), _run(oracle, GROUP_Q, LATE_END))
    assert be.fused_aggs == 2 and be.tile_hits == hits + 1


# ---------------------------------------------------------------------------
# the cache's lock and the selection identity
# ---------------------------------------------------------------------------

class _SizeRecorder(dict):
    """The tile cache's dict, recording the most entries it ever held. It
    yields the interpreter lock before each insert and each pop, so that
    without the cache's lock two threads would interleave there (an
    overshoot past the cap, or a pop of a key another thread popped)."""

    most = 0

    def __setitem__(self, key, value):
        time.sleep(0)
        super().__setitem__(key, value)
        self.most = max(self.most, len(self))

    def pop(self, key, *default):
        time.sleep(0)
        return super().pop(key, *default)


def test_tile_cache_lock_under_concurrent_selections():
    rows = _rows(True, S=48, n=120)
    sels = [[RawSeries({"i": str(2 * j + r)}, *rows[2 * j + r],
                       snapshot_key=("ds", 0, 2 * j + r, 1, 0),
                       chunk_len=rows[2 * j + r][0].size)
             for r in range(2)] for j in range(24)]
    assert len(sels) > TorchBackend._TILE_CACHE_MAX
    be = TorchBackend(device="cpu")
    be._tile_cache = _SizeRecorder()
    first, last = _grid(0, nsteps=8)
    params = RangeParams(first, STEP, last)
    errs = []
    barrier = threading.Barrier(16)

    def worker(k):
        barrier.wait()
        try:
            for j in range(k, k + 24, 3):
                be.periodic_samples(sels[j % 24], params, "rate", 300_000)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert errs == []
    assert be._tile_cache.most <= TorchBackend._TILE_CACHE_MAX
    assert len(be._tile_cache) == TorchBackend._TILE_CACHE_MAX
    assert be.tile_builds + be.tile_hits == 16 * 8
    # the identity map names only cached keys
    assert set(be._tile_ident.values()) <= set(be._tile_cache)


def _span_selection(parts, scale, rng):
    """Two series with leaf-dispatch (span-bounded) snapshot keys:
    (node, ds, shard, part, num_chunks, col, start, end)."""
    out = []
    for p in parts:
        ts = BASE + np.arange(300, dtype=np.int64) * DT
        v = np.cumsum(rng.random(300) * scale)
        out.append(((p, ts, v), ("node", "ds", 0, p, 7, 1, BASE,
                                 BASE + 3_000_000)))
    return out


def test_span_selections_of_equal_length_keep_their_own_tiles():
    """Two selections of two partitions each on one shard, with the same
    chunk counts and span: each gets its own tiles and the oracle's
    answers. (ROADMAP C records that the JAX backend takes the chunk count
    out of these keys by the raw-selection layout's position, and so files
    both selections under one identity.)"""
    rng = np.random.default_rng(1)
    a = _span_selection([1, 2], 1.0, rng)
    b = _span_selection([3, 4], 100.0, rng)
    params = RangeParams(BASE + 600_000, STEP, BASE + 2_400_000)

    def port(sel):
        return [RawSeries({"p": str(p)}, t, v, is_counter=True,
                          snapshot_key=k, chunk_len=t.size)
                for (p, t, v), k in sel]
    be = TorchBackend(device="cpu")
    for sel in (a, b):
        got = be.periodic_samples(port(sel), params, "rate", 300_000).values
        oracle = np.vstack([rf.evaluate("rate", t, v, params.start_ms, STEP,
                                        params.end_ms, 300_000)
                            for (_, t, v), _k in sel])
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-9)
    assert be.tile_builds == 2 and be.tile_hits == 0
    assert len(be._tile_ident) == 2
