"""The slice as a whole: the same PromQL over the same shard contents,
answered by the port's engine with ``TorchBackend(device="cpu")``, by the
JAX engine with ``TpuBackend`` and by the numpy oracle.

Shard contents (numpy, one seed): jittered counter series with a reset,
flushed into chunks, plus an unflushed write-buffer tail, plus series of
irregular cadence. Tolerances: grouped sums from the fused kernels within
rtol 1e-5, atol 1e-7 of each other (the kernels' own bound); per-series
rates within 8 f32 ulps of JAX (twice the f32-epilogue budget, see
test_torch_tilestore); everything within rtol 1e-5 of the f64 oracle."""

import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import TimeSeriesShard as JShard
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetRef as JRef
from filodb_tpu.promql.parser import TimeStepParams as JParams
from filodb_tpu.promql.parser import parse_query_range as j_parse
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.query.tpu import TpuBackend
from filodb_tpu_torch import state
from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.query import kernels as kn
from filodb_tpu_torch.query.backend import TorchBackend
from filodb_tpu_torch.query.engine import QueryEngine

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

T0 = 1_600_000_000_000
DT = 10_000
N = 360
TAIL = 30


def _contents(seed=11, S=32, S_irr=8):
    """(flushed rows, tail rows) as (labels, ts, values) triples."""
    rng = np.random.default_rng(seed)
    flushed, tail = [], []
    for i in range(S):
        ts = T0 + np.arange(N + TAIL) * DT + rng.integers(-2000, 2000,
                                                          N + TAIL)
        v = 1e9 + np.cumsum(rng.uniform(0, 5, N + TAIL))
        if i == 3:
            v[N // 2:] -= v[N // 2 - 1]          # counter reset
        lab = {"_metric_": "http_requests_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 4}", "instance": f"i{i}"}
        flushed.append((lab, ts[:N], v[:N]))
        tail.append((lab, ts[N:], v[N:]))
    for i in range(S_irr):
        # 10 s nominal cadence with jitter past half a slot: no shared
        # cadence grid, so these take the packed path
        ts = np.unique(T0 + np.arange(N) * DT
                       + rng.integers(-6000, 6000, N))
        v = np.cumsum(rng.uniform(0, 3, ts.size))
        lab = {"_metric_": "irregular_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 2}", "instance": f"k{i}"}
        flushed.append((lab, ts, v))
    return flushed, tail


@pytest.fixture(scope="module")
def shards():
    flushed, tail = _contents()
    port = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0)
    state.load_series(port, flushed)
    state.load_series(port, tail, flush=False)
    ref = JShard(JRef("timeseries"), J_SCHEMAS, 0)
    for rows, flush in ((flushed, True), (tail, False)):
        b = JBuilder(J_SCHEMAS)
        for lab, ts, vals in rows:
            for t, v in zip(ts, vals):
                b.add_sample("prom-counter", lab, int(t), float(v))
        for c in b.containers():
            ref.ingest(c)
        if flush:
            ref.flush_all()
    return port, ref


FLUSHED_END = (T0 + (N - 5) * DT) // 1000       # seconds
TAIL_END = (T0 + (N + TAIL - 2) * DT) // 1000
START = T0 // 1000 + 600


def _run(shards, q, end):
    port, ref = shards
    be = TorchBackend(device="cpu")
    jbe = TpuBackend(batcher=None)
    got = QueryEngine([port], backend=be).execute(
        parse_query_range(q, TimeStepParams(START, 60, end)))
    oracle = QueryEngine([port]).execute(
        parse_query_range(q, TimeStepParams(START, 60, end)))
    want = JEngine([ref], backend=jbe).execute(
        j_parse(q, JParams(START, 60, end)))
    assert [dict(k) for k in got.keys] == [dict(k) for k in want.keys]
    assert [dict(k) for k in got.keys] == [dict(k) for k in oracle.keys]
    np.testing.assert_array_equal(np.isnan(got.values),
                                  np.isnan(want.values))
    np.testing.assert_allclose(got.values, oracle.values, rtol=1e-5,
                               atol=1e-9)
    return got.values, want.values, be, jbe


def _within_f32_ulps(a, b, n):
    ok = ~np.isnan(a)
    mag = np.maximum(np.abs(a[ok]), np.abs(b[ok])).astype(np.float32)
    assert np.all(np.abs(a[ok] - b[ok])
                  <= n * np.spacing(mag).astype(np.float64))


@pytest.mark.parametrize("op", ["sum", "avg", "count"])
def test_grouped_rate_fused(shards, op):
    q = f"{op} by (job) (rate(http_requests_total[5m]))"
    got, want, be, jbe = _run(shards, q, FLUSHED_END)
    assert be.fused_aggs == 1 and jbe.fused_aggs == 1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert got.shape == (4, (FLUSHED_END - START) // 60 + 1)


@pytest.mark.parametrize("func", ["rate", "increase", "delta"])
def test_per_series_into_the_tail(shards, func):
    kn.reset_launches()
    got, want, be, _ = _run(shards, f"{func}(http_requests_total[5m])",
                            TAIL_END)
    # the last steps reach the unflushed tail: spliced from the packed path
    assert be.packed_dispatches == 1 and be.tile_builds == 1
    assert not np.isnan(got[:, -1]).any()
    _within_f32_ulps(got, want, 8)
    assert kn.LAUNCHES == {"counter_groupsum": 0, "window_extract": 0}


@pytest.mark.parametrize("q", ["rate(irregular_total[5m])",
                               "sum by (job) (increase(irregular_total[5m]))"])
def test_irregular_cadence_packed(shards, q):
    got, want, be, _ = _run(shards, q, FLUSHED_END)
    assert be.packed_dispatches >= 1 and be.fused_aggs == 0
    # both packages take exact f64 boundary values: a few f64 ulps apart
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-12)


def test_other_functions_fall_back_to_the_oracle(shards):
    # deriv has no device form in either package
    port, _ = shards
    be = TorchBackend(device="cpu")
    q = "deriv(http_requests_total[5m])"
    got = QueryEngine([port], backend=be).execute(
        parse_query_range(q, TimeStepParams(START, 60, FLUSHED_END)))
    want = QueryEngine([port]).execute(
        parse_query_range(q, TimeStepParams(START, 60, FLUSHED_END)))
    np.testing.assert_array_equal(got.values, want.values)
    assert be.tile_builds == 0 and be.packed_dispatches == 0
