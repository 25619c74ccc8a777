"""Raw/downsample query tiering in the port (LongTimeRangePlanner.scala:30
+ StitchRvsExec.scala:116) against the JAX package's planner, with
``now_ms`` pinned.

Both sides persist the same full history, run their own downsampler job
into their own column store, and keep a raw shard of only what retention
keeps. The port's planner (TorchBackend on the CPU) must produce the same
plan shape (a ``StitchExec`` or not, the same raw/ds boundary) as the JAX
planner, and answers equal to the JAX planner's (rtol 1e-12; the counter
rates within the engine tests' rtol 1e-5) and to an all-raw JAX shard
holding the whole history, as the reference test holds its own (gauges
rtol 1e-12, counters 5 %)."""

import numpy as np
import pytest

from filodb_tpu.core.memstore import TimeSeriesShard as JShard
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetRef as JRef
from filodb_tpu.downsample import DownsampledTimeSeriesStore as JDStore
from filodb_tpu.downsample import DownsamplerJob as JJob
from filodb_tpu.promql.parser import TimeStepParams as JParams
from filodb_tpu.promql.parser import parse_query_range as j_parse
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.query.planner import QueryPlanner as JPlanner
from filodb_tpu.query.planner import StitchExec as JStitch
from filodb_tpu.query.planner import plan_range as j_plan_range
from filodb_tpu.query.planner import stitch_grids as j_stitch_grids
from filodb_tpu.store import FlatFileColumnStore as JStore
from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.downsample import (DownsampledTimeSeriesStore,
                                         DownsamplerJob)
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.query.backend import TorchBackend
from filodb_tpu_torch.query.model import GridResult
from filodb_tpu_torch.query.planner import (QueryPlanner, StitchExec,
                                            plan_range, stitch_grids)
from filodb_tpu_torch.store import FlatFileColumnStore

RES = 300_000                       # 5m downsample resolution
T0 = (1_600_000_000_000 // RES) * RES
SAMPLE_OFF = 5_000                  # samples 5s past period boundaries
N_SAMPLES = 720                     # 2h at 10s
SPAN_MS = N_SAMPLES * 10_000
NOW = T0 + SPAN_MS
RETENTION_MS = 1_800_000            # raw keeps the last 30min
EARLIEST_RAW = NOW - RETENTION_MS


def _add_all(builder, first, last):
    """Gauges + counters for sample index range [first, last)."""
    for s in range(3):
        glabels = {"_metric_": "cpu", "_ws_": "demo", "_ns_": "App-0",
                   "instance": f"i{s}"}
        clabels = {"_metric_": "reqs_total", "_ws_": "demo",
                   "_ns_": "App-0", "instance": f"i{s}"}
        for t in range(first, last):
            ts = T0 + SAMPLE_OFF + t * 10_000
            builder.add_sample("gauge", glabels, ts,
                               50.0 + 40.0 * np.sin(t / 7.0 + s))
            builder.add_sample("prom-counter", clabels, ts,
                               float((t + 1) * (s + 1)))


def _mk_shard(shard_cls, builder_cls, ref, schemas, first, last,
              column_store=None):
    shard = shard_cls(ref, schemas, 0, column_store=column_store,
                      max_chunk_rows=120)
    b = builder_cls(schemas)
    _add_all(b, first, last)
    for c in b.containers():
        shard.ingest(c)
    if column_store is not None:
        shard.flush_all(offset=1)
    return shard


@pytest.fixture(scope="module")
def tiers(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiering")
    first_kept = (EARLIEST_RAW - T0) // 10_000
    full = _mk_shard(JShard, JBuilder, JRef("timeseries"), J_SCHEMAS, 0,
                     N_SAMPLES)
    jcs = JStore(str(root / "jax"))
    _mk_shard(JShard, JBuilder, JRef("timeseries"), J_SCHEMAS, 0,
              N_SAMPLES, column_store=jcs)
    JJob(jcs, resolutions=(RES,)).run("timeseries", 0)
    jplanner = JPlanner(
        [_mk_shard(JShard, JBuilder, JRef("timeseries"), J_SCHEMAS,
                   first_kept, N_SAMPLES)],
        ds_store=JDStore(jcs, "timeseries", 1, resolutions=(RES,)),
        raw_retention_ms=RETENTION_MS, now_ms=NOW)
    pcs = FlatFileColumnStore(str(root / "port"))
    _mk_shard(TimeSeriesShard, RecordBuilder, DatasetRef("timeseries"),
              DEFAULT_SCHEMAS, 0, N_SAMPLES, column_store=pcs)
    DownsamplerJob(pcs, resolutions=(RES,), device="cpu").run(
        "timeseries", 0)
    planner = QueryPlanner(
        [_mk_shard(TimeSeriesShard, RecordBuilder, DatasetRef("timeseries"),
                   DEFAULT_SCHEMAS, first_kept, N_SAMPLES)],
        backend=TorchBackend(device="cpu", batcher=None),
        ds_store=DownsampledTimeSeriesStore(pcs, "timeseries", 1,
                                            resolutions=(RES,)),
        raw_retention_ms=RETENTION_MS, now_ms=NOW)
    return {"full": full, "jplanner": jplanner, "planner": planner}


def _tsp(start_s, step_s, end_s):
    return TimeStepParams(start_s, step_s, end_s), \
        JParams(start_s, step_s, end_s)


def _materialize(tiers, query, start_s, step_s, end_s):
    tsp, jtsp = _tsp(start_s, step_s, end_s)
    ex = tiers["planner"].materialize(parse_query_range(query, tsp))
    jex = tiers["jplanner"].materialize(j_parse(query, jtsp))
    # the same shape as the JAX planner's, on the same boundary
    assert isinstance(ex, StitchExec) == isinstance(jex, JStitch), query
    if isinstance(ex, StitchExec):
        for side in ("ds_exec", "raw_exec"):
            got, want = getattr(ex, side), getattr(jex, side)
            assert (got is None) == (want is None), (query, side)
            if got is not None:
                assert plan_range(got.plan) == j_plan_range(want.plan)
    return ex, jex


def _compare(tiers, query, start_s, step_s, end_s, rtol=0.0):
    ex, jex = _materialize(tiers, query, start_s, step_s, end_s)
    got = ex.execute()
    jgot = jex.execute()
    want = JEngine([tiers["full"]]).execute(
        j_parse(query, JParams(start_s, step_s, end_s)))
    assert isinstance(got, GridResult)
    np.testing.assert_array_equal(got.steps, want.steps)
    np.testing.assert_array_equal(got.steps, jgot.steps)
    gmap = {tuple(sorted(k.items())): got.values[i]
            for i, k in enumerate(got.keys)}
    assert len(gmap) == want.num_series == jgot.num_series, query
    for i, k in enumerate(jgot.keys):
        np.testing.assert_allclose(
            gmap[tuple(sorted(k.items()))], jgot.values[i],
            rtol=1e-12 if rtol == 0.0 else 1e-5, equal_nan=True,
            err_msg=query)
    for i, k in enumerate(want.keys):
        g = gmap[tuple(sorted(k.items()))]
        if rtol == 0.0:
            np.testing.assert_allclose(g, want.values[i], rtol=1e-12,
                                       equal_nan=True, err_msg=query)
        else:
            ok = np.isfinite(want.values[i]) & np.isfinite(g)
            assert ok.sum() >= want.values[i].size - 2, query
            np.testing.assert_allclose(g[ok], want.values[i][ok],
                                       rtol=rtol, err_msg=query)


def test_split_plan_shape(tiers):
    ex, _ = _materialize(tiers, "min_over_time(cpu[10m])",
                         T0 // 1000 + 1800, 600, NOW // 1000)
    assert isinstance(ex, StitchExec)
    assert ex.ds_exec is not None and ex.raw_exec is not None
    # raw side starts at the first step whose window is inside retention
    rng = plan_range(ex.raw_exec.plan)
    assert rng[0] - rng[3] >= EARLIEST_RAW
    # ds side ends exactly one step earlier
    ds_rng = plan_range(ex.ds_exec.plan)
    assert ds_rng[2] == rng[0] - rng[1]
    assert "StitchExec(" in ex.plan_tree()


@pytest.mark.parametrize("q", ["min_over_time(cpu[10m])",
                               "max_over_time(cpu[10m])",
                               "sum_over_time(cpu[10m])",
                               "count_over_time(cpu[10m])",
                               "sum(min_over_time(cpu[10m])) by (instance)",
                               "avg(max_over_time(cpu[10m]))"])
def test_gauge_queries_stitch_exactly(tiers, q):
    # step grid on period boundaries; 10m windows nest 5m ds periods
    _compare(tiers, q, T0 // 1000 + 1800, 600, NOW // 1000)


@pytest.mark.parametrize("q", ["increase(reqs_total[10m])",
                               "sum(rate(reqs_total[10m]))"])
def test_counter_rate_stitches(tiers, q):
    # ds counter chunks keep period boundary samples: small extrapolation
    # differences only
    _compare(tiers, q, T0 // 1000 + 1800, 600, NOW // 1000, rtol=0.05)


def test_fully_beyond_retention_serves_from_ds(tiers):
    end_s = (EARLIEST_RAW - 1_200_000) // 1000
    ex, _ = _materialize(tiers, "min_over_time(cpu[10m])",
                         T0 // 1000 + 1800, 600, end_s)
    assert isinstance(ex, StitchExec) and ex.raw_exec is None
    _compare(tiers, "min_over_time(cpu[10m])", T0 // 1000 + 1800, 600,
             end_s)


def test_recent_query_stays_raw(tiers):
    start_s = (EARLIEST_RAW + 1_200_000) // 1000
    ex, _ = _materialize(tiers, "min_over_time(cpu[10m])", start_s, 600,
                         NOW // 1000)
    assert not isinstance(ex, StitchExec)
    _compare(tiers, "min_over_time(cpu[10m])", start_s, 600, NOW // 1000)


def test_no_ds_mapping_falls_back_to_raw(tiers):
    # quantile_over_time has no exact ds column: raw only
    ex, _ = _materialize(tiers, "quantile_over_time(0.5, cpu[10m])",
                         T0 // 1000 + 1800, 600, NOW // 1000)
    assert not isinstance(ex, StitchExec)


def test_replace_range_keeps_offset_in_raw_bounds():
    """The tier split's range rewrite shifts raw fetch bounds by the
    offset, as the JAX package's does."""
    from filodb_tpu.query.engine import lp_replace_range as j_replace
    from filodb_tpu_torch.query.engine import lp_replace_range
    tsp, jtsp = _tsp(1000, 60, 2000)
    q = "rate(reqs_total[5m] offset 1h)"
    out = lp_replace_range(parse_query_range(q, tsp), 1_500_000, 60_000,
                           2_000_000)
    jout = j_replace(j_parse(q, jtsp), 1_500_000, 60_000, 2_000_000)
    assert out.raw.start_ms == jout.raw.start_ms \
        == 1_500_000 - 300_000 - 3_600_000
    assert out.raw.end_ms == jout.raw.end_ms == 2_000_000 - 3_600_000


def test_offset_query_stitches(tiers):
    _compare(tiers, "min_over_time(cpu[10m] offset 30m)",
             T0 // 1000 + 3600, 600, NOW // 1000)


def test_mixed_windows_use_min_for_resolution(tiers):
    """A small window beside a large one vetoes a resolution too coarse
    for the small window: the whole query answers from raw."""
    ex, _ = _materialize(
        tiers, "min_over_time(cpu[10m]) + min_over_time(cpu[5m])",
        T0 // 1000 + 1800, 600, NOW // 1000)
    assert not isinstance(ex, StitchExec)


def test_at_pinned_beyond_retention_routes_to_ds(tiers):
    """@ pinned before raw retention consults the ds tier (the step grid
    itself is recent, but the data read is not)."""
    at_s = (T0 + 1_800_000) // 1000
    q = f"min_over_time(cpu[10m] @ {at_s})"
    start_s = (EARLIEST_RAW + 1_200_000) // 1000
    ex, jex = _materialize(tiers, q, start_s, 600, NOW // 1000)
    assert isinstance(ex, StitchExec) and ex.raw_exec is None
    got, jgot = ex.execute(), jex.execute()
    want = JEngine([tiers["full"]]).execute(
        j_parse(q, JParams(start_s, 600, NOW // 1000)))
    assert got.num_series == jgot.num_series == want.num_series == 3
    gmap = {k["instance"]: got.values[i] for i, k in enumerate(got.keys)}
    for w in (want, jgot):
        for i, k in enumerate(w.keys):
            np.testing.assert_allclose(gmap[k["instance"]], w.values[i],
                                       rtol=1e-12, equal_nan=True)


def test_stitch_grids_prefers_first_non_nan():
    steps_a = np.array([0, 60, 120], dtype=np.int64)
    steps_b = np.array([120, 180], dtype=np.int64)
    a = GridResult(steps_a, [{"x": "1"}], np.array([[1.0, np.nan, 3.0]]))
    b = GridResult(steps_b, [{"x": "1"}, {"x": "2"}],
                   np.array([[9.0, 4.0], [7.0, 8.0]]))
    out = stitch_grids(a, b)
    from filodb_tpu.query.model import GridResult as JGrid
    jout = j_stitch_grids(
        JGrid(steps_a, [{"x": "1"}], np.array([[1.0, np.nan, 3.0]])),
        JGrid(steps_b, [{"x": "1"}, {"x": "2"}],
              np.array([[9.0, 4.0], [7.0, 8.0]])))
    np.testing.assert_array_equal(out.steps, [0, 60, 120, 180])
    np.testing.assert_array_equal(out.steps, jout.steps)
    assert out.keys == jout.keys
    np.testing.assert_array_equal(out.values, jout.values)
    m = {k["x"]: out.values[i] for i, k in enumerate(out.keys)}
    # overlap at 120: first side's non-NaN wins
    np.testing.assert_allclose(m["1"], [1.0, np.nan, 3.0, 4.0],
                               equal_nan=True)
    np.testing.assert_allclose(m["2"], [np.nan, np.nan, 7.0, 8.0],
                               equal_nan=True)
