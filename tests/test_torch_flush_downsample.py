"""Flush-time downsample emission and memory-pressure headroom eviction in
the port, against the JAX package on the same seeded rows.

(ShardDownsampler.scala:40,62 populateDownsampleRecords;
PartitionEvictionPolicy / headroom task equivalents.) The emitted ds
chunks decode to the JAX package's (sums and averages within rtol 1e-12,
everything else exact); the ds queries go through the port's engine and
TorchBackend and match the JAX engine over the reference's ds chunks
(rtol 1e-9, the rate within the engine tests' 1e-5) and over raw data as
the reference test holds its own."""

import numpy as np

from filodb_tpu.core.memstore import TimeSeriesShard as JShard
from filodb_tpu.core.record import PartKey as JPartKey
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetRef as JRef
from filodb_tpu.downsample import DownsampledTimeSeriesStore as JDStore
from filodb_tpu.downsample.flush import FlushDownsampler as JFlush
from filodb_tpu.memory import vectors as jbv
from filodb_tpu.promql.parser import TimeStepParams as JParams
from filodb_tpu.promql.parser import parse_query_range as j_parse
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.store import FlatFileColumnStore as JStore
from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.core.record import PartKey, RecordBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.downsample import DownsampledTimeSeriesStore
from filodb_tpu_torch.downsample.flush import FlushDownsampler
from filodb_tpu_torch.memory import vectors as bv
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.query.backend import TorchBackend
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.store import FlatFileColumnStore
from test_torch_downsample import _ds_contents

RES = 300_000
T0 = (1_600_000_000_000 // RES) * RES
OFF = 5_000


def _seed(builder_cls, shard, n=720):
    b = builder_cls(shard.schemas)
    for s in range(3):
        g = {"_metric_": "cpu", "_ws_": "demo", "_ns_": "App-0",
             "instance": f"i{s}"}
        c = {"_metric_": "reqs_total", "_ws_": "demo", "_ns_": "App-0",
             "instance": f"i{s}"}
        for t in range(n):
            ts = T0 + OFF + t * 10_000
            b.add_sample("gauge", g, ts, 50.0 + s + np.sin(t / 9.0) * 20)
            b.add_sample("prom-counter", c, ts, float((t + 1) * (s + 1)))
    for cont in b.containers():
        shard.ingest(cont)


def test_flush_emission_serves_ds_queries(tmp_path):
    cs = FlatFileColumnStore(str(tmp_path / "port"))
    shard = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0,
                            column_store=cs, max_chunk_rows=120)
    shard.flush_downsampler = FlushDownsampler(
        cs, "timeseries", 0, DEFAULT_SCHEMAS, resolutions=(RES,))
    _seed(RecordBuilder, shard)
    shard.flush_all(offset=1)
    jcs = JStore(str(tmp_path / "jax"))
    jshard = JShard(JRef("timeseries"), J_SCHEMAS, 0, column_store=jcs,
                    max_chunk_rows=120)
    jshard.flush_downsampler = JFlush(jcs, "timeseries", 0, J_SCHEMAS,
                                      resolutions=(RES,))
    _seed(JBuilder, jshard)
    jshard.flush_all(offset=1)
    assert shard.flush_downsampler.samples_emitted == \
        jshard.flush_downsampler.samples_emitted > 0
    name = f"timeseries_ds_{RES}"
    got = _ds_contents(cs, bv, PartKey, DEFAULT_SCHEMAS, name)
    want = _ds_contents(jcs, jbv, JPartKey, J_SCHEMAS, name)
    assert set(got) == set(want) and len(got) == 6
    for key, (wts, wcols) in want.items():
        gts, gcols = got[key]
        np.testing.assert_array_equal(gts, wts)
        names = [c.name for c in DEFAULT_SCHEMAS.by_name(key[0])
                 .data_columns]
        for n, g, w in zip(names, gcols, wcols):
            if n in ("sum", "avg"):
                np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=n)
            else:
                np.testing.assert_array_equal(g, w, err_msg=n)

    # the ds tier is queryable at once, without the batch job
    dstore = DownsampledTimeSeriesStore(cs, "timeseries", 1,
                                        resolutions=(RES,))
    jdstore = JDStore(jcs, "timeseries", 1, resolutions=(RES,))
    be = TorchBackend(device="cpu", batcher=None)
    start_s, end_s = T0 // 1000 + 1800, T0 // 1000 + 7000
    for q, rtol, raw_rtol in [("min_over_time(cpu[10m])", 1e-9, 1e-9),
                              ("sum_over_time(cpu[10m])", 1e-9, 1e-9),
                              ("increase(reqs_total[10m])", 1e-5, 0.05)]:
        plan = parse_query_range(q, TimeStepParams(start_s, 600, end_s))
        jplan = j_parse(q, JParams(start_s, 600, end_s))
        picked = dstore.plan_query(plan, 600_000, 600_000)
        jpicked = jdstore.plan_query(jplan, 600_000, 600_000)
        assert picked is not None and jpicked is not None, q
        g = QueryEngine(picked[0], backend=be).execute(picked[1])
        w_ds = JEngine(jpicked[0]).execute(jpicked[1])
        w_raw = JEngine([jshard]).execute(jplan)
        gmap = {k["instance"]: g.values[i] for i, k in enumerate(g.keys)}
        assert len(gmap) == w_ds.num_series == w_raw.num_series, q
        for i, k in enumerate(w_ds.keys):
            np.testing.assert_allclose(gmap[k["instance"]], w_ds.values[i],
                                       rtol=rtol, equal_nan=True, err_msg=q)
        for i, k in enumerate(w_raw.keys):
            gv, wv = gmap[k["instance"]], w_raw.values[i]
            ok = np.isfinite(wv) & np.isfinite(gv)
            assert ok.sum() >= wv.size - 2, q
            np.testing.assert_allclose(gv[ok], wv[ok], rtol=raw_rtol,
                                       err_msg=q)


def _staggered(builder_cls, shard):
    b = builder_cls(shard.schemas)
    for s in range(10):
        labels = {"_metric_": "m", "_ws_": "w", "_ns_": "n",
                  "instance": f"i{s}"}
        for t in range(200):
            # staggered recency: series s ends at T0 + (s+1)*2000s
            b.add_sample("gauge", labels, T0 + s * 2_000_000 + t * 10_000,
                         float(t))
    for c in b.containers():
        shard.ingest(c)
    shard.flush_all(offset=1)


def test_headroom_eviction(tmp_path):
    shard = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0,
                            column_store=FlatFileColumnStore(
                                str(tmp_path / "port")),
                            max_chunk_rows=100)
    jshard = JShard(JRef("timeseries"), J_SCHEMAS, 0,
                    column_store=JStore(str(tmp_path / "jax")),
                    max_chunk_rows=100)
    _staggered(RecordBuilder, shard)
    _staggered(JBuilder, jshard)
    assert shard.resident_samples() == 2000 == shard.recount_resident()
    evicted = shard.ensure_headroom(max_samples=1000)
    assert evicted == jshard.ensure_headroom(max_samples=1000) > 0
    after = shard.resident_samples()
    assert after == jshard.resident_samples()
    assert after <= 1000 * 0.75 + 200      # within headroom (+1 part slop)
    # evicted data still answers via ODP page-in, as the reference's does
    start_s, end_s = T0 // 1000, T0 // 1000 + 2_000 * 10
    got = QueryEngine([shard], backend=TorchBackend(
        device="cpu", batcher=None)).execute(
        parse_query_range("m", TimeStepParams(start_s, 600, end_s)))
    want = JEngine([jshard]).execute(
        j_parse("m", JParams(start_s, 600, end_s)))
    assert got.num_series == want.num_series == 10
    gmap = {k["instance"]: got.values[i] for i, k in enumerate(got.keys)}
    for i, k in enumerate(want.keys):
        np.testing.assert_array_equal(gmap[k["instance"]], want.values[i])
    assert shard.resident_samples() == shard.recount_resident()
    assert shard.ensure_headroom(max_samples=10_000_000) == 0


def test_flush_downsampler_memory_bounded(tmp_path):
    """ds-tier chunks are released from memory on EVERY flush round, not
    just the first, and every round's rows reach the store as the
    reference's do."""
    cs = FlatFileColumnStore(str(tmp_path / "port"))
    shard = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0,
                            column_store=cs, max_chunk_rows=60)
    fds = FlushDownsampler(cs, "timeseries", 0, DEFAULT_SCHEMAS,
                           resolutions=(RES,))
    shard.flush_downsampler = fds
    jcs = JStore(str(tmp_path / "jax"))
    jshard = JShard(JRef("timeseries"), J_SCHEMAS, 0, column_store=jcs,
                    max_chunk_rows=60)
    jfds = JFlush(jcs, "timeseries", 0, J_SCHEMAS, resolutions=(RES,))
    jshard.flush_downsampler = jfds
    for round_no in range(4):
        for builder_cls, sh in ((RecordBuilder, shard), (JBuilder, jshard)):
            b = builder_cls(sh.schemas)
            labels = {"_metric_": "cpu", "_ws_": "w", "_ns_": "n"}
            for t in range(60):
                b.add_sample("gauge", labels,
                             T0 + OFF + (round_no * 60 + t) * 10_000,
                             float(t))
            for c in b.containers():
                sh.ingest(c)
            sh.flush_all(offset=round_no + 1)
        for sh in fds._out.values():
            assert sh.resident_samples() == 0, round_no
        assert fds.samples_emitted == jfds.samples_emitted
    name = f"timeseries_ds_{RES}"
    got = _ds_contents(cs, bv, PartKey, DEFAULT_SCHEMAS, name)
    want = _ds_contents(jcs, jbv, JPartKey, J_SCHEMAS, name)
    assert set(got) == set(want) == {("ds-gauge", (
        ("_metric_", "cpu"), ("_ns_", "n"), ("_ws_", "w")))}
    for key in want:
        np.testing.assert_array_equal(got[key][0], want[key][0])
        for g, w in zip(got[key][1], want[key][1]):
            np.testing.assert_array_equal(g, w)
