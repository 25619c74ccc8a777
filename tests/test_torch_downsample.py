"""Downsampling in the port against the JAX package: the device functions
(gather path, regular-cadence fast path, cascades, counter emit mask) on the
same seeded inputs, and the batch job end to end (the same raw chunks in a
reference store and a port store, both jobs run, the decoded ds chunks
compared, then ds queries through the port's engine and TorchBackend).

Tolerances: counts, minima, maxima, last values, last timestamps and the
emit mask bit for bit the JAX package's; sums within rtol 1e-12 (the
reference test's own bound against its numpy oracle, tests/test_downsample.py).
Every function is also held against the numpy oracle as the reference's
tests hold theirs."""

import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import TimeSeriesShard as JShard
from filodb_tpu.core.record import PartKey as JPartKey
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetRef as JRef
from filodb_tpu.downsample import DownsamplerJob as JJob
from filodb_tpu.downsample import kernels as jk
from filodb_tpu.memory import vectors as jbv
from filodb_tpu.promql.parser import TimeStepParams as JParams
from filodb_tpu.promql.parser import parse_query_range as j_parse
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.store import FlatFileColumnStore as JStore
from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.downsample import (DownsampledTimeSeriesStore,
                                         DownsamplerJob, ds_dataset)
from filodb_tpu_torch.downsample import kernels
from filodb_tpu_torch.lint.contracts import CONTRACTS, check_contract
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.query.backend import TorchBackend
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.store import FlatFileColumnStore

torch.set_num_threads(1)

RES = 300_000
# period-aligned epoch; samples sit 5s past boundaries so windows aligned
# to periods nest them exactly
T0_MS = (1_600_000_000_000 // RES) * RES
SAMPLE_OFF = 5_000
NAMES = ("sum", "count", "min", "max", "last_v", "last_ts")


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _np(out):
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
            for o in out]


def _same_as_jax(got, want, what=""):
    """Port outputs against the JAX package's: sums within rtol 1e-12,
    everything else bit for bit."""
    got, want = _np(got), _np(want)
    for g, w, name in zip(got, want, NAMES):
        assert g.shape == w.shape, (what, name)
        if name == "sum":
            np.testing.assert_allclose(g, w, rtol=1e-12, equal_nan=True,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def _same_as_oracle(got, ts, vals, lens, base, res, nperiods):
    got = _np(got)
    for i in range(ts.shape[0]):
        o = kernels.downsample_gauge_oracle(ts[i, :lens[i]],
                                            vals[i, :lens[i]], base, res,
                                            nperiods)
        has = o[1] > 0
        np.testing.assert_allclose(got[0][i][has], o[0][has], rtol=1e-12)
        np.testing.assert_array_equal(got[1][i], o[1])
        for k in (2, 3, 4):
            np.testing.assert_array_equal(got[k][i][has], o[k][has])
        np.testing.assert_array_equal(got[5][i][has], o[5][has])
        assert np.all(np.isnan(got[0][i][~has]))


def test_gauge_kernel_matches_jax_and_oracle():
    rng = np.random.default_rng(3)
    S, N = 5, 700
    ts = np.sort(T0_MS + rng.integers(0, 3_600_000, (S, N)), axis=1)
    ts = ts + np.arange(N)[None, :]
    vals = rng.normal(50, 20, (S, N))
    lens = np.full(S, N, dtype=np.int32)
    lens[2] = 300                      # one short row
    base = (int(ts.min()) // RES) * RES
    nperiods = int((ts.max() - base) // RES) + 1
    got = kernels.downsample_gauge_tiles(*_t(ts, vals, lens), base, RES,
                                         nperiods)
    want = jk.downsample_gauge_tiles(ts, vals, lens, np.int64(base),
                                     np.int64(RES), nperiods)
    _same_as_jax(got, want)
    _same_as_oracle(got, ts, vals, lens, base, RES, nperiods)


def test_gather_chunks_rows_under_the_budget(monkeypatch):
    """The [S, P, W] gather cut into row chunks gives the one-pass
    answers."""
    rng = np.random.default_rng(7)
    S, N = 9, 400
    ts = np.sort(T0_MS + rng.integers(0, 3_600_000, (S, N)), axis=1)
    ts = ts + np.arange(N)[None, :]
    vals = rng.normal(0, 9, (S, N))
    lens = np.full(S, N, dtype=np.int32)
    base = (int(ts.min()) // RES) * RES
    nperiods = int((ts.max() - base) // RES) + 1
    whole = kernels.downsample_gauge_tiles(*_t(ts, vals, lens), base, RES,
                                           nperiods, 64)
    monkeypatch.setattr(kernels, "GATHER_BUDGET_BYTES",
                        2 * nperiods * 64 * kernels._GATHER_ELT_BYTES)
    cut = kernels.downsample_gauge_tiles(*_t(ts, vals, lens), base, RES,
                                         nperiods, 64)
    for a, b in zip(_np(whole), _np(cut)):
        np.testing.assert_array_equal(a, b)


def _regular(seed, S, N, phase_off, jit_ms):
    rng = np.random.default_rng(seed)
    DT = 10_000
    t0 = T0_MS + phase_off
    jit = rng.integers(-jit_ms, jit_ms, (S, N))
    ts = t0 + np.arange(N, dtype=np.int64)[None, :] * DT + jit
    vals = rng.normal(50, 20, (S, N))
    lens = np.full(S, N, dtype=np.int32)
    base = (int(ts.min()) // RES) * RES
    nperiods = int((ts.max() - base) // RES) + 1
    return ts, vals, lens, base, nperiods


@pytest.mark.parametrize("seed,S,N,phase_off,jit_ms", [
    (11, 6, 700, 0, 2000), (11, 6, 700, 8_500, 2000),
    (29, 4, 500, -2_000, 4000), (29, 4, 500, 3_000, 4000),
    (29, 4, 500, 8_000, 4000)],
    ids=["up", "down", "wide-2000", "wide+3000", "wide+8000"])
def test_gauge_regular_fast_path_matches_jax(seed, S, N, phase_off, jit_ms):
    """Reshape fast path == JAX == oracle on jittered regular-cadence
    tiles, for both boundary-crossing directions and for jitter close to
    dt/2 with the edge ticks on the wrong side of the base boundary."""
    ts, vals, lens, base, nperiods = _regular(seed, S, N, phase_off, jit_ms)
    got = kernels.downsample_gauge_fast(*_t(ts, vals, lens), base, RES,
                                        nperiods)
    want = jk.downsample_gauge_fast(ts, vals, lens, base, RES, nperiods)
    assert got is not None and want is not None
    _same_as_jax(got, want)
    _same_as_oracle(got, ts, vals, lens, base, RES, nperiods)
    # and the gather path on the same batch: bit for bit but sums
    gather = kernels.downsample_gauge_tiles(*_t(ts, vals, lens), base, RES,
                                            nperiods, 64)
    _same_as_jax(got, gather, "fast vs gather")


def test_gauge_regular_edge_tick_before_base():
    """A first tick whose nominal time precedes the batch base but whose
    jitter lands it inside period 0 is counted (up-mode edge)."""
    DT = 10_000
    base = T0_MS
    ts = base - 2_000 + np.arange(40, dtype=np.int64) * DT
    ts[0] += 3_000
    vals = np.arange(40, dtype=np.float64)
    lens = np.array([40], np.int32)
    nper = int((ts.max() - base) // RES) + 1
    got = kernels.downsample_gauge_fast(*_t(ts[None, :], vals[None, :], lens),
                                        base, RES, nper)
    want = jk.downsample_gauge_fast(ts[None, :], vals[None, :], lens, base,
                                    RES, nper)
    _same_as_jax(got, want)
    o = kernels.downsample_gauge_oracle(ts, vals, base, RES, nper)
    np.testing.assert_array_equal(_np(got)[1][0], o[1])


def test_gauge_regular_fast_path_gates():
    S, N, DT = 2, 600, 10_000
    lens = np.full(S, N, dtype=np.int32)
    ts = T0_MS + np.arange(N, dtype=np.int64)[None, :] * DT \
        + np.zeros((S, 1), np.int64)
    vals = np.zeros((S, N))
    ts_bad = ts.copy()
    ts_bad[0, N // 2:] += 57_000
    lens2 = lens.copy()
    lens2[1] = 100
    for t, ln in ((ts_bad, lens), (ts, lens2)):
        assert (kernels.downsample_gauge_fast(*_t(t, vals, ln), T0_MS, RES,
                                              4) is None)
        assert jk.downsample_gauge_fast(t, vals, ln, T0_MS, RES, 4) is None
    assert kernels.regular_cadence(ts, lens, RES) == \
        jk.regular_cadence(ts, lens, RES)


def test_cascade_aligned_matches_jax():
    rng = np.random.default_rng(5)
    S, N, DT = 4, 1500, 10_000
    res1h = 3_600_000
    ts = T0_MS + np.arange(N, dtype=np.int64)[None, :] * DT \
        + rng.integers(-2000, 2000, (S, N))
    vals = rng.normal(0, 5, (S, N))
    lens = np.full(S, N, dtype=np.int32)
    base5 = (int(ts.min()) // RES) * RES
    base1h = (int(ts.min()) // res1h) * res1h
    nper5 = int((ts.max() - base5) // RES) + 1
    nper1h = int((ts.max() - base1h) // res1h) + 1
    lead = int((base5 - base1h) // RES)
    fine = kernels.downsample_gauge_fast(*_t(ts, vals, lens), base5, RES,
                                         nper5)
    got = kernels.cascade_gauge_aligned(fine, res1h // RES, lead)
    jfine = jk.downsample_gauge_fast(ts, vals, lens, base5, RES, nper5)
    want = jk.cascade_gauge_aligned(jfine, res1h // RES, lead)
    _same_as_jax(got, want)
    Q = _np(got)[0].shape[1]
    g = _np(got)
    for i in range(S):
        o = kernels.downsample_gauge_oracle(ts[i], vals[i], base1h, res1h,
                                            nper1h)
        has = o[1][:Q] > 0
        np.testing.assert_allclose(g[0][i][has], o[0][:Q][has], rtol=1e-12)
        np.testing.assert_array_equal(g[1][i], o[1][:Q])
        for k in (2, 3, 4, 5):
            np.testing.assert_array_equal(g[k][i][has], o[k][:Q][has])


def test_counter_emit_mask_matches_jax():
    ts = np.arange(1, 61, dtype=np.int64)[None, :] * 10_000 + T0_MS
    vals = np.cumsum(np.full(60, 5.0))
    vals[30:] = np.cumsum(np.full(30, 5.0))        # reset at index 30
    vals = vals[None, :]
    lens = np.array([60], dtype=np.int32)
    base = (int(ts.min()) // RES) * RES
    nperiods = int((ts.max() - base) // RES) + 1
    mask = kernels.counter_emit_mask(*_t(ts, vals, lens), base, RES,
                                     nperiods).numpy()
    want = np.asarray(jk.counter_emit_mask(
        ts, vals, lens, np.int64(base), np.int64(RES), nperiods))
    np.testing.assert_array_equal(mask, want)
    mask = mask[0]
    assert mask[29] and mask[30]                   # both sides of the reset
    p = (ts[0] - base) // RES
    for period in np.unique(p):
        assert mask[np.max(np.where(p == period))], period
    # a ragged batch with padding and several resets per row
    rng = np.random.default_rng(17)
    S, N = 6, 256
    ts = T0_MS + np.arange(N)[None, :] * 10_000 \
        + rng.integers(-2000, 2000, (S, N))
    vals = np.cumsum(rng.uniform(0, 5, (S, N)), axis=1)
    vals[:, 100:] -= vals[:, 99:100]
    vals[::2, 180:] -= 7.0
    lens = np.array([256, 200, 31, 256, 1, 128], np.int32)
    for i in range(S):
        ts[i, lens[i]:] = 1 << 60
        vals[i, lens[i]:] = 0.0
    base = (int(ts[:, 0].min()) // RES) * RES
    nperiods = int((ts[ts < (1 << 59)].max() - base) // RES) + 1
    got = kernels.counter_emit_mask(*_t(ts, vals, lens), base, RES,
                                    nperiods).numpy()
    want = np.asarray(jk.counter_emit_mask(
        ts, vals, lens, np.int64(base), np.int64(RES), nperiods))
    np.testing.assert_array_equal(got, want)


def test_resolution_selection():
    from filodb_tpu.downsample.store import select_resolution as j_sel
    from filodb_tpu_torch.downsample.store import select_resolution
    for args in (((300_000, 3_600_000), 600_000, 300_000),
                 ((300_000, 3_600_000), 7_200_000, 3_600_000),
                 ((300_000, 3_600_000), 300_000, 60_000)):
        assert select_resolution(*args) == j_sel(*args)
    assert select_resolution((300_000, 3_600_000), 7_200_000,
                             3_600_000) == 3_600_000
    assert select_resolution((300_000, 3_600_000), 300_000, 60_000) is None


def test_cascade_matches_jax_and_direct():
    """1h level cascaded from the 5m level == the JAX cascade, and == 1h
    computed direct from raw."""
    rng = np.random.default_rng(9)
    S, N = 3, 2000
    ts = np.sort(T0_MS + rng.integers(0, 6 * 3_600_000, (S, N)), axis=1)
    ts = ts + np.arange(N)[None, :]
    vals = rng.normal(0, 100, (S, N))
    lens = np.full(S, N, dtype=np.int32)
    lens[1] = 1200
    base5 = (int(ts.min()) // RES) * RES
    res_h = 3_600_000
    base_h = (int(ts.min()) // res_h) * res_h
    np5 = int((ts.max() - base5) // RES) + 1
    nph = int((ts.max() - base_h) // res_h) + 1
    fine = kernels.downsample_gauge_tiles(*_t(ts, vals, lens), base5, RES,
                                          np5, 64)
    casc = kernels.cascade_gauge(fine, base_h, res_h, nph, 16)
    jfine = jk.downsample_gauge_tiles(ts, vals, lens, np.int64(base5),
                                      np.int64(RES), np5, 64)
    want = jk.cascade_gauge(jfine, np.int64(base_h), np.int64(res_h), nph,
                            16)
    _same_as_jax(casc, want)
    direct = kernels.downsample_gauge_tiles(*_t(ts, vals, lens), base_h,
                                            res_h, nph, 2048)
    for c, d, name in zip(_np(casc), _np(direct), NAMES):
        if name == "last_ts":
            np.testing.assert_array_equal(c, d, err_msg=name)
        else:
            np.testing.assert_allclose(c, d, rtol=1e-9, atol=1e-9,
                                       equal_nan=True, err_msg=name)


@pytest.mark.parametrize("name", ["downsample_gauge", "counter_emit_mask",
                                  "downsample_regular", "cascade_aligned"])
def test_port_contracts_hold(name):
    """The port's kernel contracts (torch examples), checked on the CPU:
    the JAX package's linter imports the module but checks only its own
    registry."""
    got = [c for (m, n), c in CONTRACTS.items()
           if m == kernels.__name__ and n == name]
    assert len(got) == 1
    assert check_contract(got[0], "cpu") is None


# ---------------------------------------------------------------------------
# the batch job: the same raw chunks through both jobs
# ---------------------------------------------------------------------------

def _raw_rows():
    """(schema, labels, ts, values) of 4 gauges (one with gaps) and 2
    counters (one with a reset) over 2 h at 10 s."""
    rng = np.random.default_rng(11)
    rows = []
    for s in range(4):
        labels = {"_metric_": "cpu_seconds", "_ws_": "demo",
                  "_ns_": "App-0", "instance": f"i{s}"}
        t = T0_MS + SAMPLE_OFF + np.arange(720) * 10_000
        v = rng.normal(50, 10, 720)
        keep = rng.random(720) > (0.1 if s == 3 else 0.0)
        rows.append(("gauge", labels, t[keep], v[keep]))
    for s in range(2):
        labels = {"_metric_": "reqs_total", "_ws_": "demo",
                  "_ns_": "App-0", "instance": f"i{s}"}
        v = np.cumsum(np.full(720, 7.0 * (s + 1)))
        if s == 1:
            v[400:] -= v[399]
        rows.append(("prom-counter", labels,
                     T0_MS + SAMPLE_OFF + np.arange(720) * 10_000, v))
    return rows


def _seed(builder_cls, shard, rows):
    b = builder_cls(shard.schemas)
    for schema, labels, t, v in rows:
        for ti, vi in zip(t, v):
            b.add_sample(schema, labels, int(ti), float(vi))
    for c in b.containers():
        shard.ingest(c)
    shard.flush_all(offset=1)


def _ds_contents(cs, bv, part_key_cls, schemas, name):
    """{labels: (ts, [data columns])} of every partition of a ds dataset."""
    out = {}
    for e in cs.scan_part_keys(name, 0):
        pk = part_key_cls.from_bytes(e.part_key)
        schema = schemas.by_id(pk.schema_id)
        ts, cols = [], [[] for _ in schema.data_columns]
        for c in cs.read_chunks(name, 0, e.part_key):
            ts.append(bv.decode_longs(c.vectors[0]))
            for j in range(len(cols)):
                cols[j].append(bv.decode_doubles(c.vectors[j + 1]))
        out[(schema.name, tuple(sorted(pk.labels)))] = (
            np.concatenate(ts), [np.concatenate(c) for c in cols])
    return out


@pytest.fixture(scope="module")
def both_jobs(tmp_path_factory):
    from filodb_tpu_torch.core.record import PartKey
    from filodb_tpu_torch.memory import vectors as bv
    root = tmp_path_factory.mktemp("ds")
    rows = _raw_rows()
    jcs = JStore(str(root / "jax"))
    _seed(JBuilder, JShard(JRef("timeseries"), J_SCHEMAS, 0,
                           max_chunk_rows=128, column_store=jcs), rows)
    pcs = FlatFileColumnStore(str(root / "port"))
    raw = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0,
                          max_chunk_rows=128, column_store=pcs)
    _seed(RecordBuilder, raw, rows)
    res = (RES, 3_600_000)
    jstats = JJob(jcs, resolutions=res).run("timeseries", 0)
    pstats = DownsamplerJob(pcs, resolutions=res,
                            device="cpu").run("timeseries", 0)
    contents = {r: (_ds_contents(jcs, jbv, JPartKey, J_SCHEMAS,
                                 ds_dataset("timeseries", r)),
                    _ds_contents(pcs, bv, PartKey, DEFAULT_SCHEMAS,
                                 ds_dataset("timeseries", r)))
                for r in res}
    return {"jstats": jstats, "pstats": pstats, "contents": contents,
            "cs": pcs, "jcs": jcs, "raw": raw, "rows": rows}


@pytest.mark.parametrize("res", [RES, 3_600_000])
def test_job_ds_chunks_decode_to_the_reference_jobs(both_jobs, res):
    js, ps = both_jobs["jstats"], both_jobs["pstats"]
    assert (ps.partitions_read, ps.samples_read, ps.samples_written) == \
        (js.partitions_read, js.samples_read, js.samples_written)
    assert ps.partitions_read == 6 and ps.chunks_written > 0
    want, got = both_jobs["contents"][res]
    assert set(got) == set(want) and len(got) == 6
    for key, (wts, wcols) in want.items():
        gts, gcols = got[key]
        np.testing.assert_array_equal(gts, wts, err_msg=str(key))
        names = [c.name for c in DEFAULT_SCHEMAS.by_name(key[0])
                 .data_columns]
        for n, g, w in zip(names, gcols, wcols):
            if n in ("sum", "avg"):
                np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=n)
            else:
                np.testing.assert_array_equal(g, w, err_msg=n)


def test_job_end_to_end_and_query_parity(both_jobs):
    """ds queries through the port's engine and TorchBackend against the
    JAX engine over the reference job's ds store (rtol 1e-9; the counter
    increase within the engine tests' rtol 1e-5), and against the JAX
    engine over the raw history as the reference test holds its own:
    gauge min/max/sum/count over nested windows exactly, the increase of
    the counter without a reset within 5 %."""
    from filodb_tpu.downsample import DownsampledTimeSeriesStore as JDStore
    cs, raw = both_jobs["cs"], both_jobs["raw"]
    dstore = DownsampledTimeSeriesStore(cs, "timeseries", 1,
                                        resolutions=(RES,))
    jdstore = JDStore(both_jobs["jcs"], "timeseries", 1, resolutions=(RES,))
    jraw = JShard(JRef("timeseries"), J_SCHEMAS, 0)
    _seed(JBuilder, jraw, both_jobs["rows"])
    start_s = T0_MS // 1000 + 1800
    end_s = T0_MS // 1000 + 7000
    be = TorchBackend(device="cpu", batcher=None)
    for q, rtol in [("min_over_time(cpu_seconds[10m])", 1e-9),
                    ("max_over_time(cpu_seconds[10m])", 1e-9),
                    ("sum_over_time(cpu_seconds[10m])", 1e-9),
                    ("count_over_time(cpu_seconds[10m])", 1e-9),
                    ("increase(reqs_total[10m])", 1e-5)]:
        plan = parse_query_range(q, TimeStepParams(start_s, 600, end_s))
        jplan = j_parse(q, JParams(start_s, 600, end_s))
        picked = dstore.plan_query(plan, 600_000, 600_000)
        jpicked = jdstore.plan_query(jplan, 600_000, 600_000)
        assert picked is not None and jpicked is not None, q
        got = QueryEngine(picked[0], backend=be).execute(picked[1])
        want_ds = JEngine(jpicked[0]).execute(jpicked[1])
        want_raw = JEngine([jraw]).execute(jplan)
        gmap = {k["instance"]: got.values[i]
                for i, k in enumerate(got.keys)}
        assert len(gmap) == want_ds.num_series == want_raw.num_series, q
        for i, k in enumerate(want_ds.keys):
            np.testing.assert_allclose(gmap[k["instance"]],
                                       want_ds.values[i], rtol=rtol,
                                       equal_nan=True, err_msg=q)
        for i, k in enumerate(want_raw.keys):
            g, w = gmap[k["instance"]], want_raw.values[i]
            if rtol == 1e-9:
                np.testing.assert_allclose(g, w, rtol=1e-9, equal_nan=True,
                                           err_msg=q)
            elif k["instance"] == "i0":
                ok = np.isfinite(w) & np.isfinite(g)
                assert ok.sum() >= w.size - 2, q
                np.testing.assert_allclose(g[ok], w[ok], rtol=0.05,
                                           err_msg=q)
