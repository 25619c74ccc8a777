"""The port's range functions other than the rate family against the JAX
package's and the numpy oracle, on identical inputs made from a seed:

  * aligned: ``filodb_tpu_torch.query.tilestore.evaluate_aligned`` against
    ``filodb_tpu.query.tilestore.evaluate_aligned`` on tiles built from the
    same arrays (jittered dense tiles, tiles with 30 % gaps, and values near
    1e8 with an O(1) spread for the variance family);
  * packed: the port's ``_window_endpoint`` and ``_window_gather`` against
    ``filodb_tpu.query.tpu``'s on ragged rows with empty windows;
  * the engine: every function of ``DEVICE_FUNCS`` through the port's
    ``QueryEngine`` with ``TorchBackend(device="cpu")``, the JAX engine with
    ``TpuBackend(batcher=None)``, and the oracle.

Tolerances, port against JAX:
  * endpoint selections, counts, present/absent, changes/resets, idelta and
    min/max: bit-equal, NaN positions equal;
  * irate, timestamp and the rate family on the packed path: within 4 f64
    ulps (XLA on the CPU turns ``x / 1000.0`` into a reciprocal multiply);
  * quantile_over_time: within 2 f64 ulps (the same interpolation, which
    XLA may contract into a fused multiply-add);
  * the prefix-sum family: the windowed sums ``s`` (of ``v``) and ``s2``
    (of ``vc2`` on the aligned path, of ``v*v`` on the packed path) within
    8 f64 ulps of the row's largest prefix magnitude, since the cumsum
    may add in another order. With Ds and Ds2 those bounds and cnt the
    window's count, the derived bounds are
      avg:    Ds/cnt + 2 ulp(avg);
      stdvar: (Ds2 + 2|dm| Ds + Ds^2/cnt)/cnt + 4 ulp(s2/cnt)
              (dm = mean - shift: the aligned path's vshift, 0 packed;
              the last term covers the rounding of s2/cnt - dm^2, which XLA
              may also contract);
      stddev: stdvar's bound / (sd_port + sd_jax) + 2 ulp(sd);
      z_score: (Ds/cnt + |z| * stddev's bound) / sd + 4 ulp(z).
    Largest differences measured on these inputs: the aligned windowed s
    6.0 and s2 6.0 ulps of the row's prefix magnitude, the packed
    prefixes 7.0 (cs) and 7.0 (cs2); the derived functions at most 0.75
    of their bound.
  * The engine test holds the prefix-sum family to JAX at twice the
    oracle tolerance (each package within it of the oracle).
Port and JAX against the oracle: rtol 1e-9, atol 1e-9
(tests/test_tpu_backend.py), z_score rtol 5e-6 and, near 1e8, the variance
family rtol 1e-6 (tests/test_tilestore.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from filodb_tpu.core.memstore import TimeSeriesShard as JShard
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetRef as JRef
from filodb_tpu.promql.parser import TimeStepParams as JParams
from filodb_tpu.promql.parser import parse_query_range as j_parse
from filodb_tpu.query import tilestore as jtst
from filodb_tpu.query import tpu as jtpu
from filodb_tpu.query.engine import QueryEngine as JEngine
from filodb_tpu.query.model import RangeParams as JRange
from filodb_tpu.query.model import RawSeries as JRaw
from filodb_tpu.query.tpu import TpuBackend
from filodb_tpu_torch import state
from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.query import backend as pb
from filodb_tpu_torch.query import kernels as kn
from filodb_tpu_torch.query import rangefn as rf
from filodb_tpu_torch.query import tilestore as ptst
from filodb_tpu_torch.query.backend import DEVICE_FUNCS, TorchBackend
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.model import RangeParams, RawSeries

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

BASE = 1_600_000_000_000
DT = 10_000
WINDOW = 300_000
STEP = 60_000

COUNTER_FAMILY = ("rate", "increase", "delta")
BIT_EQUAL = {"last_sample", "last_over_time", "first_over_time",
             "present_over_time", "absent_over_time", "count_over_time",
             "changes", "resets", "idelta", "min_over_time",
             "max_over_time"}
ULPS_4 = {"irate", "timestamp", "rate", "increase", "delta"}
PREFIX_FAMILY = {"sum_over_time", "avg_over_time", "stddev_over_time",
                 "stdvar_over_time", "z_score", "rate_over_delta",
                 "increase_over_delta"}
VARIANCE = ("stddev_over_time", "stdvar_over_time", "z_score")


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float64)))


def _same_nans(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))


def _max_ulps(got, want):
    """Largest |got - want| in ulps of max(|got|, |want|) over finite
    cells; infinities must coincide."""
    _same_nans(got, want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    if not ok.any():
        return 0.0
    mag = np.maximum(np.abs(got[ok]), np.abs(want[ok]))
    return float((np.abs(got[ok] - want[ok])
                  / np.maximum(_ulp(mag), np.finfo(np.float64).tiny)).max())


def _oracle(series, func, steps, scalar=None):
    return np.vstack([rf.evaluate(func, t, v, int(steps[0]), STEP,
                                  int(steps[-1]), WINDOW, scalar=scalar)
                      for t, v in series])


def _oracle_rtol(func, kind=""):
    if func == "z_score":
        return 5e-6
    if kind == "offset" and func in VARIANCE:
        return 1e-6
    return 1e-9


def _var_bound(cnt, dm, ds, ds2, var, **_):
    """Bound on |port - JAX| of a window's variance."""
    with np.errstate(all="ignore"):
        return ((ds2 + 2 * np.abs(dm) * ds + ds * ds / cnt) / cnt
                + 4 * _ulp(var + dm * dm))


def _meaningful(func, stats):
    """Cells where a variance-family answer means something: the window's
    variance exceeds its own rounding bound. Elsewhere (one sample, or
    repeats only) every implementation returns the rounding residue of a
    prefix difference, and z_score is 0/0 or 0/residue."""
    if func not in VARIANCE or stats is None:
        return None
    with np.errstate(invalid="ignore"):
        return ~(stats["var"] <= _var_bound(**stats))


def _check_oracle(got, want, func, kind="", stats=None):
    keep = _meaningful(func, stats)
    if keep is not None:
        got, want = got[keep], want[keep]
    _same_nans(got, want)
    np.testing.assert_allclose(got, want, rtol=_oracle_rtol(func, kind),
                               atol=1e-9, err_msg=func)


def _prefix_bound(func, got, want, cnt, dm, ds, ds2, var, **_):
    """Per-cell bound on |port - JAX| of a prefix-sum function from the
    windowed-sum bounds ds, ds2 (module docstring)."""
    with np.errstate(all="ignore"):
        if func in ("sum_over_time", "increase_over_delta"):
            return ds + 0 * want
        if func == "rate_over_delta":
            return ds / (WINDOW / 1000.0) + 2 * _ulp(want)
        if func == "avg_over_time":
            return ds / cnt + 2 * _ulp(want)
        bvar = _var_bound(cnt, dm, ds, ds2, var)
        if func == "stdvar_over_time":
            return bvar
        if func == "stddev_over_time":
            # |sqrt(a) - sqrt(b)| = |a - b| / (sqrt(a) + sqrt(b))
            return np.where(got + want == 0, 0.0,
                            bvar / (got + want)) + 2 * _ulp(want)
        sd = np.sqrt(var)
        bsd = bvar / sd + 2 * _ulp(sd)
        return (ds / cnt + np.abs(want) * bsd) / sd + 4 * _ulp(want)


def _check_prefix(func, got, want, stats):
    keep = ~np.isnan(want)
    if func == "z_score":
        keep &= _meaningful(func, stats)
    _same_nans(got[keep], want[keep])
    bound = _prefix_bound(func, got, want, **stats)
    with np.errstate(invalid="ignore"):
        ratio = np.abs(got - want)[keep] / bound[keep]
    assert (ratio <= 1).all(), (func, float(ratio.max()))
    return float(ratio.max()) if ratio.size else 0.0


def _check_jax(func, got, want, stats=None):
    if func in BIT_EQUAL:
        np.testing.assert_array_equal(got, want, err_msg=func)
    elif func in ULPS_4:
        assert _max_ulps(got, want) <= 4, func
    elif func == "quantile_over_time":
        assert _max_ulps(got, want) <= 2, func
    else:
        assert func in PREFIX_FAMILY, func
        _check_prefix(func, got, want, stats)


def _row_prefix_ulps(x):
    """8 ulps of each row's largest |prefix sum| of x -> [S, 1]."""
    cs = np.cumsum(np.asarray(x, np.float64), axis=1)
    return 8 * _ulp(np.abs(cs).max(axis=1, initial=0.0))[:, None]


# ---------------------------------------------------------------------------
# aligned path
# ---------------------------------------------------------------------------

ALIGNED_N = 240
# the grid starts and ends in windows with no sample
ALIGNED_STEPS = np.arange(BASE - 120_000, BASE + ALIGNED_N * DT + 360_000,
                          STEP, dtype=np.int64)
# the large-offset case as tests/test_tilestore.py builds it: 4 dense series
# of 150 samples at DT, 1e8 + N(0, 2), an interior grid
OFFSET_STEPS = np.arange(300_000, 1_500_001, STEP, dtype=np.int64)


def _walk(rng, shape, level=1000.0, sd=10.0):
    """A gauge's random walk with repeats (30 % of steps) and drops."""
    d = np.where(rng.random(shape) < 0.3, 0.0, rng.normal(0, sd, shape))
    return level + np.cumsum(d, axis=1)


def _noise(rng, shape, mean, sd):
    """Values as the reference's tests draw them (normal), with 20 %
    repeats of the previous sample so that changes() has non-events."""
    v = rng.normal(mean, sd, shape)
    rep = rng.random(shape) < 0.2
    rep[..., :1] = False
    idx = np.where(rep, 0, np.arange(shape[-1]))
    idx = np.maximum.accumulate(idx, axis=-1)
    return np.take_along_axis(v, idx, axis=-1)


def _aligned_arrays(kind, S=32, N=ALIGNED_N, seed=5):
    """(base, valid, ts, vals, steps) of one aligned case."""
    rng = np.random.default_rng(seed)
    if kind == "offset":
        ts = np.tile(np.arange(1, 151, dtype=np.float64) * DT, (4, 1))
        vals = 1e8 + rng.normal(0.0, 2.0, ts.shape)
        return DT, np.ones(ts.shape, bool), ts, vals, OFFSET_STEPS
    ts = (BASE + np.arange(N)[None, :] * DT
          + rng.integers(-2000, 2001, (S, N))).astype(np.float64)
    vals = _noise(rng, (S, N), 10.0, 3.0)
    valid = np.ones((S, N), bool)
    if kind == "gaps":
        valid = rng.random((S, N)) > 0.3
        valid[:, 0] = valid[:, -1] = True
    return BASE, valid, ts, vals, ALIGNED_STEPS


_ALIGNED = {}


def _aligned_case(kind):
    """JAX tiles, port tiles, oracle rows, grid and window statistics over
    the same arrays."""
    if kind not in _ALIGNED:
        base, valid, ts, vals, steps = _aligned_arrays(kind)
        keys = [{"i": str(i)} for i in range(valid.shape[0])]
        jt = jtst.AlignedTiles(keys, base, DT, valid, ts, vals)
        pt = state.tiles_from_numpy(keys, base, DT, valid, ts, vals,
                                    device="cpu")
        rows = [(ts[i][valid[i]].astype(np.int64), vals[i][valid[i]])
                for i in range(valid.shape[0])]
        stats = {
            "cnt": _oracle(rows, "count_over_time", steps),
            "dm": (_oracle(rows, "avg_over_time", steps)
                   - np.asarray(jt.vshift)[:, None]),
            "var": _oracle(rows, "stdvar_over_time", steps),
            "ds": _row_prefix_ulps(np.asarray(jt.channel("v"))),
            "ds2": _row_prefix_ulps(np.asarray(jt.channel("vc2")))}
        _ALIGNED[kind] = {"jt": jt, "pt": pt, "rows": rows, "steps": steps,
                          "base": base, "stats": stats}
    return _ALIGNED[kind]


ALIGNED_CASES = (
    [("jittered", f) for f in sorted(ptst.ALIGNED_FUNCS)
     if f not in COUNTER_FAMILY]
    + [("gaps", f) for f in sorted(ptst.ALIGNED_FUNCS)
       if f not in COUNTER_FAMILY]
    + [("offset", f) for f in VARIANCE])


@pytest.mark.parametrize("kind, func", ALIGNED_CASES)
def test_evaluate_aligned_matches_jax_and_oracle(kind, func):
    A = _aligned_case(kind)
    steps = A["steps"]
    want = np.asarray(jtst.evaluate_aligned(A["jt"], func, steps, WINDOW))
    got = ptst.evaluate_aligned(A["pt"], func, steps, WINDOW).numpy()
    assert got.shape == want.shape == (len(A["rows"]), steps.size)
    _check_jax(func, got, want, A["stats"])
    oracle = _oracle(A["rows"], func, steps)
    _check_oracle(got, oracle, func, kind, A["stats"])
    _check_oracle(want, oracle, func, kind, A["stats"])
    if kind != "offset":
        # the grid's first window holds no sample
        assert np.isnan(got[:, 0]).all() != (func == "absent_over_time")


@pytest.mark.parametrize("kind", ["jittered", "gaps", "offset"])
@pytest.mark.parametrize("channel", ["v", "vc2", "ones", "ev_change",
                                     "ev_reset"])
def test_aligned_window_sums_within_prefix_ulps(kind, channel):
    """The windowed sums under every prefix-sum function: within 8 ulps of
    the row's largest prefix (0/1 channels: exact). vc2 is compared on
    JAX's shift, which the port's may miss by an ulp of the mean (the
    reduction order differs); the derived functions are invariant to it."""
    A = _aligned_case(kind)
    jt, pt, steps, base = A["jt"], A["pt"], A["steps"], A["base"]
    vs = np.asarray(jt.vshift)
    assert _max_ulps(pt.vshift.numpy(), vs) <= 2
    if channel == "vc2":
        pt = state.tiles_from_numpy(jt.keys, base, DT, np.array(jt.valid),
                                    np.nan_to_num(np.array(jt.ts)),
                                    np.array(jt.vals), device="cpu")
        pt._channels["_vshift"] = torch.from_numpy(vs.copy())
    t = np.arange(steps.size, dtype=np.int64)
    wend = int(steps[0]) + t * STEP
    wstart = wend - WINDOW
    k_hi = np.floor((wend - base + DT / 2.0) / DT).astype(np.int64)
    k_lo = np.ceil((wstart - base - DT / 2.0) / DT).astype(np.int64)
    ja = {"ts": jt.ts, "ps_" + channel: jt.prefix(channel),
          "ch_" + channel: jt.channel(channel)}
    pa = {"ts": pt.ts, "ps_" + channel: pt.prefix(channel),
          "ch_" + channel: pt.channel(channel)}
    want = np.asarray(jtst._window_sum(ja, channel, jt.num_slots,
                                       jnp.asarray(k_lo), jnp.asarray(k_hi),
                                       jnp.asarray(wstart),
                                       jnp.asarray(wend)))
    got = ptst._window_sum(pa, channel, pt.num_slots, torch.from_numpy(k_lo),
                           torch.from_numpy(k_hi), torch.from_numpy(wstart),
                           torch.from_numpy(wend)).numpy()
    if channel in ("v", "vc2"):
        bound = _row_prefix_ulps(np.asarray(jt.channel(channel)))
        assert (np.abs(got - want) <= bound).all()
    else:
        np.testing.assert_array_equal(got, want)


def test_evaluate_aligned_leaves_the_rate_family_to_the_counter_path():
    A = _aligned_case("jittered")
    with pytest.raises(ValueError):
        ptst.evaluate_aligned(A["pt"], "rate", A["steps"], WINDOW)


# ---------------------------------------------------------------------------
# packed path
# ---------------------------------------------------------------------------

PACKED_T = 64
PACKED_W0S = BASE - 100_000


def _packed_series(counters, S=24, seed=3):
    """Ragged irregular rows: 5-20 s intervals, rows that end early, rows
    with a long gap (empty windows), one empty row and one single sample.
    Values as the reference's packed tests draw them, with repeats, or
    counters with a reset in every third row."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(S):
        n = int(rng.integers(100, 256))
        ts = np.unique(BASE + np.cumsum(rng.integers(5000, 20_000, n)))
        if i % 5 == 0:
            ts = ts[ts < BASE + 900_000]
        if i % 7 == 3:
            ts = ts[(ts < BASE + 600_000) | (ts > BASE + 1_500_000)]
        if i == S - 1:
            ts = ts[:0]
        if i == S - 2:
            ts = ts[:1]
        if counters:
            vals = np.cumsum(rng.uniform(0, 5, ts.size))
            if i % 3 == 0:
                vals[ts.size // 2:] -= vals[ts.size // 2 - 1:ts.size // 2]
        else:
            vals = _noise(rng, (ts.size,), 100.0, 25.0)
        out.append((ts.astype(np.int64), vals))
    return out


_PACKED = {}


def _packed(counters=False):
    if counters not in _PACKED:
        rows = _packed_series(counters)
        ser = [RawSeries({"i": str(i)}, t, v) for i, (t, v) in
               enumerate(rows)]
        ts, vals, lens = pb.pack_series(ser)
        steps = (PACKED_W0S + WINDOW
                 + np.arange(PACKED_T, dtype=np.int64) * STEP)
        stats = {"cnt": _oracle(rows, "count_over_time", steps),
                 "dm": _oracle(rows, "avg_over_time", steps),
                 "var": _oracle(rows, "stdvar_over_time", steps),
                 "ds": _row_prefix_ulps(vals),
                 "ds2": _row_prefix_ulps(vals * vals)}
        _PACKED[counters] = {"rows": rows, "ser": ser,
                             "arrays": (ts, vals, lens), "steps": steps,
                             "stats": stats}
    return _PACKED[counters]


def _jax_args(ts, vals, lens):
    return (ts, vals, lens, np.int64(PACKED_W0S),
            np.int64(PACKED_W0S + WINDOW), np.int64(STEP))


def _port_args(ts, vals, lens):
    return (torch.from_numpy(ts), torch.from_numpy(vals),
            torch.from_numpy(lens), PACKED_W0S, PACKED_W0S + WINDOW, STEP)


ENDPOINT_FUNCS = sorted(DEVICE_FUNCS - pb._GATHER_FUNCS)


@pytest.mark.parametrize("func", ENDPOINT_FUNCS)
def test_window_endpoint_matches_jax_and_oracle(func):
    # the rate family on counters: on noise its reset correction is a long
    # f64 cumsum, which both packages add in their own order
    P = _packed(counters=func in COUNTER_FAMILY)
    arrays = P["arrays"]
    want = np.asarray(jtpu._window_endpoint(func, *_jax_args(*arrays),
                                            PACKED_T, 0.0))
    got = pb._window_endpoint(func, *_port_args(*arrays), PACKED_T).numpy()
    assert got.shape == want.shape == (24, PACKED_T)
    _check_jax(func, got, want, P["stats"])
    oracle = _oracle(P["rows"], func, P["steps"])
    _check_oracle(got, oracle, func, stats=P["stats"])
    _check_oracle(want, oracle, func, stats=P["stats"])
    if func == "count_over_time":
        assert np.isnan(got).any()            # empty windows


GATHER_CASES = ([("min_over_time", 0.0), ("max_over_time", 0.0)]
                + [("quantile_over_time", q)
                   for q in (-0.5, 0.0, 0.5, 0.9, 1.0, 1.5)])


def _w_bound(P):
    return pb._window_sample_bound(P["ser"], WINDOW, P["arrays"][0].shape[1])


@pytest.mark.parametrize("func, q", GATHER_CASES)
def test_window_gather_matches_jax_and_oracle(func, q):
    P = _packed()
    arrays = P["arrays"]
    wb = _w_bound(P)
    assert wb < arrays[0].shape[1]         # the bound, not the row length
    want = np.asarray(jtpu._window_gather(func, wb, *_jax_args(*arrays),
                                          PACKED_T, q))
    got = pb._window_gather(func, wb, *_port_args(*arrays), PACKED_T,
                            q).numpy()
    _check_jax(func, got, want)
    oracle = _oracle(P["rows"], func, P["steps"], scalar=q)
    _check_oracle(got, oracle, func)
    _check_oracle(want, oracle, func)


@pytest.mark.parametrize("func, q", [("max_over_time", 0.0),
                                     ("quantile_over_time", 0.9)])
def test_window_gather_chunks_match_one_pass(func, q, monkeypatch):
    """Cutting the series axis under the memory budget changes no bit."""
    P = _packed()
    arrays = P["arrays"]
    wb = _w_bound(P)
    one = pb._window_gather(func, wb, *_port_args(*arrays), PACKED_T, q)
    elt = PACKED_T * wb * pb._GATHER_ELT_BYTES
    assert pb.GATHER_BUDGET_BYTES >= 24 * elt          # one pass here
    monkeypatch.setattr(pb, "GATHER_BUDGET_BYTES", 5 * elt)  # 5 rows a go
    chunked = pb._window_gather(func, wb, *_port_args(*arrays), PACKED_T, q)
    assert torch.equal(torch.nan_to_num(chunked, nan=7.0),
                       torch.nan_to_num(one, nan=7.0))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

N = 360
TAIL = 30
START = BASE // 1000 + 600
FLUSHED_END = (BASE + (N - 5) * DT) // 1000       # seconds
TAIL_END = (BASE + (N + TAIL - 2) * DT) // 1000


def _contents(seed=23, S=16, S_irr=6, S_g=16):
    """(flushed rows, tail rows) as (schema, labels, ts, values): jittered
    counters with a reset, irregular counters, and integer gauges (one
    series in 4 misses 5 % of its scrapes, one has a 10 minute gap),
    counters and gauges with an unflushed tail; one more gauge carries a
    NaN stale marker on a step of the query grid."""
    rng = np.random.default_rng(seed)
    flushed, tail = [], []

    def jittered():
        return BASE + np.arange(N + TAIL) * DT + rng.integers(-2000, 2001,
                                                              N + TAIL)
    for i in range(S):
        ts = jittered()
        v = 1e9 + np.cumsum(rng.uniform(0, 5, N + TAIL))
        if i == 3:
            v[N // 2:] -= v[N // 2 - 1]
        lab = {"_metric_": "http_requests_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 4}", "instance": f"i{i}"}
        flushed.append(("prom-counter", lab, ts[:N], v[:N]))
        tail.append(("prom-counter", lab, ts[N:], v[N:]))
    for i in range(S_irr):
        ts = np.unique(BASE + np.arange(N) * DT
                       + rng.integers(-6000, 6000, N))
        lab = {"_metric_": "irregular_total", "_ws_": "demo",
               "_ns_": "App-0", "job": f"job{i % 2}", "instance": f"k{i}"}
        flushed.append(("prom-counter", lab, ts,
                        np.cumsum(rng.uniform(0, 3, ts.size))))
    for i in range(S_g):
        ts = jittered()
        v = np.round(_walk(rng, (1, N + TAIL))[0])
        keep = np.ones(N + TAIL, bool)
        if i % 4 == 1:
            keep[:N] = rng.random(N) > 0.05
        if i == 2:
            keep[100:160] = False
        lab = {"_metric_": "queue_depth", "_ws_": "demo", "_ns_": "App-0",
               "job": f"job{i % 4}", "instance": f"g{i}"}
        flushed.append(("gauge", lab, ts[:N][keep[:N]], v[:N][keep[:N]]))
        tail.append(("gauge", lab, ts[N:], v[N:]))
    ts = jittered()[:N]
    v = np.round(_walk(rng, (1, N))[0])
    ts[N // 2] = BASE + N // 2 * DT
    v[N // 2] = np.nan
    flushed.append(("gauge", {"_metric_": "stale_gauge", "_ws_": "demo",
                              "_ns_": "App-0", "instance": "s0"}, ts, v))
    return flushed, tail


@pytest.fixture(scope="module")
def shards():
    flushed, tail = _contents()
    port = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0)
    for rows, flush in ((flushed, True), (tail, False)):
        for schema in ("prom-counter", "gauge"):
            sel = [(lab, ts, v) for sch, lab, ts, v in rows if sch == schema]
            state.load_series(port, sel, schema=schema, flush=False)
        if flush:
            port.flush_all()
    ref = JShard(JRef("timeseries"), J_SCHEMAS, 0)
    for rows, flush in ((flushed, True), (tail, False)):
        b = JBuilder(J_SCHEMAS)
        for schema, lab, ts, vals in rows:
            for t, v in zip(ts, vals):
                b.add_sample(schema, lab, int(t), float(v))
        for c in b.containers():
            ref.ingest(c)
        if flush:
            ref.flush_all()
    return port, ref


def _query(func):
    """(PromQL, end s, route) of the engine case of ``func``."""
    if func in COUNTER_FAMILY:
        return f"{func}(irregular_total[5m])", FLUSHED_END, "packed"
    if func in ("irate", "idelta"):
        return f"{func}(http_requests_total[5m])", FLUSHED_END, "packed"
    if func == "quantile_over_time":
        return "quantile_over_time(0.9, queue_depth[5m])", TAIL_END, "packed"
    if func in pb._GATHER_FUNCS:
        return f"{func}(queue_depth[5m])", TAIL_END, "packed"
    return f"{func}(queue_depth[5m])", TAIL_END, "aligned"


def _engines(shards, q, end):
    port, ref = shards
    be = TorchBackend(device="cpu")
    jbe = TpuBackend(batcher=None)
    got = QueryEngine([port], backend=be).execute(
        parse_query_range(q, TimeStepParams(START, 60, end)))
    oracle = QueryEngine([port]).execute(
        parse_query_range(q, TimeStepParams(START, 60, end)))
    want = JEngine([ref], backend=jbe).execute(
        j_parse(q, JParams(START, 60, end)))
    keys = [dict(k) for k in got.keys]
    assert keys == [dict(k) for k in want.keys]
    assert keys == [dict(k) for k in oracle.keys]
    return got.values, want.values, oracle.values, be


@pytest.mark.parametrize("func", sorted(DEVICE_FUNCS))
def test_engine_function_matches_jax_and_oracle(shards, func):
    q, end, route = _query(func)
    kn.reset_launches()
    got, want, oracle, be = _engines(shards, q, end)
    assert np.isfinite(got).any()
    _same_nans(got, want)
    _same_nans(got, oracle)
    if func in COUNTER_FAMILY:
        # both packages take exact f64 boundary values on the packed path
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-12)
        np.testing.assert_allclose(got, oracle, rtol=1e-9, atol=1e-9)
    elif func in PREFIX_FAMILY:
        rtol = 2 * _oracle_rtol(func)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=2e-9)
        _check_oracle(got, oracle, func)
    else:
        _check_jax(func, got, want)
        _check_oracle(got, oracle, func)
    if route == "aligned":
        # the flushed steps from the tiles, the tail's by the packed path
        assert (be.tile_builds, be.aligned_evals, be.packed_dispatches) \
            == (1, 1, 1)
    else:
        assert be.aligned_evals == 0 and be.packed_dispatches == 1
    assert be.fused_aggs == 0
    assert kn.LAUNCHES == {"counter_groupsum": 0, "window_extract": 0}


def test_grouped_max_over_time_through_the_engine(shards):
    got, want, oracle, be = _engines(
        shards, "sum by (job) (max_over_time(queue_depth[5m]))", TAIL_END)
    assert got.shape == (4, (TAIL_END - START) // 60 + 1)
    assert be.fused_aggs == 0 and be.packed_dispatches == 1
    # sums of the same per-series maxima, added in the engine's order
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, want)


def test_last_sample_with_a_stale_marker_leaves_the_aligned_path(shards):
    """Both backends decline the aligned path when a tile holds a NaN stale
    marker; the packed path keeps NaNs, so the marked step is stale."""
    got, want, oracle, be = _engines(shards, "last_sample(stale_gauge[5m])",
                                     FLUSHED_END)
    assert be.tile_builds == 1 and be.aligned_evals == 0
    assert be.packed_dispatches == 1
    assert np.isnan(got).any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    # last_over_time drops the marker and rides the tiles
    got, want, oracle, be = _engines(
        shards, "last_over_time(stale_gauge[5m])", FLUSHED_END)
    assert be.aligned_evals == 1 and be.packed_dispatches == 0
    np.testing.assert_array_equal(got, want)


def _selections():
    """Selections as (ts, values) rows: aligned gauges, irregular
    counters, and a mix of both."""
    rng = np.random.default_rng(9)
    out = {}
    ts = (BASE + np.arange(200)[None, :] * DT
          + rng.integers(-2000, 2001, (6, 200)))
    out["aligned"] = [(ts[i], np.round(_walk(rng, (1, 200))[0]))
                      for i in range(6)]
    irr = [np.unique(BASE + np.cumsum(rng.integers(1000, 20_000, 150)))
           for _ in range(4)]
    out["irregular"] = [(t, np.cumsum(rng.uniform(0, 3, t.size)))
                        for t in irr]
    out["mixed"] = out["aligned"][:3] + out["irregular"][:3]
    return out


@pytest.mark.parametrize("func", sorted(DEVICE_FUNCS) + ["deriv",
                                                         "holt_winters"])
def test_backends_decline_exactly_where_the_reference_does(func):
    params = RangeParams(BASE + 600_000, STEP, BASE + 1_900_000)
    jparams = JRange(BASE + 600_000, STEP, BASE + 1_900_000)
    args = {"quantile_over_time": (0.5,), "holt_winters": (0.5, 0.5)}.get(
        func, ())
    be = TorchBackend(device="cpu")
    jbe = TpuBackend(batcher=None)
    hist = np.ones((3, 4))
    cases = dict(_selections())
    cases["histogram"] = [(np.arange(3, dtype=np.int64) * DT + BASE, hist)]
    cases["empty"] = []
    for name, sel in cases.items():
        les = np.array([1.0, 2, 4, np.inf]) if name == "histogram" else None
        p = [RawSeries({"i": str(i)}, t, v, bucket_les=les)
             for i, (t, v) in enumerate(sel)]
        j = [JRaw({"i": str(i)}, t, v, bucket_les=les)
             for i, (t, v) in enumerate(sel)]
        got = be.periodic_samples(p, params, func, WINDOW, args)
        want = jbe.periodic_samples(j, jparams, func, WINDOW, args)
        assert (got is None) == (want is None), (name, func)
        assert (got is None) == (func not in DEVICE_FUNCS
                                 or name in ("histogram", "empty"))
        if got is not None:
            _same_nans(got.values, want.values)
