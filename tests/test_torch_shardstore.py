"""The port's device-resident sharded tile store
(``filodb_tpu_torch/parallel/shardstore.py``) on the CPU, held against the
port's single-device tilestore, the numpy f64 oracle and the JAX package's
``ShardedTiles`` (``tests/test_shardstore.py``).

Partition layouts are (partitions, time-parallel) pairs as the reference
test names them: (4, 2) is 2 shard x 2 time partitions. The port lays them
on the CPU; the reference on the conftest's virtual CPU devices.

Tolerances: per-series answers bit for bit the port's single-device
answers; against the JAX package's sharded evaluators, the f32 counter
evaluators within 8 f32 ulps (ROADMAP C.10: XLA rewrites the epilogue's
divisions) and the f64 aligned families within 1e-9 relative. Grouped
answers within 1e-12 relative of the numpy f64 oracle over the
single-device rates, counts exact. The reference's own grouped collective
misses that oracle (ROADMAP C.13); one test shows its miss beside the
port's match on the same tiles."""

import gc

import numpy as np
import pytest
import torch

import jax

from filodb_tpu.lint import capacity as j_capacity
from filodb_tpu.lint import numerics as j_nmod
from filodb_tpu.parallel.mesh import make_mesh as j_make_mesh
from filodb_tpu.parallel.shardstore import ShardedTiles as JSharded
from filodb_tpu.query import tilestore as j_tst
from filodb_tpu_torch.lint import capacity as p_capacity
from filodb_tpu_torch.lint import contracts as p_contracts
from filodb_tpu_torch.lint import numerics as nmod
from filodb_tpu_torch.parallel.mesh import make_mesh
from filodb_tpu_torch.parallel.shardstore import (ShardedTileEvaluator,
                                                  ShardedTiles,
                                                  _append_step)
from filodb_tpu_torch.query import kernels as kn
from filodb_tpu_torch.query import tilestore as tst
from filodb_tpu_torch.query.backend import TorchBackend
from filodb_tpu_torch.query.model import RangeParams, RawSeries

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

BASE = 1_000_000_000_000
DT = 10_000
W = 300_000
STEP = 60_000
CPU = torch.device("cpu")
LAYOUTS = [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2), (8, 2)]


def _arrays(S=13, N=200, seed=3, jitter=2000):
    rng = np.random.default_rng(seed)
    ts = (BASE + np.arange(N, dtype=np.float64)[None, :] * DT
          + rng.integers(-jitter, jitter + 1, (S, N)))
    vals = np.cumsum(rng.uniform(0, 5, (S, N)), axis=1)
    return np.ones((S, N), bool), ts, vals


def _tiles(**kw):
    valid, ts, vals = _arrays(**kw)
    keys = [{"i": str(i)} for i in range(valid.shape[0])]
    return tst.AlignedTiles(keys, BASE, DT, valid, ts, vals, device="cpu")


def _jtiles(**kw):
    valid, ts, vals = _arrays(**kw)
    keys = [{"i": str(i)} for i in range(valid.shape[0])]
    return j_tst.AlignedTiles(keys, BASE, DT, valid, ts, vals)


def _steps(n=24, start=400_000):
    return BASE + start + np.arange(n, dtype=np.int64) * STEP


def _mesh(ndev, tp=1):
    return make_mesh(ndev // tp, tp, [CPU] * ndev)


def _jmesh(ndev, tp=1):
    return j_make_mesh(ndev // tp, tp, jax.devices()[:ndev])


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and np.array_equal(got, want,
                                                      equal_nan=True)


def _ulps_apart(a, b, dtype):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    mag = np.maximum(np.abs(a[ok]), np.abs(b[ok])).astype(dtype)
    ulp = np.spacing(mag).astype(np.float64)
    return np.abs(a[ok] - b[ok]) / np.maximum(ulp, np.finfo(dtype).tiny)


# ---------------------------------------------------------------------------
# per-series families: bit for bit the single-device path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev,tp", LAYOUTS)
@pytest.mark.parametrize("func", ["rate", "increase", "delta"])
def test_counter_parity_bitwise_across_device_counts(ndev, tp, func):
    tiles = _tiles()
    st = ShardedTileEvaluator(_mesh(ndev, tp)).place(tiles)
    assert st is not None
    steps = _steps()
    ref = tst.evaluate_counters_t(tiles, func, steps, W).numpy()
    got = st.eval_counters(func, steps, W).numpy()
    assert _same(got, ref)
    # the reference's sharded evaluator at the same layout
    j_st = JSharded(_jmesh(ndev, tp), _jtiles())
    want = np.asarray(j_st.eval_counters(func, steps, W))
    assert _ulps_apart(got, want, np.float32).max() <= 8


def test_counter_parity_instant_and_offset():
    tiles = _tiles()
    st = ShardedTileEvaluator(_mesh(8, 2)).place(tiles)
    one = _steps(1)                      # instant-query shape (T=1)
    assert _same(st.eval_counters("rate", one, W).numpy(),
                 tst.evaluate_counters_t(tiles, "rate", one, W).numpy())
    steps = _steps(16)
    assert _same(st.eval_counters("rate", steps, W,
                                  offset_ms=60_000).numpy(),
                 tst.evaluate_counters_t(tiles, "rate", steps, W,
                                         offset_ms=60_000).numpy())


@pytest.mark.parametrize("ndev,tp", [(4, 2), (8, 1)])
def test_batch_parity_bitwise(ndev, tp):
    tiles = _tiles()
    st = ShardedTileEvaluator(_mesh(ndev, tp)).place(tiles)
    steps = _steps()
    fam = tst.counters_batch_family(tiles, "rate", steps, W, 0)
    w0e = int(steps[0])
    w0s_l = [w0e - W + k * STEP for k in range(3)]
    w0e_l = [w0e + k * STEP for k in range(3)]
    ref = tst.evaluate_counters_t_batch(tiles, "rate", fam, steps.size,
                                        STEP, w0s_l, w0e_l).numpy()
    got = st.eval_counters_batch("rate", steps.size, STEP, w0s_l,
                                 w0e_l).numpy()
    assert got.shape == ref.shape == (3, steps.size, 13)
    assert _same(got, ref)
    for k in range(3):                   # each member its scalar answer
        one = tst.evaluate_counters_t(tiles, "rate", steps + k * STEP,
                                      W).numpy()
        assert _same(got[k], one)


@pytest.mark.parametrize("func", ["sum_over_time", "avg_over_time",
                                  "count_over_time", "last_over_time",
                                  "stddev_over_time", "changes",
                                  "first_over_time"])
def test_aligned_family_parity_bitwise(func):
    tiles = _tiles()
    st = ShardedTileEvaluator(_mesh(8, 2)).place(tiles)
    steps = _steps()
    got = st.eval_aligned(tiles, func, steps, W).numpy()
    assert _same(got, tst.evaluate_aligned(tiles, func, steps, W).numpy())
    j_st = JSharded(_jmesh(8, 2), _jtiles())
    want = np.asarray(j_st.eval_aligned(_jtiles(), func, steps, W))
    np.testing.assert_allclose(got, want, rtol=1e-9, equal_nan=True)


def test_aligned_batch_parity_bitwise():
    tiles = _tiles()
    st = ShardedTileEvaluator(_mesh(2, 1)).place(tiles)
    steps = _steps()
    w0e = int(steps[0])
    w0s_l = [w0e - W, w0e - W + STEP]
    w0e_l = [w0e, w0e + STEP]
    ref = tst.evaluate_aligned_batch(tiles, "sum_over_time", steps.size,
                                     STEP, w0s_l, w0e_l).numpy()
    got = st.eval_aligned_batch(tiles, "sum_over_time", steps.size, STEP,
                                w0s_l, w0e_l).numpy()
    assert _same(got, ref)


# ---------------------------------------------------------------------------
# grouped: the numpy f64 oracle
# ---------------------------------------------------------------------------

def _host_grouped(rates, gids, G, agg):
    """[T, S] rates -> [G, T] f64 oracle of agg by group."""
    out = np.full((G, rates.shape[0]), np.nan)
    for g in range(G):
        rows = rates[:, gids == g]
        ok = ~np.isnan(rows)
        any_ok = ok.any(axis=1)
        with np.errstate(invalid="ignore"):
            if agg == "sum":
                v = np.where(ok, rows, 0.0).sum(axis=1)
            elif agg == "count":
                v = ok.sum(axis=1).astype(float)
            elif agg == "avg":
                v = np.where(ok, rows, 0.0).sum(axis=1) / ok.sum(axis=1)
            elif agg == "min":
                v = np.nanmin(np.where(ok, rows, np.inf), axis=1)
            else:
                v = np.nanmax(np.where(ok, rows, -np.inf), axis=1)
        out[g] = np.where(any_ok, v, np.nan)
    return out


@pytest.mark.parametrize("ndev,tp", LAYOUTS)
@pytest.mark.parametrize("agg", ["sum", "count", "avg", "min", "max"])
def test_grouped_collective_matches_host_oracle(ndev, tp, agg):
    tiles = _tiles()
    st = ShardedTileEvaluator(_mesh(ndev, tp)).place(tiles)
    steps = _steps()
    gids = np.arange(13) % 3
    rates = tst.evaluate_counters_t(tiles, "rate", steps, W).numpy()
    want = _host_grouped(rates.astype(np.float64), gids, 3, agg)
    got = st.eval_grouped("rate", steps, W, gids, 3, agg)
    assert got.shape == (3, steps.size) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("ndev,tp", LAYOUTS)
def test_grouped_pair_matches_fused_contract(ndev, tp):
    tiles = _tiles()
    st = ShardedTileEvaluator(_mesh(ndev, tp)).place(tiles)
    steps = _steps()
    gids = np.arange(13) % 3
    sums, cnts = st.eval_grouped_pair("rate", steps, W, gids, 3)
    assert sums.shape == (steps.size, 3) and cnts.shape == sums.shape
    assert sums.dtype == cnts.dtype == np.float64
    rates = tst.evaluate_counters_t(tiles, "rate", steps, W).numpy()
    want = _host_grouped(rates.astype(np.float64), gids, 3, "sum")
    wantc = _host_grouped(rates.astype(np.float64), gids, 3, "count")
    np.testing.assert_allclose(sums.T[wantc > 0], want[wantc > 0],
                               rtol=1e-12, atol=0)
    assert np.array_equal(cnts.T, np.where(np.isnan(wantc), 0, wantc))


@pytest.mark.parametrize("agg", ["sum", "count"])
def test_the_reference_grouped_collective_misses_where_the_port_matches(
        agg):
    """The same tiles, the same 8 x 2 layout: the JAX package's grouped
    collective is off the oracle (its own test_shardstore fails so,
    ROADMAP C.13: the psum counts each time partition's replica again),
    the port's within 1e-12."""
    steps = _steps()
    gids = np.arange(13) % 3
    tiles = _tiles()
    rates = tst.evaluate_counters_t(tiles, "rate", steps, W).numpy()
    want = _host_grouped(rates.astype(np.float64), gids, 3, agg)
    got = ShardedTiles(_mesh(8, 2), tiles).eval_grouped(
        "rate", steps, W, gids, 3, agg)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    j_got = np.asarray(JSharded(_jmesh(8, 2), _jtiles()).eval_grouped(
        "rate", steps, W, gids, 3, agg))
    assert not np.allclose(j_got, want, rtol=1e-5), \
        "the reference's grouped collective matches now: update ROADMAP C.13"


# ---------------------------------------------------------------------------
# eligibility gates
# ---------------------------------------------------------------------------

def test_non_dense_tiles_not_placed():
    S, N = 8, 64
    valid = np.ones((S, N), bool)
    valid[0, 5] = False
    ts = BASE + np.arange(N, dtype=np.float64)[None, :] * DT \
        + np.zeros((S, 1))
    tiles = tst.AlignedTiles([{"i": str(i)} for i in range(S)], BASE, DT,
                             valid, ts, np.ones((S, N)), device="cpu")
    assert not ShardedTiles.tiles_eligible(tiles)
    assert ShardedTileEvaluator(_mesh(2)).place(tiles) is None


def test_query_fits_rejects_wide_grid():
    st = ShardedTileEvaluator(_mesh(2)).place(_tiles())
    wide = np.array([BASE + 400_000, BASE + (1 << 32)], dtype=np.int64)
    assert not st.query_fits(wide, W, 0)
    assert st.query_fits(_steps(), W, 0)


def test_mesh_shape_must_match_the_partitions():
    with pytest.raises(ValueError):
        make_mesh(3, 1, [CPU] * 4)
    m = make_mesh(2, 2, [CPU] * 4)
    assert m.shape == {"shard": 2, "time": 2} and m.size == 4


# ---------------------------------------------------------------------------
# residency
# ---------------------------------------------------------------------------

def test_residency_is_recorded_and_dropped_with_the_store():
    tiles = _tiles(S=13, N=200)
    st = ShardedTiles(_mesh(4, 2), tiles)
    fam = "shardstore-resident-channels"
    snap = p_capacity.residency_snapshot()[fam]
    # 20 B a padded slot: cap 256 (pow2 of 200) x S_pad 14 (2 shards)
    assert st.cap == 256 and st.S_pad == 14
    assert snap["2"] >= 20 * 256 * 14
    key = st._res_key
    del st
    gc.collect()
    assert key[2] not in p_capacity._RESIDENT.get((fam, "2"), {})


# ---------------------------------------------------------------------------
# the in-place refresh
# ---------------------------------------------------------------------------

def _extend(tiles, k, seed=11, reset_at=None):
    """Fresh tiles extending ``tiles`` by k appended slots."""
    rng = np.random.default_rng(seed)
    S = len(tiles.keys)
    N = tiles.num_slots
    ts_old = tiles.ts.numpy()
    v_old = tiles.channel("v").numpy()
    new_ts = (BASE + (N + np.arange(k, dtype=np.float64))[None, :] * DT
              + rng.integers(-2000, 2001, (S, k)))
    incs = rng.uniform(0, 5, (S, k))
    new_v = v_old[:, -1:] + np.cumsum(incs, axis=1)
    if reset_at is not None:
        new_v[:, reset_at:] = np.cumsum(incs[:, reset_at:], axis=1)
    return tst.AlignedTiles(list(tiles.keys), BASE, DT,
                            np.ones((S, N + k), bool),
                            np.concatenate([ts_old, new_ts], axis=1),
                            np.concatenate([v_old, new_v], axis=1),
                            device="cpu")


def _ptrs(st):
    return [t.data_ptr() for name in ("tsr", "v", "cv")
            for row in st._chan[name] for t in row]


@pytest.mark.parametrize("ndev,tp", [(4, 2), (8, 1)])
def test_donated_refresh_matches_fresh_rebuild_bitwise(ndev, tp):
    tiles = _tiles()
    ev = ShardedTileEvaluator(_mesh(ndev, tp))
    st = ev.place(tiles)
    ptrs = _ptrs(st)
    tiles2 = _extend(tiles, 32)
    assert ev.refresh(tiles, tiles2)
    assert ev.snapshot()["donated_refreshes"] == 1
    st2 = ev.place(tiles2)          # the refreshed placement, reused
    assert st2 is st and _ptrs(st2) == ptrs
    steps = _steps(30)
    assert _same(st2.eval_counters("rate", steps, W).numpy(),
                 tst.evaluate_counters_t(tiles2, "rate", steps, W).numpy())
    # the channels themselves: bitwise a from-scratch placement
    fresh = ShardedTiles(_mesh(ndev, tp), tiles2)
    for name in ("tsr", "v", "cv"):
        for i in range(st.n_shard):
            n = st2.n_filled
            assert torch.equal(st2._chan[name][i][0][:n],
                               fresh._chan[name][i][0][:n]), name
    # the old placement key is gone: old tiles re-place from scratch
    assert id(tiles) not in ev._placed


@pytest.mark.parametrize("func", ["sum_over_time", "last_over_time"])
def test_stale_snapshot_query_after_refresh_leaves_fresh_answers(func):
    # a query still holding the old snapshot reaches eval_aligned after
    # the refresh appended in place: it answers from its own slots, and
    # the fresh snapshot's queries are not served its placement
    tiles = _tiles()
    ev = ShardedTileEvaluator(_mesh(4, 2))
    st = ev.place(tiles)
    steps = _steps()
    st.eval_aligned(tiles, func, steps, W)
    tiles2 = _extend(tiles, 32)
    assert ev.refresh(tiles, tiles2)
    old = st.eval_aligned(tiles, func, steps, W).numpy()
    assert _same(old, tst.evaluate_aligned(tiles, func, steps, W).numpy())
    steps2 = _steps(30)
    got = ev.place(tiles2).eval_aligned(tiles2, func, steps2, W).numpy()
    assert _same(got,
                 tst.evaluate_aligned(tiles2, func, steps2, W).numpy())


def test_donated_refresh_with_counter_reset_in_appended_span():
    tiles = _tiles()
    ev = ShardedTileEvaluator(_mesh(2, 1))
    ev.place(tiles)
    tiles2 = _extend(tiles, 24, reset_at=8)
    assert ev.refresh(tiles, tiles2)
    steps = _steps(28)
    ref = tst.evaluate_counters_t(tiles2, "rate", steps, W).numpy()
    got = ev.place(tiles2).eval_counters("rate", steps, W).numpy()
    # the correction carry is the same value; the rounding order of the
    # cumsum may differ from the rebuild's
    np.testing.assert_allclose(got.astype(np.float64),
                               ref.astype(np.float64), rtol=1e-6,
                               equal_nan=True)


def test_refresh_incompatible_falls_back():
    tiles = _tiles()
    ev = ShardedTileEvaluator(_mesh(2, 1))
    st = ev.place(tiles)
    assert st is not None
    assert not ev.refresh(tiles, _tiles(S=14, seed=9))   # other series
    big = _extend(tiles, st.cap)     # n_filled + k_pad > cap
    assert not st.append_slots(big)


def test_placement_dropped_when_tiles_die():
    ev = ShardedTileEvaluator(_mesh(2, 1))
    tiles = _tiles(S=5, N=64)
    assert ev.place(tiles) is not None and len(ev._placed) == 1
    del tiles
    gc.collect()
    assert len(ev._placed) == 0


def test_placements_are_bounded():
    ev = ShardedTileEvaluator(_mesh(2, 1))
    held = [_tiles(S=4, N=64, seed=s) for s in range(10)]
    for t in held:
        ev.place(t)
    assert len(ev._placed) == ShardedTileEvaluator.MAX_PLACEMENTS
    assert ev.snapshot()["placements"] == 10


def test_append_step_writes_in_place():
    """The zero-copy property itself: the storage of the channels is
    reused, the appended rows are written, and the correction carry
    continues the resident channel."""
    tsr = torch.zeros((64, 8), dtype=torch.int32)
    v = torch.ones((64, 8), dtype=torch.float64)
    cv = torch.full((64, 8), 3.0, dtype=torch.float64)   # carry 2.0
    ptrs = (tsr.data_ptr(), v.data_ptr(), cv.data_ptr())
    new_tsr = torch.ones((8, 8), dtype=torch.int32)
    new_v = torch.full((8, 8), 2.0, dtype=torch.float64)
    t2, v2, c2 = _append_step(tsr, v, cv, new_tsr, new_v, 32)
    assert (t2.data_ptr(), v2.data_ptr(), c2.data_ptr()) == ptrs
    assert torch.equal(v[32:40], new_v) and torch.equal(tsr[32:40], new_tsr)
    assert torch.equal(cv[32:40], torch.full((8, 8), 4.0,
                                             dtype=torch.float64))
    assert torch.equal(cv[:32], torch.full((32, 8), 3.0,
                                           dtype=torch.float64))


# ---------------------------------------------------------------------------
# backend integration: mesh-shaped batches and dispatch routing
# ---------------------------------------------------------------------------

def _counter_series(n, seed):
    rng = np.random.default_rng(seed)
    return [RawSeries({"i": str(i)}, BASE + np.arange(128, dtype=np.int64)
                      * DT, np.cumsum(rng.uniform(0, 5, 128)),
                      is_counter=True) for i in range(n)]


def test_backend_routes_counters_through_mesh_and_matches():
    series = _counter_series(9, 0)
    params = RangeParams(BASE + 400_000, STEP, BASE + 400_000 + 23 * STEP)
    ref = TorchBackend(device="cpu", batcher=None).periodic_samples(
        series, params, "rate", W)
    meshed = TorchBackend(device="cpu", batcher=None,
                          mesh_eval=ShardedTileEvaluator(_mesh(8, 2)))
    got = meshed.periodic_samples(series, params, "rate", W)
    assert meshed.mesh_dispatches >= 1
    assert np.array_equal(got.values, ref.values, equal_nan=True)


def test_backend_mesh_batch_run_parity():
    """The mesh-shaped micro-batch: _aligned_run_inner with 3 members
    through the sharded batch evaluator splits back bit for bit the
    members' single dispatches."""
    tiles = _tiles()
    ev = ShardedTileEvaluator(_mesh(4, 2))
    st = ev.place(tiles)
    be = TorchBackend(device="cpu", batcher=None, mesh_eval=ev)
    steps = _steps()
    fam = tst.counters_batch_family(tiles, "rate", steps, W, 0)
    members = [(int(steps[0] + k * STEP) - W, int(steps[0] + k * STEP),
                steps + k * STEP, tiles) for k in range(3)]
    res = be._aligned_run_inner(tiles, "rate", fam, steps.size, STEP, W,
                                0, st, members)
    for k in range(3):
        want = tst.evaluate_counters_t(tiles, "rate", steps + k * STEP,
                                       W).numpy().T
        assert np.array_equal(res.get(k), want, equal_nan=True)
    assert be.mesh_dispatches == 3


def test_fused_groupsum_rides_resident_collective(monkeypatch):
    """The grouped sum takes the sharded collective before the group-sum
    kernel: the kernel is not called on this route."""
    def no_kernel(*a, **k):
        raise AssertionError("the group-sum kernel ran on the mesh route")
    monkeypatch.setattr(kn, "counter_groupsum", no_kernel)
    series = _counter_series(8, 1)
    be = TorchBackend(device="cpu", batcher=None,
                      mesh_eval=ShardedTileEvaluator(_mesh(4, 1)))
    steps = _steps(16)
    gids = np.arange(8) % 2
    sums, cnts = be.fused_groupsum(series, "rate", steps, W, 0, gids, 2)
    assert sums.shape == (16, 2) and (cnts > 0).any()
    assert be.fused_aggs == 1 and be.mesh_dispatches == 1
    plain = TorchBackend(device="cpu", batcher=None)
    rates = plain.periodic_samples(
        series, RangeParams(int(steps[0]), STEP, int(steps[-1])), "rate",
        W).values
    for g in range(2):
        np.testing.assert_allclose(sums[:, g],
                                   rates[gids == g].sum(axis=0),
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# the reference's declarations at the port's sites
# ---------------------------------------------------------------------------

def test_declarations_at_the_port_sites_with_the_reference_budgets():
    nmod.import_annotated_modules()
    j_nmod.import_annotated_modules()
    p = nmod.precision_claim("append-carry-exact")
    j = j_nmod.precision_claim("append-carry-exact")
    assert (p.module, p.qualname) == ("filodb_tpu_torch.parallel.shardstore",
                                      "_append_step")
    assert (p.bits, p.rel_ulps) == (j.bits, j.rel_ulps)
    sites = {"grouped-reduce-psum": ("filodb_tpu_torch.parallel.mesh",
                                     "_grouped_reduce"),
             "grouped-pair-psum": ("filodb_tpu_torch.parallel.shardstore",
                                   "_grouped_pair")}
    for name, site in sites.items():
        oc = nmod.order_claim(name)
        assert (oc.module, oc.qualname) == site
        assert oc.tolerance == j_nmod.order_claim(name).tolerance
    cap = p_capacity.capacity_claim("shardstore-resident-channels")
    j_cap = j_capacity.capacity_claim("shardstore-resident-channels")
    assert cap.bytes_per_sample == j_cap.bytes_per_sample == 20.0
    assert cap.sharded and cap.qualname == "ShardedTiles"
    names = {c.name for c in p_contracts.CONTRACTS.values()}
    assert {"mesh_grouped_reduce", "sharded_counter_eval"} <= names
    for c in p_contracts.CONTRACTS.values():
        if c.name in ("mesh_grouped_reduce", "sharded_counter_eval"):
            assert c.check() is None
