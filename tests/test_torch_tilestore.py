"""The port's aligned tiles and counter evaluators
(filodb_tpu_torch.query.tilestore) against the JAX package's, on identical
tiles built from the same numpy arrays.

Tolerances: the packed channels and relative timestamps are bit-exact. The
counter-corrected ``cv`` channel may differ by 2 f64 ulps (the reset
cumsum may associate differently), so the fixed-point split is checked
bit-exact on JAX's own ``cv``. The exact f64 evaluator agrees within 4 f64
ulps. The f32-epilogue evaluators agree within 8 f32 ulps: twice the
reference's ``counter-epilogue-f32`` budget (4 ulps), the bound the
reference itself states for two programs of the same chain — XLA rewrites
``x / 1000.0`` into ``x * (1 / 1000.0)`` and ``(a / b) / c`` into
``a / (b * c)``, which the port (IEEE division throughout) does not."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from filodb_tpu.query import tilestore as jtst
from filodb_tpu_torch import state
from filodb_tpu_torch.query import tilestore as ptst

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

BASE = 1_600_000_000_000
DT = 10_000


def _arrays(S=100, N=288, seed=7, gappy=False, resets=1):
    rng = np.random.default_rng(seed)
    ts = (BASE + np.arange(N)[None, :] * DT
          + rng.uniform(-2000, 2000, (S, N)))
    vals = 1e15 + np.cumsum(rng.uniform(0, 5, (S, N)), axis=1)
    for r in range(resets):
        vals[(5 + r) % S, N // 2 + 7 * r:] *= 0.99
    valid = np.ones((S, N), bool)
    if gappy:
        valid = rng.random((S, N)) > 0.15
    return valid, ts, vals


def _pair(**kw):
    valid, ts, vals = _arrays(**kw)
    S = valid.shape[0]
    keys = [{"i": str(i)} for i in range(S)]
    jt = jtst.AlignedTiles(keys, BASE, DT, valid, ts, vals)
    pt = state.tiles_from_numpy(keys, BASE, DT, valid, ts, vals,
                                device="cpu")
    return jt, pt


def _ulps_apart(a, b, dtype):
    """Elementwise |a - b| in units of the last place of max(|a|, |b|)
    (NaNs must coincide)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    mag = np.maximum(np.abs(a[ok]), np.abs(b[ok])).astype(dtype)
    ulp = np.spacing(mag).astype(np.float64)
    return np.abs(a[ok] - b[ok]) / np.maximum(ulp, np.finfo(dtype).tiny)


def test_relative_timestamps_bit_exact():
    jt, pt = _pair()
    np.testing.assert_array_equal(pt.t_tsr_i32().numpy(),
                                  np.asarray(jt.t_tsr_i32()))
    assert pt.jitter_ms() == jt.jitter_ms()


def test_counter_corrected_channel_within_2_ulps():
    jt, pt = _pair(resets=3)
    d = _ulps_apart(pt.channel("cv").numpy(), np.asarray(jt.channel("cv")),
                    np.float64)
    assert d.max() <= 2


@pytest.mark.parametrize("st", [1, 6])
def test_fixed_point_channels_bit_exact(st):
    jt, pt = _pair(resets=3)
    # the split is held bit-exact on the same cv input
    pt._channels["cv"] = torch.from_numpy(np.array(jt.channel("cv")))
    jfx = jt._fixed_channels("cv")
    pfx = pt._fixed_channels("cv")
    for j, p in zip(jfx, pfx):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        pt.t_perm_fixed_tiled("cv", st).numpy(),
        np.asarray(jt.t_perm_fixed_tiled("cv", st)))
    np.testing.assert_array_equal(pt.t_fixed_base("cv").numpy(),
                                  np.asarray(jt.t_fixed_base("cv")))


def test_fixed_point_refuses_nonfinite_and_huge_spans():
    valid, ts, vals = _arrays(S=8)
    bad = vals.copy()
    bad[2, 9] = np.inf
    pt = state.tiles_from_numpy([{}] * 8, BASE, DT, valid, ts, bad,
                                device="cpu")
    assert pt._fixed_channels("v") is None
    wide = vals.copy()
    wide[3, 0], wide[3, 1] = -1e300, 1e300
    pt = state.tiles_from_numpy([{}] * 8, BASE, DT, valid, ts, wide,
                                device="cpu")
    assert pt._fixed_channels("v") is None


def _grid(phase=0, step=60_000, n=None):
    stop = BASE + 2_400_000
    steps = np.arange(BASE + 400_000 + phase, stop, step, dtype=np.int64)
    return steps if n is None else steps[:n]


# (family, tiles kwargs, steps, window): slide = regular interior grid
# over dense tiles; fast = int31 span but off the slide guard (gappy
# tiles, or a step that is not a slot multiple); t = a window reaching
# past int31 ms relative to the tile base (exact f64 family)
_FAMILIES = {
    "slide": ({}, _grid(), 300_000),
    "fast-gappy": ({"gappy": True}, _grid(), 300_000),
    "fast-offgrid": ({}, _grid(step=61_000), 300_000),
    "t": ({}, _grid(), 2_200_000_000),
    "t-gappy": ({"gappy": True}, _grid(), 2_200_000_000),
}


@pytest.mark.parametrize("func", ["rate", "increase", "delta"])
@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_evaluate_counters_t_matches_jax(family, func):
    kw, steps, window = _FAMILIES[family]
    jt, pt = _pair(**kw)
    want = np.asarray(jtst.evaluate_counters_t(jt, func, steps, window))
    got = ptst.evaluate_counters_t(pt, func, steps, window).numpy()
    assert got.dtype == want.dtype
    d = _ulps_apart(got, want, got.dtype)
    budget = 8 if got.dtype == np.float32 else 4
    assert d.max() <= budget, (family, func, d.max())
    if family == "slide":
        assert ptst._slide_eligible(pt, steps.size, int(steps[0] - window),
                                    int(steps[0]), int(steps[-1]),
                                    int(steps[1] - steps[0])) is not None


def test_build_aligned_tiles_matches_jax():
    from filodb_tpu.query.model import RawSeries as JRaw
    from filodb_tpu_torch.query.model import RawSeries as PRaw

    rng = np.random.default_rng(5)
    raws = []
    for i in range(12):
        ts = (BASE + np.arange(100) * DT
              + rng.integers(-1500, 1500, 100)).astype(np.int64)
        raws.append(({"i": str(i)}, ts, np.cumsum(rng.random(100))))
    ts = np.sort(rng.integers(BASE, BASE + 1_000_000, 100))
    raws.append(({"i": "irregular"}, ts, rng.random(100)))
    jtiles, jidx = jtst.build_aligned_tiles(
        [JRaw(lab, t, v) for lab, t, v in raws])
    ptiles, pidx = ptst.build_aligned_tiles(
        [PRaw(lab, t, v) for lab, t, v in raws], device="cpu")
    assert jidx == pidx
    assert (ptiles.base_ms, ptiles.dt_ms, ptiles.num_slots) == \
        (jtiles.base_ms, jtiles.dt_ms, jtiles.num_slots)
    np.testing.assert_array_equal(ptiles.valid.numpy(),
                                  np.asarray(jtiles.valid))
    np.testing.assert_array_equal(ptiles.ts.numpy(), np.asarray(jtiles.ts))


def test_groupsum_dispatcher_refusals():
    """The reference's semantic refusals return None (the caller takes the
    per-series path); nothing else is refused."""
    valid, ts, vals = _arrays(S=16)
    tiles = state.tiles_from_numpy([{}] * 16, BASE, DT, valid, ts, vals,
                                   device="cpu")
    onehot = np.ones((16, 1), np.float32)
    # irregular step (not a slot multiple)
    steps = np.arange(BASE + 400_000, BASE + 1_000_000, 61_000,
                      dtype=np.int64)
    assert ptst.groupsum_counters(tiles, "rate", steps, 300_000,
                                  onehot) is None
    # grid past the tile end
    steps = np.arange(BASE + 400_000, BASE + 288 * DT + 600_000, 60_000,
                      dtype=np.int64)
    assert ptst.groupsum_counters(tiles, "rate", steps, 300_000,
                                  onehot) is None
    # gappy tiles
    gv, gts, gvals = _arrays(S=16, gappy=True)
    gappy = state.tiles_from_numpy([{}] * 16, BASE, DT, gv, gts, gvals,
                                   device="cpu")
    steps = np.arange(BASE + 400_000, BASE + 1_000_000, 60_000,
                      dtype=np.int64)
    assert ptst.groupsum_counters(gappy, "rate", steps, 300_000,
                                  onehot) is None
    # window not a whole number of steps
    assert ptst.groupsum_counters(tiles, "rate", steps, 290_000,
                                  onehot) is None
    # window/step beyond the merged-stream row cap
    steps = np.arange(BASE + 900_000, BASE + 2_000_000, 10_000,
                      dtype=np.int64)
    assert ptst.groupsum_counters(tiles, "rate", steps, 600_000,
                                  onehot) is None
    # non-finite values
    bad = vals.copy()
    bad[:, 5] = np.inf
    badt = state.tiles_from_numpy([{}] * 16, BASE, DT, valid, ts, bad,
                                  device="cpu")
    steps = np.arange(BASE + 400_000, BASE + 1_000_000, 60_000,
                      dtype=np.int64)
    assert ptst.groupsum_counters(badt, "rate", steps, 300_000,
                                  onehot) is None
    # and the eligible query is served
    assert ptst.groupsum_counters(tiles, "rate", steps, 300_000,
                                  onehot) is not None


@pytest.mark.parametrize("func", ["rate", "increase", "delta"])
def test_groupsum_counters_matches_jax_dispatcher(func):
    jt, pt = _pair(S=64)
    steps = _grid()
    gid = np.arange(64) % 4
    onehot = np.zeros((64, 4), np.float32)
    onehot[np.arange(64), gid] = 1.0
    want = jtst.groupsum_counters(jt, func, steps, 300_000,
                                  jnp.asarray(onehot), interpret=True)
    got = ptst.groupsum_counters(pt, func, steps, 300_000, onehot)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-7)


# ragged tiles: rows of unequal extent, each one run of samples, as a
# peer's span-bounded series lie beside an entry node's whole series. The
# grid of _grid() with a 300 s window reads slots 10 to 238: READ_LO is
# the first window's first in-window slot, READ_HI the last window's end.
READ_LO, READ_HI = 10, 238


def _ragged(S=64, N=288, seed=11):
    valid, ts, vals = _arrays(S=S, N=N, seed=seed)
    rng = np.random.default_rng(seed)
    first = rng.integers(0, READ_LO + 1, S)
    last = rng.integers(READ_HI, N, S)
    first[:S // 4] = 0              # a quarter of the rows are whole
    last[:S // 4] = N - 1
    k = np.arange(N)[None, :]
    valid = (k >= first[:, None]) & (k <= last[:, None])
    return valid, ts, vals


def _slide_args(tiles, steps, window):
    return (tiles, steps.size, int(steps[0] - window), int(steps[0]),
            int(steps[-1]), int(steps[1] - steps[0]))


@pytest.mark.parametrize("func", ["rate", "increase", "delta"])
def test_ragged_tiles_ride_the_slide_and_groupsum(func):
    """Rows that are dense over the slots the grid reads take the slide
    evaluator and the group-sum, and both agree with the f32 evaluator
    that reads no slot outside each window (_eval_counter_fast) and with
    the JAX package, which declines the slide on any ragged tile."""
    valid, ts, vals = _ragged()
    S = valid.shape[0]
    keys = [{"i": str(i)} for i in range(S)]
    assert not valid.all()
    pt = state.tiles_from_numpy(keys, BASE, DT, valid, ts, vals,
                                device="cpu")
    jt = jtst.AlignedTiles(keys, BASE, DT, valid, ts, vals)
    steps, window = _grid(), 300_000
    assert ptst._slide_eligible(*_slide_args(pt, steps, window)) is not None
    assert pt.dense_over(READ_LO, READ_HI)
    assert not pt.dense_over(0, READ_HI)
    got = ptst.evaluate_counters_t(pt, func, steps, window).numpy()
    w0e = int(steps[0])
    fast = ptst._eval_counter_fast(
        func, steps.size, ptst._tiles_arrays_fast(pt, func), pt.num_slots,
        pt.base_ms, pt.dt_ms, w0e - window, w0e,
        int(steps[1] - steps[0])).numpy()
    assert got.dtype == fast.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, fast)
    want = np.asarray(jtst.evaluate_counters_t(jt, func, steps, window))
    assert _ulps_apart(got, want, np.float32).max() <= 8
    # the group-sum's plain version over the same ragged tiles
    G = 4
    gid = np.arange(S) % G
    onehot = np.zeros((S, G), np.float32)
    onehot[np.arange(S), gid] = 1.0
    sums, cnts = ptst.groupsum_counters(pt, func, steps, window, onehot)
    nom = np.stack([fast[:, gid == g].astype(np.float64).sum(axis=1)
                    for g in range(G)], axis=1)
    np.testing.assert_array_equal(cnts.numpy(), np.full_like(nom, S // G))
    np.testing.assert_allclose(sums.numpy(), nom, rtol=1e-5,
                               atol=1e-6 * np.abs(nom).max())


def _one_row(first=0, last=287, gap=None):
    valid, ts, vals = _ragged()
    valid[0] = False
    valid[0, first:last + 1] = True
    if gap is not None:
        valid[0, gap] = False
    return valid, ts, vals


def test_ragged_guard_reads_exactly_the_grids_slots():
    """A row that holds samples over exactly the slots read passes; one
    slot less on either side declines."""
    steps, window = _grid(), 300_000
    for row, ok in (({"first": READ_LO, "last": READ_HI}, True),
                    ({"first": READ_LO + 1, "last": READ_HI}, False),
                    ({"first": READ_LO, "last": READ_HI - 1}, False)):
        valid, ts, vals = _one_row(**row)
        pt = state.tiles_from_numpy([{}] * valid.shape[0], BASE, DT, valid,
                                    ts, vals, device="cpu")
        el = ptst._slide_eligible(*_slide_args(pt, steps, window))
        assert (el is not None) == ok, row


@pytest.mark.parametrize("case,row", [
    ("gap inside the read range", {"gap": 100}),
    ("gap at the first slot read", {"gap": READ_LO}),
    ("gap at the last slot read", {"gap": READ_HI}),
    ("gap outside the read range", {"gap": 270}),
    ("row starts inside the range", {"first": READ_LO + 1}),
    ("row ends inside the range", {"last": READ_HI - 1}),
    ("empty row", {"first": 1, "last": 0}),
])
def test_ragged_tiles_guard_declines(case, row):
    """One row that is not a single run of samples over the slots read
    (or not a single run at all) turns the slide guard down, so the
    group-sum declines and the counter evaluators take the f32 path, whose
    answers match the JAX package's."""
    valid, ts, vals = _one_row(**row)
    S = valid.shape[0]
    keys = [{"i": str(i)} for i in range(S)]
    pt = state.tiles_from_numpy(keys, BASE, DT, valid, ts, vals,
                                device="cpu")
    steps, window = _grid(), 300_000
    assert ptst._slide_eligible(*_slide_args(pt, steps, window)) is None, \
        case
    onehot = np.ones((S, 1), np.float32)
    assert ptst.groupsum_counters(pt, "rate", steps, window, onehot) is None
    jt = jtst.AlignedTiles(keys, BASE, DT, valid, ts, vals)
    got = ptst.evaluate_counters_t(pt, "rate", steps, window).numpy()
    want = np.asarray(jtst.evaluate_counters_t(jt, "rate", steps, window))
    assert _ulps_apart(got, want, got.dtype).max() <= 8


def _cadence_rows(kind, rng):
    """Timestamp rows of one cadence shape for the alignment tests."""
    if kind == "jittered":
        return [(BASE + np.arange(200) * DT
                 + rng.integers(-2000, 2001, 200)).astype(np.int64)
                for _ in range(20)]
    if kind == "collisions":         # 10 s +/-6 s: slots collide
        return [(BASE + np.arange(200) * DT
                 + rng.integers(-6000, 6001, 200)).astype(np.int64)
                for _ in range(20)]
    if kind == "back to back":       # 50 s / 70 s rows, 10 s apart
        rows, t = [], BASE
        for i in range(30):
            rows.append(np.array([t, t + (50_000, 70_000)[i % 2]],
                                 dtype=np.int64))
            t = int(rows[-1][-1]) + 10_000
        return rows
    if kind == "ragged":             # lengths 0-3 and gaps
        return [np.sort(rng.choice(np.arange(40) * DT + BASE,
                                   int(rng.integers(0, 4)),
                                   replace=False)).astype(np.int64)
                for _ in range(30)]
    # unsorted rows, one with duplicate timestamps
    rows = [rng.permutation(BASE + np.arange(50) * DT).astype(np.int64)
            for _ in range(5)]
    rows.append(np.repeat(BASE + np.arange(25) * DT, 2).astype(np.int64))
    return rows


@pytest.mark.parametrize("kind", ["jittered", "collisions",
                                  "back to back", "ragged", "unsorted"])
def test_cadence_estimate_and_row_alignment_match_jax(kind):
    """The dt candidates (every row's diffs in one pass) and the rows that
    align (slot collisions found without np.unique) are the JAX
    package's, row for row."""
    from filodb_tpu.query.model import RawSeries as JRaw
    from filodb_tpu_torch.query.model import RawSeries as PRaw

    rng = np.random.default_rng(11)
    rows = _cadence_rows(kind, rng)
    vals = [np.cumsum(rng.random(t.size)) for t in rows]
    jser = [JRaw({"i": str(i)}, t, v) for i, (t, v) in
            enumerate(zip(rows, vals))]
    pser = [PRaw({"i": str(i)}, t, v) for i, (t, v) in
            enumerate(zip(rows, vals))]
    cands = ptst._estimate_dt_candidates(pser)
    assert cands == jtst._estimate_dt_candidates(jser)
    for dt in cands + [DT]:
        prow, pidx, plo, phi = ptst._align_rows(pser, dt)
        jrow, jidx, jlo, jhi = jtst._align_rows(jser, dt)
        assert (pidx, plo, phi) == (jidx, jlo, jhi)
        for a, b in zip(prow, jrow):
            np.testing.assert_array_equal(a[1], b[1])
