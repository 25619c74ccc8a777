"""The port's micro-batcher (filodb_tpu_torch.query.batcher) and the
batched evaluators it dispatches, on the CPU.

  * the seven mechanics and parity tests of tests/test_batcher.py, on
    ``TorchBackend(device="cpu")``: batched and unbatched answers bit for
    bit equal, inline and executor-queued;
  * ``tilestore.evaluate_counters_t_batch`` (families slide, fast, t) and
    ``evaluate_aligned_batch`` (every non-counter function of
    ALIGNED_FUNCS) against the JAX package's twins on the same tiles, and
    every member bit for bit the port's own scalar evaluator;
  * ``_window_endpoint``/``_window_gather`` with per-row ([S]) grids
    against ``filodb_tpu.query.tpu``'s, and each row group bit for bit the
    port's scalar-grid call, including a gather cut into several chunks.

Tolerances, port against JAX, as tests/test_torch_functions.py and
tests/test_torch_tilestore.py state them: the f32 counter evaluators
within 8 f32 ulps, the exact one within 4 f64 ulps; endpoint selections
and counts bit-equal; irate/timestamp and the packed rate family within 4
f64 ulps; quantile within 2; the prefix-sum family within the bound
derived from each row's prefix magnitude.
"""

import threading

import numpy as np
import pytest
import torch

from filodb_tpu.query import tilestore as jtst
from filodb_tpu.query import tpu as jtpu
from filodb_tpu_torch.query import backend as pb
from filodb_tpu_torch.query import qos
from filodb_tpu_torch.query import rangefn as rf
from filodb_tpu_torch.query import tilestore as ptst
from filodb_tpu_torch.query.batcher import (DeviceExecutor, MicroBatcher,
                                            SplitResult)
from filodb_tpu_torch.query.backend import TorchBackend
from filodb_tpu_torch.query.model import RangeParams, RawSeries

from test_torch_functions import (COUNTER_FAMILY, ENDPOINT_FUNCS,
                                  GATHER_CASES, PACKED_T, PACKED_W0S, STEP,
                                  WINDOW, _aligned_case, _check_jax,
                                  _packed, _row_prefix_ulps, _w_bound)
from test_torch_tilestore import _FAMILIES, _pair, _ulps_apart

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

BASE = 1_600_000_000_000


def _series(n=300, S=5, regular=True, counter=True, seed=0, snap=True):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(S):
        if regular:
            ts = BASE + np.arange(n, dtype=np.int64) * 10_000
        else:
            ts = BASE + np.cumsum(
                rng.integers(8_000, 12_000, n)).astype(np.int64)
        vals = np.cumsum(rng.random(n) * 4).astype(np.float64)
        out.append(RawSeries(
            {"i": str(s)}, ts, vals, is_counter=counter,
            snapshot_key=("ds", 0, s, 7, 0) if snap else None,
            chunk_len=n if snap else -1))
    return out


def _params(k, nsteps=16, step=60_000):
    start = BASE + 600_000 + k * step
    return RangeParams(start, step, start + (nsteps - 1) * step)


def _backend(**kw):
    return TorchBackend(device="cpu", batcher=MicroBatcher(**kw))


def _run_concurrent(backend, series, func, window_ms, n=8, nsteps=16):
    """n same-shape queries released together through the backend ->
    {k: values}."""
    outs = {}
    lock = threading.Lock()
    barrier = threading.Barrier(n)

    def worker(k):
        barrier.wait()
        g = backend.periodic_samples(series, _params(k, nsteps=nsteps),
                                     func, window_ms)
        with lock:
            outs[k] = g.values
    ths = [threading.Thread(target=worker, args=(k,)) for k in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
        assert not t.is_alive()
    return outs


@pytest.mark.parametrize("use_executor", [False, True],
                         ids=["cpu-inline", "executor-queued"])
@pytest.mark.parametrize("func,regular,window_ms", [
    ("rate", True, 300_000),           # aligned slide family
    ("avg_over_time", True, 600_000),  # aligned evaluator
    ("rate", False, 300_000),          # packed path (vs the extract path)
    ("max_over_time", False, 300_000),  # packed gather family
    ("sum_over_time", False, 300_000),  # packed prefix-sum family
])
def test_batched_equals_unbatched_bit_for_bit(func, regular, window_ms,
                                              use_executor):
    series = _series(regular=regular)
    ref_backend = _backend(enabled=False)
    refs = {k: ref_backend.periodic_samples(
        series, _params(k), func, window_ms).values for k in range(8)}
    backend = _backend(use_executor=use_executor)
    try:
        for _ in range(3):      # repeat: batch composition varies per run
            outs = _run_concurrent(backend, series, func, window_ms)
            for k in range(8):
                assert np.array_equal(outs[k], refs[k], equal_nan=True), \
                    (func, regular, use_executor, k)
    finally:
        backend.batcher.executor.stop(10)
    snap = backend.batcher.stats.snapshot()
    assert snap["queries"] >= 24
    assert snap["occupancy_max"] >= 1


def test_batched_queries_actually_batch():
    """With the executor-queued mode and a barrier start, most of the 8
    concurrent same-shape queries share dispatches."""
    series = _series()
    backend = _backend(use_executor=True)
    try:
        for _ in range(3):
            _run_concurrent(backend, series, "rate", 300_000)
    finally:
        backend.batcher.executor.stop(10)
    snap = backend.batcher.stats.snapshot()
    assert snap["batched_queries"] > 0
    assert snap["occupancy_max"] >= 2
    assert snap["batches"] < snap["queries"]


def test_mixed_shapes_do_not_share_batches():
    """Queries with different step counts resolve to different batch keys
    and still match their unbatched references."""
    series = _series()
    ref_backend = _backend(enabled=False)
    backend = _backend(use_executor=True)
    refs, outs = {}, {}
    lock = threading.Lock()
    barrier = threading.Barrier(8)
    for k in range(8):
        nsteps = 16 if k % 2 == 0 else 31
        refs[k] = ref_backend.periodic_samples(
            series, _params(k, nsteps=nsteps), "rate", 300_000).values

    def worker(k):
        barrier.wait()
        nsteps = 16 if k % 2 == 0 else 31
        g = backend.periodic_samples(series, _params(k, nsteps=nsteps),
                                     "rate", 300_000)
        with lock:
            outs[k] = g.values
    ths = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    try:
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
            assert not t.is_alive()
    finally:
        backend.batcher.executor.stop(10)
    for k in range(8):
        assert np.array_equal(outs[k], refs[k], equal_nan=True), k


def test_shape_bucketing_is_invisible():
    """Pow2 S/T bucketing pads with sentinel rows/steps: results for
    non-pow2 series counts and step counts equal the reference computed
    series by series."""
    series = _series(S=5, regular=False, counter=False)
    backend = _backend(enabled=False)
    for nsteps in (3, 10, 17):
        g = backend.periodic_samples(series, _params(0, nsteps=nsteps),
                                     "sum_over_time", 300_000)
        assert g.values.shape == (5, nsteps)
        one = backend.periodic_samples(series[:1],
                                       _params(0, nsteps=nsteps),
                                       "sum_over_time", 300_000)
        assert np.array_equal(g.values[:1], one.values, equal_nan=True)
    assert backend.packed_dispatches == 6


def test_batch_failure_fails_all_members():
    b = MicroBatcher(use_executor=True)
    b.enter()
    b.enter()           # simulate a second in-flight query thread
    errs = []
    barrier = threading.Barrier(4)

    def run_batch(members):
        raise RuntimeError("kernel exploded")

    def worker(i):
        barrier.wait()
        try:
            b.submit("k", i, run_batch)
        except RuntimeError as e:
            errs.append(str(e))
    ths = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
        assert not t.is_alive()
    assert len(errs) == 4
    b.exit()
    b.exit()
    b.executor.stop(10)


def test_split_result_single_sync():
    calls = []

    class FakeDev(torch.Tensor):
        def cpu(self):
            calls.append(1)
            return torch.Tensor.cpu(self)

    dev = torch.arange(6, dtype=torch.float64).reshape(3, 2) \
        .as_subclass(FakeDev)
    sr = SplitResult(dev, 3)
    got = [sr.get(i) for i in range(3)]
    assert len(calls) == 1          # one device->host copy per batch
    assert isinstance(got[1], np.ndarray)
    assert np.array_equal(got[1], [2.0, 3.0])


def test_executor_owns_submissions_in_order():
    ex = DeviceExecutor()
    seen = []
    done = threading.Event()
    for i in range(5):
        ex.submit(lambda i=i: seen.append(i))
    ex.submit(done.set)
    assert done.wait(5)
    assert seen == [0, 1, 2, 3, 4]
    ex.stop(5)


def test_executor_runs_by_priority_then_arrival():
    """A queued interactive closure runs before a background one queued
    earlier; the executor survives a closure that raises."""
    ex = DeviceExecutor()
    gate = threading.Event()
    seen = []
    ex.submit(gate.wait)                    # hold the thread
    ex.submit(lambda: seen.append("bg1"), priority=1)
    ex.submit(lambda: 1 / 0, priority=1)
    ex.submit(lambda: seen.append("bg2"), priority=1)
    ex.submit(lambda: seen.append("int"), priority=0)
    gate.set()
    ex.stop(10)
    assert seen == ["int", "bg1", "bg2"]


def test_use_executor_resolves_from_the_device():
    assert MicroBatcher(device="cpu").use_executor is False
    assert MicroBatcher(device="cuda").use_executor is True
    assert MicroBatcher().use_executor is True      # None means CUDA
    be = TorchBackend(device="cpu")
    assert isinstance(be.batcher, MicroBatcher) and be.batcher.enabled
    assert be.batcher.use_executor is False
    assert TorchBackend(device="cpu", batcher=None).batcher is None


@pytest.mark.parametrize("raw,want", [
    (None, qos.PRIORITY_INTERACTIVE),
    ("", qos.PRIORITY_INTERACTIVE),
    ("rules", qos.PRIORITY_BACKGROUND),
    (" Background ", qos.PRIORITY_BACKGROUND),
    ("best-effort", qos.PRIORITY_BEST_EFFORT),
    ("bogus", qos.PRIORITY_INTERACTIVE),
])
def test_parse_priority(raw, want):
    assert qos.parse_priority(raw) == want


def test_qos_context_sets_the_batch_priority():
    """A query under an activated QoS context is filed under its class in
    the batcher's counters; the context is restored afterwards."""
    backend = _backend(use_executor=False)
    series = _series()
    assert qos.current() is None
    ctx = qos.QosContext(priority=qos.PRIORITY_BACKGROUND)
    with qos.activate(ctx):
        assert qos.capture() is ctx
        backend.periodic_samples(series, _params(0), "avg_over_time",
                                 300_000)
    assert qos.current_priority() == qos.PRIORITY_INTERACTIVE
    backend.periodic_samples(series, _params(1), "avg_over_time", 300_000)
    assert backend.batcher.stats.snapshot()["by_priority"] == {
        "background": 1, "interactive": 1}


# ---------------------------------------------------------------------------
# batched aligned evaluators against the JAX twins and the scalar path
# ---------------------------------------------------------------------------

B = 5


def _member_grids(steps, window, k_step):
    """B grids shifted by k * k_step -> (steps list, w0s list, w0e list)."""
    grids = [steps + k * k_step for k in range(B)]
    w0e = [int(g[0]) for g in grids]
    return grids, [e - window for e in w0e], w0e


def _nan_equal(a, b):
    return torch.equal(torch.nan_to_num(a, nan=7.0),
                       torch.nan_to_num(b, nan=7.0))


@pytest.mark.parametrize("func", COUNTER_FAMILY)
@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_counters_batch_matches_jax_and_scalar(family, func):
    kw, steps, window = _FAMILIES[family]
    jt, pt = _pair(**kw)
    step = int(steps[1] - steps[0])
    grids, w0s, w0e = _member_grids(steps[:-B], window, step)
    fam = ptst.counters_batch_family(pt, func, grids[0], window)
    assert fam == jtst.counters_batch_family(jt, func, grids[0], window)
    assert {ptst.counters_batch_family(pt, func, g, window)
            for g in grids} == {fam}
    assert fam[0] == family.split("-")[0]
    nsteps = grids[0].size
    got = ptst.evaluate_counters_t_batch(pt, func, fam, nsteps, step, w0s,
                                         w0e)
    assert tuple(got.shape) == (B, nsteps, len(pt.keys))
    for i, g in enumerate(grids):
        assert _nan_equal(got[i], ptst.evaluate_counters_t(pt, func, g,
                                                           window)), i
    want = np.asarray(jtst.evaluate_counters_t_batch(jt, func, fam, nsteps,
                                                     step, w0s, w0e))[:B]
    d = _ulps_apart(got.numpy(), want, got.numpy().dtype)
    assert d.max() <= (8 if got.dtype == torch.float32 else 4), d.max()


ALIGNED_BATCH_CASES = [(k, f) for k in ("jittered", "gaps")
                       for f in sorted(ptst.ALIGNED_FUNCS)
                       if f not in COUNTER_FAMILY]


@pytest.mark.parametrize("kind, func", ALIGNED_BATCH_CASES)
def test_aligned_batch_matches_jax_and_scalar(kind, func):
    A = _aligned_case(kind)
    steps = A["steps"]
    # the members' grids are the case's grid, offset by whole steps, so
    # the window statistics of the case hold for each of them
    grids = [steps[k:k + steps.size - B] for k in range(B)]
    w0e = [int(g[0]) for g in grids]
    w0s = [e - WINDOW for e in w0e]
    nsteps = grids[0].size
    got = ptst.evaluate_aligned_batch(A["pt"], func, nsteps, STEP, w0s, w0e)
    assert tuple(got.shape) == (B, len(A["rows"]), nsteps)
    want = np.asarray(jtst.evaluate_aligned_batch(A["jt"], func, nsteps,
                                                  STEP, w0s, w0e))[:B]
    for i, g in enumerate(grids):
        assert _nan_equal(got[i], ptst.evaluate_aligned(A["pt"], func, g,
                                                        WINDOW)), i
        stats = {k: (v[:, i:i + nsteps] if v.shape[1] == steps.size
                     else v) for k, v in A["stats"].items()}
        _check_jax(func, got[i].numpy(), want[i], stats)


def test_aligned_batch_refuses_the_counter_family():
    A = _aligned_case("jittered")
    with pytest.raises(ValueError):
        ptst.evaluate_aligned_batch(A["pt"], "rate", 4, STEP, [0, 1], [5, 6])


# ---------------------------------------------------------------------------
# per-row grids on the packed path
# ---------------------------------------------------------------------------

GROUPS = 3


def _row_grids(S):
    """Per-row grids: row r belongs to group r % GROUPS, whose grid starts
    g steps later and, for group 2, has a 90 s step -> (w0s, w0e, step)
    [S] int64 arrays and each group's (rows, steps)."""
    g = np.arange(S) % GROUPS
    step = np.where(g == 2, 90_000, STEP).astype(np.int64)
    w0s = (PACKED_W0S + g * STEP).astype(np.int64)
    w0e = w0s + WINDOW
    groups = []
    for k in range(GROUPS):
        rows = np.flatnonzero(g == k)
        st = int(step[rows[0]])
        groups.append((rows, int(w0s[rows[0]]), st,
                       int(w0e[rows[0]]) + np.arange(PACKED_T,
                                                     dtype=np.int64) * st))
    return w0s, w0e, step, groups


def _group_stats(P, rows, steps):
    """The window statistics _check_jax's prefix-sum bound reads, on one
    group's grid."""
    sub = [P["rows"][r] for r in rows]
    vals = P["arrays"][1][rows]

    def oracle(func):
        return np.vstack([rf.evaluate(func, t, v, int(steps[0]),
                                      int(steps[1] - steps[0]),
                                      int(steps[-1]), WINDOW)
                          for t, v in sub])
    return {"cnt": oracle("count_over_time"),
            "dm": oracle("avg_over_time"),
            "var": oracle("stdvar_over_time"),
            "ds": _row_prefix_ulps(vals), "ds2": _row_prefix_ulps(vals * vals)}


def _check_row_groups(func, P, got, want, groups, scalar_call):
    for rows, w0s, st, steps in groups:
        one = scalar_call(rows, w0s, st)
        assert _nan_equal(got[rows], one), (func, w0s, st)
        _check_jax(func, got[rows].numpy(), want[rows],
                   _group_stats(P, rows, steps))


@pytest.mark.parametrize("func", ENDPOINT_FUNCS)
def test_window_endpoint_per_row_grids(func):
    P = _packed(counters=func in COUNTER_FAMILY)
    ts, vals, lens = P["arrays"]
    w0s, w0e, step, groups = _row_grids(ts.shape[0])
    got = pb._window_endpoint(func, torch.from_numpy(ts),
                              torch.from_numpy(vals), torch.from_numpy(lens),
                              torch.from_numpy(w0s), torch.from_numpy(w0e),
                              torch.from_numpy(step), PACKED_T)
    want = np.asarray(jtpu._window_endpoint(func, ts, vals, lens, w0s, w0e,
                                            step, PACKED_T, 0.0))

    def scalar(rows, s, st):
        return pb._window_endpoint(
            func, torch.from_numpy(ts[rows]), torch.from_numpy(vals[rows]),
            torch.from_numpy(lens[rows]), s, s + WINDOW, st, PACKED_T)
    _check_row_groups(func, P, got, want, groups, scalar)


@pytest.mark.parametrize("chunked", [False, True], ids=["one-pass",
                                                        "chunked"])
@pytest.mark.parametrize("func, q", GATHER_CASES)
def test_window_gather_per_row_grids(func, q, chunked, monkeypatch):
    P = _packed()
    ts, vals, lens = P["arrays"]
    wb = _w_bound(P)
    w0s, w0e, step, groups = _row_grids(ts.shape[0])

    def scalar(rows, s, st):
        return pb._window_gather(
            func, wb, torch.from_numpy(ts[rows]), torch.from_numpy(vals[rows]),
            torch.from_numpy(lens[rows]), s, s + WINDOW, st, PACKED_T, q)
    if chunked:
        # 5 rows a chunk: the per-row grids are cut with their rows
        monkeypatch.setattr(pb, "GATHER_BUDGET_BYTES",
                            5 * PACKED_T * wb * pb._GATHER_ELT_BYTES)
    got = pb._window_gather(func, wb, torch.from_numpy(ts),
                            torch.from_numpy(vals), torch.from_numpy(lens),
                            torch.from_numpy(w0s), torch.from_numpy(w0e),
                            torch.from_numpy(step), PACKED_T, q)
    want = np.asarray(jtpu._window_gather(func, wb, ts, vals, lens, w0s,
                                          w0e, step, PACKED_T, q))
    _check_row_groups(func, P, got, want, groups, scalar)
