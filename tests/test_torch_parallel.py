"""The port's mesh and scatter-gather executor
(``filodb_tpu_torch/parallel/mesh.py``) on the CPU, held against the
numpy oracle (``rangefn.evaluate`` per series, then the aggregation) as
``tests/test_parallel.py`` holds the JAX package's, and against the JAX
``MeshExecutor`` at 8 shard partitions (the layout where the reference's
collective holds its own oracle).

Layouts: 8 shard partitions, 4 x 2 (shard x time) and 1, 2 and 4, laid on
the CPU. Tolerance: rtol 1e-9 against the oracle and the reference (the
reference test's), topk winners exact. The collectives and the partition
count of ``FILODB_MESH_PARTITIONS`` (``local_devices``) are tested
alone."""

import numpy as np
import pytest
import torch

import jax

from filodb_tpu.parallel.mesh import MeshExecutor as JMeshExecutor
from filodb_tpu.parallel.mesh import make_mesh as j_make_mesh
from filodb_tpu.query.model import RawSeries as JRawSeries
from filodb_tpu_torch import parallel
from filodb_tpu_torch.parallel import mesh as pmesh
from filodb_tpu_torch.parallel.mesh import (MeshExecutor, make_mesh,
                                            pack_sharded)
from filodb_tpu_torch.query import rangefn as rf
from filodb_tpu_torch.query.model import RangeParams, RawSeries

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
PARAMS = RangeParams(300_000, 60_000, 1_200_000)
WINDOW = 300_000
LAYOUTS = [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2)]


def _mk_series(seed, n_series, t0=10_000, dt=10_000, n=120, counter=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_series):
        ts = t0 + np.arange(n, dtype=np.int64) * dt \
            + rng.integers(-500, 500, n)
        ts = np.sort(ts)
        if counter:
            vals = np.cumsum(rng.uniform(0, 5, n))
        else:
            vals = rng.normal(10, 3, n)
        out.append(RawSeries({"job": f"j{i % 3}", "i": str(i)}, ts, vals,
                             is_counter=counter))
    return out


def _oracle_agg(series, params, func, window_ms, agg, group_of):
    groups = {}
    for s in series:
        row = rf.evaluate(func, s.ts, s.values, params.start_ms,
                          params.step_ms, params.end_ms, window_ms)
        groups.setdefault(group_of(s), []).append(row)
    out = {}
    for g, rows in groups.items():
        m = np.vstack(rows)
        ok = ~np.isnan(m)
        cnt = ok.sum(axis=0)
        with np.errstate(invalid="ignore"):
            if agg == "sum":
                r = np.where(ok, m, 0.0).sum(axis=0)
            elif agg == "avg":
                r = np.where(ok, m, 0.0).sum(axis=0) / cnt
            elif agg == "count":
                r = cnt.astype(float)
            elif agg == "min":
                r = np.nanmin(np.where(ok, m, np.inf), axis=0)
                r[np.isinf(r)] = np.nan
            elif agg == "max":
                r = np.nanmax(np.where(ok, m, -np.inf), axis=0)
                r[np.isinf(r)] = np.nan
        out[g] = np.where(cnt > 0, r, np.nan)
    return out


def _ex(ndev, tp=1):
    return MeshExecutor(make_mesh(ndev // tp, tp, [CPU] * ndev))


def _by_job(series, n_groups):
    by_shard = [series[i::n_groups] for i in range(n_groups)]
    jobs = sorted({s.labels["job"] for s in series})
    gid = {j: i for i, j in enumerate(jobs)}
    return by_shard, jobs, [[gid[s.labels["job"]] for s in row]
                            for row in by_shard]


@pytest.mark.parametrize("ndev,tp", LAYOUTS)
@pytest.mark.parametrize("agg", ["sum", "avg", "count", "min", "max"])
def test_mesh_agg_matches_oracle(ndev, tp, agg):
    series = _mk_series(1, 64, counter=True)
    by_shard, jobs, gids = _by_job(series, 8)
    out = _ex(ndev, tp).window_aggregate(by_shard, PARAMS, "rate", WINDOW,
                                         agg, gids, len(jobs))
    oracle = _oracle_agg(series, PARAMS, "rate", WINDOW, agg,
                         lambda s: s.labels["job"])
    assert out.shape == (len(jobs), PARAMS.num_steps)
    for j, job in enumerate(jobs):
        np.testing.assert_allclose(out[j], oracle[job], rtol=1e-9,
                                   equal_nan=True)


@pytest.mark.parametrize("agg", ["sum", "avg", "count", "min", "max"])
def test_mesh_agg_matches_the_jax_executor(agg):
    series = _mk_series(1, 64, counter=True)
    by_shard, jobs, gids = _by_job(series, 8)
    out = _ex(8).window_aggregate(by_shard, PARAMS, "rate", WINDOW, agg,
                                  gids, len(jobs))
    j_by_shard = [[JRawSeries(dict(s.labels), s.ts, s.values,
                              is_counter=True) for s in row]
                  for row in by_shard]
    want = JMeshExecutor(j_make_mesh(8, 1, jax.devices()[:8])) \
        .window_aggregate(j_by_shard, PARAMS, "rate", WINDOW, agg, gids,
                          len(jobs))
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-9,
                               equal_nan=True)


def test_mesh_time_parallel_matches():
    """4-way shard x 2-way time: the same answer as the oracle."""
    series = _mk_series(2, 32)
    by_shard = [series[i::4] for i in range(4)]
    gids = [[0] * len(row) for row in by_shard]
    out = _ex(8, 2).window_aggregate(by_shard, PARAMS, "sum_over_time",
                                     WINDOW, "sum", gids, 1)
    oracle = _oracle_agg(series, PARAMS, "sum_over_time", WINDOW, "sum",
                         lambda s: 0)
    np.testing.assert_allclose(out[0], oracle[0], rtol=1e-9, equal_nan=True)


@pytest.mark.parametrize("func,agg", [("min_over_time", "min"),
                                      ("max_over_time", "max")])
def test_mesh_gather_funcs(func, agg):
    """Order-statistic range functions route through _window_gather."""
    series = _mk_series(9, 16)
    by_shard = [series[i::8] for i in range(8)]
    gids = [[0] * len(r) for r in by_shard]
    out = _ex(8).window_aggregate(by_shard, PARAMS, func, WINDOW, agg,
                                  gids, 1)
    oracle = _oracle_agg(series, PARAMS, func, WINDOW, agg, lambda s: 0)
    np.testing.assert_allclose(out[0], oracle[0], rtol=1e-9, equal_nan=True)


def test_mesh_empty_step_grid():
    series = _mk_series(10, 8)
    by_shard = [series[i::8] for i in range(8)]
    gids = [[0] * len(r) for r in by_shard]
    out = _ex(8).window_aggregate(
        by_shard, RangeParams(300_000, 60_000, 200_000), "rate", WINDOW,
        "sum", gids, 1)
    assert out.shape == (1, 0)


def test_mesh_ragged_shards():
    """Shards with different series counts / sample counts pad cleanly."""
    series = _mk_series(3, 20)
    by_shard = [series[:1], series[1:4], series[4:10], series[10:11],
                series[11:15], series[15:16], series[16:19], series[19:]]
    gids = [[0] * len(r) for r in by_shard]
    out = _ex(8).window_aggregate(by_shard, PARAMS, "avg_over_time",
                                  WINDOW, "avg", gids, 1)
    oracle = _oracle_agg(series, PARAMS, "avg_over_time", WINDOW, "avg",
                         lambda s: 0)
    np.testing.assert_allclose(out[0], oracle[0], rtol=1e-9, equal_nan=True)


def test_shard_groups_must_divide_the_shard_axis():
    series = _mk_series(3, 6)
    with pytest.raises(ValueError):
        _ex(4).window_aggregate([series[:3], series[3:], []], PARAMS,
                                "rate", WINDOW, "sum", [[0] * 3, [0] * 3,
                                                        []], 1)
    with pytest.raises(ValueError):
        _ex(2).window_aggregate([series], PARAMS, "rate", WINDOW,
                                "quantile", [[0] * 6], 1)


def test_pack_sharded_shapes():
    series = _mk_series(4, 6, n=100)
    ts, vals, lens, keys = pack_sharded([series[:4], series[4:]])
    assert ts.shape[0] == 2 and ts.shape[1] == 4
    assert ts.shape[2] >= 100 and (ts.shape[2] & (ts.shape[2] - 1)) == 0
    assert lens[1, 2] == 0          # padding series empty
    assert len(keys[0]) == 4 and len(keys[1]) == 2


def test_mesh_absent_over_time_padding_not_counted():
    """Padding rows must not leak absent_over_time=1.0 into group 0."""
    by_shard = [_mk_series(5, 3)] + [[] for _ in range(7)]
    gids = [[0, 0, 0]] + [[] for _ in range(7)]
    ex = _ex(8)
    out = ex.window_aggregate(by_shard, PARAMS, "absent_over_time",
                              WINDOW, "sum", gids, 1)
    assert np.all(np.isnan(out[0]))
    cnt = ex.window_aggregate(by_shard, PARAMS, "present_over_time",
                              WINDOW, "count", gids, 1)
    assert np.nanmax(cnt[0]) == 3.0


def _oracle_topk(series, k, bottom):
    rows = np.vstack([rf.evaluate("rate", s.ts, s.values, PARAMS.start_ms,
                                  PARAMS.step_ms, PARAMS.end_ms, WINDOW)
                      for s in series])
    win = np.zeros(rows.shape, bool)
    for t in range(rows.shape[1]):
        col = np.where(np.isnan(rows[:, t]), -np.inf,
                       -rows[:, t] if bottom else rows[:, t])
        order = np.argsort(-col, kind="stable")[:k]
        win[order[np.isfinite(col[order])], t] = True
    return rows, win


@pytest.mark.parametrize("ndev,tp", [(8, 1), (4, 2), (1, 1)])
@pytest.mark.parametrize("bottom", [False, True])
def test_mesh_topk_winners_match_oracle(ndev, tp, bottom):
    series = _mk_series(6, 24, counter=True)
    by_shard = [series[i::8] for i in range(8)]
    gids = [[0] * len(r) for r in by_shard]
    vals, ids, s_pad = _ex(ndev, tp).window_topk(
        by_shard, PARAMS, "rate", WINDOW, 3, bottom, gids, 1)
    T = PARAMS.num_steps
    assert vals.shape == ids.shape == (1, T, 3)
    rows, win = _oracle_topk(series, 3, bottom)
    index = {id(s): n for n, s in enumerate(series)}
    for t in range(T):
        got = {index[id(by_shard[r // s_pad][r % s_pad])]
               for r in ids[0, t] if r >= 0}
        assert got == set(np.nonzero(win[:, t])[0]), t
        for v, r in zip(vals[0, t], ids[0, t]):
            if r >= 0:
                s = index[id(by_shard[r // s_pad][r % s_pad])]
                assert v == rows[s, t] or np.isclose(v, rows[s, t],
                                                     rtol=1e-9)


def test_topk_takes_the_lower_index_among_ties():
    """jax.lax.top_k's order among equal values (the lower index first),
    which torch.topk leaves unspecified on CUDA."""
    score = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]], dtype=torch.float64)
    v, i = pmesh._topk_first(score, 2)
    assert i.tolist() == [[1, 2]] and v.tolist() == [[3.0, 3.0]]


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def test_collectives_reduce_in_partition_order():
    f64 = torch.float64
    parts = [torch.tensor([1e16, 1.0], dtype=f64),
             torch.tensor([1.0, 2.0], dtype=f64),
             torch.tensor([-1e16, 3.0], dtype=f64)]
    # ((1e16 + 1) - 1e16): the order of the adds shows in the result
    assert pmesh.psum(parts).tolist() == [0.0, 6.0]
    assert pmesh.pmin(parts).tolist() == [-1e16, 1.0]
    assert pmesh.pmax(parts).tolist() == [1e16, 3.0]
    assert pmesh.all_gather(parts).shape == (3, 2)


def test_local_devices_lays_partitions_round_robin(monkeypatch):
    monkeypatch.delenv(pmesh.PARTITIONS_ENV, raising=False)
    assert pmesh.local_devices("cpu") == [CPU]
    monkeypatch.setenv(pmesh.PARTITIONS_ENV, "4")
    assert pmesh.local_devices("cpu") == [CPU] * 4
    m = make_mesh(devices=pmesh.local_devices("cpu"))
    assert m.shape == {"shard": 4, "time": 1}
    assert m.axis_names == ("shard", "time") and m.devices.shape == (4, 1)
    monkeypatch.setenv(pmesh.PARTITIONS_ENV, "0")
    with pytest.raises(ValueError):
        pmesh.local_devices("cpu")


def test_local_devices_default_to_cuda_and_refuse_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pmesh.local_devices()
    with pytest.raises(RuntimeError):
        make_mesh()


def test_make_mesh_rejects_a_grid_that_does_not_match():
    with pytest.raises(ValueError):
        make_mesh(3, 2, [CPU] * 4)


def test_the_package_exports_the_executor_lazily():
    assert parallel.MeshExecutor is MeshExecutor
    assert parallel.pack_sharded is pack_sharded
    with pytest.raises(AttributeError):
        parallel.no_such_name  # noqa: B018
