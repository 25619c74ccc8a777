"""The device mesh and scatter-gather execution of windowed range
functions with aggregation, in PyTorch (counterpart of
``filodb_tpu.parallel.mesh``).

The reference lays its distributed query tree (per-shard leaves gathered
by DistConcatExec / ReduceAggregateExec) onto a ``jax.sharding.Mesh`` with
two axes and runs it as one ``shard_map`` program:

  * shards ride the mesh's **'shard' axis**: each partition holds the
    series of its shard groups;
  * output query steps ride the **'time' axis**: each partition computes
    a contiguous slice of the step grid from its series (windows need
    only that partition's series, which are replicated along 'time');
  * the cross-shard aggregation tree is a collective over the 'shard'
    axis (``psum`` / ``pmin`` / ``pmax``), and a grouped (``by``)
    aggregation is a one-hot [S, G] matmul before it.

Here a :class:`Mesh` is a ('shard', 'time') grid of partitions, each a
``torch.device``; a device may stand in several cells, so one card can
hold 1, 2, 4 or more partitions (``local_devices``). Each partition's
work is the port's own evaluator on that partition's tensors, and the
collectives of this module combine the partials in one process, in
partition order, on the first partition's device: deterministic, and the
same answer whichever devices the cells name.

Wire format between host and device is dense padded tiles from
:func:`pack_sharded` (ragged series -> [shard group, S_pad, N_pad]).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from filodb_tpu_torch.lint.caches import cache_registry
from filodb_tpu_torch.lint.contracts import kernel_contract
from filodb_tpu_torch.lint.numerics import order_insensitive
from filodb_tpu_torch.query.backend import (_GATHER_FUNCS, _TS_PAD,
                                            _next_pow2, _window_endpoint,
                                            _window_gather,
                                            _window_sample_bound,
                                            clean_rows)
from filodb_tpu_torch.query.model import RangeParams, RawSeries
from filodb_tpu_torch.query.tilestore import resolve_device

F64 = torch.float64
I32 = torch.int32

# Aggregations executable as mesh collectives (AggrOverRangeVectors
# RowAggregator map/reduce protocol, aggregator/RowAggregator.scala:28).
MESH_AGGS = frozenset({"sum", "count", "avg", "min", "max", "group"})

# The counterpart of XLA's --xla_force_host_platform_device_count: the
# number of mesh partitions laid round-robin over the visible devices.
PARTITIONS_ENV = "FILODB_MESH_PARTITIONS"


def local_devices(device=None) -> List[torch.device]:
    """The partitions a mesh may use (the counterpart of
    ``jax.devices()``): every visible CUDA device, or the one device
    ``device`` names (``"cpu"`` for tests). With ``FILODB_MESH_PARTITIONS``
    = n in the environment, n partitions laid round-robin over those
    devices, so one card holds n partitions. Raises when CUDA is asked
    for (or defaulted to) and absent."""
    if device is None:
        base = resolve_device(None)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())] or [base]
    else:
        devs = [resolve_device(device)]
    n = os.environ.get(PARTITIONS_ENV)
    if n:
        k = int(n)
        if k < 1:
            raise ValueError(f"{PARTITIONS_ENV}={n}: need at least one")
        devs = [devs[i % len(devs)] for i in range(k)]
    return devs


class Mesh:
    """A ('shard', 'time') grid of partitions, each a ``torch.device``
    (the counterpart of ``jax.sharding.Mesh``): ``devices`` is the
    [n_shard, n_time] object array, ``shape`` maps each axis name to its
    size, ``axis_names`` is ('shard', 'time'). A device may repeat."""

    axis_names: Tuple[str, str] = ("shard", "time")

    def __init__(self, devices):
        devs = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            devs[idx] = torch.device(d)
        if devs.ndim != 2:
            raise ValueError("a mesh is a 2-D grid of devices")
        self.devices = devs
        self.shape = dict(zip(self.axis_names, devs.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The first partition's device: where collectives land."""
        return self.devices[0, 0]


def make_mesh(n_shard_groups: Optional[int] = None,
              time_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('shard', 'time') mesh over the available partitions
    (``local_devices()`` by default).

    n_shard_groups x time_parallel must equal the partition count; by
    default all partitions go on the shard axis (pure scatter-gather, like
    the reference's one-node-per-shard-group layout)."""
    devs = list(devices) if devices is not None else local_devices()
    n = len(devs)
    if n_shard_groups is None:
        n_shard_groups = n // time_parallel
    if n_shard_groups * time_parallel != n:
        raise ValueError(f"{n_shard_groups}x{time_parallel} != {n} devices")
    grid = np.empty((n_shard_groups, time_parallel), dtype=object)
    for k, d in enumerate(devs):
        grid[k // time_parallel, k % time_parallel] = d
    return Mesh(grid)


# ---------------------------------------------------------------------------
# collectives (one process, partition order, the first partition's device)
# ---------------------------------------------------------------------------

def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of the per-partition partials, added in partition order on the
    first partition's device."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return acc


def pmin(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.minimum(acc, p.to(acc.device))
    return acc


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(acc.device))
    return acc


def all_gather(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The partials stacked along a new leading axis, in partition order,
    on the first partition's device."""
    dev = parts[0].device
    return torch.stack([p.to(dev) for p in parts])


def pack_sharded(series_by_shard: Sequence[Sequence[RawSeries]],
                 drop_nan: bool = True,
                 s_pad: Optional[int] = None,
                 n_pad: Optional[int] = None,
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                            List[List[Dict[str, str]]]]:
    """Pack per-shard ragged series into [G, S, N] tiles (G = shard groups).

    Equalizes series-count and sample-count across shards by padding
    (pow2-bucketized, as the reference does for its compile cache).
    Padding series have len 0 and _TS_PAD timestamps so every evaluator
    treats them as empty."""
    G = len(series_by_shard)
    maxlen, maxs = 1, 1
    cleaned: List[List[Tuple[np.ndarray, np.ndarray]]] = []
    keys: List[List[Dict[str, str]]] = []
    for group in series_by_shard:
        row, ml = clean_rows(group, drop_nan)
        cleaned.append(row)
        keys.append([dict(s.labels) for s in group])
        maxlen = max(maxlen, ml)
        maxs = max(maxs, len(row))
    S = s_pad or _next_pow2(maxs, 1)
    N = n_pad or _next_pow2(maxlen)
    ts_pad = np.full((G, S, N), _TS_PAD, dtype=np.int64)
    vals_pad = np.zeros((G, S, N), dtype=np.float64)
    lens = np.zeros((G, S), dtype=np.int32)
    for g, row in enumerate(cleaned):
        for i, (ts, vals) in enumerate(row):
            n = ts.size
            ts_pad[g, i, :n] = ts
            vals_pad[g, i, :n] = vals
            lens[g, i] = n
    return ts_pad, vals_pad, lens, keys


def _grouped_reduce_check():
    """Shape check on the CPU: two partitions of [8, 16] f64 local
    results into [4, 16] f64 group rows."""
    loc = [torch.zeros((8, 16), dtype=F64) for _ in range(2)]
    gids = [torch.arange(8, dtype=I32) % 4 for _ in range(2)]
    out = _grouped_reduce(loc, gids, 4, "sum")
    if tuple(out.shape) != (4, 16) or out.dtype != F64:
        return f"grouped reduce {tuple(out.shape)}/{out.dtype} != (4,16) f64"
    return None


@order_insensitive(
    "grouped-reduce-psum", tolerance=1e-12,
    reason="the sum/avg family psums f64 per-partition partial "
           "aggregates whose grouping follows the shard-axis partition "
           "count; each partial is a one-hot matmul of at most "
           "S/n_partitions f64 terms, so regrouping moves the result by "
           "at most a few f64 ulps — certified at 1/2/4/8 partitions. "
           "min/max ride pmin/pmax (order-free) and counts are integers "
           "in f64 (exact below 2**53)")
@kernel_contract(
    "mesh_grouped_reduce", kind="eager",
    check=_grouped_reduce_check,
    notes="per-partition one-hot [S,G] f64 matmul / scatter min-max, "
          "then psum/pmin/pmax over the 'shard' axis in partition order: "
          "ReduceAggregateExec as a collective")
def _grouped_reduce(local: Sequence[torch.Tensor],
                    gids: Sequence[torch.Tensor], num_groups: int,
                    agg: str) -> torch.Tensor:
    """Per-partition [S_l, T] windowed results + [S_l] group ids (one
    entry per partition along the 'shard' axis) -> the [G, T] aggregate,
    each partition's partial computed on its own device, then the
    collective.

    The sum family runs as a one-hot [S, G] f64 matmul; min/max as
    scatter reductions; NaN (stale/empty) entries contribute nothing.
    Mean is sum/count reduced separately.

    Padding rows carry the sentinel gid -1: their one-hot row is all-zero
    and their entries are masked out, so functions that map empty rows to
    non-NaN values (absent_over_time -> 1.0) cannot contaminate group 0,
    while a REAL series with zero samples still aggregates normally."""
    cnt, val = grouped_partials(local, gids, num_groups, agg)
    return grouped_finish(cnt, val, agg)


def grouped_partials(local: Sequence[torch.Tensor],
                     gids: Sequence[torch.Tensor], num_groups: int,
                     agg: str) -> Tuple[torch.Tensor,
                                        Optional[torch.Tensor]]:
    """The collective's operands over these partitions: the [G, T] f64
    counts of present values (psummed) and, for sum/avg, their sums
    (psummed), for min/max their minima/maxima (pmin/pmax); None for
    count/group. ``window_aggregate_distributed`` reduces them once more
    across processes before :func:`grouped_finish`."""
    if agg not in MESH_AGGS:
        raise ValueError(f"unhandled mesh agg {agg}")
    cnts, vals = [], []
    for loc, g in zip(local, gids):
        dev = loc.device
        loc = loc.to(F64)
        g = g.to(device=dev, dtype=torch.int64)
        valid = (g >= 0)[:, None]                       # [S, 1]
        ok = ~torch.isnan(loc) & valid
        g0 = torch.where(valid[:, 0], g, torch.zeros_like(g))
        onehot = ((g0[:, None] == torch.arange(num_groups, device=dev)
                   [None, :]) & valid).to(F64)          # [S, G]
        cnts.append(onehot.T @ ok.to(F64))              # [G, T]
        if agg in ("sum", "avg"):
            zero = torch.zeros((), dtype=F64, device=dev)
            vals.append(onehot.T @ torch.where(ok, loc, zero))
        elif agg in ("min", "max"):
            big = float("inf") if agg == "min" else float("-inf")
            masked = torch.where(ok, loc, torch.full((), big, dtype=F64,
                                                     device=dev))
            red = torch.full((num_groups, loc.shape[1]), big, dtype=F64,
                             device=dev)
            red.scatter_reduce_(0, g0[:, None].expand_as(masked), masked,
                                "amin" if agg == "min" else "amax",
                                include_self=True)
            vals.append(red)
    val = None
    if agg in ("sum", "avg"):
        val = psum(vals)
    elif agg in ("min", "max"):
        val = (pmin if agg == "min" else pmax)(vals)
    return psum(cnts), val


def grouped_finish(cnt: torch.Tensor, val: Optional[torch.Tensor],
                   agg: str) -> torch.Tensor:
    """The [G, T] aggregate from the reduced operands of
    :func:`grouped_partials`: NaN where a group has no present value."""
    nan = torch.full((), float("nan"), dtype=F64, device=cnt.device)
    if agg == "count":
        return torch.where(cnt > 0, cnt, nan)
    if agg == "group":
        return torch.where(cnt > 0, torch.ones_like(cnt), nan)
    val = val.to(cnt.device)
    if agg == "avg":
        val = val / cnt
    return torch.where(cnt > 0, val, nan)


def _topk_first(score: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, the lower index first among
    equal values (``jax.lax.top_k``'s order; ``torch.topk`` leaves it
    unspecified on CUDA): a stable descending sort, cut to k."""
    v, i = torch.sort(score, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# cache inventory: the port builds nothing per shape (eager ops); the
# executor's first-sight key set closes over ONE mesh instance and keys
# on the kernel shape — world-independent by construction; a topology
# change builds a new executor, never mutates this one
@cache_registry("mesh-executable", keyed=("mesh", "kernel-shape"))
class MeshExecutor:
    """Distributed query step executor over a ('shard', 'time') mesh.

    ``window_aggregate`` runs the reference's whole per-query pipeline
    below the planner (SelectRawPartitions, already packed, then
    PeriodicSamplesMapper, AggregateMapReduce and ReduceAggregate): each
    partition evaluates its series over its slice of the step grid, then
    the grouped collective combines the partitions."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        # first-sight keys for the dispatch telemetry (one executor is
        # driven by one query engine call at a time; a race would only
        # count a build twice)
        self._exec_seen: set = set()

    @property
    def ndev(self) -> int:
        """The mesh's partition count: every mesh dispatch key carries
        it, so /metrics and &explain=analyze show the 1/2/4/8-partition
        dispatches of one shape as distinct executables."""
        return self.mesh.size

    def _prepare_inputs(self, series_by_shard, params, func, window_ms,
                        group_ids_by_shard, offset_ms):
        """Shared packing/padding prologue for the windowed mesh entry
        points: [G,S,N] tiles, padded gid table, step-grid scalars and the
        per-window sample bound."""
        n_shard = self.mesh.shape["shard"]
        n_time = self.mesh.shape["time"]
        if len(series_by_shard) % n_shard:
            raise ValueError("shard groups must divide mesh shard axis")
        ts, vals, lens, _ = pack_sharded(series_by_shard,
                                         drop_nan=(func != "last_sample"))
        G, S, _ = ts.shape
        gids = np.full((G, S), -1, dtype=np.int32)   # -1 marks padding rows
        for g, row in enumerate(group_ids_by_shard):
            gids[g, :len(row)] = row
        steps = params.steps
        T = steps.size
        T_pad = -(-T // n_time) * n_time
        step = int(params.step_ms if T > 1 else 1)
        w0e = int(steps[0] - offset_ms)
        w0s = int(w0e - window_ms)
        w_bound = 0
        if func in _GATHER_FUNCS:
            all_series = [s for row in series_by_shard for s in row]
            w_bound = _window_sample_bound(all_series, window_ms,
                                           ts.shape[2])
        return (ts, vals, lens, gids, T, T_pad // n_time, step, w0s, w0e,
                w_bound, S)

    def _local_results(self, func, ts, vals, lens, gids, t_local, step,
                       w0s, w0e, w_bound, scalar):
        """Each partition's [S_l, t_local] windowed results and [S_l]
        group ids: ``out[j][i]`` for shard partition i on time slice j,
        on that partition's device."""
        mesh = self.mesh
        n_shard, n_time = mesh.devices.shape
        G, S, N = ts.shape
        gl = G // n_shard
        out = []
        for j in range(n_time):
            t_off = j * t_local * step
            col = []
            for i in range(n_shard):
                dev = mesh.devices[i, j]
                sl = slice(i * gl, (i + 1) * gl)
                ts2 = torch.as_tensor(ts[sl].reshape(gl * S, N), device=dev)
                vals2 = torch.as_tensor(vals[sl].reshape(gl * S, N),
                                        device=dev)
                lens2 = torch.as_tensor(lens[sl].reshape(-1), device=dev)
                gids2 = torch.as_tensor(gids[sl].reshape(-1), device=dev)
                if func in _GATHER_FUNCS:
                    local = _window_gather(func, w_bound, ts2, vals2, lens2,
                                           w0s + t_off, w0e + t_off, step,
                                           t_local, scalar)
                else:
                    local = _window_endpoint(func, ts2, vals2, lens2,
                                             w0s + t_off, w0e + t_off, step,
                                             t_local)
                col.append((local, gids2))
            out.append(col)
        return out

    def window_aggregate(self,
                         series_by_shard: Sequence[Sequence[RawSeries]],
                         params: RangeParams,
                         function: str,
                         window_ms: int,
                         agg: str,
                         group_ids_by_shard: Sequence[Sequence[int]],
                         num_groups: int,
                         func_args: Sequence[float] = (),
                         offset_ms: int = 0) -> np.ndarray:
        """Returns the [num_groups, T] aggregated grid."""
        if agg not in MESH_AGGS:
            raise ValueError(f"agg {agg} not mesh-executable")
        func = function or "last_sample"
        if params.steps.size == 0:
            return np.empty((num_groups, 0), dtype=np.float64)
        (ts, vals, lens, gids, T, t_local, step, w0s, w0e, w_bound,
         _) = self._prepare_inputs(series_by_shard, params, func,
                                   window_ms, group_ids_by_shard,
                                   offset_ms)
        sc = float(func_args[0]) if func_args else 0.0
        parts = self._local_results(func, ts, vals, lens, gids, t_local,
                                    step, w0s, w0e, w_bound, sc)
        out = torch.cat([
            _grouped_reduce([loc for loc, _ in col], [g for _, g in col],
                            num_groups, agg)
            for col in parts], dim=1)
        self._note_exec(("agg", func, agg, t_local, tuple(ts.shape),
                         self.ndev), (ts, vals, lens, gids), out)
        return out[:, :T].cpu().numpy()

    def window_topk(self,
                    series_by_shard: Sequence[Sequence[RawSeries]],
                    params: RangeParams,
                    function: str,
                    window_ms: int,
                    k: int,
                    bottom: bool,
                    group_ids_by_shard: Sequence[Sequence[int]],
                    num_groups: int,
                    func_args: Sequence[float] = (),
                    offset_ms: int = 0):
        """topk/bottomk over the mesh. Returns (values [G, T, k],
        row_ids [G, T, k], S_pad): row_id // S_pad is the shard group,
        row_id % S_pad the series index within it (-1 = empty slot).

        Each partition takes its per-group, per-step top k, the partials
        are gathered in partition order, and a second top k picks the
        winners (the TopBottomK reduce tree as a collective)."""
        func = function or "last_sample"
        k = int(k)
        if params.steps.size == 0:
            return (np.empty((num_groups, 0, k)),
                    np.full((num_groups, 0, k), -1, np.int32), 1)
        (ts, vals, lens, gids, T, t_local, step, w0s, w0e, w_bound,
         S) = self._prepare_inputs(series_by_shard, params, func,
                                   window_ms, group_ids_by_shard,
                                   offset_ms)
        sc = float(func_args[0]) if func_args else 0.0
        parts = self._local_results(func, ts, vals, lens, gids, t_local,
                                    step, w0s, w0e, w_bound, sc)
        sign = -1.0 if bottom else 1.0
        n_shard = self.mesh.shape["shard"]
        gl_rows = ts.shape[0] // n_shard * S
        cols_v, cols_i = [], []
        for col in parts:
            top_vs, top_ids = [], []
            for i, (local, g) in enumerate(col):
                dev = local.device
                ninf = torch.full((), float("-inf"), dtype=F64, device=dev)
                score = torch.where(torch.isnan(local), ninf, sign * local)
                score = torch.where((g >= 0)[:, None], score, ninf)
                row_ids = i * gl_rows + torch.arange(gl_rows, dtype=I32,
                                                     device=dev)
                ong = g[None, :] == torch.arange(num_groups,
                                                 device=dev)[:, None]
                sc_g = torch.where(ong[:, :, None], score[None, :, :],
                                   ninf)                      # [G, S_l, T_l]
                sc_t = sc_g.transpose(1, 2)                   # [G, T_l, S_l]
                kk = min(k, sc_t.shape[-1])
                top_v, top_i = _topk_first(sc_t, kk)
                ids = row_ids[top_i]
                if kk < k:
                    pad = sc_t.shape[:2] + (k - kk,)
                    top_v = torch.cat([top_v, torch.full(
                        pad, float("-inf"), dtype=F64, device=dev)], -1)
                    ids = torch.cat([ids, torch.full(
                        pad, -1, dtype=I32, device=dev)], -1)
                top_vs.append(top_v)
                top_ids.append(ids)
            all_v = all_gather(top_vs)                  # [n_sh, G, T_l, k]
            all_i = all_gather(top_ids)
            cat_v = all_v.permute(1, 2, 0, 3).reshape(
                num_groups, t_local, n_shard * k)
            cat_i = all_i.permute(1, 2, 0, 3).reshape(
                num_groups, t_local, n_shard * k)
            fin_v, slot = _topk_first(cat_v, k)         # [G, T_l, k]
            fin_ids = torch.gather(cat_i, -1, slot)
            ok = torch.isfinite(fin_v)
            cols_v.append(torch.where(ok, sign * fin_v, torch.full(
                (), float("nan"), dtype=F64, device=fin_v.device)))
            cols_i.append(torch.where(ok, fin_ids, torch.full(
                (), -1, dtype=I32, device=fin_v.device)))
        out_v = torch.cat(cols_v, dim=1)
        out_i = torch.cat(cols_i, dim=1)
        self._note_exec(("topk", func, k, bool(bottom), t_local,
                         tuple(ts.shape), self.ndev),
                        (ts, vals, lens, gids), (out_v, out_i))
        return (out_v[:, :T].cpu().numpy(), out_i[:, :T].cpu().numpy(), S)

    def _note_exec(self, key, inputs, out) -> None:
        """Dispatch telemetry of the mesh site (obs/devprof.py) per
        (kernel, shape, partition count) key: the key's first sight in
        this executor is its build, later dispatches hits. Feeds the
        filodb_executable_* families and the &explain=analyze
        executable attribution; the lazy cost probe holds shapes only."""
        import functools

        from filodb_tpu_torch.obs import devprof
        first = key not in self._exec_seen
        if first:
            self._exec_seen.add(key)
        sig = devprof.arg_sig(inputs)
        probe = None
        if first:
            probe = functools.partial(
                devprof.sig_cost, sig, devprof.arg_sig(
                    out if isinstance(out, tuple) else (out,)))
        devprof.note_dispatch("mesh", key, first, probe=probe, sig=sig)
