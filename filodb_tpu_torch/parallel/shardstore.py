"""Device-resident sharded tile serving, in PyTorch (counterpart of
``filodb_tpu.parallel.shardstore``).

The scatter-gather mesh executor (``parallel/mesh.py``) packs and ships
every query's series to the partitions. This module makes the SHARDED
tile store the thing queries dispatch from: the aligned tile store's
slot-major channels (``query/tilestore.py`` ``AlignedTiles``) are placed
ONCE across the ('shard', 'time') mesh (series on the shard axis: each
shard partition holds its S/n_shard slice of every [N, S] channel on its
device, replicated along the time axis) and the evaluators run per
partition:

  * per-series windowed evaluation calls the port's own
    ``_eval_counter_fast`` / ``_eval_core`` on each partition's series
    slice, over that partition's slice of the output step grid (the
    window scalars offset by ``j * t_local * step``, as the reference's
    ``axis_index`` does), so member (t, s) of the assembled grid is bit
    for bit the single-device value;
  * grouped aggregation is a per-partition f64 one-hot matmul of the
    local rates, summed over the shard partitions in partition order
    (``mesh.psum``);
  * cross-flush tile refreshes write the new slot columns INTO the
    capacity-padded channels (``_append_step``): the storage is reused in
    place (the counterpart of ``donate_argnums``), no second copy of the
    store during a rebuild.

Escape hatches: tiles must be dense (every slot valid) with the tile span
in int32 ms, exactly the fast-family eligibility of the single-device
dispatcher, and a query whose grid leaves the int32 range (or whose tiles
never qualified) takes the single-device tilestore path unchanged.
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from filodb_tpu_torch.lint.caches import cache_registry
from filodb_tpu_torch.lint.capacity import (capacity, drop_resident,
                                            ensure_residency_collector,
                                            record_resident)
from filodb_tpu_torch.lint.contracts import kernel_contract
from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.lint.numerics import order_insensitive, precision
from filodb_tpu_torch.parallel.mesh import (Mesh, _grouped_reduce,
                                            grouped_partials, make_mesh)
from filodb_tpu_torch.query import tilestore as tst
from filodb_tpu_torch.query.backend import _next_pow2

F64 = torch.float64
I32 = torch.int32

# cache inventory (graftlint): the dispatch keys of the sharded
# evaluators key purely on (kernel family, func, step shape, mesh shape),
# a pure function of the request shape and the partition layout
__cache_registry__ = {
    "shardstore-executables": {"keyed": ("kernel", "func", "shape-bucket",
                                         "mesh-shape")},
}

_COUNTERS = ("rate", "increase")


# ---------------------------------------------------------------------------
# In-place refresh step
# ---------------------------------------------------------------------------

@precision(
    "append-carry-exact", bits=53, rel_ulps=0,
    reason="the in-place append extends the counter-corrected channel "
           "in exact f64: absent counter resets in the appended block "
           "the carry and cumsum terms are all zero, so the refreshed "
           "channel is BITWISE the from-scratch rebuild (certified); "
           "with resets the carry value itself is still exact, only "
           "the add order differs from a rebuild")
def _append_step(tsr: torch.Tensor, v: torch.Tensor, cv: torch.Tensor,
                 new_tsr: torch.Tensor, new_v: torch.Tensor,
                 n_filled: int):
    """Zero-copy slot append: write a flush's new slot columns into the
    capacity-padded channels IN PLACE (the storage of ``tsr``, ``v`` and
    ``cv`` is reused; their ``data_ptr()`` does not change).

    The counter-corrected channel extends exactly like a full rebuild:
    the correction carry at the append point is read off the resident
    buffers (``cv[n-1] - v[n-1]``), the previous-sample chain starts at
    the last resident row, and drops accumulate through the appended
    block, so rate/increase over the refreshed store match a from-scratch
    rebuild (bit for bit when the appended span carries no counter
    resets; the carry is the same value either way)."""
    n = int(n_filled)
    k = new_v.shape[0]
    prev0 = v[n - 1:n]
    corr0 = cv[n - 1:n] - prev0
    prevs = torch.cat([prev0, new_v[:-1]], dim=0)
    drop = new_v < prevs
    zero = torch.zeros((), dtype=new_v.dtype, device=new_v.device)
    new_cv = new_v + torch.cumsum(torch.where(drop, prevs, zero),
                                  dim=0) + corr0
    tsr[n:n + k].copy_(new_tsr)
    v[n:n + k].copy_(new_v)
    cv[n:n + k].copy_(new_cv)
    return tsr, v, cv


# ---------------------------------------------------------------------------
# Sharded evaluators (per partition, then assembled)
# ---------------------------------------------------------------------------

def _sharded_counter_check():
    """Shape check on the CPU: a 1x1 mesh's counter evaluator over
    [64, 8] resident channels -> [16, 8] f32."""
    tiles = tst.AlignedTiles(
        [{"i": str(i)} for i in range(8)], 0, 10_000,
        np.ones((8, 64), bool),
        np.arange(64, dtype=np.float64)[None, :] * 10_000 + np.zeros((8, 1)),
        np.cumsum(np.ones((8, 64)), axis=1), device="cpu")
    st = ShardedTiles(make_mesh(1, 1, [torch.device("cpu")]), tiles)
    out = st.eval_counters("rate", 100_000 + np.arange(16) * 60_000,
                           60_000)
    if tuple(out.shape) != (16, 8) or out.dtype != torch.float32:
        return f"sharded counter eval {tuple(out.shape)}/{out.dtype}" \
            " != (16,8) f32"
    return None


@kernel_contract(
    "sharded_counter_eval", kind="eager",
    check=_sharded_counter_check,
    rel_time_bits=31, span_guard="ShardedTiles.query_fits",
    notes="slot-major counter fast path per partition of the "
          "('shard','time') mesh from device-resident sharded tiles; "
          "per-partition step-grid slices offset by j * t_local * step; "
          "bit for bit the single-device _eval_counter_fast values")
def _sharded_counter_eval(st: "ShardedTiles", func: str, t_local: int,
                          w0s: int, w0e: int, step: int,
                          grids: Optional[Tuple[Sequence[int],
                                                Sequence[int]]] = None):
    """``_eval_counter_fast`` on each partition's series slice over its
    slice of the step grid -> ``parts[j][i]`` ([t_local, S_l] f32 on
    partition (i, j)'s device). With ``grids`` = (w0s_list, w0e_list)
    each part is the batch of those grids, vmapped over the grid scalars
    as ``evaluate_counters_t_batch`` does ([B, t_local, S_l])."""
    args = (st.n_filled, st.base_ms, st.dt_ms)
    vch = "cv" if func in _COUNTERS else "v"
    parts = []
    for j in range(st.n_time):
        off = j * t_local * step
        col = []
        for i in range(st.n_shard):
            arrs = {"tsr": st._chan["tsr"][i][j],
                    "ff_v": st._chan[vch][i][j]}
            if grids is None:
                col.append(tst._eval_counter_fast(
                    func, t_local, arrs, *args, w0s + off, w0e + off,
                    step))
                continue
            body = functools.partial(tst._eval_counter_fast, func, t_local,
                                     arrs, *args)
            col.append(tst._vmap_grids(
                lambda s, e, sp, body=body, off=off: body(s + off, e + off,
                                                          sp),
                grids[0], grids[1], step, arrs["tsr"].device))
        parts.append(col)
    return parts


@capacity(
    "shardstore-resident-channels", bytes_per_sample=20.0, sharded=True,
    reason="the resident store keeps three [cap, S_pad] slot-major "
           "channels — int32 relative timestamps (4 B) + raw f64 "
           "values (8 B) + counter-corrected f64 values (8 B) = 20 B "
           "per PADDED slot (pow2 slot capacity, shard-aligned series "
           "pad); the non-counter _aligned placements are transient "
           "per-family row sets cleared on every refresh")
class ShardedTiles:
    """One aligned-tile cohort resident across the mesh: capacity-padded
    [cap, S_pad] slot-major channels (int32 relative timestamps, raw
    values, counter-corrected values), series sharded over the first
    mesh axis (shard partition i holds series [i*S_l, (i+1)*S_l) on its
    device, S_l = S_pad / n_shard; a time partition on another device
    holds a copy). Immutable except through :meth:`append_slots`."""

    def __init__(self, mesh: Mesh, tiles) -> None:
        self.mesh = mesh
        self.base_ms = int(tiles.base_ms)
        self.dt_ms = int(tiles.dt_ms)
        self.keys = list(tiles.keys)
        S = len(self.keys)
        N = int(tiles.num_slots)
        n_shard = int(mesh.shape[mesh.axis_names[0]])
        self.n_shard = n_shard
        self.n_time = int(mesh.shape[mesh.axis_names[1]])
        self.S = S
        self.S_pad = -(-S // n_shard) * n_shard
        self.S_l = self.S_pad // n_shard
        self.cap = _next_pow2(N, 64)
        self.n_filled = N
        ts = tiles.ts.to(F64)                                   # [S, N]
        host = {"tsr": (ts - self.base_ms).T.to(I32),
                "v": tiles.channel("v").to(F64).T,
                "cv": tiles.channel("cv").to(F64).T}
        # channel name -> per-(shard, time) partition tensor; cells of
        # one shard partition on the same device share one tensor
        self._chan: Dict[str, List[List[torch.Tensor]]] = {}
        for name, h in host.items():
            self._chan[name] = self._place_cols(h, N)
        # non-counter aligned channel placements of the current
        # snapshot: (id(tiles), channel set) -> (weakref to tiles, grid)
        self._aligned: Dict[Tuple, Tuple[object, List[List[
            Dict[str, torch.Tensor]]]]] = {}
        # runtime residency accounting: live device bytes under the
        # filodb_device_memory_bytes{family,shard} gauge, dropped when
        # the store is collected
        ensure_residency_collector()
        self._res_key = ("shardstore-resident-channels", str(n_shard),
                         id(self))
        weakref.finalize(self, drop_resident, *self._res_key)
        self._record_residency()

    def _per_partition(self, make) -> List[List[torch.Tensor]]:
        """``make(lo, hi, dev)`` (shard partition i's series [lo, hi) on
        ``dev``) for every cell of the mesh -> ``grid[i][j]``; the cells
        of one shard partition on the same device share one result."""
        out = []
        for i in range(self.n_shard):
            lo, hi = i * self.S_l, min((i + 1) * self.S_l, self.S)
            row, by_dev = [], {}
            for j in range(self.n_time):
                dev = self.mesh.devices[i, j]
                if str(dev) not in by_dev:
                    by_dev[str(dev)] = make(lo, hi, dev)
                row.append(by_dev[str(dev)])
            out.append(row)
        return out

    def _place_cols(self, h: torch.Tensor, N: int
                    ) -> List[List[torch.Tensor]]:
        """[N, S] slot-major channel -> each partition's capacity-padded
        [cap, S_l] slice of series on its device."""
        def make(lo, hi, dev):
            t = torch.zeros((self.cap, self.S_l), dtype=h.dtype, device=dev)
            if hi > lo:
                t[:N, :hi - lo].copy_(h[:, lo:hi])
            return t
        return self._per_partition(make)

    def _place_rows(self, h: torch.Tensor) -> List[List[torch.Tensor]]:
        """[S, ...] row-major array -> each partition's [S_l, ...] slice
        of series (zero rows past S) on its device."""
        def make(lo, hi, dev):
            t = torch.zeros((self.S_l,) + tuple(h.shape[1:]), dtype=h.dtype,
                            device=dev)
            if hi > lo:
                t[:hi - lo].copy_(h[lo:hi])
            return t
        return self._per_partition(make)

    @staticmethod
    def _distinct(grid) -> List:
        """Each distinct placed object of a partition grid once."""
        seen, out = set(), []
        for row in grid:
            for t in row:
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def _record_residency(self) -> None:
        """The store's logical bytes (one copy of each channel, as the
        reference's global arrays report): 20 x cap x S_pad, plus the
        row-major placements of the non-counter families."""
        nbytes = 20 * self.cap * self.S_pad
        for _, placed in list(self._aligned.values()):
            for a in placed[0][0].values():
                nbytes += int(a.element_size() * a.numel()) * self.n_shard
        record_resident(*self._res_key, nbytes)

    # -- eligibility -------------------------------------------------------

    @staticmethod
    def tiles_eligible(tiles) -> bool:
        """Build-time gate, mirroring the single-device fast-family
        guard: dense tiles whose whole span fits int32 ms."""
        return (tiles is not None and tiles._dense
                and len(tiles.keys) > 0
                and tiles.num_slots * tiles.dt_ms + tiles.dt_ms
                < tst._SENT_HI)

    def query_fits(self, steps: np.ndarray, window_ms: int,
                   offset_ms: int) -> bool:
        """Per-query span guard: the grid must sit in int32 ms relative
        to the tile base (the dispatcher's fits_i32 condition); wider
        grids take the single-device exact-f64 path."""
        if steps.size == 0:
            return False
        w0s = int(steps[0] - offset_ms) - window_ms
        return (tst._SENT_LO < w0s - self.base_ms
                and int(steps[-1] - offset_ms) - self.base_ms
                < tst._SENT_HI)

    def _grid(self, steps: np.ndarray, window_ms: int, offset_ms: int):
        nsteps = steps.size
        T_pad = -(-nsteps // self.n_time) * self.n_time
        w0e = int(steps[0] - offset_ms)
        w0s = int(w0e - window_ms)
        step = int(steps[1] - steps[0]) if nsteps > 1 else 1
        return T_pad // self.n_time, w0s, w0e, step

    def _mesh_key(self) -> Tuple:
        return (self.n_shard, self.n_time, int(self.mesh.devices.size))

    def _inputs(self) -> Tuple:
        return tuple(self._distinct(self._chan[n])
                     for n in ("tsr", "v", "cv"))

    def _assemble(self, parts, t_axis: int, s_axis: int) -> torch.Tensor:
        """``parts[j][i]`` (time slice j, shard partition i) -> one
        tensor on the first partition's device: shard partitions joined
        along ``s_axis``, then time slices along ``t_axis``."""
        dev = self.mesh.first
        return torch.cat([torch.cat([p.to(dev) for p in col], dim=s_axis)
                          for col in parts], dim=t_axis)

    # -- evaluation --------------------------------------------------------

    def eval_counters(self, func: str, steps: np.ndarray, window_ms: int,
                      offset_ms: int = 0) -> torch.Tensor:
        """rate/increase/delta from the resident store -> [T, S] f32 on
        the first partition's device (bit for bit the single-device
        fast path's values)."""
        t_local, w0s, w0e, step = self._grid(steps, window_ms, offset_ms)
        out = self._assemble(_sharded_counter_eval(
            self, func, t_local, w0s, w0e, step), 0, 1)
        tst.note_exec("mesh-tiles",
                      ("mesh-fast", func, t_local, self._mesh_key()),
                      self._inputs(), out)
        return out[:steps.size, :self.S]

    def eval_counters_batch(self, func: str, nsteps: int, step: int,
                            w0s_list: Sequence[int],
                            w0e_list: Sequence[int]) -> torch.Tensor:
        """One sharded evaluation of B counter grids -> [B, T, S] (the
        mesh-shaped micro-batch), each member vmapped over its grid
        scalars as ``evaluate_counters_t_batch`` does."""
        T_pad = -(-nsteps // self.n_time) * self.n_time
        t_local = T_pad // self.n_time
        out = self._assemble(_sharded_counter_eval(
            self, func, t_local, 0, 0, step,
            grids=(list(w0s_list), list(w0e_list))), 1, 2)
        key = ("mesh-fast-b", func, t_local, tst._pad_width(len(w0s_list)),
               self._mesh_key())
        tst.note_exec("mesh-tiles", key, self._inputs(), out)
        return out[:, :nsteps, :self.S]

    def _aligned_arrs(self, tiles, func: str
                      ) -> List[List[Dict[str, torch.Tensor]]]:
        """Sharded placement of the row-major channel set ``func`` needs
        (``tilestore._tiles_arrays``): parts[i][j] is partition (i, j)'s
        dict. Cached per (tiles snapshot, channel set), and only for the
        snapshot whose slot count the store holds: a query still on an
        older snapshot (served during a background rebuild, while
        ``append_slots`` runs on another thread) gets a placement of its
        own slots that no fresher query can find."""
        arrs = tst._tiles_arrays(tiles, func)
        key = (id(tiles), tuple(sorted(arrs)))
        got = self._aligned.get(key)
        if got is not None and got[0]() is tiles:
            return got[1]
        per_name = {k: self._place_rows(a) for k, a in arrs.items()}
        placed = [[{k: per_name[k][i][j] for k in arrs}
                   for j in range(self.n_time)]
                  for i in range(self.n_shard)]
        if int(tiles.num_slots) == self.n_filled:
            self._aligned[key] = (weakref.ref(tiles), placed)
            self._record_residency()
        return placed

    def _aligned_parts(self, tiles, func: str, run):
        placed = self._aligned_arrs(tiles, func)
        return [[run(placed[i][j], j) for i in range(self.n_shard)]
                for j in range(self.n_time)], placed

    @staticmethod
    def _placed_inputs(placed) -> Tuple:
        return tuple(tst._arr_inputs(placed[i][0])
                     for i in range(len(placed)))

    def eval_aligned(self, tiles, func: str, steps: np.ndarray,
                     window_ms: int, offset_ms: int = 0) -> torch.Tensor:
        """Non-counter aligned families from sharded channels -> [S, T]
        f64, bit for bit the single-device ``_eval_core``."""
        t_local, w0s, w0e, step = self._grid(steps, window_ms, offset_ms)
        args = (int(tiles.num_slots), self.base_ms, self.dt_ms)

        def run(arrs, j):
            off = j * t_local * step
            return tst._eval_core(func, t_local, arrs, *args, w0s + off,
                                  w0e + off, step)
        parts, placed = self._aligned_parts(tiles, func, run)
        out = self._assemble(parts, 1, 0)
        sig = tuple(sorted((k, v.dim()) for k, v in placed[0][0].items()))
        key = ("mesh-aligned", func, t_local, sig, self._mesh_key())
        tst.note_exec("mesh-tiles", key, self._placed_inputs(placed), out)
        return out[:self.S, :steps.size]

    def eval_aligned_batch(self, tiles, func: str, nsteps: int, step: int,
                           w0s_list: Sequence[int],
                           w0e_list: Sequence[int]) -> torch.Tensor:
        """B aligned grids of a non-counter function -> [B, S, T]."""
        T_pad = -(-nsteps // self.n_time) * self.n_time
        t_local = T_pad // self.n_time
        args = (int(tiles.num_slots), self.base_ms, self.dt_ms)

        def run(arrs, j):
            off = j * t_local * step
            body = functools.partial(tst._eval_core, func, t_local, arrs,
                                     *args)
            return tst._vmap_grids(
                lambda s, e, st: body(s + off, e + off, st),
                w0s_list, w0e_list, step, arrs["ts"].device)
        parts, placed = self._aligned_parts(tiles, func, run)
        out = self._assemble(parts, 2, 1)
        sig = tuple(sorted((k, v.dim()) for k, v in placed[0][0].items()))
        key = ("mesh-aligned-b", func, t_local,
               tst._pad_width(len(w0s_list)), sig, self._mesh_key())
        tst.note_exec("mesh-tiles", key, self._placed_inputs(placed), out)
        return out[:, :self.S, :nsteps]

    def _gid_parts(self, gids: np.ndarray) -> List[List[torch.Tensor]]:
        g = np.full(self.S_pad, -1, dtype=np.int32)   # -1 = padding rows
        g[:self.S] = np.asarray(gids, dtype=np.int32)
        return self._place_rows(torch.as_tensor(g))

    def eval_grouped(self, func: str, steps: np.ndarray, window_ms: int,
                     gids: np.ndarray, num_groups: int, agg: str = "sum",
                     offset_ms: int = 0) -> np.ndarray:
        """sum/count/avg/min/max by (g) of rate/increase/delta straight
        off the resident store: each partition's local rates into the
        grouped collective (``mesh._grouped_reduce``) -> [G, T] numpy."""
        t_local, w0s, w0e, step = self._grid(steps, window_ms, offset_ms)
        gp = self._gid_parts(gids)
        parts = _sharded_counter_eval(self, func, t_local, w0s, w0e, step)
        out = torch.cat([
            _grouped_reduce([loc.T for loc in col],
                            [gp[i][j] for i in range(self.n_shard)],
                            num_groups, agg)
            for j, col in enumerate(parts)], dim=1)
        key = ("mesh-grouped", func, agg, t_local, num_groups,
               self._mesh_key())
        tst.note_exec("mesh-tiles", key, self._inputs(), out)
        return out[:, :steps.size].cpu().numpy()

    def eval_grouped_pair(self, func: str, steps: np.ndarray,
                          window_ms: int, gids: np.ndarray,
                          num_groups: int, offset_ms: int = 0
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused `sum by (g)` contract off the resident store ->
        (sums [T, G], counts [T, G]) f64 numpy, the group-sum kernel's
        return shape (``TorchBackend.fused_groupsum``)."""
        t_local, w0s, w0e, step = self._grid(steps, window_ms, offset_ms)
        sums, cnts = _grouped_pair(self, func, t_local, w0s, w0e, step,
                                   self._gid_parts(gids), num_groups)
        key = ("mesh-grouped-pair", func, t_local, num_groups,
               self._mesh_key())
        tst.note_exec("mesh-tiles", key, self._inputs(), (sums, cnts))
        T = steps.size
        return sums[:T].cpu().numpy(), cnts[:T].cpu().numpy()

    # -- the in-place refresh ------------------------------------------------

    def append_slots(self, tiles_new) -> bool:
        """Cross-flush refresh: when ``tiles_new`` extends this store's
        series set by appended slots (same cohort, same cadence, grown
        prefix), write the new slot columns in place through
        :func:`_append_step` and serve the fresh world with no second
        copy of the store. Returns False when incompatible: the caller
        re-places from scratch."""
        if not self.tiles_eligible(tiles_new):
            return False
        if (int(tiles_new.base_ms) != self.base_ms
                or int(tiles_new.dt_ms) != self.dt_ms
                or list(tiles_new.keys) != self.keys):
            return False
        n_new = int(tiles_new.num_slots)
        if n_new <= self.n_filled:
            return n_new == self.n_filled    # nothing to append
        k = n_new - self.n_filled
        # pow2-bucketed append width, the tail row repeated (the padded
        # rows land beyond n_filled and are never read; the next append
        # overwrites them), as the reference buckets its append program
        k_pad = _next_pow2(k, 8)
        if self.n_filled + k_pad > self.cap:
            return False                     # out of capacity: re-place
        ts = tiles_new.ts.to(F64)[:, self.n_filled:]
        v = tiles_new.channel("v").to(F64)[:, self.n_filled:]
        new_tsr = (ts - self.base_ms).T.to(I32)
        new_v = v.T
        new_tsr = torch.cat([new_tsr, new_tsr[-1:].expand(k_pad - k, -1)])
        new_v = torch.cat([new_v, new_v[-1:].expand(k_pad - k, -1)])
        for i in range(self.n_shard):
            lo, hi = i * self.S_l, min((i + 1) * self.S_l, self.S)
            done = set()
            for j in range(self.n_time):
                tsr = self._chan["tsr"][i][j]
                if id(tsr) in done:
                    continue
                done.add(id(tsr))
                dev = tsr.device
                nt = torch.zeros((k_pad, self.S_l), dtype=I32, device=dev)
                nv = torch.zeros((k_pad, self.S_l), dtype=F64, device=dev)
                if hi > lo:
                    nt[:, :hi - lo].copy_(new_tsr[:, lo:hi])
                    nv[:, :hi - lo].copy_(new_v[:, lo:hi])
                _append_step(tsr, self._chan["v"][i][j],
                             self._chan["cv"][i][j], nt, nv, self.n_filled)
        self.n_filled = n_new
        self._aligned.clear()   # row-major placements are per-snapshot
        self._record_residency()
        return True


@order_insensitive(
    "grouped-pair-psum", tolerance=1e-12,
    reason="sums and counts are f64 per-partition one-hot matmul "
           "partials psummed over the shard axis; regrouping across "
           "partition counts moves the sums by at most a few f64 ulps "
           "(counts are exact integers in f64) — certified at "
           "1/2/4/8 partitions")
def _grouped_pair(st: ShardedTiles, func: str, t_local: int, w0s: int,
                  w0e: int, step: int, gid_parts, num_groups: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused-groupsum contract from resident tiles: per partition,
    the f32 local rates of its series slice over its step slice, their
    f64 one-hot partial sums and counts; summed over the shard partitions
    in order -> (sums [T_pad, G], counts [T_pad, G]) f64 on the first
    partition's device, sums meaningful where counts > 0."""
    parts = _sharded_counter_eval(st, func, t_local, w0s, w0e, step)
    sums_t, cnts_t = [], []
    for j, col in enumerate(parts):
        cnt, val = grouped_partials(
            [loc.T for loc in col], [gid_parts[i][j] for i in range(len(col))],
            num_groups, "sum")
        sums_t.append(val.T)
        cnts_t.append(cnt.T)
    return torch.cat(sums_t, dim=0), torch.cat(cnts_t, dim=0)


# ---------------------------------------------------------------------------
# Placement cache (the evaluator the backend holds)
# ---------------------------------------------------------------------------

# cache inventory: placements key on tile-snapshot IDENTITY (an
# AlignedTiles instance is an immutable snapshot; a weakref finalizer
# drops the placement the moment its tiles die, so a recycled id can
# never serve stale channels)
@cache_registry("sharded-tile-placement", keyed=("tiles-identity",))
@guarded_by("_lock", "_placed")
class ShardedTileEvaluator:
    """The serving-path facade ``TorchBackend`` holds: lazily places
    eligible aligned-tile cohorts across the mesh, serves the sharded
    evaluator families from them, and rides cross-flush rebuilds through
    the in-place append."""

    MAX_PLACEMENTS = 8

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self._lock = threading.Lock()
        # id(tiles) -> (weakref to tiles, ShardedTiles)
        self._placed: Dict[int, Tuple[object, ShardedTiles]] = {}
        self.placements = 0          # observability: builds
        self.donated_refreshes = 0   # observability: in-place appends

    @property
    def ndev(self) -> int:
        return int(self.mesh.devices.size)

    def _drop_cb(self, key: int):
        """The weakref callback dropping ``key``'s placement when its
        tiles die; it holds this evaluator only weakly, so a dropped
        evaluator (and its placements' device memory) goes at once."""
        me = weakref.ref(self)

        def _drop(_ref, *, _key=key):
            ev = me()
            if ev is not None:
                with ev._lock:
                    ev._placed.pop(_key, None)
        return _drop

    def place(self, tiles) -> Optional[ShardedTiles]:
        """The resident placement for ``tiles`` (built on first sight),
        or None when the tiles don't qualify."""
        if tiles is None or not ShardedTiles.tiles_eligible(tiles):
            return None
        key = id(tiles)
        with self._lock:
            got = self._placed.get(key)
            if got is not None:
                return got[1]
        placed = ShardedTiles(self.mesh, tiles)
        ref = weakref.ref(tiles, self._drop_cb(key))
        with self._lock:
            while len(self._placed) >= self.MAX_PLACEMENTS:
                self._placed.pop(next(iter(self._placed)))
            # graftlint: disable=hbm-residency-budget (the placement cache holds ShardedTiles stores, whose channels the shardstore-resident-channels claim on ShardedTiles prices; MAX_PLACEMENTS caps it)
            self._placed[key] = (ref, placed)
            self.placements += 1
        return placed

    def refresh(self, old_tiles, new_tiles) -> bool:
        """Cross-flush hand-over: move the old tiles' placement onto the
        freshly-built tiles through the in-place append when compatible;
        otherwise drop it (the next query re-places). Returns True when
        the append served."""
        with self._lock:
            got = self._placed.pop(id(old_tiles), None)
        if got is None or new_tiles is None:
            return False
        placed = got[1]
        if not placed.append_slots(new_tiles):
            return False
        key = id(new_tiles)
        ref = weakref.ref(new_tiles, self._drop_cb(key))
        with self._lock:
            self._placed[key] = (ref, placed)
            self.donated_refreshes += 1
        return True

    def release(self) -> None:
        """Drop every placement (and with it its device memory)."""
        with self._lock:
            self._placed.clear()

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"placements": self.placements,
                    "resident": len(self._placed),
                    "donated_refreshes": self.donated_refreshes,
                    "devices": self.ndev}
