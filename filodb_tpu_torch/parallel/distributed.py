"""Multi-process mesh: ``torch.distributed`` across OS processes (the
counterpart of ``filodb_tpu.parallel.distributed``).

The reference scales out with one process per node joined into ONE global
``jax.distributed`` mesh, whose collectives then cross hosts. Here every
process keeps its own ('shard', 'time') mesh over its local partitions
(``parallel/mesh.py``), evaluates only ITS shard groups there, and the
partial aggregates of all processes meet through ``all_reduce``: SUM for
the f64 counts and sums, MIN/MAX for the order statistics of min/max. No
process ever materializes another's samples.

``init_process`` joins one process to the group over ``tcp://`` (or a
``file://`` rendezvous on a file system every rank shares): gloo on the
CPU and where ranks share one card, NCCL where each rank has a card of its
own. ``window_aggregate_distributed`` is the cross-process
``MeshExecutor.window_aggregate``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from filodb_tpu_torch.lint.ranks import rank_invariant


def backend_for(device, num_processes: int) -> str:
    """The collective backend of a group of ``num_processes`` ranks whose
    partitions live on ``device`` (``"cpu"``, ``"cuda"``): NCCL when every
    rank can have a CUDA card of its own, gloo otherwise (the CPU, or
    ranks sharing one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def init_process(coordinator_address: str, num_processes: int,
                 process_id: int, device="cpu") -> str:
    """Join this process to the ``torch.distributed`` group of
    ``num_processes`` ranks rendezvousing at ``coordinator_address``
    (``host:port``, ``tcp://host:port``, or ``file:///path``: a file that
    no rank has made yet, which needs no free port; nothing of a cluster
    is discovered). Returns the backend chosen by :func:`backend_for`;
    under NCCL the rank's card is ``cuda:<process_id>``."""
    import torch.distributed as dist

    addr = coordinator_address
    if not addr.startswith(("tcp://", "file://")):
        addr = "tcp://" + addr
    backend = backend_for(device, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id)
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id)
    return backend


def _collective_device() -> torch.device:
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce(t: torch.Tensor, op) -> torch.Tensor:
    """``all_reduce`` of ``t`` on the group's collective device, the
    result back on ``t``'s device."""
    import torch.distributed as dist
    buf = t.to(_collective_device()).contiguous()
    dist.all_reduce(buf, op=op)
    return buf.to(t.device)


@rank_invariant(
    "params", "func", "agg", "window_ms", "num_groups", "offset_ms",
    reason="every rank runs the same query: the step grid, the function, "
           "the aggregation, the window, the global group table's size "
           "and the offset come from it; only a rank's shard groups and "
           "their group ids are its own")
def window_aggregate_distributed(mesh_ex, local_series_by_shard,
                                 local_group_ids, params, func: str,
                                 agg: str, window_ms: int,
                                 num_groups: int,
                                 offset_ms: int = 0) -> np.ndarray:
    """``MeshExecutor.window_aggregate`` across processes.

    Each process passes the shard groups IT owns (a multiple of its own
    mesh's shard axis) and their group ids in the global group table;
    the processes agree on the pad shapes, evaluate their own groups on
    their own partitions, and their partial aggregates meet through
    ``all_reduce``. Returns the full [num_groups, T] result on every
    process."""
    import torch.distributed as dist

    from filodb_tpu_torch.parallel.mesh import (_GATHER_FUNCS, MESH_AGGS,
                                                grouped_finish,
                                                grouped_partials,
                                                pack_sharded)
    from filodb_tpu_torch.query.backend import (_next_pow2,
                                                _window_sample_bound)

    if agg not in MESH_AGGS:
        raise ValueError(f"agg {agg} not mesh-executable")
    mesh = mesh_ex.mesh
    n_shard = mesh.shape["shard"]
    n_time = mesh.shape["time"]
    if not local_series_by_shard or len(local_series_by_shard) % n_shard:
        raise ValueError("pass this process's shard groups: a multiple "
                         "of its mesh's shard axis")
    func = func or "last_sample"
    # agree on the global pad shapes and window bound, so every process
    # packs the same [S, N] tiles and gathers the same window width
    local_maxs = max([1] + [len(r) for r in local_series_by_shard])
    local_maxn = max([1] + [s.ts.size for row in local_series_by_shard
                            for s in row])
    w_local = 0
    if func in _GATHER_FUNCS:
        all_local = [s for row in local_series_by_shard for s in row]
        w_local = _window_sample_bound(all_local, window_ms, local_maxn)
    agreed = _all_reduce(torch.tensor([local_maxs, local_maxn, w_local],
                                      dtype=torch.int64),
                         dist.ReduceOp.MAX).tolist()
    s_pad = _next_pow2(int(agreed[0]), 1)
    n_pad = _next_pow2(int(agreed[1]), 1)
    w_bound = int(agreed[2])
    ts, vals, lens, _ = pack_sharded(local_series_by_shard,
                                     drop_nan=(func != "last_sample"),
                                     s_pad=s_pad, n_pad=n_pad)
    gids = np.full((len(local_series_by_shard), s_pad), -1, dtype=np.int32)
    for g, row in enumerate(local_group_ids):
        gids[g, :len(row)] = row
    steps = params.steps
    T = steps.size
    if T == 0:
        return np.empty((num_groups, 0), dtype=np.float64)
    t_local = -(-T // n_time)
    step = int(params.step_ms if T > 1 else 1)
    w0e = int(steps[0] - offset_ms)
    w0s = int(w0e - window_ms)
    parts = mesh_ex._local_results(func, ts, vals, lens, gids, t_local,
                                   step, w0s, w0e, w_bound, 0.0)
    cnts, vals_ = [], []
    for col in parts:
        c, v = grouped_partials([loc for loc, _ in col],
                                [g for _, g in col], num_groups, agg)
        cnts.append(c)
        vals_.append(v)
    # graftlint: disable=reduction-order-determinism (f64 counts of present values are exact integers below 2**53, so every grouping of ranks sums them alike)
    cnt = _all_reduce(torch.cat(cnts, dim=1), dist.ReduceOp.SUM)
    val: Optional[torch.Tensor] = None
    if vals_[0] is not None:
        op = {"min": dist.ReduceOp.MIN,
              "max": dist.ReduceOp.MAX}.get(agg, dist.ReduceOp.SUM)
        # graftlint: disable=reduction-order-determinism (f64 partial sums regrouped across ranks as grouped-reduce-psum regroups them across partitions, certified at 1/2/4/8; tests/test_torch_distributed.py holds the two-process answer to the one-process mesh within 1e-12)
        val = _all_reduce(torch.cat(vals_, dim=1), op)
    return grouped_finish(cnt, val, agg)[:, :T].cpu().numpy()
