#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (filodb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, none of whose failures is caught (a failing phase logs a line that
names it to standard error, and its exception ends the run with a
non-zero exit):
  1. card and build: the card's name and power limit, then both CUDA
     kernels compiled from filodb_tpu_torch/csrc/ into build/kernels/;
  2. kernel parity: each kernel against its plain PyTorch version on the
     card (group-sum: every func and boundary-mode pair, step == dt, and
     the tiling's edges: G 1 and 300, one s-tile and a ragged last one, T
     no multiple of the step chunk, st == 1 with both fallback families,
     dspan == GS_DSPAN_MAX, each call run twice and compared bit for bit;
     boundary extract: ragged rows with duplicates and empty windows, and
     rows too long for the shared-memory stage);
  3. device tiles at real size: 65,536 counter series x 2,880 slots (8 h at
     10 s, +/-2 s jitter) generated on the card; `sum by` of rate with a
     5 m window and 60 s step over T = 470 steps and 16 groups, at three
     grid phases, held against a numpy f64 oracle on an 8,192-series
     subset; the group-sum timed there and at the shape phase 4 sends it
     (S_ENGINE = 4,096 series, T = 469); the boundary extract at 65,536 x
     512 samples x 128 windows;
  4. the engine end to end (the main path): a TimeSeriesShard with 4,096
     flushed counter series, an unflushed 30-sample tail and 512 series of
     irregular cadence, queried through parse_query_range +
     QueryEngine(backend=TorchBackend()) and checked against the same
     engine's numpy oracle; kernel launch counts are reset just before and
     read just after, and every kernel call it made is held against the
     plain version on the same inputs;
  5. every range function the backend serves on the device
     (DEVICE_FUNCS) through the engine over the phase-4 shard, which also
     holds S_ENGINE integer gauges (`queue_depth`) with an unflushed tail:
     each answer held against the engine's numpy oracle, each route
     asserted by the backend's counters (aligned tiles, tiles plus the
     packed tail, packed endpoint or gather, boundary extract); then each
     family's device function timed alone at the full-width shape beside
     its byte bound and peak device memory (the `functions` line);
  6. the serving fast path on the phase-4 shard (bursts behind a barrier,
     the batched ones meeting again at the batcher's door once every
     member's host preparation is done; engine clients; a flush with its
     stale serve and rebuild: the `serving` line; the clients' queries/s
     is over the span from the first measured query's start to the last
     one's end);
  7. the standalone server (`filodb_tpu_torch.standalone.server`) on the
     card, holding phase 4's data routed over 4 shards as the reference
     routes it, plus seed_dev_data(), started with the rules of phase 10
     and self-monitoring (both loops run through the phase): PromQL over
     HTTP (the default sample limit's 422, each query held against the
     numpy oracle with the kernels it launched, again from the results
     cache and with &cache=false), one warm query of each route again
     with &explain=analyze (the grouped rate: the group-sum; one job's
     irregular rate: the extract; the gauges' max_over_time: the gather;
     their avg_over_time: the aligned evaluator), each answer's data
     byte for byte the same as without it, each kernel site's dispatches
     in the payload equal to the kernel's launches in that query and its
     bytes_accessed equal to the bytes this script's bound counts for the
     shape, /metrics carrying the filodb_executable_* families, 4 HTTP
     clients (the `server` line, with `analyze`; the wall-clock rule
     ticks' launches, told apart from the queries' by their BACKGROUND
     class, in its `loops`);
 10. on phase 7's server, before it stops: recording rules, alerting and
     self-monitoring. The rules: `job:http_requests:rate5m` = sum by (job)
     of rate(http_requests_total[5m]), `irregular:rate5m` =
     rate(irregular_total[5m]), and the alert `JobRequestRateHigh`, the
     grouped rate above X (the median of the 16 jobs' oracle rates at the
     first tick, fixed before any tick) for 2m, posting to a loopback
     webhook sink. The wall-clock scheduler's thread is ended and the
     caches of phase 7 (which ran the same query texts on the same grids)
     dropped; then every group ticks through eval_group_once at 8
     boundaries of the data's time ending at the flushed end, both
     kernels' launches counted. Checked: the recorded job rates against
     the oracle and the same query over HTTP with &cache=false; the
     irregular rates bit for bit against the engine with the extract's
     plain version; every recorded sample read back from __rules__; the
     alert's states per tick (pending, then firing after 2m) in the
     engine, ALERTS, /api/v1/alerts and the webhook; explain=analyze (a
     cold tick, then partial hits computing the newest step); and
     __selfmon__ (the loop's tick counter, the rule-evaluation counter
     counting this phase's evaluations exactly, and a rate over each
     against the oracle on the raw samples) (the `rules` line);
  8. the write path and durability: phase 4's flushed history (the
     counters and the irregular series) backfilled into a fresh data-dir
     through the memstore and a FlatFileColumnStore; server A on the card
     over that data-dir, a fresh stream-dir and a gateway (WRITE_CONFIG:
     fsync per append, no timed flush) takes the counters' 30-sample tail
     through POST /api/v1/ingest/influx, one POST of 4,096 lines per
     scrape, and an irregular tail through the TCP gateway; its grouped
     sum and average of rate (the fused group-sum), one job's rate into
     the tail and the irregular rate into the tail (the boundary extract)
     are held against the numpy oracle, and a remote read of 64 series
     must give back every sample written; A's drivers stop without a
     flush (a crash: the tail lives only in the stream logs); server B on
     the same directories goes through RECOVERY to ACTIVE, and must give
     A's answers bit for bit and the same remote-read bytes, through both
     kernels, then stops without a flush as well (the `durability` line);
  9. the cluster: two FiloServers in this process, both on the card
     (they share the interpreter and the card), 4 shards over 2 nodes
     (node0 owns 0-1, node1 2-3) on phase 8's directories, peers and the
     gRPC plane: the grouped rate entering node0 and node1 (the peer's
     series fetched over gRPC into the entry node's tiles and group-sum),
     one job's rate and the irregular rate into the tail entering each
     node (the extract on the entry node), a same-metric join pushed down
     to both nodes and a series fan-out, each held to the oracle and to
     server B's answer; the first, cold, cross-node grouped rate sent
     with &explain=analyze, its stages and device spans split (ROADMAP
     C.17) and its kernel dispatches equal to the launches; then node1
     stopped without a drain (detection),
     restarted (recovery) and drained into node0 (planned handoff), the
     grouped rate after each (the `cluster` line);
 11. the supervisor: `python -m filodb_tpu_torch.standalone.supervisor`
     as a subprocess, two worker processes of the port's server on the
     card behind one public port, on a copy of phase 8's directories made
     before phase 9 (so the workers start from what phase 9's nodes
     started from) with phase 9's node config and one 60 s time()
     recording rule: phase 9's grouped, job and irregular rates entering
     each worker's private port and the public port, each private answer
     bit for bit phase 9's entering the same ordinal, the public one
     equal to one of them, all within the oracle's bounds; each private
     query with &explain=analyze (its stages, its device-dispatch spans
     and the kernels the worker launched: `launches_phase11`); worker 0's
     sampling profiler (profiler-enabled) read after its cold query, its
     samples by thread root; the merged /debug/threads, /debug/traces
     and /metrics of both workers; /admin/invalidate; kill -9 of worker
     0 (respawn, the rule evaluator handed to worker 1 and back, its
     grouped answer again bit for bit); SIGTERM of the supervisor (a
     drain, exit 0, no worker left) (the `supervisor` line);
 12. downsampling and the raw/downsample tiering, on its own copy of
     phase 8's data-dir (taken with phase 11's copy, before phase 9) and
     fresh stream logs: (a) the B.7 device functions at
     bench_downsample.py's batch shape, 8,192 x 16,384 samples (10 s +/-2
     s) made on the card from --seed: the reshape fast path at 5 m, the
     aligned cascade to 1 h, the gather path (w_bound 64) at 5 m and the
     counter emit mask, the fast path held against the gather path on
     every row and 64 rows against the numpy oracle (the mask against its
     rule), each timed by CUDA events beside its byte bound and peak
     memory; (b) one in 4 of phase 5's 4,096 gauges (1,024, part="p0"
     among them) backfilled into the copy, then
     DownsamplerJob over its 4 shards at 5 m and 1 h on the card, 64
     gauges held against downsample_gauge_oracle and 64 counters (16
     irregular) against the emit rule, from the raw rows; (c) a
     FiloServer on the card over the copy with raw-retention-s set from
     the wall clock (the boundary about 4 h before the data's last
     sample) and flush-downsample on: over HTTP the grouped rate, one
     job's irregular rate, the gauges' avg and max over 30 m at a 300 s
     step across the 8 h, and max over 2 h at 3,600 s wholly beyond
     retention (the 1 h resolution); each answer's StitchExec recorded,
     the boundary read from its raw side's plan, each side held against
     the numpy oracle over that side's rows, each side's launches
     counted (at least one on the ds side); then 1,024 counters' tails
     through POST /api/v1/ingest/influx, a clean stop (the flush), and
     every ds sample emitted read back from the 5 m and 1 h datasets
     (the `downsample` line);
 13. the certification rail (filodb_tpu_torch/lint/ulpcert.py and
     filodb_tpu_torch/testing/soak.py): (a) every @precision claim's
     harness with device="cuda" (the torch ops the card runs and, for
     groupsum-recombine-f32, the group-sum kernel's own output over the
     harness's full-span world), each claim's worst error beside its
     budget, then at the engine's width: the three counter claims over
     S_ENGINE series and the group-sum claim at S_ENGINE series x 469
     steps of a 5 m window every 60 s (one group per series, windows on
     samples: each group's sum is its series' recombined delta); the
     card's division by a Python scalar checked apart (against the CPU's,
     a 0-dim divisor on the card, and a multiply by the reciprocal); (b) the
     generated soak: 200 queries of QueryGen(seed=0xD1FF) over the
     regular world (10 s +/-2 s, no gaps, a reset, flushed, an unflushed
     tail for two metrics) and over the reference soak's world, through
     QueryEngine with TorchBackend() on the card, each answer held to the
     pure-Python ref_eval, with the cache off and again through the
     results cache (cold, then warm); the backend's route counters and both
     kernels' launches over the soak above 0, every kernel call of the
     soak held against its plain version (the `certification` line);
 14. the mesh (filodb_tpu_torch/parallel/): the mesh's three claims
     (append-carry-exact, grouped-reduce-psum, grouped-pair-psum)
     certified on the card; (a) phase 4's S_ENGINE counters x N_FULL
     slots as dense tiles placed on 1x1, 2x1, 4x1 and 2x2 (shard x time)
     partitions of the card: rate/increase/delta, five aligned families
     and a batch of 4 grids bit for bit the single-device evaluators,
     the grouped pair and sum/avg/min/max/count by (job) against the
     numpy f64 oracle, the resident bytes 20 x cap x S_pad, the
     scatter-gather executor (max/sum_over_time by job, topk 3) over the
     512 irregular series against the oracle, each evaluator timed by
     CUDA events beside the single-device path; a 30-slot append in
     place (data_ptr unchanged), bitwise a fresh placement on the
     reset-free series; (b) a plain server and one with mesh-enabled
     under 4 partitions of the card over the counters' last hour plus
     seed_dev_data(): tests/test_mesh_serving.py's queries over HTTP,
     the per-series data sections byte for byte the same, the grouped
     ones against the numpy f64 oracle of the per-series rates, mesh
     dispatches, mesh-tiles executables in &explain=analyze, no
     group-sum launch on the mesh's grouped route; (c) two processes x 2
     partitions of the card joined over gloo
     (window_aggregate_distributed of sum by (job) of rate over the
     irregular series; started first, overlapping (a) and (b)), each
     rank's answer against the single-process 4-partition mesh (the
     `mesh` line);
 15. capacity and contracts (filodb_tpu_torch/lint/memcert.py and the
     kernels' @kernel_contract), no query and no kernel launch: (a)
     every @capacity claim certified on the card at full width — the
     aligned tiles over phase 4's 4,096 counters x 2,880 slots, the tile
     cache holding phase 4's entries (the counters' tiles, the
     irregular selection's none), the sharded store on 1, 2 and 4
     partitions, the downsampler's staging block for one batch of 256
     of phase 12(b)'s gauges — each with its storage walk, the
     allocator's requested-bytes and memory_allocated deltas around the
     build, the claimed bytes and verdict, the bytes per padded slot
     and the projected resident series per card of its total_memory at
     2,880 samples each (the `capacity` line); (b) each CUDA contract's
     registers and static shared bytes against the ptxas report of the
     kernels' build (kept beside each library, so a reused build reads
     it too) and against its functions' attributes as the card loaded
     them (cudaFuncGetAttributes), its shared-memory budget against the
     card's opt-in limit, and, at every shape phases 3-14 launched in
     this process, what the library reports it launches (the
     launcher's own arithmetic) against the contract's plan and limits
     (the `contracts` line); (c) the port's static analyser
     (filodb_tpu_torch/lint, `run_lint` with its contracts and both
     certification rails, ulpcert's and memcert's, each on the CPU) over
     filodb_tpu_torch/ on the card's machine: 0 findings, the sites each
     family looked at (`seen`), the rules with no torch counterpart and
     the seconds (the `lint` line; its PromQL micro-soak runs on the
     host's numpy path, and nothing of it touches the card);
  then the `memory` line: the card's allocated memory (live tensors)
  after each phase, each stopped server's held to within 256 MiB of the
  level before it started, and phase 12 starting with at most 1 GiB
  allocated (ROADMAP C.23; each reading is also logged on its own line);
  then the `kernels` line: launches (phase 4, and phases 5-14 as
  `launches_phase5` to `launches_phase14`; phase 11's are the workers'
  own counts, from their &explain=analyze), max error, kernel and plain
  times (CUDA events over warmed launches; `device_ms` by CUDA-graph
  replay, without the host's cost of a call) and the least time the card
  could take, at the phase-3 shapes, and for the group-sum also at the
  engine shape (`engine_shape_*`).

Tolerances: group-sum counts exact, sums |k - p| <= 1e-5 |p| + 1e-6 max|p|
(f32 sums in another order than the plain version's f64 product); the
boundary extract bit-exact; the engine within rtol 1e-5 of its f64 oracle,
plus, where a window's extrapolation branch is a knife edge on integer ms,
the spread of that series' answers with the branch taken either way
(check_engine_answer); the fused group answers also within rtol 1e-5 of an
f64 oracle that decides the branch on integer ms as the kernel does. Phase
5: the rate family as phase 4; every other answer within rtol 1e-9, atol
1e-9 of the oracle (z_score rtol 5e-6, the reference's own bound), plus,
for the prefix-sum family on the packed path, an absolute bound derived
per row from its prefix magnitude and the window's count
(packed_prefix_bound), logged beside the error. Phase 7: every answer
parsed from its Prometheus JSON and held as phases 4-5 hold theirs; the
cached and uncached repeats equal to the first answer. Phase 8: A's
answers as phase 7's; B's equal to A's bit for bit; the remote read exact.
Phase 9: each answer as phase 7's; the per-series and irregular rates
equal to server B's bit for bit, the grouped rate within the group-sum
tolerance of B's; the join within rtol 2e-5 of the range its sides'
branch variants span; no downgrade from gRPC to HTTP on either node.
Phase 11: each answer as phase 9's, and equal to it bit for bit.
Phase 12: the B.7 functions' counts, minima, maxima, last values, last
timestamps and emit mask bit for bit (fast path against gather path,
and against the oracle), sums within rtol 1e-12 (the reference test's
bound); the job's ds rows likewise against the oracle and the emit rule;
each side of a tiered answer within rtol 1e-5 of the numpy oracle over
that side's rows, the grouped rate's knife-edge cells allowed their
branch spread (check_tier_answer); the emitted ds samples exactly the
flush rule's.
Phase 13: each claim within its @precision budget (f32 or f64 ulps of
the f64 reference, plus the fixed-point floor span * 2**-59 where the
claim states it); each soak answer within 1e-6 absolute + 1e-6 relative
of ref_eval on f64 routes, within its f32 routes' budgets in f32 ulps of
the answer (of the sum of the magnitudes of the f32-route values it adds
or subtracts) on f32 routes (tilestore/fast and /slide 16, the group-sum
4 + 4), a knife edge (a gap within 1 ms of its threshold) allowed the
other branch, counted and named (filodb_tpu_torch/testing/soak.py).
Phase 14: per-series answers bit for bit the single-device path's (in
(b) the data sections byte for byte); grouped sums and averages within
1e-12 relative of the numpy f64 oracle over the single-device rates,
min, max and counts exact; the scatter-gather's max exact and its sums
within 1e-9 (the reference test's); topk winners exact; the append
bitwise on the reset-free series and within 2 f64 ulps on those with a
reset before it (the same carry added in another order); both ranks
within 1e-12 of the single-process mesh.
Phase 15: each claim's walk within the claim and the claim within 1.25x
the walk; the requested bytes within 512 B a storage of the walk and
memory_allocated's delta from the walk to 1 MiB a storage above it (a
cached block is handed out whole when at most 1 MiB would remain);
registers and static shared bytes equal to ptxas's and the card's; every
launch the contract's plan and admitted.
Phase 10: the job rates within rtol 1e-5 of the integer-rule oracle (on
a tick that did not take the fused group-sum, plus the knife spread) and
of the uncached HTTP answer; the alert's active set decided by the
recorded rates, which must agree with the oracle's side of X wherever the
oracle is further from X than that tolerance; the __selfmon__ rates
within rtol 1e-5 of a branch variant of the oracle.

Standard output: the card's name and power limit after phase 1, then each
phase's JSON line as the phase ends (`functions` with `queries`,
`serving`, `server`, `rules`, `durability`, `cluster`, `supervisor`,
`downsample`, `certification`, `mesh`, `capacity`, `contracts`), then
the `memory` and `kernels` lines,
and last
{"ok": true, "device": {...}}. The script exits non-zero,
printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

BASE = 1_600_000_000_000
DT = 10_000
WINDOW = 300_000
STEP = 60_000
S_FULL = 65_536
N_FULL = 2_880
T_FULL = 470
G = 16
S_ORACLE = 8_192
# counter (and gauge) series of the engine phases 4-12: cut from 8,192 when
# the whole run outgrew the 1,200 s limit on a slower host (ROADMAP C.14);
# the cold first query of each server is host-bound and linear in it
S_ENGINE = 4_096
KNIFE_MS = 8
J_MS = 2_000

# published device-memory rate and non-tensor f32 rate by card model
# (NVIDIA data sheets); the first name fragment that matches wins
_CARDS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
          ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str):
    for frag, bw, f32 in _CARDS:
        if frag in name:
            return bw, f32
    raise RuntimeError(f"no published rates for card {name!r}")


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of `fn`: `calls` calls captured in one CUDA
    graph, the graph replayed `reps` times between CUDA events (the host's
    cost of each call is left out)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return time_ms(g.replay, reps=reps, warm=2) / calls


def check_groupsum(got, want, what: str) -> float:
    """Counts exact; sums within 1e-5 |p| + 1e-6 max|p|. Returns the max
    absolute error of the sums."""
    gs, gc = (x.double().cpu() for x in got)
    ws, wc = (x.double().cpu() for x in want)
    if not torch.equal(gc, wc):
        raise AssertionError(f"{what}: group counts differ")
    tol = 1e-5 * ws.abs() + 1e-6 * float(ws.abs().max())
    err = (gs - ws).abs()
    if not bool((err <= tol).all()) or not bool(torch.isfinite(gs).all()):
        raise AssertionError(f"{what}: sums differ by {float(err.max())}")
    return float(err.max())


def check_extract(got, want, what: str) -> float:
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: boundary extract differs")
    return 0.0


# ---------------------------------------------------------------------------
# data generated on the card
# ---------------------------------------------------------------------------

def gen_counters(S: int, N: int, gen: torch.Generator, dev):
    """Integer-ms jittered scrape times and counter values (one reset in
    every 97th series)."""
    jit = torch.randint(-J_MS, J_MS + 1, (S, N), generator=gen, device=dev)
    ts = (BASE + torch.arange(N, device=dev, dtype=torch.int64)[None, :]
          * DT + jit).to(torch.float64)
    del jit
    vals = torch.rand((S, N), generator=gen, device=dev,
                      dtype=torch.float64).mul_(5.0).cumsum_(dim=1)
    vals[::97, N // 2:] -= vals[::97, N // 2 - 1:N // 2].clone()
    return ts, vals


def gen_ragged(S: int, N: int, T: int, step: int, window: int,
               gen: torch.Generator, dev):
    """Sorted irregular rows relative to the first window start, with
    duplicate timestamps, ragged lengths (TR_PAD padding) and gaps that
    leave windows empty; payload = 3xf32 split of f64 counters."""
    from filodb_tpu_torch.query import kernels as kn

    span = (T - 1) * step + window
    mean = max(span // N, 2)
    iv = torch.randint(0, 2 * mean, (S, N), generator=gen, device=dev)
    iv[:, ::97] = 0                                  # duplicates
    iv[::7, N // 3] += 4 * window                    # empty windows
    ts = iv.cumsum(dim=1) - mean * 4
    lens = torch.randint(N // 2, N + 1, (S,), generator=gen, device=dev)
    live = torch.arange(N, device=dev)[None, :] < lens[:, None]
    tr = torch.where(live, ts, torch.full((), int(kn.TR_PAD),
                                          device=dev)).to(torch.int32)
    vals = 1e12 + torch.rand((S, N), generator=gen, device=dev,
                             dtype=torch.float64).mul_(5.0).cumsum_(dim=1)
    vals = torch.where(live, vals, torch.zeros((), dtype=torch.float64,
                                               device=dev))
    return tr.contiguous(), kn.split3(vals).contiguous()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# (st, step, window, T, first step) of the group-sum edge cases: T that is
# no multiple of the step chunk or batch, st == 1, dspan == GS_DSPAN_MAX
EDGE_GRIDS = ((6, STEP, WINDOW, 150, BASE + 400_000),
              (1, DT, WINDOW, 301, BASE + 400_000),
              (1, DT, 480_000, 300, BASE + 600_000),
              (6, STEP, 2_880_000, 101, BASE + 3_000_000))


def groupsum_edge_cases(S: int, N: int, G_e: int, gen, dev) -> int:
    """The group-sum kernel against its plain version on S series and G_e
    groups over EDGE_GRIDS, each at the plan's modes and with both
    fallback families forced; every call run twice and compared with
    torch.equal (reruns must be bit-identical). Returns the case count."""
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query import tilestore as tst

    ts, vals = gen_counters(S, N, gen, dev)
    tiles = tst.AlignedTiles([{}] * S, BASE, DT,
                             torch.ones((S, N), dtype=torch.bool, device=dev),
                             ts, vals)
    del ts, vals
    n_s = -(-S // kn.GS_SS)
    oh = torch.zeros((n_s * kn.GS_SS, G_e), dtype=torch.float32, device=dev)
    oh[torch.arange(S, device=dev), torch.arange(S, device=dev) % G_e] = 1.0
    base = tiles.t_fixed_base("cv")
    n = 0
    for st, step, window, T, first in EDGE_GRIDS:
        steps = first + np.arange(T, dtype=np.int64) * step
        plan = tst.groupsum_plan(tiles, "rate", steps, window)
        assert plan is not None and plan["st"] == st
        assert window != 480_000 or plan["dspan"] == kn.GS_DSPAN_MAX
        v_p = tiles.t_perm_fixed_tiled("cv", st)
        for modes in sorted({(plan["hi_mode"], plan["lo_mode"]),
                             (kn.GS_BOTH, kn.GS_BOTH)}):
            args = ("rate", st, plan["dspan"], *modes, v_p, base, oh,
                    plan["kl0"], plan["w0e_rel"], window, step, T)
            got = kn.counter_groupsum(*args)
            again = kn.counter_groupsum(*args)
            torch.cuda.synchronize()
            what = (f"group-sum S={S} G={G_e} st={st} dspan={plan['dspan']} "
                    f"T={T} modes={modes}")
            check_groupsum(got, kn.counter_groupsum_reference(*args), what)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                f"{what}: rerun not bit-identical"
            n += 1
    return n


def phase_parity(gen, dev) -> None:
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query import tilestore as tst

    S, N = 4_096, 1_200
    ts, vals = gen_counters(S, N, gen, dev)
    tiles = tst.AlignedTiles([{}] * S, BASE, DT,
                             torch.ones((S, N), dtype=torch.bool, device=dev),
                             ts, vals)
    del ts, vals
    oh = torch.zeros((S, G), dtype=torch.float32, device=dev)
    oh[torch.arange(S, device=dev), torch.arange(S, device=dev) % G] = 1.0
    n_pair = 0
    for st, step, T in ((6, STEP, 150), (1, DT, 300)):
        steps = BASE + 400_000 + np.arange(T, dtype=np.int64) * step
        for func in ("rate", "increase", "delta"):
            plan = tst.groupsum_plan(tiles, func, steps, WINDOW)
            assert plan is not None and plan["st"] == st
            v_p = tiles.t_perm_fixed_tiled(plan["vch"], st)
            base = tiles.t_fixed_base(plan["vch"])
            modes = ([(h, lo) for h in (0, 1, 2) for lo in (0, 1, 2)]
                     if st != 1 else [(plan["hi_mode"], plan["lo_mode"])])
            for hi_mode, lo_mode in modes:
                args = (func, st, plan["dspan"], hi_mode, lo_mode, v_p,
                        base, oh, plan["kl0"], plan["w0e_rel"], WINDOW,
                        step, T)
                got = kn.counter_groupsum(*args)
                torch.cuda.synchronize()
                want = kn.counter_groupsum_reference(*args)
                check_groupsum(got, want,
                               f"group-sum {func} st={st} modes="
                               f"{hi_mode}/{lo_mode}")
                n_pair += 1
    del tiles
    log(f"phase 2: group-sum parity ok over {n_pair} (func, stride, mode "
        f"pair) cases at S={S}")
    n_edge = 0
    for S_e, G_e in ((100, 1), (700, 300)):
        n_edge += groupsum_edge_cases(S_e, N, G_e, gen, dev)
    log(f"phase 2: group-sum parity and bit-identical reruns ok over "
        f"{n_edge} edge cases (G 1 and 300, S 100 and 700, st 1 and 6, "
        f"dspan up to {kn.GS_DSPAN_MAX}, every family read)")
    tr, pay = gen_ragged(2_048, 300, 77, 61_000, 290_000, gen, dev)
    got = kn.window_extract(tr, pay, 61_000, 290_000, 77)
    torch.cuda.synchronize()
    want = kn.window_extract_reference(tr, pay, 61_000, 290_000, 77)
    check_extract(got, want, "boundary extract (ragged)")
    empty = int((want[0] == 0).sum())
    dups = int((tr[:, 1:] == tr[:, :-1]).sum())
    assert empty > 0 and dups > 0
    log(f"phase 2: boundary-extract parity ok (bit-exact; {empty} empty "
        f"windows, {dups} duplicate timestamps)")
    # rows too long to stage in shared memory are searched in device memory
    n_long = 16_384
    assert n_long > kn.WX_SMEM_ROW_MAX
    tr, pay = gen_ragged(256, n_long, 77, 61_000, 290_000, gen, dev)
    got = kn.window_extract(tr, pay, 61_000, 290_000, 77)
    torch.cuda.synchronize()
    want = kn.window_extract_reference(tr, pay, 61_000, 290_000, 77)
    check_extract(got, want, "boundary extract (rows in device memory)")
    assert int((want[0] == 0).sum()) > 0
    log(f"phase 2: boundary-extract parity ok (bit-exact) on 256 rows of "
        f"up to {n_long} samples, past the {kn.WX_SMEM_ROW_MAX}-sample "
        f"shared-memory stage")


def _oracle_rates(ts: np.ndarray, vals: np.ndarray, w0e: int, T: int,
                  knife_ms: Optional[int] = None, window: int = WINDOW,
                  step: int = STEP) -> np.ndarray:
    """Straightforward f64 Prometheus rate per series and window (of
    `window` ms, ends `step` ms apart from w0e) -> [S, T]
    (sorted rows, searchsorted bounds, reset-corrected values; NaN under two
    samples). The extrapolation branch ("gap < 1.1 x the average interval")
    is decided on integer ms, 10*(cnt-1)*gap <= 11*sampled, the rule the
    reference kernel documents.

    With knife_ms, returns [4, S, T]: the rates with the branch as decided,
    then taken the other way at the start edge, at the end edge, and at
    both, wherever that edge's |10*(cnt-1)*gap - 11*sampled| <= knife_ms.
    An f64 or f32 compare of the same test may fall on either side there."""
    S, N = ts.shape
    prev = np.concatenate([np.full((S, 1), np.nan), vals[:, :-1]], axis=1)
    cv = vals + np.cumsum(np.where(vals < prev, prev, 0.0), axis=1)
    wend = w0e + np.arange(T, dtype=np.int64) * step
    wstart = wend - window
    lo = np.empty((S, T), np.int64)
    hi = np.empty((S, T), np.int64)
    for s in range(S):
        lo[s] = np.searchsorted(ts[s], wstart, side="left")
        hi[s] = np.searchsorted(ts[s], wend, side="right") - 1
    rows = np.arange(S)[:, None]
    lo_c, hi_c = np.clip(lo, 0, N - 1), np.clip(hi, 0, N - 1)
    cnt = hi - lo + 1
    t1, t2 = ts[rows, lo_c], ts[rows, hi_c]
    v1, v2 = cv[rows, lo_c], cv[rows, hi_c]
    ds_ms = t1 - wstart[None, :]
    de_ms = wend[None, :] - t2
    m_ds = 10 * (cnt - 1) * ds_ms - 11 * (t2 - t1)
    m_de = 10 * (cnt - 1) * de_ms - 11 * (t2 - t1)
    sampled = (t2 - t1) / 1000.0
    delta = v2 - v1
    out = []
    with np.errstate(all="ignore"):
        avg = sampled / (cnt - 1.0)
        dzero = np.where((delta > 0) & (v1 >= 0), sampled * v1 / delta,
                         np.inf)
        zlt = dzero < ds_ms / 1000.0
        dstart = np.where(zlt, dzero, ds_ms / 1000.0)
        flips = ((False, False),) if knife_ms is None else \
            ((False, False), (True, False), (False, True), (True, True))
        for f_ds, f_de in flips:
            use_ds = m_ds <= 0
            use_de = m_de <= 0
            if f_ds:
                use_ds = use_ds ^ (np.abs(m_ds) <= knife_ms)
            if f_de:
                use_de = use_de ^ (np.abs(m_de) <= knife_ms)
            use_ds = np.where(zlt, dzero < 1.1 * avg, use_ds)
            extrap = sampled + np.where(use_ds, dstart, avg / 2) \
                + np.where(use_de, de_ms / 1000.0, avg / 2)
            rate = delta * extrap / sampled / (window / 1000.0)
            out.append(np.where(cnt >= 2, rate, np.nan))
    return out[0] if knife_ms is None else np.stack(out)


def _group_sum(rates: np.ndarray, gid: np.ndarray) -> np.ndarray:
    """[..., S, T] per-series rates -> [..., T, G] sums (NaN as 0)."""
    r = np.nan_to_num(rates, nan=0.0)
    return np.stack([r[..., gid == g, :].sum(axis=-2) for g in range(G)],
                    axis=-1)


def groupsum_bound(args, bw: float, f32_rate: float):
    """(bytes, least ms, "bytes" or "operations") of one group-sum call:
    each boundary row of the families its modes read once (kc and kl share
    one run of T + dspan rows), base, one-hot and the outputs."""
    from filodb_tpu_torch.query import kernels as kn

    _, st, dspan, hi_mode, lo_mode, v_p, base, oh = args[:8]
    T = args[-1]
    n_s, G = v_p.shape[0], oh.shape[1]
    fams = 1 + (hi_mode != kn.GS_CUR) + (lo_mode != kn.GS_CUR)
    rows = (T + dspan) + T * (fams - 1)
    nbytes = (rows * n_s * kn.GS_SS * 12 + base.numel() * 4
              + oh.numel() * 4 + 2 * T * G * 4)
    ops = T * n_s * kn.GS_SS * (40 + 4 * G)
    by = "bytes" if nbytes / bw >= ops / f32_rate else "operations"
    return nbytes, 1e3 * max(nbytes / bw, ops / f32_rate), by


def extract_bytes(S: int, N: int, C: int, T: int, nonempty: int) -> int:
    """Bytes one boundary-extract call must move: every relative timestamp
    of the [S, N] rows once, the C payload channels at both boundaries of
    each of the `nonempty` windows that hold a sample, and the outputs
    (counts and both boundary times, int32, and both boundaries' C
    channels, f32, for each of S x T windows)."""
    return S * N * 4 + nonempty * 2 * C * 4 + S * T * (12 + 8 * C)


def time_groupsum(args, bw: float, f32_rate: float, what: str) -> dict:
    """The group-sum kernel on `args` held against its plain version, then
    timed beside it and its bound: `ms` by CUDA events over warmed
    back-to-back calls (the host's cost of a call included where it
    exceeds the kernel's), `device_ms` by graph_ms."""
    from filodb_tpu_torch.query import kernels as kn

    k_out = kn.counter_groupsum(*args)
    p_out = kn.counter_groupsum_reference(*args)
    err = check_groupsum(k_out, p_out, what)
    del k_out, p_out
    ms = time_ms(lambda: kn.counter_groupsum(*args))
    dms = graph_ms(lambda: kn.counter_groupsum(*args))
    pms = time_ms(lambda: kn.counter_groupsum_reference(*args), reps=5,
                  warm=1)
    nbytes, bound, by = groupsum_bound(args, bw, f32_rate)
    _, st, dspan, hi_mode, lo_mode, v_p, _, oh = args[:8]
    n_s, T = v_p.shape[0], args[-1]
    lp = kn.groupsum_launch_plan(n_s, T, oh.shape[1], hi_mode, lo_mode,
                                 torch.cuda.get_device_properties(0)
                                 .multi_processor_count)
    log(f"phase 3: {what} (n_s={n_s}, T={T}, st={st}, dspan={dspan}, "
        f"modes={hi_mode}/{lo_mode}; launch {json.dumps(lp)}): kernel "
        f"{ms:.4f} ms, device {dms:.4f} ms, plain {pms:.3f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e9:.4f} GB, {by}; device time "
        f"{100 * bound / dms:.1f} % of it)")
    return {"err": err, "ms": ms, "device_ms": dms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": by}


def engine_shape_args(gen, dev):
    """Group-sum arguments at the shape phase 4's first query sends the
    kernel: S_ENGINE series (16 s-tiles) x N_FULL slots, 60 s steps over
    the flushed range, 5 m window, G groups."""
    from filodb_tpu_torch.query import tilestore as tst

    q, start, end = engine_queries()[0]
    T = (end - start) // (STEP // 1000) + 1
    ts, vals = gen_counters(S_ENGINE, N_FULL, gen, dev)
    tiles = tst.AlignedTiles([{}] * S_ENGINE, BASE, DT,
                             torch.ones((S_ENGINE, N_FULL), dtype=torch.bool,
                                        device=dev), ts, vals)
    del ts, vals
    steps = start * 1000 + np.arange(T, dtype=np.int64) * STEP
    plan = tst.groupsum_plan(tiles, "rate", steps, WINDOW)
    assert plan is not None
    oh = torch.zeros((S_ENGINE, G), dtype=torch.float32, device=dev)
    oh[torch.arange(S_ENGINE, device=dev),
       torch.arange(S_ENGINE, device=dev) % G] = 1.0
    return ("rate", plan["st"], plan["dspan"], plan["hi_mode"],
            plan["lo_mode"], tiles.t_perm_fixed_tiled("cv", plan["st"]),
            tiles.t_fixed_base("cv"), oh, plan["kl0"], plan["w0e_rel"],
            WINDOW, STEP, T)


def phase_real_size(gen, dev, bw: float, f32_rate: float) -> dict:
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query import tilestore as tst

    t0 = time.perf_counter()
    ts, vals = gen_counters(S_FULL, N_FULL, gen, dev)
    ts_o = ts[:S_ORACLE].cpu().numpy().astype(np.int64)
    vals_o = vals[:S_ORACLE].cpu().numpy()
    tiles = tst.AlignedTiles([{}] * S_FULL, BASE, DT,
                             torch.ones((S_FULL, N_FULL), dtype=torch.bool,
                                        device=dev), ts, vals)
    del ts, vals
    base_bytes = S_FULL * N_FULL * 17
    steps0 = BASE + 400_000 + np.arange(T_FULL, dtype=np.int64) * STEP
    plan = tst.groupsum_plan(tiles, "rate", steps0, WINDOW)
    v_p = tiles.t_perm_fixed_tiled("cv", plan["st"])
    base = tiles.t_fixed_base("cv")
    torch.cuda.synchronize()
    log(f"phase 3: tiles {S_FULL}x{N_FULL} on the card in "
        f"{time.perf_counter() - t0:.1f} s: base {base_bytes / 1e9:.2f} GB, "
        f"packed group-sum channel {v_p.numel() * 4 / 1e9:.2f} GB")
    gid = torch.arange(S_FULL, device=dev) % G
    oh = torch.zeros((S_FULL, G), dtype=torch.float32, device=dev)
    oh[torch.arange(S_FULL, device=dev), gid] = 1.0
    seen = {}
    for phase in (0, 3000, -3000):
        steps = steps0 + phase
        plan = tst.groupsum_plan(tiles, "rate", steps, WINDOW)
        sums, cnts = tst.groupsum_counters(tiles, "rate", steps, WINDOW, oh)
        torch.cuda.synchronize()
        assert tuple(sums.shape) == (T_FULL, G)
        assert bool(torch.isfinite(sums).all()) and bool((cnts > 0).all())
        seen[(plan["hi_mode"], plan["lo_mode"])] = phase
    log(f"phase 3: group-sum at {len(seen)} mode pairs "
        f"{sorted(seen)} (window 5 m over +/-2 s jitter)")
    # parity vs the numpy f64 oracle: one-hot over the first S_ORACLE
    # series only
    oh_sub = oh.clone()
    oh_sub[S_ORACLE:] = 0.0
    plan = tst.groupsum_plan(tiles, "rate", steps0, WINDOW)
    sub = kn.counter_groupsum("rate", plan["st"], plan["dspan"],
                              plan["hi_mode"], plan["lo_mode"], v_p, base,
                              oh_sub, plan["kl0"], plan["w0e_rel"], WINDOW,
                              STEP, T_FULL)
    want = _group_sum(_oracle_rates(ts_o, vals_o, int(steps0[0]), T_FULL),
                      gid[:S_ORACLE].cpu().numpy())
    got = sub[0].double().cpu().numpy()
    rel = float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30))
                .max())
    assert rel < 1e-5, f"group-sum vs f64 oracle: max rel err {rel}"
    log(f"phase 3: group-sum vs numpy f64 oracle on {S_ORACLE} series: "
        f"max rel err {rel:.3g}")

    # B1 timing at this shape (BOTH/BOTH: every family read)
    args = ("rate", plan["st"], plan["dspan"], plan["hi_mode"],
            plan["lo_mode"], v_p, base, oh, plan["kl0"], plan["w0e_rel"],
            WINDOW, STEP, T_FULL)
    t1 = time_groupsum(args, bw, f32_rate, "group-sum at real size")
    b1 = {"name": "counter_groupsum", "route": "cuda",
          "source": "filodb_tpu_torch/csrc/counter_groupsum.cu",
          "replaces": "filodb_tpu/query/pallas_kernels.py:499",
          "max_abs_err": t1["err"], "ms": t1["ms"],
          "device_ms": t1["device_ms"],
          "plain_ms": t1["plain_ms"], "bound_ms": t1["bound_ms"],
          "bound_by": t1["bound_by"], "library_ms": None}
    del tiles, v_p, base, oh, oh_sub, args
    torch.cuda.empty_cache()
    # the same kernel at the shape the engine phase sends it
    te = time_groupsum(engine_shape_args(gen, dev), bw, f32_rate,
                       "group-sum at the engine shape")
    b1["max_abs_err"] = max(b1["max_abs_err"], te["err"])
    b1.update({"engine_shape_ms": te["ms"],
               "engine_shape_device_ms": te["device_ms"],
               "engine_shape_plain_ms": te["plain_ms"],
               "engine_shape_bound_ms": te["bound_ms"],
               "engine_shape_bound_by": te["bound_by"]})
    torch.cuda.empty_cache()

    # B2 at 65,536 series x 512 samples x 128 windows x 3 channels
    S2, N2, T2 = S_FULL, 512, 128
    tr, pay = gen_ragged(S2, N2, T2, STEP, WINDOW, gen, dev)
    k_out = kn.window_extract(tr, pay, STEP, WINDOW, T2)
    p_out = kn.window_extract_reference(tr, pay, STEP, WINDOW, T2)
    torch.cuda.synchronize()
    err2 = check_extract(k_out, p_out, "boundary extract at real size")
    nonempty = int((p_out[0] > 0).sum())
    ms2 = time_ms(lambda: kn.window_extract(tr, pay, STEP, WINDOW, T2))
    pms2 = time_ms(lambda: kn.window_extract_reference(tr, pay, STEP,
                                                       WINDOW, T2),
                   reps=5, warm=1)
    C = pay.shape[1]
    bytes2 = extract_bytes(S2, N2, C, T2, nonempty)
    ops2 = 2 * S2 * T2 * math.ceil(math.log2(N2 + 1))
    b2 = {"name": "window_extract", "route": "cuda",
          "source": "filodb_tpu_torch/csrc/window_extract.cu",
          "replaces": "filodb_tpu/query/pallas_kernels.py:690",
          "max_abs_err": err2, "ms": ms2, "plain_ms": pms2,
          "bound_ms": 1e3 * max(bytes2 / bw, ops2 / f32_rate),
          "bound_by": "bytes" if bytes2 / bw >= ops2 / f32_rate
          else "operations", "library_ms": None}
    log(f"phase 3: boundary-extract kernel {ms2:.4f} ms, plain "
        f"{pms2:.3f} ms, bound {b2['bound_ms']:.4f} ms "
        f"({bytes2 / 1e9:.3f} GB)")
    del tr, pay, k_out, p_out
    torch.cuda.empty_cache()
    return {"counter_groupsum": b1, "window_extract": b2}


ENGINE_TAIL = 30
# irregular-cadence series (10 s +/-6 s): cut from 1,024 with S_ENGINE
ENGINE_IRREGULAR = 512


def engine_rows(rng: np.random.Generator, S: int) -> dict:
    """The engine phases' data as (labels, ts, values) rows: S counter
    series x N_FULL flushed samples and an ENGINE_TAIL-sample tail each,
    ENGINE_IRREGULAR series of irregular cadence, and S gauge series
    (gauge_rows, with tails) -> {"counters", "counter_tails", "irregular",
    "gauges", "gauge_tails", "ts", "vals"}, the last two the counter
    series' [S, N_FULL + ENGINE_TAIL] times and values."""
    N, TAIL = N_FULL, ENGINE_TAIL
    ts = (BASE + np.arange(N + TAIL)[None, :] * DT
          + rng.integers(-J_MS, J_MS + 1, (S, N + TAIL)))
    vals = np.cumsum(rng.uniform(0, 5, (S, N + TAIL)), axis=1)
    vals[::97, N // 2:] -= vals[::97, N // 2 - 1:N // 2]
    lab = [{"_metric_": "http_requests_total", "_ws_": "demo",
            "_ns_": "App-0", "job": f"job{i % G}", "instance": f"i{i}"}
           for i in range(S)]
    irr = []
    for i in range(ENGINE_IRREGULAR):
        t = np.unique(BASE + np.arange(N) * DT
                      + rng.integers(-6_000, 6_000, N))
        irr.append(({"_metric_": "irregular_total", "_ws_": "demo",
                     "_ns_": "App-0", "job": f"job{i % G}",
                     "instance": f"k{i}"}, t,
                    np.cumsum(rng.uniform(0, 3, t.size))))
    g_flushed, g_tail = gauge_rows(
        np.random.default_rng(int(rng.integers(2**62))), S)
    return {"counters": [(lab[i], ts[i, :N], vals[i, :N])
                         for i in range(S)],
            "counter_tails": [(lab[i], ts[i, N:], vals[i, N:])
                              for i in range(S)],
            "irregular": irr, "gauges": g_flushed, "gauge_tails": g_tail,
            "ts": ts, "vals": vals}


# (rows, schema, flush) in loading order: the tails last, since a flush
# would encode them into chunks
LOAD_ORDER = (("counters", "prom-counter", True),
              ("irregular", "prom-counter", True),
              ("gauges", "gauge", True),
              ("counter_tails", "prom-counter", False),
              ("gauge_tails", "gauge", False))


def build_engine_shard(rng: np.random.Generator, S: int):
    """A TimeSeriesShard holding engine_rows(rng, S) -> (shard, rows)."""
    from filodb_tpu_torch import state
    from filodb_tpu_torch.core.memstore import TimeSeriesShard
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef

    rows = engine_rows(rng, S)
    shard = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0)
    for key, schema, flush in LOAD_ORDER:
        state.load_series(shard, rows[key], schema=schema, flush=flush)
    return shard, rows


GAUGE = "queue_depth"
GAUGE_PARTS = 32        # label part="p0" selects one gauge series in 32


def gauge_rows(rng: np.random.Generator, S: int):
    """S integer gauges (a queue depth: a random walk about 1,000 with
    steps of up to 15, 30 % repeats, and drops) x N_FULL flushed samples
    at DT +/- J_MS integer-ms jitter, one series in 8 missing 5 % of its
    scrapes, plus an ENGINE_TAIL-sample tail -> (flushed, tail) rows."""
    N, TAIL = N_FULL, ENGINE_TAIL
    ts = (BASE + np.arange(N + TAIL)[None, :] * DT
          + rng.integers(-J_MS, J_MS + 1, (S, N + TAIL)))
    d = np.where(rng.random((S, N + TAIL)) < 0.3, 0,
                 rng.integers(-15, 16, (S, N + TAIL)))
    vals = (1000 + np.cumsum(d, axis=1)).astype(np.float64)
    flushed, tail = [], []
    for i in range(S):
        lab = {"_metric_": GAUGE, "_ws_": "demo", "_ns_": "App-0",
               "job": f"job{i % G}", "instance": f"g{i}",
               "part": f"p{i % GAUGE_PARTS}"}
        keep = rng.random(N) > 0.05 if i % 8 == 0 else slice(None)
        flushed.append((lab, ts[i, :N][keep], vals[i, :N][keep]))
        tail.append((lab, ts[i, N:], vals[i, N:]))
    return flushed, tail


def engine_grid():
    """(start, end on the flushed chunks, end in the unflushed tail), in
    seconds, of the engine phases' 60 s step grids."""
    return (BASE // 1000 + 600, (BASE + (N_FULL - 10) * DT) // 1000,
            (BASE + (N_FULL + ENGINE_TAIL - 2) * DT) // 1000)


def engine_queries():
    """(PromQL, start s, end s) of the engine phase, 60 s steps."""
    start, flushed_end, tail_end = engine_grid()
    return [
        ("sum by (job) (rate(http_requests_total[5m]))", start, flushed_end),
        ("avg by (job) (rate(http_requests_total[5m]))", start, flushed_end),
        ("count by (job) (rate(http_requests_total[5m]))", start,
         flushed_end),
        ("rate(http_requests_total[5m])", start, tail_end),
        ("rate(irregular_total[5m])", start, flushed_end),
    ]


def check_engine_answer(q: str, got, want, variants: np.ndarray) -> dict:
    """Holds one engine answer against the engine's numpy oracle (`want`,
    rtol 1e-5) and, for the counter metric's rates, against this script's
    integer-rule oracle (`variants`, [4, S, T'] from _oracle_rates with
    KNIFE_MS over the same grid, T' >= T). Raises on a mismatch.

    Where a window's extrapolation branch is a knife edge, the engine's
    oracle decides it by an f64 compare and may take the other side: there
    the bound against `want` grows by the spread of that series' branch
    variants (summed over the group for a group sum, over its count for an
    average), and no more. The fused group-sum decides on integer ms, so
    its group answers must match variant 0 at rtol 1e-5 with no allowance;
    a per-series answer must match one of the four variants at rtol 1e-5,
    and the engine's oracle one of them at rtol 1e-9."""
    assert [dict(k) for k in got.keys] == [dict(k) for k in want.keys]
    assert got.values.shape == want.values.shape
    gv, wv = got.values, want.values
    assert np.array_equal(np.isnan(gv), np.isnan(wv))
    assert np.isfinite(gv).any()
    nan = np.isnan(wv)
    allow = np.zeros(wv.shape)
    out = {"knife_cells": 0}
    if "http_requests_total" in q and not q.startswith("count"):
        var = variants[..., :gv.shape[1]]
        spread = np.nan_to_num(np.nanmax(var, axis=0)
                               - np.nanmin(var, axis=0), nan=0.0)
        if " by (job) " in q:
            gid = np.arange(var.shape[1]) % G
            rows = [int(k["job"][3:]) for k in got.keys]
            nom = _group_sum(var[0], gid)[:, rows].T
            allow = _group_sum(spread, gid)[:, rows].T
            if q.startswith("avg"):
                n = _group_sum((~np.isnan(var[0])).astype(np.float64),
                               gid)[:, rows].T
                with np.errstate(all="ignore"):
                    nom, allow = nom / n, allow / n
            ierr = np.abs(gv - nom)
            assert (nan | (ierr <= 1e-5 * np.abs(nom) + 1e-9)).all(), \
                f"{q}: vs the integer-rule oracle, max abs err " \
                f"{np.nanmax(ierr)}"
            assert (nan | (np.abs(wv - nom) <= 1e-9 * np.abs(nom) + allow
                           + 1e-9)).all(), f"{q}: the oracles disagree"
        else:
            idx = [int(k["instance"][1:]) for k in got.keys]
            cand = var[:, idx]
            allow = spread[idx]

            def hits(x, rtol):
                return (np.abs(x[None] - cand)
                        <= rtol * np.abs(cand) + 1e-9).any(axis=0)
            assert (nan | hits(gv, 1e-5)).all(), \
                f"{q}: matches no branch variant of the integer-rule oracle"
            assert (nan | hits(wv, 1e-9)).all(), f"{q}: the oracles disagree"
        cells = (allow > 0) & ~nan
        with np.errstate(all="ignore"):
            rel_allow = allow / np.abs(wv)
            rel_err = np.abs(gv - wv) / np.abs(wv)
        out = {"knife_cells": int(cells.sum()),
               "max_rel_allowance": float(rel_allow[cells].max())
               if cells.any() else 0.0,
               "max_rel_err_knife": float(rel_err[cells].max())
               if cells.any() else 0.0}
    err = np.abs(gv - wv)
    ok = nan | (err <= 1e-5 * np.abs(wv) + allow + 1e-9)
    assert ok.all(), f"{q}: max abs err {np.nanmax(err)}"
    with np.errstate(all="ignore"):
        out["max_rel_err"] = float(np.nanmax(err / np.abs(wv)))
    return out


def phase_engine(rng: np.random.Generator) -> dict:
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query.backend import TorchBackend
    from filodb_tpu_torch.query.engine import QueryEngine

    S = S_ENGINE
    t0 = time.perf_counter()
    shard, rows = build_engine_shard(rng, S)
    ts, vals, irr = rows["ts"], rows["vals"], rows["irregular"]
    ingest_s = time.perf_counter() - t0
    log(f"phase 4: shard with {S} counter series x {N_FULL} samples "
        f"(+{ENGINE_TAIL} unflushed), {ENGINE_IRREGULAR} irregular series "
        f"and {S} gauge series (+{ENGINE_TAIL} unflushed), ingest + flush "
        f"{ingest_s:.1f} s")

    be = TorchBackend()
    oracle = QueryEngine([shard])
    engine = QueryEngine([shard], backend=be)
    queries = engine_queries()
    calls, originals = record_kernel_calls()
    kn.reset_launches()
    t1 = time.perf_counter()
    results = []
    split = None
    for q, start, end in queries:
        plan = parse_query_range(q, TimeStepParams(start, STEP // 1000,
                                                   end))
        timer = HostSplit() if split is None else None
        tq = time.perf_counter()
        try:
            got = engine.execute(plan)
        finally:
            if timer is not None:
                timer.restore()
        secs = time.perf_counter() - tq
        if timer is not None:
            split = timer.split(secs)
            log(f"phase 4: host split of the first query ({q}): "
                f"{json.dumps(split)}")
        results.append((q, plan, got, secs))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t1
    launches = dict(kn.LAUNCHES)
    restore_kernels(originals)
    log(f"phase 4: main path {main_s:.2f} s, kernel launches {launches}, "
        f"fused aggregations {be.fused_aggs}, packed dispatches "
        f"{be.packed_dispatches}, tile builds {be.tile_builds}")
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the main path"
    assert be.fused_aggs > 0
    T_max = max(r[2].values.shape[1] for r in results)
    variants = _oracle_rates(ts, vals, queries[0][1] * 1000, T_max,
                             knife_ms=KNIFE_MS)
    readings = {}
    for q, plan, got, secs in results:
        r = check_engine_answer(q, got, oracle.execute(plan), variants)
        readings[q] = r
        log(f"phase 4: {q} -> {got.values.shape} in {secs:.3f} s, agrees "
            f"with the numpy oracle: {json.dumps(r)}")
    errs = check_kernel_calls(calls, originals, "the main path")
    log(f"phase 4: main-path kernel calls held against the plain versions: "
        f"{ {k: len(v) for k, v in calls.items()} }")
    # what the tile cache held after the main path: phase 15 certifies
    # the cache's claim over the same entries
    tile_cache = [None if e.tiles is None else list(e.tiles.valid.shape)
                  for e in be._tile_cache.values()]
    log(f"phase 4: tile cache entries (series, slots): {tile_cache}")
    return {"launches": launches, "errs": errs, "ingest_s": ingest_s,
            "shard": shard, "backend": be, "irr": irr, "ts": ts,
            "vals": vals, "rows": rows, "first_query_split": split,
            "tile_cache": tile_cache}


class HostSplit:
    """Wall seconds spent in the first engine query's stages, by
    time.perf_counter around the calls (the calls themselves unchanged):
    series selection and chunk decode (engine.select_raw_series), row
    alignment (tilestore._align_rows), tile assembly and host-to-device
    copies (tilestore.build_aligned_tiles less the alignment), and the
    group-sum (tilestore.groupsum_counters: the lazily packed group-sum
    channels and the kernel, synchronised)."""

    TARGETS = (("engine", "select_raw_series", "select_decode_s", False),
               ("tst", "_align_rows", "align_rows_s", False),
               ("tst", "build_aligned_tiles", "build_tiles_s", False),
               ("tst", "groupsum_counters", "groupsum_device_s", True))

    def __init__(self):
        from filodb_tpu_torch.query import engine as engine_mod
        from filodb_tpu_torch.query import tilestore as tst

        self.mods = {"engine": engine_mod, "tst": tst}
        self.secs = {label: 0.0 for *_, label, _ in self.TARGETS}
        self.originals = []
        for mod, name, label, sync in self.TARGETS:
            fn = getattr(self.mods[mod], name)
            self.originals.append((mod, name, fn))
            setattr(self.mods[mod], name, self._wrap(fn, label, sync))

    def _wrap(self, fn, label, sync):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                self.secs[label] += time.perf_counter() - t0
        return call

    def restore(self) -> None:
        for mod, name, fn in self.originals:
            setattr(self.mods[mod], name, fn)

    def split(self, total_s: float) -> dict:
        s = dict(self.secs)
        s["tile_assembly_h2d_s"] = s["build_tiles_s"] - s["align_rows_s"]
        s["other_host_s"] = (total_s - s["select_decode_s"]
                             - s["build_tiles_s"] - s["groupsum_device_s"])
        s["total_s"] = total_s
        return s


def record_kernel_calls():
    """Wrap both kernel wrappers so that every call is recorded (to hold it
    against the plain version afterwards) -> (calls, originals)."""
    from filodb_tpu_torch.query import kernels as kn

    calls = {"counter_groupsum": [], "window_extract": []}
    originals = {name: getattr(kn, name) for name in calls}

    def recorder(name):
        def call(*a, **kw):
            calls[name].append((a, kw))
            return originals[name](*a, **kw)
        return call

    for name in calls:
        setattr(kn, name, recorder(name))
    return calls, originals


def restore_kernels(originals) -> None:
    from filodb_tpu_torch.query import kernels as kn

    for name, fn in originals.items():
        setattr(kn, name, fn)


def check_kernel_calls(calls, originals, what: str) -> dict:
    """Rerun each recorded kernel call and hold it against the plain
    version on the same inputs -> max error per kernel."""
    from filodb_tpu_torch.query import kernels as kn

    errs = {}
    for a, kw in calls["counter_groupsum"]:
        got = originals["counter_groupsum"](*a, **kw)
        want = kn.counter_groupsum_reference(*a, **kw)
        e = check_groupsum(got, want, f"group-sum on {what}")
        errs["counter_groupsum"] = max(errs.get("counter_groupsum", 0.0), e)
    for a, kw in calls["window_extract"]:
        got = originals["window_extract"](*a, **kw)
        want = kn.window_extract_reference(*a, **kw)
        errs["window_extract"] = check_extract(got, want,
                                               f"extract on {what}")
    return errs


class LaunchClasses:
    """Counts the kernels' launches by the priority class they serve, so
    that phase 7 tells the rules engine's wall-clock ticks (BACKGROUND,
    set by rule_eval_range) apart from its own queries (every other
    class): on the launching thread its QoS class, on the batcher's
    executor thread the class of the batch it runs (a batch a query
    joined counts as the query's). The kernel wrappers' calls are
    serialised here, so that each call's LAUNCHES delta is its own."""

    def __init__(self, batcher):
        import threading
        from filodb_tpu_torch.query import kernels as kn
        from filodb_tpu_torch.query import qos

        self.kn, self.batcher = kn, batcher
        self.background = qos.PRIORITY_BACKGROUND
        self.lock = threading.Lock()
        self.local = threading.local()
        self.counts = {"rules": dict.fromkeys(kn.LAUNCHES, 0),
                       "queries": dict.fromkeys(kn.LAUNCHES, 0)}
        self.wrapped = {name: getattr(kn, name) for name in kn.LAUNCHES}
        for name, fn in self.wrapped.items():
            setattr(kn, name, self._count(name, fn))
        execute = batcher._execute

        def run_at(key, p, run_batch, queued, **kw):
            self.local.priority = p.priority
            try:
                return execute(key, p, run_batch, queued, **kw)
            finally:
                self.local.priority = None
        batcher._execute = run_at

    def _count(self, name, fn):
        def call(*a, **kw):
            from filodb_tpu_torch.query import qos

            prio = getattr(self.local, "priority", None)
            if prio is None:
                prio = qos.current_priority()
            who = "rules" if prio == self.background else "queries"
            with self.lock:
                n0 = self.kn.LAUNCHES[name]
                try:
                    return fn(*a, **kw)
                finally:
                    self.counts[who][name] += self.kn.LAUNCHES[name] - n0
        return call

    def queries(self) -> dict:
        return dict(self.counts["queries"])

    def restore(self) -> None:
        del self.batcher._execute
        for name, fn in self.wrapped.items():
            setattr(self.kn, name, fn)


# ---------------------------------------------------------------------------
# phase 5: every device function through the engine
# ---------------------------------------------------------------------------

# the prefix-sum family on the packed path (_window_endpoint): differences
# of long f64 prefix sums, the variance unshifted
PACKED_PREFIX = ("sum_over_time", "avg_over_time", "stddev_over_time",
                 "stdvar_over_time", "z_score", "rate_over_delta",
                 "increase_over_delta")
# the aligned functions phase 5 runs besides its four named full-width ones
ALIGNED_REST = ("sum_over_time", "count_over_time", "stdvar_over_time",
                "z_score", "resets", "timestamp", "last_sample",
                "first_over_time", "present_over_time", "absent_over_time",
                "rate_over_delta", "increase_over_delta")


def function_queries():
    """Phase 5's queries as (func, PromQL, end s, route, oracle PromQL):
    every function of DEVICE_FUNCS through the engine on the phase-4 grid.

    route: "aligned" (the tiles alone), "aligned+tail" (the tiles, then the
    packed path for the steps that reach the unflushed tail), "packed"
    (_window_endpoint or _window_gather), "extract" (the boundary-extract
    kernel). Where an oracle query is named, the numpy oracle answers the
    gauges with part="p0" (one series in GAUGE_PARTS) and the device's
    full-width answer is held against it on those rows: the oracle's
    order statistics loop over every window in Python (min_over_time
    about 2 ms and quantile_over_time about 40 ms a series)."""
    _, fe, te = engine_grid()
    g = GAUGE
    sub = f'{g}{{part="p0"}}'
    q = [("last_over_time", f"last_over_time({g}[5m])", fe, "aligned", None),
         ("avg_over_time", f"avg_over_time({g}[5m])", te, "aligned+tail",
          None),
         ("stddev_over_time", f"stddev_over_time({g}[5m])", fe, "aligned",
          None),
         ("changes", f"changes({g}[5m])", fe, "aligned", None),
         ("irate", "irate(http_requests_total[5m])", fe, "packed", None),
         ("quantile_over_time", f"quantile_over_time(0.9, {g}[5m])", fe,
          "packed", f"quantile_over_time(0.9, {sub}[5m])"),
         ("max_over_time", f"sum by (job) (max_over_time({g}[5m]))", fe,
          "packed", None)]
    q += [(f, f"{f}({g}[5m])", fe, "aligned", None) for f in ALIGNED_REST]
    q += [("idelta", f"idelta({g}[5m])", fe, "packed", None),
          ("min_over_time", f"min_over_time({g}[5m])", fe, "packed",
           f"min_over_time({sub}[5m])"),
          ("max_over_time", "max_over_time(irregular_total[5m])", fe,
           "packed", None),
          ("quantile_over_time",
           'quantile_over_time(0.5, irregular_total{job="job0"}[5m])', fe,
           "packed", None)]
    q += [(f, f"{f}(irregular_total[5m])", fe, "extract", None)
          for f in ("rate", "increase", "delta")]
    q += [(f, f"{f}(irregular_total[5m])", fe, "packed", None)
          for f in PACKED_PREFIX]
    return q


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float64)))


def packed_prefix_bound(func: str, got, want, rows, cnt, mean, var):
    """Per-cell absolute bound on |device - oracle| of a prefix-sum function
    on the packed path, from each row's prefix magnitude and the window's
    count. A prefix of n terms added in any order is off by at most
    (n - 1) u sum|v| (u = 2^-53), so a window sum of the device and of the
    oracle differ by at most Ds = 4 (n - 1) u sum|v|, and Ds2 likewise
    with sum v^2 for the squares. Then avg: Ds/cnt; stdvar: (Ds2 + 2|mean|
    Ds + Ds^2/cnt)/cnt + 4 ulp(s2/cnt) (the unshifted E[x^2] - mean^2);
    stddev: that over (sd_dev + sd_oracle); z_score: (Ds/cnt + |z| *
    stdvar's bound / sd) / sd; each plus a few ulps of the result."""
    u = 2.0 ** -53
    n = np.array([max(v.size - 1, 0) for _, v in rows], float)[:, None]
    ds = 4 * n * u * np.array([np.abs(v).sum() for _, v in rows])[:, None]
    ds2 = 4 * n * u * np.array([(v * v).sum() for _, v in rows])[:, None]
    with np.errstate(all="ignore"):
        if func in ("sum_over_time", "increase_over_delta"):
            return ds + _ulp(want)
        if func == "rate_over_delta":
            return ds / (WINDOW / 1000.0) + 2 * _ulp(want)
        if func == "avg_over_time":
            return ds / cnt + 2 * _ulp(want)
        bvar = ((ds2 + 2 * np.abs(mean) * ds + ds * ds / cnt) / cnt
                + 4 * _ulp(var + mean * mean))
        if func == "stdvar_over_time":
            return bvar
        if func == "stddev_over_time":
            return np.where(got + want == 0, 0.0,
                            bvar / (got + want)) + 2 * _ulp(want)
        sd = np.sqrt(var)
        return ((ds / cnt + np.abs(want) * (bvar / sd + 2 * _ulp(sd))) / sd
                + 4 * _ulp(want))


def check_function_answer(func: str, q: str, got, want, allow=None) -> dict:
    """One phase-5 answer against the engine's numpy oracle: the same
    series (rows of `got` not in `want` are dropped when the oracle ran on
    a subset), NaN in the same cells, and |got - want| <= rtol |want| +
    1e-9 (+ `allow`, the packed prefix-sum bound), rtol 1e-9 (z_score
    5e-6, the reference's own bound)."""
    gk = [tuple(sorted(k.items())) for k in got.keys]
    wk = [tuple(sorted(k.items())) for k in want.keys]
    rows = {k: i for i, k in enumerate(gk)}
    assert set(wk) <= set(rows), f"{q}: series differ"
    assert len(wk) == len(gk) or len(wk) < len(gk) // 2
    gv = got.values[[rows[k] for k in wk]]
    wv = want.values
    assert gv.shape == wv.shape, f"{q}: {gv.shape} vs {wv.shape}"
    assert np.array_equal(np.isnan(gv), np.isnan(wv)), f"{q}: NaN cells"
    assert func == "absent_over_time" or np.isfinite(gv).any(), q
    rtol = 5e-6 if func == "z_score" else 1e-9
    err = np.abs(gv - wv)
    lim = rtol * np.abs(wv) + 1e-9
    if allow is not None:
        lim = lim + allow
    ok = np.isnan(wv) | (err <= lim)
    assert ok.all(), f"{q}: max abs err {np.nanmax(err)}"
    out = {"rows": int(gv.shape[0]), "max_abs_err": float(np.nanmax(err))
           if np.isfinite(wv).any() else 0.0}
    if allow is not None:
        fin = np.isfinite(wv)
        out["max_bound"] = float(allow[fin].max())
        out["max_err_over_bound"] = float((err[fin] / allow[fin]).max())
    return out


# families timed at the full-width shape: (family, func, device function,
# JAX counterpart by file:line)
FAMILIES = (
    ("aligned endpoint", "last_over_time", "evaluate_aligned",
     "filodb_tpu/query/tilestore.py:695"),
    ("aligned prefix sum", "avg_over_time", "evaluate_aligned",
     "filodb_tpu/query/tilestore.py:695"),
    ("packed endpoint", "irate", "_window_endpoint",
     "filodb_tpu/query/tpu.py:288"),
    ("packed gather", "max_over_time", "_window_gather",
     "filodb_tpu/query/tpu.py:394"),
    ("packed gather", "quantile_over_time", "_window_gather",
     "filodb_tpu/query/tpu.py:394"),
)


class DeviceSpans:
    """Wraps the backend's device functions: each call's span between CUDA
    events (what the card runs for it, launch gaps included) is added to
    the running query's device time, and the args of the widest call (most
    output cells) of each (function, func) of FAMILIES are kept for
    timing."""

    NAMES = (("tst", "evaluate_aligned"), ("tst", "evaluate_counters_t"),
             ("pb", "_window_endpoint"), ("pb", "_window_gather"),
             ("pb", "_extract_rate"))

    def __init__(self):
        from filodb_tpu_torch.query import backend as pb
        from filodb_tpu_torch.query import tilestore as tst

        self.mods = {"tst": tst, "pb": pb}
        self.originals = {}
        self.events = []
        self.widest = {}
        self.timed = {(name, func) for _, func, name, _ in FAMILIES}
        for mod, name in self.NAMES:
            fn = getattr(self.mods[mod], name)
            self.originals[(mod, name)] = fn
            setattr(self.mods[mod], name, self._wrap(name, fn))

    @staticmethod
    def _cells(name, a):
        if name == "evaluate_aligned":
            return len(a[0].keys) * a[2].size
        if name == "_window_gather":
            return a[2].shape[0] * a[8]
        if name == "_window_endpoint":
            return a[1].shape[0] * a[7]
        return 0

    def _wrap(self, name, fn):
        def call(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            self.events.append((e0, e1))
            func = a[1] if name == "evaluate_aligned" else a[0]
            key = (name, func)
            n = self._cells(name, a) if key in self.timed else 0
            if n and n > self.widest.get(key, (0,))[0]:
                self.widest[key] = (n, a, kw)
            return out
        return call

    def take_ms(self) -> float:
        """Device ms of the calls since the last take (synchronises)."""
        torch.cuda.synchronize()
        ms = sum(e0.elapsed_time(e1) for e0, e1 in self.events)
        self.events = []
        return ms

    def restore(self) -> None:
        for (mod, name), fn in self.originals.items():
            setattr(self.mods[mod], name, fn)


def family_bound(name: str, a, bw: float):
    """(bytes, least ms) of one device-function call: what it must read
    at least, each byte once, plus its [S, T] f64 output.
      evaluate_aligned: per series and step the boundary slots it selects:
        an endpoint function one sample (value + timestamp, 16 B), a
        prefix-sum function the prefix value, prefix count and timestamp
        at both window edges (48 B);
      _window_endpoint (irate): every timestamp of every row once, and the
        two last samples' values of each window, each value once;
      _window_gather: every sample (timestamp + value) once."""
    if name == "evaluate_aligned":
        tiles, func, steps = a[0], a[1], a[2]
        cells = len(tiles.keys) * steps.size
        per = 16 if func == "last_over_time" else 48
        nbytes = cells * (per + 8)
    else:
        off = 2 if name == "_window_gather" else 1
        lens = a[off + 2]
        T = a[off + 6]
        cells = lens.shape[0] * T
        n = int(lens.sum())
        if name == "_window_gather":
            nbytes = n * 16 + cells * 8
        else:
            nbytes = n * 8 + min(2 * cells, n) * 8 + cells * 8
    return nbytes, 1e3 * nbytes / bw


def function_stats(engine, rows_q: str):
    """Oracle count, mean and variance of every window of `rows_q`'s
    selection, by series key."""
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    start, fe, _ = engine_grid()
    out = {}
    for f in ("count_over_time", "avg_over_time", "stdvar_over_time"):
        r = engine.execute(parse_query_range(
            f"{f}({rows_q}[5m])", TimeStepParams(start, STEP // 1000, fe)))
        out[f] = (r.keys, r.values)
    return out


def phase5_answers(shard, irr, be, spans=None) -> dict:
    """Phase 5's queries through QueryEngine(backend=be), each held against
    the engine's numpy oracle, its route asserted by the backend's
    counters -> per-query readings. Runs on the CPU too (spans=None)."""
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    from filodb_tpu_torch.query.backend import DEVICE_FUNCS
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query import kernels as kn

    queries = function_queries()
    covered = {f for f, *_ in queries}
    assert covered == set(DEVICE_FUNCS), sorted(set(DEVICE_FUNCS) ^ covered)
    oracle = QueryEngine([shard])
    engine = QueryEngine([shard], backend=be)
    start = engine_grid()[0]
    stats = function_stats(oracle, "irregular_total")
    irr_rows = {lab["instance"]: (t, v) for lab, t, v in irr}
    readings = []
    for func, q, end, route, oq in queries:
        tp = TimeStepParams(start, STEP // 1000, end)
        before = (be.aligned_evals, be.packed_dispatches,
                  kn.LAUNCHES["window_extract"])
        t0 = time.perf_counter()
        got = engine.execute(parse_query_range(q, tp))
        wall = time.perf_counter() - t0
        dev_ms = spans.take_ms() if spans is not None else None
        d_al = be.aligned_evals - before[0]
        d_pk = be.packed_dispatches - before[1]
        d_wx = kn.LAUNCHES["window_extract"] - before[2]
        want_route = {"aligned": (1, 0), "aligned+tail": (1, 1),
                      "packed": (0, 1), "extract": (0, 1)}[route]
        assert (d_al, d_pk) == want_route, (q, route, d_al, d_pk)
        if route == "extract" and spans is not None:
            assert d_wx == 1, (q, d_wx)
        t1 = time.perf_counter()
        want = oracle.execute(parse_query_range(oq or q, tp))
        oracle_s = time.perf_counter() - t1
        if route == "extract":
            r = check_engine_answer(q, got, want, None)
        elif "irregular_total" in q and func in PACKED_PREFIX:
            keys = [k["instance"] for k in got.keys]
            st = {f: dict(zip((k["instance"] for k in ks), v))
                  for f, (ks, v) in stats.items()}
            cnt, mean, var = (np.stack([st[f][k] for k in keys]) for f in
                              ("count_over_time", "avg_over_time",
                               "stdvar_over_time"))
            allow = packed_prefix_bound(func, got.values, want.values,
                                        [irr_rows[k] for k in keys], cnt,
                                        mean, var)
            r = check_function_answer(func, q, got, want, allow)
        else:
            r = check_function_answer(func, q, got, want)
        r.update({"q": q, "route": route, "wall_ms": 1e3 * wall,
                  "oracle_s": oracle_s})
        if dev_ms is not None:
            r["device_ms"] = dev_ms
            r["host_share"] = max(0.0, 1.0 - dev_ms / (1e3 * wall))
        readings.append(r)
        log(f"phase 5: {q} -> {got.values.shape} by {route}: "
            f"{json.dumps({k: v for k, v in r.items() if k != 'q'})}")
    return {"readings": readings}


def phase_functions(eng: dict, bw: float) -> dict:
    """Phase 5: every function of DEVICE_FUNCS through the engine on the
    card over the phase-4 shard (the phase-4 backend and its tiles stay
    resident), then each family's device function timed alone at the
    full-width shape."""
    from filodb_tpu_torch.query import backend as pb
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query import tilestore as tst

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    be = eng["backend"]
    spans = DeviceSpans()
    calls, originals = record_kernel_calls()
    kn.reset_launches()
    t0 = time.perf_counter()
    try:
        out = phase5_answers(eng["shard"], eng["irr"], be, spans)
    finally:
        spans.restore()
        restore_kernels(originals)
    launches = dict(kn.LAUNCHES)
    log(f"phase 5: {len(out['readings'])} queries in "
        f"{time.perf_counter() - t0:.1f} s; kernel launches {launches}; "
        f"aligned evals {be.aligned_evals}, packed dispatches "
        f"{be.packed_dispatches}, tile builds {be.tile_builds}, hits "
        f"{be.tile_hits}")
    assert launches["window_extract"] > 0, "window_extract not launched"
    errs = check_kernel_calls(calls, originals, "phase 5")
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 5: device memory peak {peak / 2**30:.2f} GiB "
        f"({base_mem / 2**30:.2f} GiB resident before, the phase-4 tiles "
        f"among it)")
    # each family's device function alone, on its widest call's inputs
    mods = {"evaluate_aligned": tst, "_window_endpoint": pb,
            "_window_gather": pb}
    fams = []
    for family, func, name, jax_src in FAMILIES:
        _, a, kw = spans.widest[(name, func)]
        fn = getattr(mods[name], name)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: fn(*a, **kw), reps=10, warm=2)
        fpeak = torch.cuda.max_memory_allocated()
        nbytes, bound = family_bound(name, a, bw)
        src = inspect.getsourcefile(fn)
        line = inspect.getsourcelines(fn)[1]
        if name == "evaluate_aligned":
            shape = [len(a[0].keys), int(a[2].size), a[0].num_slots]
        else:
            ts = a[2] if name == "_window_gather" else a[1]
            shape = list(ts.shape) + [a[8] if name == "_window_gather"
                                      else a[7]]
            if name == "_window_gather":
                shape.append(a[1])
        fams.append({"family": family, "func": func, "jax": jax_src,
                     "port": f"{os.path.relpath(src, REPO)}:{line}",
                     "shape": shape, "ms": ms, "bound_ms": bound,
                     "bound_bytes": nbytes, "share": bound / ms,
                     "peak_gib": fpeak / 2**30,
                     "extra_gib": (fpeak - before) / 2**30})
        log(f"phase 5: {family} ({func}, {name} {shape}): {ms:.3f} ms, "
            f"byte bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB, "
            f"{100 * bound / ms:.2f} %), peak {fpeak / 2**30:.2f} GiB "
            f"(+{(fpeak - before) / 2**30:.2f})")
    del spans
    return {"functions": fams, "queries": out["readings"],
            "launches": launches, "errs": errs, "peak_gib": peak / 2**30}


# ---------------------------------------------------------------------------
# phase 6: the serving fast path
# ---------------------------------------------------------------------------

BURST = 4               # queries released together by a barrier (cut
                        # from 8 to make room for phase 9's full-width
                        # join)
GRIDS = 8               # grid positions the clients of phases 6 and 7
                        # cycle through, up to GRIDS - 1 steps early
BURST_ROUNDS = 1        # bursts of each key with the batcher on (cut
                        # from 2 to keep phase 6 near 90 s)
DOOR_WAIT_S = 60.0      # bound on a burst member's wait at the batcher's
                        # door
CLIENTS = 4             # free-running engine clients (cut from 16 to
                        # make room for phase 12, from 8 for phase 14)
CLIENT_WARM = 1         # first queries of each client, left out (warm-up)
CLIENT_QUERIES = 1      # queries of each client that are measured (cut
                        # from 10 to make room for phase 7, from 3 for
                        # phase 9, from 2 for phase 11; the steady window
                        # is then reported when it forms, not asserted)
WAIT_S = 300.0          # bound on every wait of phase 6
REBUILD_QUERIES = 4     # concurrent queries sent while a rebuild runs

# (key, metric, func) of the bursts: the aligned counter batch, the aligned
# batch, the packed gather and prefix-sum batches, and the packed rate
# (a batch of many on _window_endpoint against the extract kernel alone)
BURST_KEYS = (("aligned counter", "http_requests_total", "rate"),
              ("aligned", GAUGE, "avg_over_time"),
              ("packed gather", "irregular_total", "max_over_time"),
              ("packed prefix sum", "irregular_total", "sum_over_time"),
              ("packed rate", "irregular_total", "rate"))


def run_threads(n: int, target) -> None:
    """target(i) on n threads; every thread joined (WAIT_S at most), the
    first exception of any re-raised."""
    import threading

    errs = []

    def body(i):
        try:
            target(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
    ths = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in ths), "a serving thread hung"
    if errs:
        raise errs[0]


def select_metric(shard, metric: str):
    """The metric's whole series as the engine selects them (the parsed
    filters, full reads with snapshot keys), so the tile cache keys match
    the engine's."""
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    from filodb_tpu_torch.query.engine import select_raw_series

    start, _, end = engine_grid()
    plan = parse_query_range(f"rate({metric}[5m])",
                             TimeStepParams(start, STEP // 1000, end))
    return select_raw_series([shard], plan.raw.filters,
                             start * 1000 - WINDOW, end * 1000, full=True)


def burst_params(nsteps: int, ks):
    """Grids shifted by k x STEP: the dashboard-refresh shape."""
    from filodb_tpu_torch.query.model import RangeParams

    start = engine_grid()[0] * 1000
    return [RangeParams(start + k * STEP, STEP,
                        start + (k + nsteps - 1) * STEP) for k in ks]


def burst(be, series, func: str, params, door: bool = False):
    """One periodic_samples per grid on its own thread, all released by a
    barrier at the backend -> (answers, latencies s). With `door` (the
    batcher on), each member also waits at the batcher's submit until
    every member has finished its host preparation: that preparation
    holds the interpreter lock, so members released together at the
    backend can reach the batcher spread wider than its 1 ms residual
    gather window, each then dispatching alone. Every member calls
    submit once on these grids; a member that does not breaks the door
    after DOOR_WAIT_S. A latency counts from the backend's barrier, the
    wait at the door included."""
    import threading

    outs = [None] * len(params)
    lat = [0.0] * len(params)
    barrier = threading.Barrier(len(params))

    def one(i):
        barrier.wait(WAIT_S)
        t0 = time.perf_counter()
        outs[i] = be.periodic_samples(series, params[i], func,
                                      WINDOW).values
        lat[i] = time.perf_counter() - t0
    b = be.batcher
    if door:
        gate = threading.Barrier(len(params))
        submit = b.submit

        def at_door(*a, **kw):
            gate.wait(DOOR_WAIT_S)
            return submit(*a, **kw)
        b.submit = at_door
    try:
        run_threads(len(params), one)
    finally:
        if door:
            del b.submit
    return outs, lat


class BatchCapture:
    """Records the widest batch the backend dispatches (its run function,
    arguments and members), to time it again against its members one by
    one."""

    NAMES = ("_aligned_run", "_packed_run")

    def __init__(self, be):
        self.be = be
        self.best = None
        for name in self.NAMES:
            setattr(be, name, self._wrap(getattr(be, name)))

    def _wrap(self, run):
        def call(*a):
            members = a[-1]
            if len(members) >= 2 and (self.best is None
                                      or len(members) > len(self.best[2])):
                self.best = (run, a[:-1], list(members))
            return run(*a)
        return call

    def restore(self) -> None:
        for name in self.NAMES:
            delattr(self.be, name)

    def dispatch_ms(self) -> dict:
        """One batched dispatch of the B members against B single
        dispatches, each with its copies to the host, between CUDA
        events."""
        run, args, members = self.best
        n = len(members)

        def batched():
            res = run(*args, members)
            for i in range(n):
                res.get(i)

        def singles():
            for m in members:
                run(*args, [m]).get(0)
        out = {"members": n,
               "batched_ms": time_ms(batched, reps=2, warm=1),
               "singles_ms": time_ms(singles, reps=2, warm=1)}
        out["saving"] = 1.0 - out["batched_ms"] / out["singles_ms"]
        return out


def rate_variants(ts, vals, start_ms: int, T: int):
    return _oracle_rates(ts, vals, start_ms, T, knife_ms=KNIFE_MS)


def check_rates(keys, got: np.ndarray, variants, grouped: bool) -> float:
    """The counter metric's rates against the integer-rule oracle's branch
    variants ([4, S, T'], T' >= T): a per-series cell within rtol 1e-5 of
    one variant; a group sum within rtol 1e-5 of the group sum of variant
    0 plus the group sum of the variants' spread (each member may take
    either side of a knife edge). NaN cells must coincide. Returns the
    largest relative error: a per-series cell's against its nearest
    variant, a group sum's against variant 0's."""
    var = variants[..., :got.shape[1]]
    if grouped:
        gid = np.arange(var.shape[1]) % G
        rows = [int(k["job"][3:]) for k in keys]
        spread = np.nan_to_num(np.nanmax(var, axis=0)
                               - np.nanmin(var, axis=0), nan=0.0)
        nom = _group_sum(var[0], gid)[:, rows].T
        allow = _group_sum(spread, gid)[:, rows].T
        nan = np.isnan(got)
        assert not nan.any(), "group sums with NaN"
        assert (np.abs(got - nom) <= 1e-5 * np.abs(nom) + allow
                + 1e-9).all(), "group sums disagree with the oracle"
        want = nom
    else:
        idx = [int(k["instance"][1:]) for k in keys]
        cand = var[:, idx]
        nan = np.isnan(cand[0])
        assert np.array_equal(np.isnan(got), nan), "NaN cells differ"
        hit = (np.abs(got[None] - cand) <= 1e-5 * np.abs(cand)
               + 1e-9).any(axis=0)
        assert (nan | hit).all(), "rates match no branch of the oracle"
        with np.errstate(all="ignore"):
            return float(np.nanmax(np.nanmin(
                np.abs(got[None] - cand) / np.abs(cand), axis=0)))
    with np.errstate(all="ignore"):
        return float(np.nanmax(np.abs(got - want) / np.abs(want)))


def check_rows(func: str, series, got: np.ndarray, params, stride: int
               ) -> float:
    """Rows 0, stride, 2 stride, ... of a packed or gauge answer against
    the numpy oracle (rangefn): rtol 1e-9, atol 1e-9; the packed rate
    rtol 1e-5 as phase 5; the packed sum within packed_prefix_bound.
    Returns the largest absolute error."""
    from filodb_tpu_torch.query import rangefn as rf

    rows = list(range(0, len(series), stride))
    want = np.vstack([rf.evaluate(func, series[r].ts, series[r].values,
                                  params.start_ms, params.step_ms,
                                  params.end_ms, WINDOW) for r in rows])
    g = got[rows]
    assert np.array_equal(np.isnan(g), np.isnan(want)), f"{func}: NaN cells"
    assert np.isfinite(g).any(), func
    err = np.abs(g - want)
    rtol = 1e-5 if func == "rate" else 1e-9
    lim = rtol * np.abs(want) + 1e-9
    if func == "sum_over_time":
        lim = lim + packed_prefix_bound(
            func, g, want, [(series[r].ts, series[r].values) for r in rows],
            None, None, None)
    assert (np.isnan(want) | (err <= lim)).all(), \
        f"{func}: max abs err {np.nanmax(err)}"
    return float(np.nanmax(err))


def serving_bursts(be, sel, ts, vals) -> dict:
    """Each BURST_KEYS key: BURST queries behind a barrier, with the
    batcher off (MicroBatcher(enabled=False)) and then on (BURST_ROUNDS
    bursts, the members meeting again at the batcher's door: see burst);
    batched answers held bit for bit to the unbatched ones (the packed
    rate: the difference between its two routes measured), the first
    member of each against the oracle -> (readings, the widest batch of
    each key, to be timed later)."""
    from filodb_tpu_torch.query.batcher import MicroBatcher

    start, flushed_end, _ = engine_grid()
    nsteps = (flushed_end - start) // (STEP // 1000) + 1 - BURST
    params = burst_params(nsteps, range(BURST))
    out, caps = {}, {}
    for name, metric, func in BURST_KEYS:
        series = sel[metric]
        be.batcher = MicroBatcher(enabled=False)
        ref, ref_lat = burst(be, series, func, params)
        b = MicroBatcher()
        be.batcher = b
        cap = BatchCapture(be)
        rounds = []
        try:
            for _ in range(BURST_ROUNDS):
                rounds.append(burst(be, series, func, params, door=True))
        finally:
            cap.restore()
            b.executor.stop(WAIT_S)
        snap = b.stats.snapshot()
        assert snap["occupancy_max"] >= 2, (name, snap)
        assert snap["batches"] < snap["queries"], (name, snap)
        diff_abs = diff_rel = 0.0
        for outs, _ in rounds:
            for k in range(BURST):
                same = np.array_equal(outs[k], ref[k], equal_nan=True)
                if name != "packed rate":
                    assert same, f"{name}: member {k} not bit-identical"
                    continue
                assert np.array_equal(np.isnan(outs[k]), np.isnan(ref[k]))
                with np.errstate(all="ignore"):
                    d = np.abs(outs[k] - ref[k])
                    diff_abs = max(diff_abs, float(np.nanmax(d)))
                    diff_rel = max(diff_rel, float(np.nanmax(
                        d / np.abs(ref[k]))))
        if func == "rate" and metric == "http_requests_total":
            v = rate_variants(ts, vals, params[0].start_ms, nsteps)
            keys = [s.labels for s in series]
            errs = [check_rates(keys, x[0], v, False)
                    for x in (ref, rounds[0][0])]
        else:
            stride = 8
            errs = [check_rows(func, series, x[0], params[0], stride)
                    for x in (ref, rounds[0][0])]
        r = {"key": name, "func": func, "series": len(series),
             "steps": nsteps, "batcher": snap,
             "unbatched_latency_ms": [1e3 * x for x in ref_lat],
             "batched_latency_ms": [1e3 * x for x in rounds[-1][1]],
             "oracle_err": errs}
        if name == "packed rate":
            r.update({"routes_bit_identical": diff_abs == 0.0,
                      "routes_max_abs_diff": diff_abs,
                      "routes_max_rel_diff": diff_rel})
        out[name] = r
        caps[name] = cap
        log(f"phase 6: burst {name} ({func}, {len(series)} series x "
            f"{nsteps} steps): {json.dumps(r)}")
    return out, caps


def client_run(shard, be) -> dict:
    """CLIENTS threads, each with its own QueryEngine, cycling through
    the per-series rate (into the tail), avg_over_time on the gauges,
    max_over_time on the irregular series and sum by (job) of the rate,
    on grids that end up to GRIDS - 1 steps early: CLIENT_WARM queries
    each, left out, then CLIENT_QUERIES measured. Latencies are those of
    the measured queries; queries/s is the measured queries over the span
    from the first measured query's start to the last one's end (a span
    that always exists). Where every client finished its warm-up before
    the first client ended (the steady window, from the last client's end
    of warm-up to the first client's last query), the queries ending in
    it over its length are reported too, with `steady_window` saying
    whether it formed; its absence is no failure, as it measures only how
    the clients' queries overlapped."""
    import threading

    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    from filodb_tpu_torch.query.engine import QueryEngine

    start, fe, te = engine_grid()
    qs = (("rate(http_requests_total[5m])", te),
          (f"avg_over_time({GAUGE}[5m])", fe),
          ("max_over_time(irregular_total[5m])", fe),
          ("sum by (job) (rate(http_requests_total[5m]))", fe))
    s = STEP // 1000
    plans = [[parse_query_range(q, TimeStepParams(start - j * s, s,
                                                  end - j * s))
              for q, end in qs] for j in range(GRIDS)]
    spans = [[] for _ in range(CLIENTS)]    # per client: (start, end) s
    t0 = time.perf_counter()

    def client(k):
        eng = QueryEngine([shard], backend=be)
        for i in range(k, k + CLIENT_WARM + CLIENT_QUERIES):
            tq = time.perf_counter()
            got = eng.execute(plans[k % GRIDS][i % len(qs)])
            spans[k].append((tq, time.perf_counter()))
            assert np.isfinite(got.values).any()
    run_threads(CLIENTS, client)
    wall = time.perf_counter() - t0
    measured = [q for c in spans for q in c[CLIENT_WARM:]]
    m0 = min(b for b, _ in measured)
    m1 = max(e for _, e in measured)
    ms = 1e3 * np.asarray([e - b for b, e in measured])
    out = {"clients": CLIENTS, "warmup_queries": CLIENTS * CLIENT_WARM,
           "queries": len(measured), "wall_s": wall,
           "measured_span_s": m1 - m0, "qps": len(measured) / (m1 - m0),
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)),
           "max_ms": float(ms.max())}
    w0 = max(c[CLIENT_WARM - 1][1] for c in spans)
    w1 = min(c[-1][1] for c in spans)
    out["steady_window"] = w1 > w0
    if w1 > w0:
        done = sum(1 for _, e in measured if w0 < e <= w1)
        out.update(window_s=w1 - w0, window_queries=done,
                   window_qps=done / (w1 - w0))
    return out


def serving_clients(shard, be) -> dict:
    from filodb_tpu_torch.query.batcher import MicroBatcher

    out = {}
    for mode in ("on", "off"):
        b = MicroBatcher(enabled=mode == "on")
        be.batcher = b
        try:
            r = client_run(shard, be)
        finally:
            b.executor.stop(WAIT_S)
        r["batcher"] = b.stats.snapshot()
        out[mode] = r
        log(f"phase 6: {CLIENTS} clients, batcher {mode}: {json.dumps(r)}")
    return out


class BuildLog:
    """Records each tile build of the backend: the thread it ran on and
    its seconds."""

    def __init__(self, be):
        import threading

        self.be = be
        self.builds = []
        build = be._build_tile_entry

        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return build(*a, **kw)
            finally:
                self.builds.append((threading.current_thread().name,
                                    time.perf_counter() - t0))
        be._build_tile_entry = call

    def restore(self) -> None:
        del self.be._build_tile_entry


def ingest_tail(shard, sel, ts, vals, rng):
    """A fresh ENGINE_TAIL-sample tail for every counter series, then
    flush_all -> (ts, vals) extended by it, flush seconds."""
    from filodb_tpu_torch import state

    S, n0 = ts.shape
    t_new = (BASE + (n0 + np.arange(ENGINE_TAIL))[None, :] * DT
             + rng.integers(-J_MS, J_MS + 1, (S, ENGINE_TAIL)))
    v_new = vals[:, -1:] + np.cumsum(rng.uniform(0, 5, (S, ENGINE_TAIL)),
                                     axis=1)
    rows = []
    for s in sel:
        i = int(s.labels["instance"][1:])
        rows.append((dict(s.labels), t_new[i], v_new[i]))
    state.load_series(shard, rows, flush=False)
    t0 = time.perf_counter()
    shard.flush_all()
    return (np.concatenate([ts, t_new], axis=1),
            np.concatenate([vals, v_new], axis=1), time.perf_counter() - t0)


def serving_flush(shard, be, ts, vals, rng) -> dict:
    """Across a flush: the first grouped and per-series queries served
    from the previous snapshot's tiles while the rebuild runs on the
    executor, queries sent during the rebuild, the rebuild landed (the
    fresh key cached, one build more), the queries again; then the same
    first query after another flush without a batcher (the inline
    rebuild)."""
    import threading

    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    from filodb_tpu_torch.query import qos
    from filodb_tpu_torch.query.batcher import MicroBatcher
    from filodb_tpu_torch.query.engine import QueryEngine

    metric = "http_requests_total"
    start = engine_grid()[0]
    s = STEP // 1000
    b = MicroBatcher()
    be.batcher = b
    logb = BuildLog(be)
    out = {}
    try:
        old_key = tuple(x.snapshot_key for x in select_metric(shard, metric))
        assert old_key in be._tile_cache, "phase-4 tiles not cached"
        ts, vals, flush_s = ingest_tail(shard, select_metric(shard, metric),
                                        ts, vals, rng)
        out["flush_s"] = flush_s
        end = (BASE + (ts.shape[1] - 2) * DT) // 1000
        T = (end - start) // s + 1
        variants = rate_variants(ts, vals, start * 1000, T)
        engine = QueryEngine([shard], backend=be)

        def query(q, shift=0, eng=engine):
            plan = parse_query_range(q, TimeStepParams(start - shift * s, s,
                                                       end - shift * s))
            t0 = time.perf_counter()
            got = eng.execute(plan)
            return got, time.perf_counter() - t0

        grouped = f"sum by (job) (rate({metric}[5m]))"
        per = f"rate({metric}[5m])"
        before = (be.tile_builds, be.tile_hits, be.fused_aggs,
                  be.packed_dispatches)
        g1, g1_s = query(grouped)
        p1, p1_s = query(per)
        me = threading.current_thread().name
        assert not [n for n, _ in logb.builds if n == me], \
            "a tile build ran inline on a query thread"
        assert be.tile_hits >= before[1] + 2, "no stale serve"
        assert be.fused_aggs == before[2], "fused group sum on stale tiles"
        refreshing = len(be._tile_refreshing)
        out["stale"] = {"grouped_ms": 1e3 * g1_s, "per_series_ms": 1e3 * p1_s,
                        "rebuilds_pending": refreshing,
                        "packed_dispatches": be.packed_dispatches - before[3],
                        "grouped_rel_err": check_rates(g1.keys, g1.values,
                                                       variants, True),
                        "per_series_rel_err": check_rates(
                            p1.keys, p1.values, variants, False)}
        # concurrent queries while the rebuild holds the executor: they
        # queue behind it
        res = [None] * REBUILD_QUERIES

        def during(i):
            res[i] = query(per, shift=i,
                           eng=QueryEngine([shard], backend=be))
        busy = len(be._tile_refreshing) > 0
        run_threads(REBUILD_QUERIES, during)
        check_rates(res[0][0].keys, res[0][0].values, variants, False)
        out["during_rebuild"] = {"rebuild_running_at_start": busy,
                                 "latency_ms": [1e3 * r[1] for r in res]}
        done = threading.Event()
        b.executor.submit(done.set, priority=qos.PRIORITY_BEST_EFFORT)
        assert done.wait(WAIT_S), "the rebuild did not finish"
        fresh_key = tuple(x.snapshot_key
                          for x in select_metric(shard, metric))
        assert fresh_key != old_key and fresh_key in be._tile_cache, \
            "the rebuild did not land"
        assert be.tile_builds == before[0] + 1, \
            (be.tile_builds, before[0])
        assert be._tile_refreshing == set()
        rebuilds = [(n, sec) for n, sec in logb.builds]
        assert len(rebuilds) == 1 and rebuilds[0][0] != me, rebuilds
        out["rebuild"] = {"thread": rebuilds[0][0], "s": rebuilds[0][1]}
        fused = be.fused_aggs
        g2, g2_s = query(grouped)
        p2, p2_s = query(per)
        assert be.fused_aggs == fused + 1, "fused group sum after the rebuild"
        assert be.tile_builds == before[0] + 1
        out["landed"] = {"grouped_ms": 1e3 * g2_s,
                         "per_series_ms": 1e3 * p2_s,
                         "grouped_rel_err": check_rates(g2.keys, g2.values,
                                                        variants, True),
                         "per_series_rel_err": check_rates(
                             p2.keys, p2.values, variants, False)}
        # the same first query after a flush without a batcher: inline
        be.batcher = None
        ts, vals, flush2_s = ingest_tail(shard, select_metric(shard, metric),
                                         ts, vals, rng)
        end = (BASE + (ts.shape[1] - 2) * DT) // 1000
        variants = rate_variants(ts, vals, start * 1000,
                                 (end - start) // s + 1)
        n_builds = len(logb.builds)
        p3, p3_s = query(per)
        assert len(logb.builds) == n_builds + 1 \
            and logb.builds[-1][0] == me, "no inline rebuild"
        out["inline_rebuild"] = {"flush_s": flush2_s,
                                 "per_series_ms": 1e3 * p3_s,
                                 "build_s": logb.builds[-1][1],
                                 "per_series_rel_err": check_rates(
                                     p3.keys, p3.values, variants, False)}
    finally:
        logb.restore()
        b.executor.stop(WAIT_S)
        be.batcher = MicroBatcher(device=be.device)
    log(f"phase 6: across a flush: {json.dumps(out)}")
    return out


def phase_serving(eng: dict) -> dict:
    """Phase 6 on the phase-4 shard and backend (its tiles, and phase 5's
    gauge tiles, resident): bursts, clients, then a flush. Runs last: it
    flushes the shard. Kernel launch counts are set to 0 before and read
    after, and every kernel call is held against its plain version."""
    from filodb_tpu_torch.query import kernels as kn

    be, shard = eng["backend"], eng["shard"]
    sel = {m: select_metric(shard, m)
           for m in ("http_requests_total", GAUGE, "irregular_total")}
    rng = np.random.default_rng(7)
    calls, originals = record_kernel_calls()
    kn.reset_launches()
    t0 = time.perf_counter()
    try:
        bursts, caps = serving_bursts(be, sel, eng["ts"], eng["vals"])
        clients = serving_clients(shard, be)
        flush = serving_flush(shard, be, eng["ts"], eng["vals"], rng)
    finally:
        restore_kernels(originals)
    launches = dict(kn.LAUNCHES)
    secs = time.perf_counter() - t0
    log(f"phase 6: {secs:.1f} s; kernel launches {launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched in phase 6"
    errs = check_kernel_calls(calls, originals, "phase 6")
    for name, cap in caps.items():
        bursts[name]["dispatch"] = cap.dispatch_ms()
        log(f"phase 6: {name}: one batched dispatch against its members "
            f"one by one: {json.dumps(bursts[name]['dispatch'])}")
    return {"launches": launches, "errs": errs,
            "serving": {"bursts": bursts, "clients": clients,
                        "flush": flush, "seconds": secs,
                        "first_query_host_split": eng["first_query_split"]}}


# ---------------------------------------------------------------------------
# phase 7: the standalone server and its Prometheus HTTP API
# ---------------------------------------------------------------------------

SERVER_CLIENTS = 4          # HTTP client threads (cut from 8 for
                            # phase 9)
SERVER_CLIENT_QUERIES = 1   # queries of each client, over phase 6's mix
                            # (cut from 3 to make room for phase 9)
# the server's config: the reference's defaults but for these keys, each
# with its reason
SERVER_CONFIG = {
    "num-shards": 4, "port": 0,
    # one query scans 11.8 M samples here: the default 1,000,000 answers
    # 422 (asserted first, on an HTTP edge at the default over the same
    # shards)
    "query-sample-limit": 0,
    # a per-series answer at 8,192 series held a slot 8-10 s (its JSON
    # encode), longer than the default 5 s wait: 8 clients on 4 slots got
    # 429 at the default
    "admission-wait-s": 120.0,
}


def server_queries():
    """(PromQL, start s, end s) of phase 7's range queries: phase 4's five,
    then avg_over_time on the gauges and max_over_time on the irregular
    series."""
    start, fe, te = engine_grid()
    return engine_queries() + [(f"avg_over_time({GAUGE}[5m])", start, te),
                               ("max_over_time(irregular_total[5m])", start,
                                fe)]


def http_get(port: int, path: str, params: dict):
    """GET over a real socket -> (HTTP code, body bytes, wall ms)."""
    import urllib.error
    import urllib.parse
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=WAIT_S) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, 1e3 * (time.perf_counter() - t0)


def http_json(port: int, path: str, params: dict):
    """A 200 answer's JSON -> (payload, wall ms, body bytes); any other
    code raises."""
    code, body, ms = http_get(port, path, params)
    assert code == 200, f"{path} {params}: HTTP {code}: {body[:500]!r}"
    out = json.loads(body)
    assert out["status"] == "success", out
    return out, ms, len(body)


def grid_from_json(payload: dict, start: int, end: int, step: int):
    """A Prometheus matrix (or vector) answer -> (keys, [S, T] values)
    on the grid, NaN where the answer omits a step; `__name__` back to
    the engine's `_metric_`."""
    from types import SimpleNamespace

    steps = np.arange(start * 1000, end * 1000 + 1, step * 1000)
    res = payload["data"]["result"]
    keys, vals = [], np.full((len(res), steps.size), np.nan)
    for i, e in enumerate(res):
        keys.append({("_metric_" if k == "__name__" else k): v
                     for k, v in e["metric"].items()})
        pts = e["values"] if "values" in e else [e["value"]]
        t = np.asarray([p[0] for p in pts], np.float64)
        idx = np.rint((t * 1000 - steps[0]) / (step * 1000)).astype(np.int64)
        vals[i, idx] = np.asarray([p[1] for p in pts]).astype(np.float64)
    return SimpleNamespace(keys=keys, values=vals)


def json_order(grid):
    """An engine answer as the HTTP API lays it out: series without a
    value dropped, the rest ordered by their encoded labels."""
    from types import SimpleNamespace

    from filodb_tpu_torch.http import prom_json

    keep = [i for i in range(len(grid.keys))
            if not np.isnan(grid.values[i]).all()]
    keep.sort(key=lambda i: prom_json._entry_order(
        {"metric": prom_json._metric(grid.keys[i])}))
    return SimpleNamespace(keys=[dict(grid.keys[i]) for i in keep],
                           values=grid.values[keep])


def scrape(port: int) -> dict:
    """/metrics -> {series text: value} of the unlabelled and labelled
    samples."""
    code, body, _ = http_get(port, "/metrics", {})
    assert code == 200
    out = {}
    for line in body.decode().splitlines():
        if line and not line.startswith("#"):
            name, _, val = line.rpartition(" ")
            out[name] = float(val)
    return out


class EngineTime:
    """Seconds spent in QueryEngine.execute since the last take (the
    server's handler thread runs the engine; one query at a time)."""

    def __init__(self):
        from filodb_tpu_torch.query.engine import QueryEngine

        self.cls, self.orig, self.s = QueryEngine, QueryEngine.execute, 0.0
        orig = self.orig

        def call(eng, plan):
            t0 = time.perf_counter()
            try:
                return orig(eng, plan)
            finally:
                self.s += time.perf_counter() - t0
        QueryEngine.execute = call

    def take(self) -> float:
        s, self.s = self.s, 0.0
        return s

    def restore(self) -> None:
        self.cls.execute = self.orig


def same_answer(a, b) -> bool:
    return a.keys == b.keys and np.array_equal(a.values, b.values,
                                               equal_nan=True)


def server_queries_http(srv, rows, engine_time, classes) -> list:
    """Phase 7's range queries and one instant query over HTTP. Each range
    query goes three times in a row: first (the kernels it launched
    counted), again as it was (the results cache answers: a full hit where
    the grid ends at or below every shard's ingest watermark), and with
    &cache=false (the engine and the device again); all three answers
    alike. Then each first answer is held against the numpy oracle as
    phases 4-5 hold theirs -> readings. A query's launches are those of
    the queries' class in `classes` (LaunchClasses): a wall-clock rule
    tick that overlaps it does not count."""
    from filodb_tpu_torch.promql.parser import (TimeStepParams, parse_query,
                                                parse_query_range)
    from filodb_tpu_torch.query.engine import QueryEngine

    step = STEP // 1000
    path = "/promql/timeseries/api/v1/query_range"
    start, fe, _ = engine_grid()
    answers = []
    for q, s, e in server_queries():
        params = {"query": q, "start": s, "end": e, "step": step}
        before = classes.queries()
        engine_time.take()
        payload, ms, nbytes = http_json(srv.port, path, params)
        engine_s = engine_time.take()
        r = {"q": q, "first_ms": ms, "bytes": nbytes,
             "launches": {k: classes.queries()[k] - before[k]
                          for k in before},
             "engine_ms": 1e3 * engine_s,
             "handler_outside_engine_ms": ms - 1e3 * engine_s,
             "timings": payload["stats"]["timings"]}
        got = grid_from_json(payload, s, e, step)
        del payload
        cached, r["cached_ms"], _ = http_json(srv.port, path, params)
        r["cached_state"] = cached["stats"]["timings"]["resultCache"]
        assert r["cached_state"] == "hit" if e <= fe else \
            r["cached_state"] in ("hit", "partial"), (q, r["cached_state"])
        assert same_answer(grid_from_json(cached, s, e, step), got), \
            f"{q}: the cached answer differs"
        del cached
        engine_time.take()
        fresh, r["uncached_ms"], _ = http_json(
            srv.port, path, dict(params, cache="false"))
        r["uncached_engine_ms"] = 1e3 * engine_time.take()
        assert fresh["stats"]["timings"]["resultCache"] == "bypass"
        assert same_answer(grid_from_json(fresh, s, e, step), got), \
            f"{q}: the answer with cache=false differs"
        del fresh
        log(f"phase 7: {q}: first {ms:.1f} ms, cached "
            f"({r['cached_state']}) {r['cached_ms']:.1f} ms, uncached "
            f"{r['uncached_ms']:.1f} ms, {nbytes} bytes")
        answers.append((q, s, e, got, r))
    # the instant query: the grouped rate at the end of the flushed chunks
    iq = "sum by (job) (rate(http_requests_total[5m]))"
    engine_time.take()
    ipay, ims, ibytes = http_json(srv.port, path.replace("_range", ""),
                                  {"query": iq, "time": fe})
    ieng = engine_time.take()
    assert ipay["data"]["resultType"] == "vector"
    oracle = QueryEngine(srv.store.shards(srv.ref))
    T_max = max(len(np.arange(s, e + 1, step)) for _, s, e in
                server_queries())
    variants = _oracle_rates(rows["ts"], rows["vals"], start * 1000, T_max,
                             knife_ms=KNIFE_MS)
    readings = []
    for q, s, e, got, r in answers:
        want = json_order(oracle.execute(parse_query_range(
            q, TimeStepParams(s, step, e))))
        if q.startswith(("avg_over_time", "max_over_time")):
            r["oracle"] = check_function_answer(q.split("(")[0], q, got,
                                                want)
        else:
            r["oracle"] = check_engine_answer(q, got, want, variants)
        readings.append(r)
        log(f"phase 7: {q} over HTTP -> {got.values.shape}: "
            f"{json.dumps(r)}")
    got = grid_from_json(ipay, fe, fe, step)
    want = json_order(oracle.execute(parse_query(iq, fe)))
    iv = _oracle_rates(rows["ts"], rows["vals"], fe * 1000, 1,
                       knife_ms=KNIFE_MS)
    r = {"q": iq, "instant": True, "first_ms": ims, "bytes": ibytes,
         "engine_ms": 1e3 * ieng, "handler_outside_engine_ms":
         ims - 1e3 * ieng, "oracle": check_engine_answer(iq, got, want, iv)}
    log(f"phase 7: instant {iq} at {fe} over HTTP: {json.dumps(r)}")
    readings.append(r)
    for r in readings[:3]:
        assert r["launches"]["counter_groupsum"] >= 1, r
    irr = [r for r in readings if r["q"] == "rate(irregular_total[5m])"][0]
    assert irr["launches"]["window_extract"] >= 1, irr
    return readings


# phase 7's warm query of each route, sent again with &explain=analyze:
# (PromQL, grid end key, the kernel its route launches or None, the site
# prefix of its executables in the analyze payload)
ANALYZE_ROUTES = (
    ("sum by (job) (rate(http_requests_total[5m]))", "fe",
     "counter_groupsum", "tilestore:groupsum/"),
    ('rate(irregular_total{job="job3"}[5m])', "fe", "window_extract",
     "packed:pallas/"),
    (f'max_over_time({GAUGE}{{part="p1"}}[5m])', "fe", None,
     "packed:gather/"),
    (f'avg_over_time({GAUGE}{{part="p1"}}[5m])', "fe", None,
     "tilestore:avg_over_time/"),
)
# the executable key prefix of each kernel's dispatch site
KERNEL_SITES = {"counter_groupsum": ("tilestore", "groupsum/"),
                "window_extract": ("packed", "pallas/")}


def kernel_dispatches(az: dict) -> dict:
    """Per kernel, the dispatches of its site in an analyze payload."""
    out = {}
    for name, (site, prefix) in KERNEL_SITES.items():
        out[name] = sum(e["dispatches"] for e in az["device"]["executables"]
                        if e["site"] == site
                        and e["executable"].startswith(prefix))
    return out


def kernel_call_bytes(name: str, a) -> tuple:
    """(executable key suffix, bytes chip_smoke's bound counts) of one
    recorded kernel call: the group-sum's groupsum_bound, the extract's
    extract_bytes with every window holding a sample (an executable's
    cost is per shape, so it counts the most the shape can need)."""
    if name == "counter_groupsum":
        func, st, dspan, hi, lo, v_p, _, oh = a[:8]
        T = a[-1]
        nbytes, _, _ = groupsum_bound(a, 1.0, 1.0)
        return (f"groupsum/{func}/{v_p.shape[0] * 512}/{T}/{oh.shape[1]}/"
                f"{st}/{dspan}/{hi}/{lo}", nbytes)
    tr, pay, _, _, T = a
    S, N = tr.shape
    return (f"/{S}/{N}/{T}", extract_bytes(S, N, pay.shape[1], T, S * T))


def analyze_routes(srv, classes, calls) -> list:
    """Each route's warm query (ANALYZE_ROUTES) over HTTP with
    &cache=false, then again with &explain=analyze: the answer's data
    byte for byte the same; each kernel site's dispatches in the analyze
    payload equal to the kernel's launches in that query (LaunchClasses'
    query class); each kernel executable's bytes_accessed equal to the
    bytes chip_smoke's bound counts for the shape of the calls recorded in
    that query; the route's executables present -> readings."""
    path = "/promql/timeseries/api/v1/query_range"
    start, fe, te = engine_grid()
    ends = {"fe": fe, "te": te}
    out = []
    for q, end_key, kernel, where in ANALYZE_ROUTES:
        params = {"query": q, "start": start, "end": ends[end_key],
                  "step": STEP // 1000, "cache": "false"}
        plain, plain_ms, _ = http_json(srv.port, path, params)
        before = classes.queries()
        n_calls = {k: len(v) for k, v in calls.items()}
        payload, ms, nbytes = http_json(srv.port, path,
                                        dict(params, explain="analyze"))
        launched = {k: classes.queries()[k] - before[k] for k in before}
        assert json.dumps(payload["data"]) == json.dumps(plain["data"]), \
            f"{q}: the answer with explain=analyze differs"
        assert payload["data"]["result"], q
        az = payload["analyze"]
        disp = kernel_dispatches(az)
        assert disp == launched, (q, disp, launched)
        if kernel is not None:
            assert launched[kernel] >= 1, (q, launched)
        site, prefix = where.split(":")
        assert any(e["site"] == site and e["executable"].startswith(prefix)
                   for e in az["device"]["executables"]), \
            (q, az["device"]["executables"])
        checked = []
        for name, (ksite, kprefix) in KERNEL_SITES.items():
            made = [kernel_call_bytes(name, a)
                    for a, _ in calls[name][n_calls[name]:]]
            for e in az["device"]["executables"]:
                if e["site"] != ksite or \
                        not e["executable"].startswith(kprefix):
                    continue
                want = {b for k, b in made if e["executable"].endswith(k)}
                assert len(want) == 1, (q, e, made)
                assert e["bytes_accessed"] == float(want.pop()), (q, e)
                checked.append(e["executable"])
        r = {"q": q, "plain_ms": plain_ms, "analyze_ms": ms,
             "bytes": nbytes, "launches": launched,
             "kernel_dispatches": disp, "bytes_checked": checked,
             "stages": {k: v for k, v in az["stages"].items()
                        if k != "staticCostBound"},
             "executables": [
                 {k: e.get(k) for k in ("site", "executable", "dispatches",
                                        "dispositions", "flops",
                                        "bytes_accessed")}
                 for e in az["device"]["executables"]]}
        log(f"phase 7: analyze {q}: {json.dumps(r)}")
        out.append(r)
    m = scrape(srv.port)
    for fam in ("filodb_executables", "filodb_executable_builds_total",
                "filodb_executable_flops",
                "filodb_executable_bytes_accessed",
                "filodb_exec_cache_misses_total"):
        assert any(k == fam or k.startswith(fam + "{") for k in m), fam
    return out


def server_clients(srv) -> dict:
    """SERVER_CLIENTS threads over HTTP, each SERVER_CLIENT_QUERIES queries
    cycling phase 6's mix on grids shifted by up to GRIDS - 1 steps, with
    &cache=false so that each reaches the device: through the admission
    gate (4 in flight by default) and the micro-batcher. queries/s = the
    queries over the run's wall time."""
    start, fe, te = engine_grid()
    s = STEP // 1000
    qs = (("rate(http_requests_total[5m])", te),
          (f"avg_over_time({GAUGE}[5m])", fe),
          ("max_over_time(irregular_total[5m])", fe),
          ("sum by (job) (rate(http_requests_total[5m]))", fe))
    lat = [[] for _ in range(SERVER_CLIENTS)]
    b0 = srv.backend.batcher.stats.snapshot()

    def client(k):
        for i in range(k, k + SERVER_CLIENT_QUERIES):
            q, end = qs[i % len(qs)]
            j = k % GRIDS
            payload, ms, _ = http_json(
                srv.port, "/promql/timeseries/api/v1/query_range",
                {"query": q, "start": start - j * s, "end": end - j * s,
                 "step": s, "cache": "false"})
            assert payload["data"]["result"], q
            lat[k].append(ms)
    t0 = time.perf_counter()
    run_threads(SERVER_CLIENTS, client)
    wall = time.perf_counter() - t0
    b1 = srv.backend.batcher.stats.snapshot()
    ms = np.asarray([x for c in lat for x in c])
    return {"clients": SERVER_CLIENTS, "queries": int(ms.size),
            "wall_s": wall, "qps": ms.size / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max()),
            "batches": b1["batches"] - b0["batches"],
            "batched_queries": b1["queries"] - b0["queries"],
            "occupancy_max": b1["occupancy_max"], "batcher": b1}


def start_server(rows: dict, loops: dict):
    """Phase 7's server: the port's FiloServer on CUDA (SERVER_CONFIG plus
    `loops`, the rules and self-monitoring keys), loaded with the engine
    phases' rows through state.load_into_store (routed to their shards as
    the reference routes them) plus seed_dev_data() -> (server, load
    reading). Phases 7 and 10 run on it; the caller stops it."""
    from filodb_tpu_torch import state
    from filodb_tpu_torch.standalone.server import DEFAULTS, FiloServer

    t0 = time.perf_counter()
    for key, why in (("query-sample-limit", "11.8 M samples a query"),
                     ("admission-wait-s", "a per-series answer holds a "
                      "slot 8-10 s")):
        log(f"phase 7: config {key} = {SERVER_CONFIG[key]} (default "
            f"{DEFAULTS[key]}): {why}")
    srv = FiloServer({**SERVER_CONFIG, **loops}).start()
    try:
        log(f"phase 7: rules engine on ({len(srv.rules.groups)} groups, "
            f"its wall-clock scheduler running), self-monitoring on (every "
            f"{srv.selfmon.interval_s} s)")
        for key, schema, flush in LOAD_ORDER:
            state.load_into_store(srv.store, srv.ref, rows[key], schema,
                                  flush, num_shards=4, spread=1)
        dev_rows = srv.seed_dev_data()
    except BaseException:
        srv.stop()
        raise
    load_s = time.perf_counter() - t0
    per_shard = {s.shard_num: len(s.partitions)
                 for s in srv.store.shards(srv.ref)}
    log(f"phase 7: server on :{srv.port}, data loaded in {load_s:.1f} s "
        f"(+{dev_rows} dev samples), series per shard {per_shard}")
    return srv, {"t0": t0, "load_s": load_s, "series_per_shard": per_shard}


def phase_server(srv, loaded: dict, rows: dict, smi: str) -> dict:
    """Phase 7 on start_server's server: PromQL over HTTP: the default
    sample limit's 422, every query held against the numpy oracle with
    the kernels it launched, the results cache and its bypass, /metrics,
    and concurrent clients, while the rules engine's wall-clock scheduler
    and the self-monitoring loop run. Kernel launch counts are set to 0
    before the first query and read after the clients; the launches of
    the wall-clock rule ticks are told apart (LaunchClasses) and reported
    in `loops`; every kernel call is held against its plain version."""
    from filodb_tpu_torch.http.server import FiloHttpServer
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query.model import QueryLimits
    from filodb_tpu_torch.standalone.server import DEFAULTS

    t0 = loaded["t0"]
    # the reference's default sample limit, on an HTTP edge over the
    # same shards
    edge = FiloHttpServer(
        {srv.ref.dataset: srv.store.shards(srv.ref)},
        backend=srv.backend, shard_mapper=srv.mapper,
        query_limits=QueryLimits(
            series_limit=DEFAULTS["query-series-limit"],
            sample_limit=DEFAULTS["query-sample-limit"]))
    edge.start()
    try:
        start, fe, _ = engine_grid()
        code, body, _ = http_get(
            edge.port, "/promql/timeseries/api/v1/query_range",
            {"query": "sum by (job) (rate(http_requests_total[5m]))",
             "start": start, "end": fe, "step": STEP // 1000})
    finally:
        edge.stop()
    assert code == 422, (code, body[:300])
    log(f"phase 7: default sample limit: HTTP {code} "
        f"{json.loads(body)['error']}")
    m0 = scrape(srv.port)
    calls, originals = record_kernel_calls()
    classes = LaunchClasses(srv.backend.batcher)
    engine_time = EngineTime()
    kn.reset_launches()
    try:
        readings = server_queries_http(srv, rows, engine_time, classes)
        analyzed = analyze_routes(srv, classes, calls)
        clients = server_clients(srv)
    finally:
        engine_time.restore()
        classes.restore()
        restore_kernels(originals)
    launches = dict(kn.LAUNCHES)
    own, ticks = classes.counts["queries"], classes.counts["rules"]
    assert all(own[k] + ticks[k] == launches[k] for k in launches), \
        (launches, classes.counts)
    log(f"phase 7: {SERVER_CLIENTS} HTTP clients: {json.dumps(clients)}")
    m1 = scrape(srv.port)
    moved = {}
    for fam in ("filodb_tile_builds_total", "filodb_tile_cache_hits_total",
                "filodb_batcher_queries_total",
                "filodb_batcher_batches_total",
                "filodb_result_cache_hits_total",
                "filodb_result_cache_partial_hits_total",
                "filodb_result_cache_bypassed_total",
                "filodb_plan_cache_hits_total"):
        moved[fam] = m1[fam] - m0[fam]
    for fam in ("filodb_tile_builds_total", "filodb_tile_cache_hits_total",
                "filodb_batcher_queries_total",
                "filodb_batcher_batches_total",
                "filodb_result_cache_bypassed_total"):
        assert moved[fam] > 0, (fam, moved)
    n_full = sum(1 for _, _, e in server_queries() if e <= fe)
    assert moved["filodb_result_cache_hits_total"] >= n_full, moved
    assert m1["filodb_admission_rejected_total"] == 0
    log(f"phase 7: /metrics moved: {json.dumps(moved)}")
    for name, n in own.items():
        assert n > 0, f"{name} was not launched by phase 7's queries"
    errs = check_kernel_calls(calls, originals, "phase 7")
    secs = time.perf_counter() - t0
    first = readings[0]
    split = {"wall_ms": first["first_ms"],
             "engine_ms": first["engine_ms"],
             "handler_outside_engine_ms":
                 first["handler_outside_engine_ms"],
             "timings": first["timings"]}
    # the rules engine's wall-clock ticks and the self-monitoring loop ran
    # beside every phase-7 query
    rs, sm = srv.rules.snapshot(), srv.selfmon.snapshot()
    loops = {"rules": {"scheduler_alive": rs["alive"],
                       "wall_ticks": rs["ticks"], "errors": rs["errors"],
                       "launches": dict(ticks)},
             "selfmon": {"alive": sm["alive"], "ticks": sm["ticks"],
                         "samples": sm["samples_ingested"],
                         "errors": sm["errors"],
                         "last_tick_s": sm["last_tick_s"]}}
    assert rs["alive"] and sm["alive"], loops
    log(f"phase 7: {secs:.1f} s; kernel launches {launches} (queries "
        f"{dict(own)}, wall-clock rule ticks {dict(ticks)})")
    return {"launches": launches, "errs": errs,
            "server": {"seconds": secs, "load_s": loaded["load_s"],
                       "series_per_shard": loaded["series_per_shard"],
                       "queries": readings, "first_grouped_split": split,
                       "analyze": analyzed,
                       "clients": clients, "metrics_moved": moved,
                       "launches_queries": dict(own), "loops": loops,
                       "card": smi}}


# ---------------------------------------------------------------------------
# phase 8: the write path and durability
# ---------------------------------------------------------------------------

WRITE_READ_SERIES = 64      # series read back through /api/v1/read
# server A and B's config: the reference's defaults but for these keys,
# each with its reason
WRITE_CONFIG = {
    "num-shards": 4, "port": 0, "gateway-port": 0,
    # phase 7's two keys, for phase 7's reasons
    "query-sample-limit": 0, "admission-wait-s": 120.0,
    # fsync per append: a 200 from the ingest endpoint means the lines are
    # on disk (the reference's default 5 ms group commit acknowledges
    # before the fsync)
    "stream-group-commit-ms": 0,
    # no timed flush: server A keeps the tail in its write buffers, so at
    # the crash it lives only in the stream logs, and B's replay puts it
    # back into the same buffers. Both servers then hold the same split
    # of chunks (the aligned tiles) and buffers (the packed path), which
    # bit-for-bit equal answers need
    "flush-interval-s": 3600.0,
}


def irregular_tail(rng: np.random.Generator, irr) -> list:
    """ENGINE_TAIL samples more of each irregular series, after its last
    flushed one, at the series' own jittered cadence."""
    out = []
    for lab, t, v in irr:
        tt = np.unique(BASE + (N_FULL + np.arange(ENGINE_TAIL)) * DT
                       + rng.integers(-6_000, 6_000, ENGINE_TAIL))
        tt = tt[tt > t[-1]]
        out.append((lab, tt, v[-1] + np.cumsum(rng.uniform(0, 3, tt.size))))
    return out


def influx_line(lab: dict, t: int, v: float) -> str:
    """One Influx line of a counter sample: the labels as tags (the
    gateway adds the default _ws_/_ns_ back), the value by repr so that it
    round-trips exactly, the timestamp in ns."""
    return (f"{lab['_metric_']},job={lab['job']},instance={lab['instance']}"
            f" counter={float(v)!r} {int(t) * 1_000_000}")


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def backfill(data_dir: str, rows: dict,
             series=(("counters", "prom-counter"),
                     ("irregular", "prom-counter"))) -> dict:
    """Phase 4's flushed history (by default the counters and the
    irregular series: `series` names the rows and their schema) written
    into a data-dir through the port's memstore with a FlatFileColumnStore,
    routed to the 4 shards as the gateway routes, as a previous run's
    flushes would leave it."""
    from filodb_tpu_torch import state
    from filodb_tpu_torch.core.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
    from filodb_tpu_torch.standalone.server import DEFAULTS
    from filodb_tpu_torch.store import FlatFileColumnStore

    t0 = time.perf_counter()
    ref = DatasetRef(DEFAULTS["dataset"])
    cs = FlatFileColumnStore(data_dir)
    store = TimeSeriesMemStore(DEFAULT_SCHEMAS, column_store=cs)
    for shard in range(WRITE_CONFIG["num-shards"]):
        store.setup(ref, shard, num_groups=DEFAULTS["groups-per-shard"],
                    max_chunk_rows=DEFAULTS["max-chunks-size"])
    n = 0
    for key, schema in series:
        n += state.load_into_store(store, ref, rows[key], schema,
                                   True, num_shards=4, spread=1)
    cs.close()
    return {"samples": n, "seconds": time.perf_counter() - t0,
            "bytes": dir_bytes(data_dir)}


def http_post(port: int, path: str, body: bytes, ctype: str):
    """POST over a real socket -> (HTTP code, body bytes, wall ms)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST",
                                 headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            code, out = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, out = e.code, e.read()
    return code, out, 1e3 * (time.perf_counter() - t0)


def wait_for(pred, what: str) -> float:
    """Poll `pred` until true, at most WAIT_S -> seconds waited."""
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < WAIT_S, f"timed out: {what}"
        time.sleep(0.02)
    return time.perf_counter() - t0


def drivers_caught_up(srv) -> bool:
    return all(d.recovered_to >= 0
               and d.next_offset >= d.stream.end_offset()
               for d in srv.drivers.values())


def write_queries():
    """(PromQL, start s, end s) of phase 8: the grouped sum and average
    of rate on the flushed history (the fused group-sum), the rate of one
    job's counters into the HTTP-ingested tail, and the irregular rate
    into the gateway-ingested tail (the boundary extract)."""
    start, fe, te = engine_grid()
    q = "by (job) (rate(http_requests_total[5m]))"
    return [(f"sum {q}", start, fe), (f"avg {q}", start, fe),
            ('rate(http_requests_total{job="job3"}[5m])', start, te),
            ("rate(irregular_total[5m])", start, te)]


def read_request(rows: dict):
    """A remote-read request of WRITE_READ_SERIES series, history and
    tail: 3/4 of them counters of job3, the rest irregular series of
    job3 -> (snappy body, [(metric, instance)] wanted)."""
    from filodb_tpu_torch.http import remote_read as rr

    n_c = WRITE_READ_SERIES * 3 // 4
    ctr = [lab["instance"] for lab, _, _ in rows["counters"]
           if lab["job"] == "job3"][:n_c]
    irr = [lab["instance"] for lab, _, _ in rows["irregular"]
           if lab["job"] == "job3"][:WRITE_READ_SERIES - n_c]
    end = BASE + (N_FULL + ENGINE_TAIL + 1) * DT
    queries = [{"matchers": [("__name__", "eq", metric),
                             ("job", "eq", "job3"),
                             ("instance", "re", "|".join(inst))],
                "start_ms": 0, "end_ms": end}
               for metric, inst in (("http_requests_total", ctr),
                                    ("irregular_total", irr))]
    body = rr.snappy_compress(rr.encode_read_request(queries))
    return body, ([("http_requests_total", i) for i in ctr]
                  + [("irregular_total", k) for k in irr])


def check_read(payload: bytes, want_keys, truth: dict) -> int:
    """Every written sample of every wanted series, history and tail,
    read back exactly -> samples checked."""
    from filodb_tpu_torch.http import remote_read as rr

    got = {}
    for series in rr.decode_read_response(rr.snappy_decompress(payload)):
        for lab, samples in series:
            got[(lab["__name__"], lab["instance"])] = samples
    assert sorted(got) == sorted(want_keys), \
        f"read back {len(got)} series of {len(want_keys)}"
    n = 0
    for key in want_keys:
        ts, vals = truth[key]
        t = np.asarray([s[0] for s in got[key]], np.int64)
        v = np.asarray([s[1] for s in got[key]], np.float64)
        assert np.array_equal(t, ts) and np.array_equal(v, vals), \
            f"{key}: {t.size} samples read back, {ts.size} written"
        n += t.size
    return n


class PageInSplit(HostSplit):
    """HostSplit plus the ODP page-ins (TimeSeriesShard._ensure_loaded),
    which run inside series selection."""

    def __init__(self):
        super().__init__()
        from filodb_tpu_torch.core.memstore import TimeSeriesShard

        self.secs["page_in_s"] = 0.0
        self.shard_cls = TimeSeriesShard
        self.orig_load = TimeSeriesShard._ensure_loaded
        TimeSeriesShard._ensure_loaded = self._wrap(self.orig_load,
                                                    "page_in_s", False)

    def restore(self) -> None:
        super().restore()
        self.shard_cls._ensure_loaded = self.orig_load

    def split(self, total_s: float) -> dict:
        s = super().split(total_s)
        s["select_decode_less_page_in_s"] = (s["select_decode_s"]
                                             - s["page_in_s"])
        return s


def query_write_server(srv, rows, oracle: bool) -> list:
    """Phase 8's queries over HTTP with &cache=false, the first of them
    split by stage -> [(query, grid, reading)]; with `oracle`, each
    answer held against the numpy oracle as phase 7 holds its answers."""
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query.engine import QueryEngine

    step = STEP // 1000
    path = "/promql/timeseries/api/v1/query_range"
    start = engine_grid()[0]
    out = []
    for i, (q, s, e) in enumerate(write_queries()):
        before = dict(kn.LAUNCHES)
        split = PageInSplit() if i == 0 else None
        try:
            payload, ms, nbytes = http_json(
                srv.port, path, {"query": q, "start": s, "end": e,
                                 "step": step, "cache": "false"})
        finally:
            if split is not None:
                split.restore()
        r = {"q": q, "end": e, "ms": ms, "bytes": nbytes,
             "launches": {k: kn.LAUNCHES[k] - before[k] for k in before}}
        if split is not None:
            r["host_split"] = split.split(ms / 1e3)
        out.append((q, grid_from_json(payload, s, e, step), r))
    if oracle:
        eng = QueryEngine(srv.store.shards(srv.ref))
        T_max = max(len(np.arange(s, e + 1, step))
                    for _, s, e in write_queries())
        variants = _oracle_rates(rows["ts"], rows["vals"], start * 1000,
                                 T_max, knife_ms=KNIFE_MS)
        for (q, got, r), (_, s, e) in zip(out, write_queries()):
            want = json_order(eng.execute(parse_query_range(
                q, TimeStepParams(s, step, e))))
            r["oracle"] = check_engine_answer(q, got, want, variants)
    for q, got, r in out:
        log(f"phase 8: {q} to {r['end']}: {json.dumps(r)}")
    return out


def start_write_server(data_dir: str, stream_dir: str):
    """FiloServer on the card over the data-dir and stream-dir, its shard
    statuses recorded -> (server, {shard: [statuses]}, seconds until every
    shard is active)."""
    from filodb_tpu_torch.standalone.server import FiloServer

    t0 = time.perf_counter()
    srv = FiloServer(dict(WRITE_CONFIG, **{"data-dir": data_dir,
                                           "stream-dir": stream_dir}))
    seen = {}
    srv.mapper.subscribe(lambda ev: seen.setdefault(ev.shard, []).append(
        ev.status.value))
    srv.start()
    wait_for(lambda: all(srv.mapper.status(s).value == "active"
                         for s in range(WRITE_CONFIG["num-shards"])),
             "shards active")
    return srv, seen, time.perf_counter() - t0


def phase_write_path(rows: dict, wdir: dict, smi: str) -> dict:
    """Phase 8: backfill the history into a data-dir; server A ingests
    the tail through POST /api/v1/ingest/influx (the counters, one POST
    per scrape) and the TCP gateway (the irregular series), answers
    phase 8's queries (held against the numpy oracle) and a remote read;
    it crashes (drivers stopped without a flush); server B recovers from
    the same directories and must answer bit for bit as A did, through
    both kernels. B then stops without a flush as A did, so that phase
    9's nodes replay the same tail from the stream logs of `wdir` (its
    "data" and "stream" directories). Kernel launch counts are set to 0
    before A's first query and read after B's last; every kernel call is
    held against its plain version."""
    from filodb_tpu_torch.gateway.server import send_lines
    from filodb_tpu_torch.query import kernels as kn

    t_phase = time.perf_counter()
    data_dir, stream_dir = wdir["data"], wdir["stream"]
    irr_tail = irregular_tail(np.random.default_rng(8), rows["irregular"])
    truth = {}
    for hist, tail in (("counters", "counter_tails"),
                       ("irregular", None)):
        tails = rows[tail] if tail else irr_tail
        for (lab, t, v), (_, tt, tv) in zip(rows[hist], tails):
            truth[(lab["_metric_"], lab["instance"])] = (
                np.concatenate([t, tt]).astype(np.int64),
                np.concatenate([v, tv]).astype(np.float64))
    bf = backfill(data_dir, rows)
    log(f"phase 8: backfill {bf['samples']} samples in "
        f"{bf['seconds']:.1f} s, {bf['bytes']} bytes on disk")
    srv, _, start_a = start_write_server(data_dir, stream_dir)
    log(f"phase 8: server A on :{srv.port}, gateway :{srv.gateway.port}"
        f", active in {start_a:.1f} s")
    # the counters' tail: one POST of S lines per scrape
    path = "/api/v1/ingest/influx"
    n_http, t0 = 0, time.perf_counter()
    tails = rows["counter_tails"]
    for k in range(ENGINE_TAIL):
        body = "\n".join(influx_line(lab, t[k], v[k])
                         for lab, t, v in tails).encode()
        code, out, _ = http_post(srv.port, path, body, "text/plain")
        assert code == 200, (k, code, out[:300])
        acc = json.loads(out)["data"]
        assert acc == {"accepted": len(tails), "rejected": 0}, acc
        n_http += len(tails)
    http_s = time.perf_counter() - t0
    # the irregular tail through the TCP gateway
    lines = [influx_line(lab, t, v) for lab, tt, vv in irr_tail
             for t, v in zip(tt, vv)]
    t0 = time.perf_counter()
    send_lines("127.0.0.1", srv.gateway.port, lines, timeout=WAIT_S)
    wait_for(lambda: srv.gateway.lines_ingested >= n_http + len(lines),
             "gateway lines")
    gw_s = time.perf_counter() - t0
    assert srv.gateway.lines_rejected == 0
    catch_up_s = wait_for(lambda: drivers_caught_up(srv),
                          "drivers caught up")
    records = {s: d.stream.end_offset() for s, d in srv.drivers.items()}
    log(f"phase 8: {n_http} lines over HTTP in {http_s:.1f} s, "
        f"{len(lines)} over the gateway in {gw_s:.1f} s, drivers "
        f"caught up {catch_up_s:.2f} s later; stream records {records}")
    m_a = scrape(srv.port)
    body, want_keys = read_request(rows)
    calls, originals = record_kernel_calls()
    kn.reset_launches()
    try:
        ans_a = query_write_server(srv, rows, oracle=True)
        code, read_a, read_ms_a = http_post(
            srv.port, "/promql/timeseries/api/v1/read", body,
            "application/x-protobuf")
        assert code == 200, read_a[:300]
        n_read = check_read(read_a, want_keys, truth)
        launches_a = dict(kn.LAUNCHES)
        # the crash: the drivers stop without a flush, then the edges
        srv.stop(flush=False)
        del srv
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        srv, seen, recovery_s = start_write_server(data_dir,
                                                   stream_dir)
        try:
            for s in range(WRITE_CONFIG["num-shards"]):
                st = seen.get(s, [])
                assert "recovery" in st and st[-1] == "active", (s, st)
            replayed = {s: d.recovered_to for s, d in
                        srv.drivers.items()}
            assert replayed == records, (replayed, records)
            ans_b = query_write_server(srv, rows, oracle=False)
            code, read_b, read_ms_b = http_post(
                srv.port, "/promql/timeseries/api/v1/read", body,
                "application/x-protobuf")
            assert code == 200 and read_b == read_a, \
                "server B's remote read differs from A's"
            paged_in_b = sum(s.stats.partitions_paged_in
                             for s in srv.store.shards(srv.ref))
        finally:
            # B crashes as A did: the tail stays in the stream logs
            srv.stop(flush=False)
    finally:
        restore_kernels(originals)
    launches = dict(kn.LAUNCHES)
    launches_b = {k: launches[k] - launches_a[k] for k in launches}
    for (q, got_a, _), (_, got_b, _) in zip(ans_a, ans_b):
        assert same_answer(got_a, got_b), \
            f"{q}: server B's answer differs from A's"
    for name, n in launches_b.items():
        assert n > 0, f"{name} was not launched on server B"
    errs = check_kernel_calls(calls, originals, "phase 8")
    fsync_n = sum(v for k, v in m_a.items()
                  if k.startswith("filodb_ingest_fsync_seconds_count"))
    fsync_s = sum(v for k, v in m_a.items()
                  if k.startswith("filodb_ingest_fsync_seconds_sum"))
    first_a, first_b = ans_a[0][2], ans_b[0][2]
    secs = time.perf_counter() - t_phase
    durability = {
        "seconds": secs,
        "backfill_s": bf["seconds"], "backfill_samples": bf["samples"],
        "bytes_on_disk": bf["bytes"],
        "http_lines": n_http, "http_s": http_s,
        "http_lines_per_s": n_http / http_s,
        "gateway_lines": len(lines), "gateway_s": gw_s,
        "gateway_lines_per_s": len(lines) / gw_s,
        "stream_records": sum(records.values()),
        "fsync_count": fsync_n, "fsync_s": fsync_s,
        "recovery_s": recovery_s,
        "records_replayed": sum(replayed.values()),
        "page_in_s": first_b["host_split"]["page_in_s"],
        "paged_in_b": paged_in_b,
        "first_grouped_ms_a": first_a["ms"],
        "first_grouped_ms_b": first_b["ms"],
        "first_grouped_split_b": first_b["host_split"],
        "queries_a": [r for _, _, r in ans_a],
        "queries_b": [r for _, _, r in ans_b],
        "read": {"series": len(want_keys), "samples": n_read,
                 "ms_a": read_ms_a, "ms_b": read_ms_b},
        "launches_a": launches_a, "launches_b": launches_b,
        "card": smi,
    }
    log(f"phase 8: {secs:.1f} s; kernel launches {launches}")
    return {"launches": launches, "errs": errs, "durability": durability,
            "answers_b": [(q, got) for q, got, _ in ans_b]}


# ---------------------------------------------------------------------------
# phase 9: the cluster, two nodes sharing the card
# ---------------------------------------------------------------------------

# failure-detect-interval-s of phase 9's nodes (threshold 2 misses): short
# enough that detection and recovery fit the phase's budget
CLUSTER_DETECT_S = 0.25
# the pushed-down join's Exec reply must exceed grpcio's default receive
# limit, so that phase 9 holds the message-size repair (ROADMAP C.15)
JOIN_REPLY_MIN_BYTES = 4 << 20
# jobs (of G, S_ENGINE / G = 256 series each) in phase 9's join: 12 jobs'
# 3,072 series, whose node1 half replied about 5.2 MB at 6 jobs of 512
JOIN_JOBS = 12
# the queries phases 9 to 11 share
Q_GROUPED = "sum by (job) (rate(http_requests_total[5m]))"
Q_IRR = "rate(irregular_total[5m])"
Q_JOB = 'rate(http_requests_total{job="job3"}[5m])'


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def cluster_config(data_dir: str, stream_dir: str, ports, ordinal: int):
    """Node `ordinal` of phase 9's two-node cluster: phase 8's directories
    and WRITE_CONFIG's keys (phase 7's two, fsync per append, no timed
    flush), no gateway, num-nodes 2 with both peers, the gRPC plane on an
    ephemeral port (the reference's default), a fast failure detector
    and query-timeout-s raised from its default 30 s to WAIT_S: the first
    cross-node query pages in both nodes' shards and ships about 100 MB
    from the peer, and on an H100 host it answered 503 at the default
    (ROADMAP C.17). The `cluster` line states both values."""
    peers = {f"node{i}": f"http://127.0.0.1:{p}" for i, p in
             enumerate(ports)}
    return dict(WRITE_CONFIG, **{
        "port": ports[ordinal], "gateway-port": None,
        "data-dir": data_dir, "stream-dir": stream_dir,
        "num-nodes": 2, "node-ordinal": ordinal, "peers": peers,
        "grpc-port": 0, "query-timeout-s": WAIT_S,
        "failure-detect-interval-s": CLUSTER_DETECT_S,
        "failure-detect-threshold": 2})


class WireLog:
    """Every gRPC call the port's clients make (grpcsvc.client._call):
    method, peer, request and reply bytes, seconds."""

    def __init__(self):
        from filodb_tpu_torch.grpcsvc import client

        self.mod, self.orig, self.calls = client, client._call, []
        orig = self.orig

        def call(addr, method, payload, timeout_s, node_id):
            t0 = time.perf_counter()
            out = orig(addr, method, payload, timeout_s, node_id)
            self.calls.append((method, node_id, len(payload), len(out),
                               time.perf_counter() - t0))
            return out
        client._call = call

    def take(self) -> dict:
        calls, self.calls = self.calls, []
        return {"frames": len(calls),
                "methods": sorted({c[0] for c in calls}),
                "request_bytes": sum(c[2] for c in calls),
                "reply_bytes": sum(c[3] for c in calls),
                "fetch_s": sum(c[4] for c in calls)}

    def restore(self) -> None:
        self.mod._call = self.orig


def analyze_split(payload: dict) -> dict:
    """An &explain=analyze answer's stage split: its stage timings, each
    span's count and total us in its trace (both nodes' spans when a
    query crossed to a peer), and the executables with their
    dispatches."""
    az = payload["analyze"]
    spans: dict = {}
    for d in payload["trace"]["spans"]:
        c = spans.setdefault(d["name"], {"n": 0, "us": 0})
        c["n"] += 1
        c["us"] += int(d.get("dur_us") or 0)
    return {"stages": {k: v for k, v in az["stages"].items()
                       if k != "staticCostBound"},
            "spans": spans,
            "executables": {f"{e['site']}:{e['executable']}":
                            e["dispatches"]
                            for e in az["device"]["executables"]},
            "kernel_dispatches": kernel_dispatches(az)}


def cluster_query(node, name: str, q: str, s: int, e: int, wire,
                  analyze: bool = False) -> tuple:
    """One query over HTTP into `node` with &cache=false (and
    &explain=analyze), split by stage (PageInSplit: page-ins of both
    nodes, since they share the process; select_decode_s holds the peer
    fetch) -> (grid, reading, payload)."""
    from filodb_tpu_torch.query import kernels as kn

    before = dict(kn.LAUNCHES)
    wire.take()
    split = PageInSplit()
    params = {"query": q, "start": s, "end": e, "step": STEP // 1000,
              "cache": "false"}
    if analyze:
        params["explain"] = "analyze"
    try:
        payload, ms, nbytes = http_json(
            node.port, "/promql/timeseries/api/v1/query_range", params)
    finally:
        split.restore()
    r = {"q": q, "entry": name, "end": e, "wall_ms": ms, "bytes": nbytes,
         "launches": {k: kn.LAUNCHES[k] - before[k] for k in before},
         "wire": wire.take()}
    r["host_split"] = split.split(ms / 1e3)
    r["host_split"]["select_decode_less_fetch_s"] = (
        r["host_split"]["select_decode_s"] - r["wire"]["fetch_s"])
    if analyze:
        r["analyze"] = analyze_split(payload)
        assert r["analyze"]["kernel_dispatches"] == r["launches"], r
    log(f"phase 9: {name} {q} to {e}: {ms:.1f} ms, {nbytes} bytes, "
        f"wire {json.dumps(r['wire'])}, split "
        f"{json.dumps(r['host_split'])}, launches {r['launches']}")
    return grid_from_json(payload, s, e, STEP // 1000), r, payload


def close_grouped(got, want, what: str) -> float:
    """Group sums within the group-sum kernel's tolerance (check_groupsum:
    |a - b| <= 1e-5 |b| + 1e-6 max |b|) -> max abs diff."""
    assert [dict(k) for k in got.keys] == [dict(k) for k in want.keys], what
    a, b = got.values, want.values
    assert np.array_equal(np.isnan(a), np.isnan(b)), what
    ok = ~np.isnan(b)
    err = np.abs(a[ok] - b[ok])
    assert (err <= 1e-5 * np.abs(b[ok]) + 1e-6 * np.abs(b[ok]).max()).all(), \
        f"{what}: max abs diff {err.max()}"
    return float(err.max()) if err.size else 0.0


def check_join(got, rows, start: int) -> dict:
    """The pushed-down join rate(x[5m]) / rate(x[5m] offset 1m) held to
    the integer-rule oracle: the 1 m offset is one grid step, so both
    sides are _oracle_rates rows of one grid from start - 60 s. Each
    answer must lie within rtol 2e-5 (two rates of rtol 1e-5) of the range
    that the four branch variants of each side span."""
    T = got.values.shape[1]
    var = _oracle_rates(rows["ts"], rows["vals"], (start - 60) * 1000,
                        T + 1, knife_ms=KNIFE_MS)
    idx = [int(k["instance"][1:]) for k in got.keys]
    num, den = var[:, idx, 1:], var[:, idx, :-1]
    with np.errstate(all="ignore"):
        combos = num[:, None] / den[None, :]
    lo, hi = np.nanmin(combos, axis=(0, 1)), np.nanmax(combos, axis=(0, 1))
    gv = got.values
    nan = np.isnan(combos[0, 0])
    assert np.array_equal(np.isnan(gv), nan), "join: NaN pattern differs"
    assert np.isfinite(gv).any()
    ok = nan | ((gv >= lo - 2e-5 * np.abs(lo))
                & (gv <= hi + 2e-5 * np.abs(hi)))
    assert ok.all(), "join: outside the integer-rule oracle's range"
    with np.errstate(all="ignore"):
        rel = np.abs(gv - combos[0, 0]) / np.abs(combos[0, 0])
    return {"series": len(idx), "max_rel_err_vs_variant0":
            float(np.nanmax(rel)), "knife_cells": int((hi > lo).sum())}


def check_grouped_rule(got, variants: np.ndarray, series) -> dict:
    """A `sum by (job)` of rate over the counter rows `series` only (a
    node's shards while its peer is down) held to the integer-rule
    oracle as check_engine_answer holds the fused group sums: variant 0's
    group sums at rtol 1e-5, no allowance."""
    var = variants[:, series, :got.values.shape[1]]
    rows = [int(k["job"][3:]) for k in got.keys]
    nom = _group_sum(var[0], np.asarray(series) % G)[:, rows].T
    gv = got.values
    nan = np.isnan(gv)
    assert np.isfinite(gv).any()
    err = np.abs(gv - nom)
    assert (nan | (err <= 1e-5 * np.abs(nom) + 1e-9)).all(), \
        f"partial group sums: max abs err {np.nanmax(err)}"
    with np.errstate(all="ignore"):
        return {"series": len(series),
                "max_rel_err": float(np.nanmax(err / np.abs(nom)))}


def wait_statuses(node, shards, status: str) -> float:
    """Poll node's shard map until every shard of `shards` has `status`
    -> seconds waited."""
    return wait_for(lambda: all(node.mapper.status(s).value == status
                                for s in shards),
                    f"shards {shards} {status} on {node.node_id}")


def phase_cluster(rows: dict, wdir: dict, answers_b: list,
                  smi: str) -> dict:
    """Phase 9: two FiloServers in this process, both on the card (they
    share the interpreter, hence the GIL, and the card), num-shards 4 over
    num-nodes 2: node0 owns shards 0-1, node1 shards 2-3, both on phase
    8's data-dir and stream-dir (each pages in and replays its own
    shards), the gRPC plane on. Queries over HTTP with &cache=false: the
    grouped rate entering node0 then node1 (leaf dispatch, the group-sum
    on each entry node), one job's per-series rate and the irregular rate
    into the tail, a same-metric join pushed down to both nodes, a series
    fan-out; each held to the numpy f64 oracle at phase 7's bounds and to
    server B's answer of phase 8 (per-series and irregular bit for bit,
    grouped within the group-sum tolerance). Then node1 is stopped without
    a drain (detection time, node0's answer with shards 2-3 DOWN),
    restarted on the same directories (recovery time, the answer equal to
    the one before), and drained into node0 (drain time; node0 answers
    from all four shards). Kernel launch counts are set to 0 before the
    first query and read after the last; every kernel call is held
    against its plain version."""
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.standalone.server import DEFAULTS, FiloServer

    t_phase = time.perf_counter()
    step = STEP // 1000
    start, fe, te = engine_grid()
    ports = [free_port(), free_port()]
    cfgs = [cluster_config(wdir["data"], wdir["stream"], ports, i)
            for i in range(2)]
    nodes = [None, None]
    wire = WireLog()
    calls, originals = record_kernel_calls()
    readings, times = [], {}
    try:
        t0 = time.perf_counter()

        def start_node(i):
            nodes[i] = FiloServer(cfgs[i]).start()
        # both start together: each replays its own shards' streams
        run_threads(2, start_node)
        n0, n1 = nodes
        times["start_s"] = wait_for(
            lambda: all(n.mapper.status(s).value == "active"
                        for n in nodes for s in range(4))
            and all(n.http.grpc_peers for n in nodes),
            "both nodes active with gRPC peers") + \
            (time.perf_counter() - t0)
        assert n0.owned_shards == [0, 1] and n1.owned_shards == [2, 3], \
            (n0.owned_shards, n1.owned_shards)
        log(f"phase 9: node0 :{n0.port} grpc :{n0.grpc_server.port}, "
            f"node1 :{n1.port} grpc :{n1.grpc_server.port}, both active "
            f"with gRPC peers in {times['start_s']:.1f} s")
        oracle = QueryEngine(n0.store.shards(n0.ref)
                             + n1.store.shards(n1.ref))
        t_or = time.perf_counter()
        T_max = len(np.arange(start, te + 1, step))
        variants = _oracle_rates(rows["ts"], rows["vals"], start * 1000,
                                 T_max, knife_ms=KNIFE_MS)
        times["oracle_variants_s"] = time.perf_counter() - t_or
        kn.reset_launches()
        fetch0 = n1.grpc_server.fetch_raw_served
        # 1. the grouped rate entering node0, then node1
        q1 = "sum by (job) (rate(http_requests_total[5m]))"
        # the first cold cross-node query, split by stage (ROADMAP C.17)
        g1a, r, _ = cluster_query(n0, "node0", q1, start, fe, wire,
                                  analyze=True)
        readings.append(r)
        g1b, r, _ = cluster_query(n1, "node1", q1, start, fe, wire)
        readings.append(r)
        assert n1.grpc_server.fetch_raw_served > fetch0
        t_or = time.perf_counter()
        want1 = json_order(oracle.execute(parse_query_range(
            q1, TimeStepParams(start, step, fe))))
        times["oracle_grouped_s"] = time.perf_counter() - t_or
        for g, r in ((g1a, readings[0]), (g1b, readings[1])):
            r["oracle"] = check_engine_answer(q1, g, want1, variants)
            r["vs_b_max_abs"] = close_grouped(g, answers_b[0][1],
                                              f"{q1} vs server B")
            assert r["launches"]["counter_groupsum"] >= 1, r
        answers = {("node0", q1): g1a, ("node1", q1): g1b}
        wants = {q1: want1}
        # 2. one job's per-series rate into the tail, 3. the irregular
        # rate into the tail (the extract kernel on the entry node), each
        # entering node0, then node1 (phase 11 holds its workers to both)
        for q, b_ix in ((Q_JOB, 2), (Q_IRR, 3)):
            assert answers_b[b_ix][0] == q
            wants[q] = json_order(oracle.execute(parse_query_range(
                q, TimeStepParams(start, step, te))))
            for node, name in ((n0, "node0"), (n1, "node1")):
                g, r, _ = cluster_query(node, name, q, start, te, wire)
                r["oracle"] = check_engine_answer(q, g, wants[q], variants)
                r["vs_b_bit_equal"] = same_answer(g, answers_b[b_ix][1])
                assert r["vs_b_bit_equal"], \
                    f"{q} into {name}: differs from server B's"
                if q == Q_IRR:
                    assert r["launches"]["window_extract"] >= 1, r
                answers[(name, q)] = g
                readings.append(r)
        # 4. a same-metric join with no `on`, over JOIN_JOBS jobs' series:
        # pushed down to both nodes (pinning _ws_/_ns_ prunes shards), its
        # Exec reply above grpcio's 4 MiB default (the C.15 repair)
        sel = ('http_requests_total{_ws_="demo",_ns_="App-0",'
               f'job=~"{"|".join(f"job{j}" for j in range(JOIN_JOBS))}"}}')
        qj = f"rate({sel}[5m]) / rate({sel}[5m] offset 1m)"
        ex = n0.http.make_planner("timeseries").materialize(
            parse_query_range(qj, TimeStepParams(start, step, fe)))
        tree = ex.plan_tree()
        assert type(ex).__name__ == "ConcatExec" and [
            type(c).__name__ for c in ex.children] == [
            "LocalEngineExec", "GrpcRemoteExec"], tree
        exec0 = n1.grpc_server.exec_served
        gj, r, _ = cluster_query(n0, "node0", qj, start, fe, wire)
        assert n1.grpc_server.exec_served == exec0 + 1
        assert r["wire"]["methods"] == ["Exec"] and \
            r["wire"]["reply_bytes"] > JOIN_REPLY_MIN_BYTES, r["wire"]
        r["plan_tree"] = tree
        r["oracle"] = check_join(gj, rows, start)
        readings.append(r)
        # 5. a metadata fan-out
        payload, ms, nbytes = http_json(
            n0.port, "/promql/timeseries/api/v1/series",
            {"match[]": "irregular_total"})
        assert len(payload["data"]) == ENGINE_IRREGULAR
        readings.append({"q": "/api/v1/series irregular_total",
                         "entry": "node0", "wall_ms": ms, "bytes": nbytes,
                         "series": len(payload["data"])})
        log(f"phase 9: series fan-out {ms:.1f} ms, "
            f"{len(payload['data'])} series")
        served = {"fetch_raw": n1.grpc_server.fetch_raw_served,
                  "exec": n1.grpc_server.exec_served}
        fallbacks = [n.http.plane_fallbacks.total for n in nodes]
        assert served["fetch_raw"] > 0 and served["exec"] > 0, served
        assert fallbacks == [0, 0], fallbacks
        # peer death: node1 stops without a drain or a flush
        t0 = time.perf_counter()
        n1.stop(flush=False)
        nodes[1] = None
        wait_statuses(n0, [2, 3], "down")
        times["detect_s"] = time.perf_counter() - t0
        gd, r, payload = cluster_query(n0, "node0 (node1 down)", q1, start,
                                       fe, wire)
        assert "shards 2,3 are down with no replica; results are " \
            "partial" in payload.get("warnings", []), payload.get("warnings")
        mine = sorted(int(lab["instance"][1:])
                      for s in n0.store.shards(n0.ref)
                      for lab in (dict(p.part_key.labels)
                                  for p in s.partitions.values())
                      if lab.get("_metric_") == "http_requests_total")
        assert 0 < len(mine) < S_ENGINE, len(mine)
        r["oracle"] = check_grouped_rule(gd, variants, mine)
        readings.append(r)
        # restart node1 on the same directories
        t0 = time.perf_counter()
        nodes[1] = FiloServer(cfgs[1]).start()
        n1 = nodes[1]
        times["restart_s"] = time.perf_counter() - t0
        wait_statuses(n0, [2, 3], "active")
        wait_for(lambda: "node1" in n0.http.grpc_peers, "gRPC re-learnt")
        times["recover_s"] = time.perf_counter() - t0
        g1c, r, _ = cluster_query(n0, "node0 (node1 back)", q1, start, fe,
                                  wire)
        r["vs_before_kill_bit_equal"] = same_answer(g1c, g1a)
        assert r["vs_before_kill_bit_equal"], \
            "the answer after the restart differs from the one before"
        readings.append(r)
        # planned handoff: node1 drains into node0
        t0 = time.perf_counter()
        code, body, _ = http_post(n1.port, "/admin/drain", b"{}",
                                  "application/json")
        times["drain_s"] = time.perf_counter() - t0
        assert code == 200, body[:300]
        out = json.loads(body)["data"]
        assert sorted(h["shard"] for h in out["handed_off"]) == [2, 3] \
            and out["failed"] == [], out
        assert sorted(s.shard_num for s in n0.store.shards(n0.ref)) == \
            [0, 1, 2, 3]
        fetch1 = n1.grpc_server.fetch_raw_served
        g1d, r, _ = cluster_query(n0, "node0 (after drain)", q1, start, fe,
                                  wire)
        assert n1.grpc_server.fetch_raw_served == fetch1
        assert r["wire"]["frames"] == 0, r["wire"]
        assert r["launches"]["counter_groupsum"] >= 1, r
        r["oracle"] = check_engine_answer(q1, g1d, want1, variants)
        r["vs_before_drain_max_abs"] = close_grouped(
            g1d, g1a, "after the drain vs before")
        r["vs_before_drain_bit_equal"] = same_answer(g1d, g1a)
        readings.append(r)
        launches = dict(kn.LAUNCHES)
        for name, n in launches.items():
            assert n > 0, f"{name} was not launched in phase 9"
        fallbacks = [n.http.plane_fallbacks.total for n in nodes]
        assert fallbacks == [0, 0], fallbacks
    finally:
        wire.restore()
        restore_kernels(originals)
        for n in nodes:
            if n is not None:
                n.stop(flush=False)
    errs = check_kernel_calls(calls, originals, "phase 9")
    secs = time.perf_counter() - t_phase
    cluster = {"seconds": secs, "times": times, "queries": readings,
               "query_timeout_s": {
                   "used": WAIT_S, "default": DEFAULTS["query-timeout-s"],
                   "raised_because": "the first cold cross-node grouped "
                   "rate answered 503 at the default (ROADMAP C.17)"},
               "grpc_served_by_node1": served,
               "plane_fallbacks": fallbacks, "launches": launches,
               "shared": "one interpreter (GIL) and one card", "card": smi}
    log(f"phase 9: {secs:.1f} s; times {json.dumps(times)}; kernel "
        f"launches {launches}; query-timeout-s {WAIT_S} (default "
        f"{DEFAULTS['query-timeout-s']}: raised, ROADMAP C.17)")
    return {"launches": launches, "errs": errs, "cluster": cluster,
            "answers": answers, "oracle": wants, "variants": variants,
            "grid": (start, fe, te)}


# ---------------------------------------------------------------------------
# phase 11: the supervisor, two worker processes sharing the card
# ---------------------------------------------------------------------------

# worker processes of phase 11; never 0, which means one worker (and one
# CUDA context) per core
SUP_WORKERS = 2
# the rule group that shows the election: the reference failover test's
# time() recording rule, at 60 s (wall-clock ticks of phase 7's
# S_ENGINE-series rules would compete with the cold queries)
SUP_RULES = {"groups": [{"name": "fo", "interval": "60s", "rules": [
    {"record": "fo:tick:value", "expr": "time()"}]}]}
# phase 11's health-fail-threshold; None keeps the supervisor's default
SUP_HEALTH_FAIL_THRESHOLD = None
# (query, grid end) of phase 11, as phase 9 ran them into both nodes
SUP_QUERIES = ((Q_GROUPED, "fe"), (Q_JOB, "te"), (Q_IRR, "te"))


def supervisor_config(wdir: dict, port: int, run_dir: str) -> dict:
    """Phase 11's base config: phase 9's node config less the keys the
    supervisor derives for each worker (port, num-nodes, node-ordinal,
    peers), so the workers are phase 9's nodes, and query-timeout-s stays
    raised to WAIT_S for phase 9's reason (ROADMAP C.17); SUP_WORKERS
    workers behind the public `port`, the election's rule group, and
    `device` left unset (the card)."""
    base = cluster_config(wdir["data"], wdir["stream"], [0, 0], 0)
    for k in ("port", "num-nodes", "node-ordinal", "peers"):
        del base[k]
    base.update({"serving-workers": SUP_WORKERS, "port": port,
                 "run-dir": run_dir, "rules": SUP_RULES,
                 # each worker's sampling profiler, read through
                 # /debug/profile after its cold query
                 "profiler-enabled": True})
    if SUP_HEALTH_FAIL_THRESHOLD is not None:
        base["health-fail-threshold"] = SUP_HEALTH_FAIL_THRESHOLD
    return base


def poll(pred, what: str, seen: Optional[dict] = None) -> float:
    """Poll `pred` until true, at most WAIT_S; a refused connection or an
    unreadable answer counts as false -> seconds waited. `seen`, which
    `pred` may fill, goes into the timeout's message."""
    t0 = time.perf_counter()
    last = None
    while True:
        try:
            if pred():
                return time.perf_counter() - t0
        except (OSError, ValueError, KeyError) as e:
            last = repr(e)
        assert time.perf_counter() - t0 < WAIT_S, \
            f"timed out: {what} (last error {last}; last seen {seen})"
        time.sleep(0.05)


def get_json(port: int, path: str, params: Optional[dict] = None):
    code, body, _ = http_get(port, path, params or {})
    if code != 200:
        raise ValueError(f"{path}: HTTP {code}: {body[:300]!r}")
    return json.loads(body)


def worker_serving(ports, i: int, seen: dict) -> bool:
    """Worker i's view: every shard active with its ordinal owner, and
    its sibling's gRPC address learnt (what it shows goes into `seen`)."""
    st = get_json(ports[i], "/api/v1/cluster/timeseries/status")["data"]
    owners = [f"node{s * SUP_WORKERS // len(st)}" for s in range(len(st))]
    h = get_json(ports[i], "/__health")
    seen[f"worker{i}"] = {"shards": st, "grpc_peers": h["grpc_peers"],
                          "down_peers": h["down_peers"]}
    return all(e["status"] == "active" for e in st) \
        and [e["address"] for e in st] == owners \
        and all(f"node{j}" in h["grpc_peers"]
                for j in range(SUP_WORKERS) if j != i)


def rules_active(port: int) -> float:
    return scrape(port)["filodb_rules_active"]


def worker_query(port: int, entry: str, q: str, grid, analyze: bool):
    """One query over HTTP with &cache=false (and &explain=analyze: the
    worker's own account of its stages and of the kernels it launched)
    -> (grid, reading)."""
    start, end = grid
    params = {"query": q, "start": start, "end": end,
              "step": STEP // 1000, "cache": "false"}
    if analyze:
        params["explain"] = "analyze"
    payload, ms, nbytes = http_json(
        port, "/promql/timeseries/api/v1/query_range", params)
    r = {"q": q, "entry": entry, "wall_ms": ms, "bytes": nbytes}
    if analyze:
        spans = payload["trace"]["spans"]
        r["spans"] = sorted({sp["name"] for sp in spans})
        r["dispatch_paths"] = sorted({
            sp.get("tags", {}).get("path", "") for sp in spans
            if sp["name"] == "device-dispatch"})
        r["analyze"] = analyze_split(payload)
    log(f"phase 11: {entry} {q} to {end}: {ms:.1f} ms, {nbytes} bytes"
        + (f", dispatch paths {r['dispatch_paths']}, analyze "
           f"{json.dumps(r['analyze'])}" if analyze else ""))
    return grid_from_json(payload, start, end, STEP // 1000), r


def worker_profile(port: int) -> dict:
    """A worker's sampling profiler since its start (/debug/profile with
    seconds=0): samples by thread root, and for each root the innermost
    functions of its stacks with the most samples (folded text)."""
    rep = get_json(port, "/debug/profile", {"seconds": 0})["data"]
    assert rep["samples"] > 0 and rep["running"], rep
    code, body, _ = http_get(port, "/debug/profile",
                             {"seconds": 0, "format": "folded"})
    assert code == 200, body[:300]
    leaves: dict = {}
    for line in body.decode().splitlines():
        stack, n = line.rsplit(" ", 1)
        frames = stack.split(";")
        per = leaves.setdefault(frames[0], {})
        per[frames[-1]] = per.get(frames[-1], 0) + int(n)
    top = {root: sorted(per.items(), key=lambda kv: -kv[1])[:5]
           for root, per in sorted(leaves.items())}
    log(f"phase 11: worker 0's profile after its cold query ({rep['hz']} "
        f"hz): samples by thread root {json.dumps(rep['roots'])}")
    for root, fns in top.items():
        log(f"phase 11:   {root}: " + ", ".join(
            f"{fn} {n}" for fn, n in fns))
    return {"samples": rep["samples"], "hz": rep["hz"],
            "attribution_fraction": rep["attribution_fraction"],
            "roots": rep["roots"], "top_by_root": top}


def merged_threads(sup: int) -> dict:
    """The supervisor's /debug/threads: both workers' thread inventories,
    each entry tagged with its worker -> per worker, its roots and those
    with live threads."""
    body = get_json(sup, "/debug/threads")
    out = {}
    for w in range(SUP_WORKERS):
        mine = [e for e in body["data"] if e.get("worker") == w]
        out[str(w)] = {"roots": sorted({e["name"] for e in mine}),
                       "live": sorted({e["name"] for e in mine
                                       if e["live_threads"]})}
        assert {"http-handler", "accept-edge", "bus-client",
                "device-executor", "profiler-sampler"} <= \
            set(out[str(w)]["roots"]), out
        assert {"accept-edge", "bus-client", "profiler-sampler"} <= \
            set(out[str(w)]["live"]), out
    log(f"phase 11: merged /debug/threads: {json.dumps(out)}")
    return out


def start_supervisor(cfg: dict, run_dir: str):
    """`python -m filodb_tpu_torch.standalone.supervisor` as a subprocess
    (its stderr and its workers' go to this script's) -> (process, its
    startup line, seconds to that line)."""
    import select

    path = os.path.join(run_dir, "supervisor.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "filodb_tpu_torch.standalone.supervisor",
         "--config", path], cwd=REPO, stdout=subprocess.PIPE)
    buf = b""
    while b"\n" not in buf:
        assert proc.poll() is None, \
            f"the supervisor exited with {proc.returncode} at start-up"
        assert time.perf_counter() - t0 < WAIT_S, \
            "no startup line from the supervisor"
        if select.select([proc.stdout], [], [], 0.5)[0]:
            buf += proc.stdout.read1(4096)
    return proc, json.loads(buf.split(b"\n", 1)[0]), \
        time.perf_counter() - t0


def end_supervisor(proc, pids) -> None:
    """Stop a supervisor this phase started and left running (a failed
    check): SIGTERM, then SIGKILL for it and every worker pid known."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def phase_supervisor(wdir: dict, p9: dict, smi: str) -> dict:
    """Phase 11: `python -m filodb_tpu_torch.standalone.supervisor` runs
    SUP_WORKERS worker processes of the port's server on the card behind
    one public port, on a copy of the directories phase 9's nodes started
    from (made before phase 9), with phase 9's node config: worker 0 owns
    shards 0-1 and worker 1 shards 2-3, as node0 and node1 did. Checked:
    both workers ready and on the bus; phase 9's grouped, job and
    irregular rates entering worker 0's private port, worker 1's, then the
    public port (&cache=false), each private answer bit for bit phase 9's
    answer entering the same ordinal (which launched both kernels and held
    them against their plain versions: the oracle route would not
    reproduce those bits) and the public one equal to one of them, all
    within the oracle's bounds; the device-dispatch spans of the private
    answers (&explain=analyze) and the merged /debug/traces of both workers;
    the merged /metrics; /admin/invalidate on both workers; kill -9 of
    worker 0 (the respawn, the rule evaluator handed to worker 1 and
    back, worker 0's grouped answer again bit for bit); SIGTERM of the
    supervisor (worker 0 drained into worker 1, both stopped, exit 0, no
    worker left). Each private query goes with &explain=analyze: the
    worker's own stage split and the dispatches of the kernels' sites,
    summed as the phase's launches; worker 0's /debug/profile after its
    cold query; the merged /debug/threads of both workers."""
    import signal

    from filodb_tpu_torch.standalone.server import DEFAULTS
    from filodb_tpu_torch.standalone.supervisor import SUPERVISOR_DEFAULTS

    t_phase = time.perf_counter()
    start, fe, te = p9["grid"]
    ends = {"fe": fe, "te": te}
    run_dir = os.path.join(os.path.dirname(wdir["data"]), "run")
    os.makedirs(run_dir, exist_ok=True)
    cfg = supervisor_config(wdir, free_port(), run_dir)
    proc, line, line_s = start_supervisor(cfg, run_dir)
    sup, pub = line["supervisor_port"], line["port"]
    ports = [w["port"] for w in line["workers"]]
    times = {"supervisor_line_s": line_s}
    pids: set = set()
    try:
        # 1. both workers ready (their startup lines) and on the bus
        ready_at = {}

        def all_ready():
            h = get_json(sup, "/__health")
            for k, w in h["workers"].items():
                if w["pid"]:
                    pids.add(w["pid"])
                if w["ready"] and k not in ready_at:
                    ready_at[k] = time.perf_counter() - t_phase
            return len(ready_at) == SUP_WORKERS \
                and h["bus_connected"] == list(range(SUP_WORKERS))
        poll(all_ready, "both workers ready and on the bus")
        serving_at, seen = {}, {}
        for i in range(SUP_WORKERS):
            poll(lambda: worker_serving(ports, i, seen),
                 f"worker {i} serving with its sibling's shards", seen)
            serving_at[str(i)] = time.perf_counter() - t_phase
        health = get_json(sup, "/__health")
        first_pids = {k: w["pid"] for k, w in health["workers"].items()}
        assert all(w["restarts"] == 0 for w in health["workers"].values()), \
            health
        workers = {k: {"port": ports[int(k)], "pid": first_pids[k],
                       "ready_s": ready_at[k], "serving_s": serving_at[k]}
                   for k in first_pids}
        log(f"phase 11: supervisor :{sup}, public :{pub}, workers "
            f"{json.dumps(workers)}")
        # 2-3. the queries through each entry point
        readings, mine, profile = [], {}, None
        launches = {k: 0 for k in KERNEL_SITES}
        entries = [(f"worker{i}", ports[i], f"node{i}")
                   for i in range(SUP_WORKERS)] + [("public", pub, None)]
        for entry, port, node in entries:
            for q, end_key in SUP_QUERIES:
                g, r = worker_query(port, entry, q, (start, ends[end_key]),
                                    analyze=node is not None)
                if node is not None:
                    # the worker's own count of its kernel launches
                    for k, n in r["analyze"]["kernel_dispatches"].items():
                        launches[k] += n
                if entry == "worker0" and profile is None:
                    profile = worker_profile(port)
                r["oracle"] = check_engine_answer(q, g, p9["oracle"][q],
                                                  p9["variants"])
                if node is not None:
                    r["vs_phase9_bit_equal"] = same_answer(
                        g, p9["answers"][(node, q)])
                    assert r["vs_phase9_bit_equal"], \
                        f"{q} into {entry}: differs from phase 9's into {node}"
                    assert "device-eval" in r["spans"] or q == Q_GROUPED, r
                    if q == Q_IRR:
                        assert "packed" in r["dispatch_paths"], r
                    mine[(node, q)] = g
                else:
                    r["equals_phase9_of"] = [
                        n for n in (f"node{i}" for i in range(SUP_WORKERS))
                        if same_answer(g, p9["answers"][(n, q)])]
                    assert r["equals_phase9_of"], \
                        f"{q} through the public port: equals neither worker's"
                readings.append(r)
        traces = get_json(sup, "/debug/traces")
        traced_workers = sorted({e["worker"] for e in traces["data"]})
        assert traced_workers == list(range(SUP_WORKERS)), traced_workers
        for name, n in launches.items():
            assert n > 0, f"{name} was not launched in phase 11's workers"
        threads = merged_threads(sup)
        # 4. the merged /metrics (a worker's election gauge is set while
        # one exposition builds and shown by the next: polled)
        snap = {}

        def elected():
            snap["m"] = scrape(sup)
            return all(snap["m"].get(f'filodb_rules_active{{worker="{i}"}}')
                       == (1 if i == 0 else 0) for i in range(SUP_WORKERS))
        poll(elected, "worker 0 the elected evaluator in /metrics")
        m = snap["m"]
        merged = {
            "workers": m["filodb_supervisor_workers"],
            "bus_connected_workers":
                m["filodb_supervisor_bus_connected_workers"]}
        for i in range(SUP_WORKERS):
            lb = f'{{worker="{i}"}}'
            merged[f"worker{i}"] = {
                "ordinal": m["filodb_worker_ordinal" + lb],
                "device_execute_count":
                    m["filodb_device_execute_seconds_count" + lb],
                "rules_active": m["filodb_rules_active" + lb]}
        assert merged["workers"] == merged["bus_connected_workers"] \
            == SUP_WORKERS, merged
        for i in range(SUP_WORKERS):
            w = merged[f"worker{i}"]
            assert w["ordinal"] == i and w["device_execute_count"] > 0 \
                and w["rules_active"] == (1 if i == 0 else 0), merged
        log(f"phase 11: merged /metrics {json.dumps(merged)}")
        # 5. /admin/invalidate reaches every worker
        inv = "filodb_plan_cache_invalidations_total{{worker=\"{}\"}}"
        before = [m[inv.format(i)] for i in range(SUP_WORKERS)]
        code, body, _ = http_post(sup, "/admin/invalidate?reason=phase11",
                                  b"{}", "application/json")
        assert code == 200, body[:300]
        times["invalidate_s"] = poll(
            lambda: all(scrape(sup)[inv.format(i)] > before[i]
                        for i in range(SUP_WORKERS)),
            "the invalidation on every worker")
        # 6. kill -9 of worker 0: respawn, hand-over and return
        t_kill = time.perf_counter()
        os.kill(first_pids["0"], signal.SIGKILL)
        since = {}

        def mark(name, pred, what):
            poll(pred, what, seen)
            since[name] = time.perf_counter() - t_kill

        def restarted():
            ws = get_json(sup, "/__health")["workers"]
            return ws["0"]["restarts"] == 1 and ws["1"]["restarts"] == 0
        mark("restart_counted_s", restarted, "the supervisor's respawn")
        mark("handover_s", lambda: rules_active(ports[1]) == 1,
             "worker 1 taking the rule evaluation over")

        def ready_again():
            w = get_json(sup, "/__health")["workers"]["0"]
            if w["pid"]:
                pids.add(w["pid"])
            return w["ready"] and w["pid"] != first_pids["0"]
        mark("ready_s", ready_again, "worker 0 ready again")
        mark("takeback_s", lambda: rules_active(ports[0]) == 1
             and rules_active(ports[1]) == 0,
             "worker 0 taking the rule evaluation back")
        mark("serving_s", lambda: worker_serving(ports, 0, seen)
             and worker_serving(ports, 1, seen), "worker 0 serving again")
        g, r = worker_query(ports[0], "worker0 (respawned)", Q_GROUPED,
                            (start, fe), analyze=False)
        r["vs_before_kill_bit_equal"] = same_answer(
            g, mine[("node0", Q_GROUPED)])
        assert r["vs_before_kill_bit_equal"], \
            "worker 0's grouped answer after the respawn differs"
        r["oracle"] = check_engine_answer(Q_GROUPED, g,
                                          p9["oracle"][Q_GROUPED],
                                          p9["variants"])
        readings.append(r)
        health = get_json(sup, "/__health")
        restarts = {k: w["restarts"] for k, w in health["workers"].items()}
        assert restarts == {"0": 1, "1": 0}, restarts
        election = get_json(ports[1], "/api/v1/rules",
                            {"debug": 1, "__local__": 1})
        log(f"phase 11: after kill -9 of worker 0: {json.dumps(since)}")
        # 7. SIGTERM: worker 0 drains into worker 1, both stop, exit 0
        last_pids = {k: w["pid"] for k, w in health["workers"].items()}
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=WAIT_S)
        times["stop_s"] = time.perf_counter() - t0
        assert rc == 0, f"the supervisor exited with {rc}"
        survivors = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                survivors.append(pid)
            except ProcessLookupError:
                pass
        assert survivors == [], f"worker pids alive after the stop: " \
            f"{survivors}"
    finally:
        end_supervisor(proc, pids)
    secs = time.perf_counter() - t_phase
    out = {
        "seconds": secs, "times": times, "workers": workers,
        "respawn": dict(since, pid=last_pids["0"]),
        "restarts": restarts, "queries": readings,
        "traced_workers": traced_workers, "merged_metrics": merged,
        "election_log_worker1": (election.get("data") or {}).get("debug"),
        "route": "each private answer bit for bit phase 9's; each "
                 "worker's launches from its own &explain=analyze "
                 "(dispatches of the kernels' sites)",
        "launches": launches, "profile_worker0": profile,
        "threads": threads,
        "serving_workers": SUP_WORKERS,
        "query_timeout_s": {"used": cfg["query-timeout-s"],
                            "default": DEFAULTS["query-timeout-s"]},
        "health_fail_threshold": {
            "used": cfg.get("health-fail-threshold",
                            SUPERVISOR_DEFAULTS["health-fail-threshold"]),
            "default": SUPERVISOR_DEFAULTS["health-fail-threshold"]},
        "card": smi}
    log(f"phase 11: {secs:.1f} s; times {json.dumps(times)}")
    return out


# ---------------------------------------------------------------------------
# phase 10: recording rules, alerting and self-monitoring on phase 7's server
# ---------------------------------------------------------------------------

RULE_TICKS = 8          # consecutive 60 s boundaries ticked, ending at the
                        # engine grid's flushed end
RULE_FOR = "2m"         # the alert's for: (pending at ticks 1-2)
SELFMON_WINDOW_S = 60   # rate window and step of the __selfmon__ checks
SELFMON_STEP_S = 15
REC_JOB = "job:http_requests:rate5m"
REC_IRR = "irregular:rate5m"
ALERT = "JobRequestRateHigh"


def rule_ticks() -> list:
    """The phase's tick boundaries in s: RULE_TICKS steps of the 60 s
    interval ending at engine_grid()'s flushed end (a multiple of 60)."""
    _, fe, _ = engine_grid()
    s = STEP // 1000
    assert fe % s == 0
    return [fe - (RULE_TICKS - 1 - k) * s for k in range(RULE_TICKS)]


def rule_threshold(rows: dict) -> float:
    """The alert's threshold X: the median of the G jobs' rates at the
    first tick by the f64 integer-rule oracle (variant 0), fixed before
    any tick and never tuned against the kernel's answer."""
    r = _oracle_rates(rows["ts"], rows["vals"], rule_ticks()[0] * 1000, 1)
    gid = np.arange(r.shape[0]) % G
    return float(np.median(_group_sum(r, gid)[0]))


def rules_config(threshold: float, webhook_url: str) -> dict:
    """Phase 7's extra keys: three rule groups at the 60 s step (inline
    JSON, so PyYAML is not needed), their webhook, and self-monitoring at
    the reference's default intervals."""
    return {"rules": {"groups": [
        {"name": "job-rates", "interval": "60s", "rules": [
            {"record": REC_JOB, "expr": Q_GROUPED}]},
        {"name": "irregular-rates", "interval": "60s", "rules": [
            {"record": REC_IRR, "expr": Q_IRR}]},
        {"name": "alerts", "interval": "60s", "rules": [
            {"alert": ALERT, "expr": f"{Q_GROUPED} > {threshold!r}",
             "for": RULE_FOR}]}]},
        "rules-webhook-url": webhook_url, "self-monitor": True}


class WebhookSink:
    """A loopback HTTP receiver of the alert webhooks: keeps every POSTed
    JSON body."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        bodies = self.bodies = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                bodies.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/alerts"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def _backend_counts(be) -> dict:
    return {k: getattr(be, k) for k in ("tile_builds", "tile_hits",
                                        "aligned_evals", "packed_dispatches",
                                        "fused_aggs")}


def rule_tick_run(srv) -> dict:
    """Ticks every group of the engine at each rule_ticks() boundary
    through eval_group_once, the kernels' calls recorded and their launch
    counts set to 0 just before the first tick and read just after the
    last. Per tick: the route (launches and backend counters moved), the
    engine's alert instances and /api/v1/rules?explain=analyze. Every
    sample the write-back received is kept."""
    from filodb_tpu_torch.query import kernels as kn

    eng, be = srv.rules, srv.backend
    writes = []
    wb_write = eng.writeback.write

    def keep(samples):
        samples = list(samples)
        writes.extend(samples)
        return wb_write(samples)
    eng.writeback.write = keep
    ticks, per_tick = rule_ticks(), []
    calls, originals = record_kernel_calls()
    kn.reset_launches()
    wall0 = time.time()
    t0 = time.perf_counter()
    try:
        for b in ticks:
            l0, c0 = dict(kn.LAUNCHES), _backend_counts(be)
            tk = time.perf_counter()
            outs = [eng.eval_group_once(g, b) for g in eng.groups]
            torch.cuda.synchronize()
            dt = time.perf_counter() - tk
            assert all(o["ok"] for o in outs), outs
            c1 = _backend_counts(be)
            r = {"at": b, "s": dt,
                 "launches": {k: kn.LAUNCHES[k] - l0[k] for k in l0},
                 "backend": {k: c1[k] - c0[k] for k in c0},
                 "groups_s": {o["group"]: o["duration_s"] for o in outs},
                 "alerts": sorted((a["labels"]["job"], a["state"])
                                  for a in eng.alerts_payload()["alerts"])}
            payload, _, _ = http_json(srv.port, "/api/v1/rules",
                                      {"explain": "analyze"})
            r["stages"] = {rule["name"]: rule["lastEval"]["stages"]
                           for g in payload["data"]["groups"]
                           for rule in g["rules"]}
            per_tick.append(r)
            cache = {k: (v["resultCache"], v["cachedSteps"])
                     for k, v in r["stages"].items()}
            log(f"phase 10: tick at {b}: {dt * 1e3:.1f} ms, launches "
                f"{r['launches']}, backend {r['backend']}, cache {cache}")
    finally:
        restore_kernels(originals)
        eng.writeback.write = wb_write
    launches = dict(kn.LAUNCHES)
    ticks_s = time.perf_counter() - t0
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched by phase 10's rule ticks"
    errs = check_kernel_calls(calls, originals, "phase 10")
    return {"per_tick": per_tick, "writes": writes, "launches": launches,
            "errs": errs, "ticks_s": ticks_s, "wall": (wall0, time.time())}


def _recorded(writes, metric: str) -> dict:
    """{(labels without _ws_/_ns_/_metric_, ts ms): value} of one metric."""
    out = {}
    for _, labels, ts, v in writes:
        if labels["_metric_"] == metric:
            key = tuple(sorted((k, x) for k, x in labels.items()
                               if k not in ("_ws_", "_ns_", "_metric_")))
            out[(key, int(ts))] = v
    return out


def _route(r: dict) -> str:
    """The route a tick's grouped rate took, from what moved: the fused
    group-sum declines a grid of one step (groupsum_plan needs two, as the
    reference does), and the engine then evaluates every series on the
    cached aligned tiles (evaluate_counters_t) and groups on the host."""
    if r["backend"]["fused_aggs"]:
        assert r["launches"]["counter_groupsum"] > 0, r
        return "fused group-sum"
    if r["backend"]["tile_hits"] or r["backend"]["tile_builds"]:
        return "per-series on aligned tiles"
    return "packed path"


def check_rule_groups(srv, rows, run, threshold) -> dict:
    """The recorded job rates at every tick against the f64 integer-rule
    oracle (group-sum tolerance) and against the same query over HTTP with
    &cache=false on the tick's grid."""
    ticks = rule_ticks()
    s = STEP // 1000
    variants = _oracle_rates(rows["ts"], rows["vals"], ticks[0] * 1000,
                             len(ticks), knife_ms=KNIFE_MS)
    gid = np.arange(variants.shape[1]) % G
    nom = _group_sum(variants[0], gid)                   # [T, G]
    spread = _group_sum(np.nan_to_num(np.nanmax(variants, axis=0)
                                      - np.nanmin(variants, axis=0)), gid)
    rec = _recorded(run["writes"], REC_JOB)
    got = np.full(nom.shape, np.nan)
    for (key, ts), v in rec.items():
        k = ticks.index(ts // 1000)
        got[k, int(dict(key)["job"][3:])] = v
    assert np.isfinite(got).all(), "a job's rate is missing at a tick"
    err = np.abs(got - nom)
    # the fused group-sum decides the extrapolation branch on integer ms as
    # variant 0 does; another route may take a knife edge either way
    fused = np.asarray([_route(r) == "fused group-sum"
                        for r in run["per_tick"]])[:, None]
    allow = np.where(fused, 0.0, spread)
    assert (err <= 1e-5 * np.abs(nom) + allow + 1e-9).all(), \
        f"recorded job rates vs the oracle: max abs err {err.max()}"
    http_diff = 0.0
    for k, b in enumerate(ticks):
        payload, _, _ = http_json(
            srv.port, "/promql/timeseries/api/v1/query_range",
            {"query": Q_GROUPED, "start": b - (RULE_TICKS - 1) * s,
             "end": b, "step": s, "cache": "false"})
        g = grid_from_json(payload, b - (RULE_TICKS - 1) * s, b, s)
        for key, row in zip(g.keys, g.values):
            j = int(key["job"][3:])
            d = abs(row[-1] - got[k, j])
            assert d <= 1e-5 * abs(got[k, j]) + 1e-9, (b, key, d)
            http_diff = max(http_diff, d / abs(got[k, j]))
    return {"samples": len(rec), "max_rel_err_vs_oracle":
            float(np.max(err / np.abs(nom))),
            "knife_cells": int(((spread > 0) & ~fused).sum()),
            "max_rel_diff_vs_http_uncached": http_diff,
            "threshold": threshold, "got": got, "nom": nom,
            "spread": spread}


def check_rule_irregular(srv, run) -> dict:
    """The recorded irregular rates at every tick: bit for bit what the
    engine gives on the tick's computed grid with the extract's plain
    version in the kernel's place, and within phase 4's tolerance of the
    engine's numpy oracle."""
    from types import SimpleNamespace

    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query.engine import QueryEngine

    ticks = rule_ticks()
    s = STEP // 1000
    rec = _recorded(run["writes"], REC_IRR)
    shards = srv.store.shards(srv.ref)
    plain = QueryEngine(shards, backend=srv.backend)
    kernel = kn.window_extract
    kn.window_extract = kn.window_extract_reference
    try:
        exact = 0
        for k, b in enumerate(ticks):
            # the first tick computes its whole grid, the others the
            # newest step (the results cache serves the rest)
            start = b - (RULE_TICKS - 1) * s if k == 0 else b
            want = plain.execute(parse_query_range(
                Q_IRR, TimeStepParams(start, s, b)))
            for key, row in zip(want.keys, want.values):
                if np.isnan(row[-1]):
                    continue
                lab = tuple(sorted((a, v) for a, v in dict(key).items()
                                   if a not in ("_ws_", "_ns_", "_metric_")))
                got = rec[(lab, b * 1000)]
                assert got == row[-1], (b, lab, got, row[-1])
                exact += 1
    finally:
        kn.window_extract = kernel
    assert exact == len(rec), (exact, len(rec))
    oracle = QueryEngine(shards).execute(parse_query_range(
        Q_IRR, TimeStepParams(ticks[0], s, ticks[-1])))
    vals = np.full(oracle.values.shape, np.nan)
    for i, key in enumerate(oracle.keys):
        lab = tuple(sorted((a, v) for a, v in dict(key).items()
                           if a not in ("_ws_", "_ns_", "_metric_")))
        for k, b in enumerate(ticks):
            vals[i, k] = rec.get((lab, b * 1000), np.nan)
    got = SimpleNamespace(keys=oracle.keys, values=vals)
    return {"samples": len(rec), "bit_exact_vs_plain_extract": exact,
            "oracle": check_engine_answer(Q_IRR, got, oracle, None)}


def check_rule_readback(srv, run) -> dict:
    """Every recorded sample read back from __rules__ over HTTP, bit for
    bit as written."""
    ticks = rule_ticks()
    s = STEP // 1000
    n = 0
    for metric in (REC_JOB, REC_IRR):
        rec = _recorded(run["writes"], metric)
        payload, _, nbytes = http_json(
            srv.port, "/promql/__rules__/api/v1/query_range",
            {"query": metric, "start": ticks[0], "end": ticks[-1],
             "step": s})
        back = {}
        for e in payload["data"]["result"]:
            assert e["metric"]["_ws_"] == "__rules__", e["metric"]
            key = tuple(sorted((a, v) for a, v in e["metric"].items()
                               if a not in ("_ws_", "_ns_", "__name__")))
            for t, v in e["values"]:
                back[(key, int(round(float(t) * 1000)))] = float(v)
        assert set(back) == set(rec), (metric, len(back), len(rec))
        for key, v in rec.items():
            assert back[key] == v, (metric, key, back[key], v)
        n += len(rec)
    return {"samples_read_back": n}


def expected_alerts(groups: dict, threshold: float, for_s: float):
    """The alert's instances after each tick by Prometheus' state machine
    over the recorded job rates; a job is active where its recorded rate
    is above X. Where the oracle puts a job clearly on one side of X
    (further than the group-sum tolerance and the knife spread) the
    recorded side must agree; closer, the recorded side decides, and the
    cell is counted -> ([sorted (job, state)] per tick, knife cells)."""
    ticks = rule_ticks()
    got, nom, spread = groups["got"], groups["nom"], groups["spread"]
    tol = 1e-5 * np.abs(nom) + spread + 1e-9
    clear = np.abs(nom - threshold) > tol
    assert ((got > threshold) == (nom > threshold))[clear].all(), \
        "a job clearly on one side of X by the oracle alerts on the other"
    state, out = {}, []
    for k, b in enumerate(ticks):
        for j in range(G):
            if got[k, j] > threshold:
                st = state.get(j)
                if st is None:
                    state[j] = ("pending" if for_s > 0 else "firing", b)
                elif st[0] == "pending" and b - st[1] >= for_s:
                    state[j] = ("firing", st[1])
            else:
                state.pop(j, None)
        out.append(sorted((f"job{j}", st[0]) for j, st in state.items()))
    return out, int((~clear).sum())


def check_alerts(srv, sink, run, groups) -> dict:
    """The alert's instances after every tick as expected_alerts() says;
    ALERTS{alertstate=...} read back from __rules__ at each step (a
    series stays visible for the 5 m lookback after its last sample),
    /api/v1/alerts after the last tick, and the webhook's firing bodies."""
    ticks = rule_ticks()
    s = STEP // 1000
    want, knife = expected_alerts(groups, groups["threshold"], 120.0)
    got = [[tuple(a) for a in r["alerts"]] for r in run["per_tick"]]
    assert got == [[tuple(a) for a in w] for w in want], (got, want)
    firing_final = sorted(j for j, st in want[-1] if st == "firing")
    assert firing_final, "no job fired"
    for state in ("pending", "firing"):
        payload, _, _ = http_json(
            srv.port, "/promql/__rules__/api/v1/query_range",
            {"query": f'ALERTS{{alertname="{ALERT}",alertstate="{state}"}}',
             "start": ticks[0], "end": ticks[-1], "step": s})
        seen = {}
        for e in payload["data"]["result"]:
            for t, _ in e["values"]:
                seen.setdefault(int(float(t)), set()).add(
                    e["metric"]["job"])
        for k, b in enumerate(ticks):
            recent = {j for i in range(k + 1) if b - ticks[i] <= 300
                      for j, st in want[i] if st == state}
            assert seen.get(b, set()) == recent, (state, b, seen.get(b),
                                                  recent)
    payload, _, _ = http_json(srv.port, "/api/v1/alerts", {})
    api = sorted((a["labels"]["job"], a["state"])
                 for a in payload["data"]["alerts"])
    assert api == [tuple(a) for a in want[-1]], (api, want[-1])
    fired = []
    for k in range(len(ticks)):
        before = {j for j, st in want[k - 1] if st == "firing"} if k else set()
        fired += sorted({j for j, st in want[k] if st == "firing"} - before)
    deadline = time.monotonic() + 60
    while sum(1 for b in sink.bodies if b["status"] == "firing") \
            < len(fired):
        assert time.monotonic() < deadline, "webhook not delivered"
        time.sleep(0.05)
    hooked = sorted(b["alerts"][0]["labels"]["job"] for b in sink.bodies
                    if b["status"] == "firing")
    assert hooked == sorted(fired), (hooked, fired)
    return {"threshold": groups["threshold"], "knife_cells": knife,
            "per_tick": [dict(want[k]) for k in range(len(ticks))],
            "firing": firing_final, "webhook_firing": hooked,
            "webhook_bodies": len(sink.bodies), "alerts_api": api}


def check_explain(run) -> dict:
    """/api/v1/rules?explain=analyze: a cold first evaluation (nothing
    cached, the plan parsed), then results-cache partial hits where only
    the newest step computes."""
    out = []
    for k, r in enumerate(run["per_tick"]):
        for name, st in r["stages"].items():
            want = ("miss", 0, "miss") if k == 0 else \
                ("partial", RULE_TICKS - 1, "hit")
            got = (st["resultCache"], st["cachedSteps"], st["rulePlanCache"])
            assert got == want, (k, name, st)
        out.append({n: st["resultCache"] for n, st in r["stages"].items()})
    return {"result_cache": out}


def selfmon_raw(srv, metric: str, start_ms: int, end_ms: int, **labels):
    """Raw (ts, values) of one __selfmon__ series (empty before its first
    sample), read from its shard."""
    from filodb_tpu_torch.core.index import ColumnFilter
    from filodb_tpu_torch.core.schemas import DatasetRef
    from filodb_tpu_torch.query.engine import select_raw_series

    filters = [ColumnFilter("_metric_", "eq", metric)] + [
        ColumnFilter(k, "eq", v) for k, v in labels.items()]
    found = select_raw_series(srv.store.shards(DatasetRef("__selfmon__")),
                              filters, start_ms, end_ms)
    assert len(found) <= 1, [s.labels for s in found]
    if not found:
        return np.zeros(0, np.int64), np.zeros(0)
    return np.asarray(found[0].ts, np.int64), np.asarray(found[0].values,
                                                         np.float64)


def check_selfmon_rate(srv, metric: str, span, **labels) -> dict:
    """rate(metric[SELFMON_WINDOW_S]) over __selfmon__ on the span's grid
    over HTTP, against the f64 oracle on the raw samples of the same
    selection: a value where the oracle has one (two samples in the
    window), matching one branch variant at rtol 1e-5 -> the reading,
    with the steps that had a value."""
    s0, s1 = span
    start = s0 + SELFMON_WINDOW_S
    end = start + (s1 - start) // SELFMON_STEP_S * SELFMON_STEP_S
    sel = metric + ("{" + ",".join(f'{k}="{v}"' for k, v in labels.items())
                    + "}" if labels else "")
    payload, _, _ = http_json(
        srv.port, "/promql/__selfmon__/api/v1/query_range",
        {"query": f"rate({sel}[{SELFMON_WINDOW_S}s])", "start": start,
         "end": end, "step": SELFMON_STEP_S})
    assert len(payload["data"]["result"]) <= 1, payload["data"]["result"]
    g = grid_from_json(payload, start, end, SELFMON_STEP_S)
    ts, vals = selfmon_raw(srv, metric, s0 * 1000 - 120_000, end * 1000,
                           **labels)
    T = (end - start) // SELFMON_STEP_S + 1
    var = np.full((4, T), np.nan) if ts.size < 2 else _oracle_rates(
        ts[None], vals[None], start * 1000, T, knife_ms=KNIFE_MS,
        window=SELFMON_WINDOW_S * 1000, step=SELFMON_STEP_S * 1000)[:, 0]
    got = g.values[0] if len(g.keys) else np.full(T, np.nan)
    ok = np.isnan(var[0]) == np.isnan(got)
    hit = (np.abs(got[None] - var) <= 1e-5 * np.abs(var) + 1e-12).any(0)
    assert (ok & (np.isnan(got) | hit)).all(), (metric, got, var[0])
    with np.errstate(all="ignore"):
        rel = np.abs(got - var[0]) / np.abs(var[0])
    rel = float(rel[np.isfinite(rel)].max()) if np.isfinite(rel).any() \
        else 0.0
    return {"query": f"rate({sel}[{SELFMON_WINDOW_S}s])", "steps": T,
            "steps_with_a_value": int(np.isfinite(got).sum()),
            "raw_samples": int(ts.size), "max_rel_err": rel}


def selfmon_wait(srv, after_s: float) -> int:
    """Waits for the self-monitoring loop's next snapshot after `after_s`
    (wall s) -> its timestamp in ms."""
    deadline = time.monotonic() + 60
    while True:
        ts, _ = selfmon_raw(srv, "filodb_selfmon_ticks_total", 0,
                            int(time.time() * 1000) + 1)
        if ts.size and ts[-1] > after_s * 1000:
            return int(ts[-1])
        assert time.monotonic() < deadline, "no self-monitoring tick"
        time.sleep(0.2)


def check_selfmon(srv, run, span) -> dict:
    """__selfmon__ over the phases' wall-time span: the loop's own tick
    counter and the rule-evaluation counter come back over HTTP, the
    latter counting this phase's evaluations exactly (a snapshot was
    taken between the scheduler's end and the first tick), and a rate
    over each is held against the oracle on the raw samples."""
    wall0, wall1 = run["wall"]
    t_last = selfmon_wait(srv, wall1)
    span = (span[0], t_last // 1000)
    payload, _, _ = http_json(
        srv.port, "/promql/__selfmon__/api/v1/query_range",
        {"query": "filodb_selfmon_ticks_total", "start": span[0],
         "end": span[1], "step": SELFMON_STEP_S})
    assert payload["data"]["result"], "no filodb_selfmon_ticks_total"
    evals = 0
    for g in srv.rules.groups:
        for rule in g.rules:
            ts, v = selfmon_raw(srv, "filodb_rule_evals_total",
                                span[0] * 1000, t_last + 1,
                                group=g.name, rule=rule.name)
            before = v[ts < wall0 * 1000]
            evals += v[-1] - (before[-1] if before.size else 0.0)
    assert evals == RULE_TICKS * sum(len(g.rules) for g in srv.rules.groups), \
        evals
    rates = [check_selfmon_rate(srv, "filodb_selfmon_ticks_total", span),
             check_selfmon_rate(srv, "filodb_rule_evals_total", span,
                                rule=REC_IRR)]
    # the loop ran through phase 7: its own counter has a rate
    assert rates[0]["steps_with_a_value"] > 0, rates
    sm = srv.selfmon.snapshot()
    return {"span_s": span[1] - span[0], "loop_ticks": sm["ticks"],
            "loop_errors": sm["errors"], "rule_evals_phase10": int(evals),
            "rates": rates}


def phase_rules(srv, rows: dict, sink, span_start: int, smi: str) -> dict:
    """Phase 10 on phase 7's server (rules and self-monitoring on since it
    started): the wall-clock scheduler's thread is ended and the cached
    plans and extents of phase 7 dropped (it ran the same query texts on
    the same grids), then every group ticks at RULE_TICKS boundaries of the
    data's time, through both kernels; recorded series, alert states,
    ALERTS, /api/v1/alerts, the webhook, explain=analyze and __selfmon__
    are checked (the `rules` line)."""
    t0 = time.perf_counter()
    eng = srv.rules
    wall = eng.snapshot()
    eng._stop_evt.set()
    eng._thread.join(WAIT_S)
    assert not eng.alive
    srv.http.plan_cache.invalidate("phase 10")
    log(f"phase 10: scheduler thread ended after {wall['ticks']} wall-clock "
        f"group ticks; plan, results and rule-plan caches dropped")
    # a self-monitoring snapshot between the last wall-clock evaluation and
    # the first tick, so that __selfmon__ can count this phase's alone
    selfmon_wait(srv, time.time())
    run = rule_tick_run(srv)
    groups = check_rule_groups(srv, rows, run, rule_threshold(rows))
    out = {
        "seconds": None, "ticks": rule_ticks(), "ticks_s": run["ticks_s"],
        "cold_tick_ms": 1e3 * run["per_tick"][0]["s"],
        "warm_tick_ms": [1e3 * r["s"] for r in run["per_tick"][1:]],
        "routes": [_route(r) for r in run["per_tick"]],
        "per_tick": [{k: r[k] for k in ("at", "launches", "backend",
                                        "groups_s")}
                     for r in run["per_tick"]],
        "how_ticked": "eval_group_once per group at each boundary; the "
                      "wall-clock scheduler's thread ended (stop event set, "
                      "thread joined) before the first tick; the plan "
                      "cache invalidated (results and rule-plan caches "
                      "with it)",
        "wall_clock_ticks_phase7": wall["ticks"],
        "job_rates": {k: groups[k] for k in (
            "samples", "max_rel_err_vs_oracle", "knife_cells",
            "max_rel_diff_vs_http_uncached", "threshold")},
        "explain": check_explain(run),
        "irregular": check_rule_irregular(srv, run),
        "readback": check_rule_readback(srv, run),
        "alerts": check_alerts(srv, sink, run, groups),
        "launches": run["launches"], "card": smi}
    out["selfmon"] = check_selfmon(srv, run, (span_start, int(time.time())))
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 10: {out['seconds']:.1f} s; kernel launches "
        f"{run['launches']}; routes {out['routes']}")
    return {"launches": run["launches"], "errs": run["errs"], "rules": out}


# ---------------------------------------------------------------------------
# phase 12: downsampling and the raw/downsample tiering
# ---------------------------------------------------------------------------

DS_S = 8_192            # 12(a): bench_downsample.py's batch, S x N samples
DS_N = 16_384           # (134 M), made on the card
DS_RES = (300_000, 3_600_000)   # the reference's downsample-resolutions
DS_W_BOUND = 64         # the gather path's samples-per-period cap
DS_ORACLE_ROWS = 64     # 12(a): rows held against the numpy oracle
DS_CHECK_SERIES = 64    # 12(b): series of each schema held to the oracle
DS_GAUGE_STRIDE = 4     # 12(b): one gauge in 4 backfilled, 1,024 of
                        # phase 5's 4,096 (cut from all of them to keep
                        # the script under 600 s); part="p0" among them
DS_TAIL_SERIES = 1_024  # 12(c): counters whose tails go through influx
TIER_STEP_S = 300       # 12(c): the tiered queries' step over the 8 h
TIER_RAW_S = 4 * 3_600  # 12(c): raw retention ends ~4 h before the data
DS_DATASET = "timeseries"


def tier_queries():
    """(PromQL, start s, end s, step s) of phase 12(c): four queries over
    the whole 8 h at a 300 s step (30 m windows: the 5 m resolution), and
    one wholly beyond raw retention at a 3,600 s step with 2 h windows
    (the 1 h resolution)."""
    start = BASE // 1000 + 1_800
    end = (BASE + (N_FULL - 10) * DT) // 1000
    b = BASE // 1000
    return [
        ("sum by (job) (rate(http_requests_total[30m]))", start, end,
         TIER_STEP_S),
        ('rate(irregular_total{job="job3"}[30m])', start, end, TIER_STEP_S),
        (f"avg_over_time({GAUGE}[30m])", start, end, TIER_STEP_S),
        (f"max_over_time({GAUGE}[30m])", start, end, TIER_STEP_S),
        (f"max_over_time({GAUGE}[2h])", b + 7_200, b + 5 * 3_600, 3_600),
    ]


def ds_batch(gen, dev, counter: bool):
    """[DS_S, DS_N] samples on the card at DT +/- J_MS: int64 ms
    timestamps and f64 values, a gauge (normal about 50, sd 10, as
    bench_downsample.py) or a counter (cumsum of uniform [0, 5), reset
    half-way in one row in 97) -> (ts, vals, lens)."""
    jit = torch.randint(-J_MS, J_MS + 1, (DS_S, DS_N), generator=gen,
                        device=dev, dtype=torch.int64)
    ts = BASE + torch.arange(DS_N, device=dev,
                             dtype=torch.int64)[None, :] * DT + jit
    del jit
    if counter:
        vals = torch.cumsum(torch.rand((DS_S, DS_N), generator=gen,
                                       device=dev, dtype=torch.float64)
                            * 5.0, dim=1)
        vals[::97, DS_N // 2:] -= vals[::97, DS_N // 2 - 1:DS_N // 2].clone()
    else:
        vals = torch.randn((DS_S, DS_N), generator=gen, device=dev,
                           dtype=torch.float64) * 10.0 + 50.0
    lens = torch.full((DS_S,), DS_N, dtype=torch.int32, device=dev)
    return ts, vals, lens


def emit_mask_rule(ts: np.ndarray, vals: np.ndarray, base: int, res: int,
                   nperiods: int) -> np.ndarray:
    """The batch job's counter rule on one sorted row (numpy): the last
    sample of every period and both sides of every drop, in periods
    [0, nperiods)."""
    p = (ts - base) // res
    last = np.ones(ts.size, bool)
    last[:-1] = p[1:] != p[:-1]
    drop = vals[1:] < vals[:-1]
    side = np.zeros(ts.size, bool)
    side[:-1] |= drop
    side[1:] |= drop
    return (last | side) & (p >= 0) & (p < nperiods)


def flush_counter_rule(ts: np.ndarray, vals: np.ndarray,
                       res: int) -> np.ndarray:
    """Flush-time emission's counter rule on one chunk (numpy): its first
    and last samples, every period's first and last, and both sides of
    every drop."""
    p = (ts - (int(ts[0]) // res) * res) // res
    keep = np.zeros(ts.size, bool)
    keep[[0, -1]] = True
    cut = np.nonzero(np.diff(p))[0]
    keep[cut] = keep[cut + 1] = True
    drop = np.nonzero(np.diff(vals) < 0)[0]
    keep[drop] = keep[drop + 1] = True
    return keep


def ds_bound(name: str, S: int, N: int, P: int, bw: float):
    """(bytes, least ms) of one B.7 call: each input read once, each
    output written once.
      gauge paths (fast, gather): [S, N] int64 ts + f64 values + int32
        lens in, 6 [S, P] outputs (5 f64, 1 int64) out;
      cascade_gauge_aligned: 6 [S, P] in (N here is the coarse Q),
        6 [S, Q] out;
      counter_emit_mask: ts + values + lens in, a [S, N] bool mask out."""
    if name == "cascade_gauge_aligned":
        nbytes = 48 * S * P + 48 * S * N
    elif name == "counter_emit_mask":
        nbytes = 16 * S * N + 4 * S + S * N
    else:
        nbytes = 16 * S * N + 4 * S + 48 * S * P
    return nbytes, 1e3 * nbytes / bw


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal element for element, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def close_sums(a: torch.Tensor, b: torch.Tensor, rtol: float = 1e-12
               ) -> float:
    """Max relative difference of two sum outputs (NaN at the same
    places); raises past rtol."""
    assert bool((torch.isnan(a) == torch.isnan(b)).all()), "sum NaNs differ"
    ok = ~torch.isnan(b)
    rel = ((a - b).abs() / b.abs().clamp_min(1e-300))[ok]
    err = float(rel.max()) if rel.numel() else 0.0
    assert err <= rtol, f"sums differ by rtol {err}"
    return err


def ds_functions(gen, dev, bw: float) -> dict:
    """Phase 12(a): the B.7 device functions at bench_downsample.py's
    batch shape, checked (the fast path against the gather path on every
    row, DS_ORACLE_ROWS rows against the numpy oracle, the emit mask
    against its rule) and timed by CUDA events over warmed calls."""
    from filodb_tpu_torch.downsample import kernels as dk

    out = {}
    res5, res1h = DS_RES
    ts, vals, lens = ds_batch(gen, dev, counter=False)
    t_lo, t_hi = int(ts[:, 0].min()), int(ts[:, -1].max())
    base5, base1h = (t_lo // res5) * res5, (t_lo // res1h) * res1h
    P = (t_hi - base5) // res5 + 1
    nper1h = (t_hi - base1h) // res1h + 1
    lead = (base5 - base1h) // res5
    cad = (BASE, DT)
    calls = {
        "downsample_gauge_fast": lambda: dk.downsample_gauge_fast(
            ts, vals, lens, base5, res5, P, cadence=cad),
        "downsample_gauge_tiles": lambda: dk.downsample_gauge_tiles(
            ts, vals, lens, base5, res5, P, DS_W_BOUND),
    }
    torch.cuda.synchronize()
    fast = calls["downsample_gauge_fast"]()
    gather = calls["downsample_gauge_tiles"]()
    coarse = dk.cascade_gauge_aligned(fast, res1h // res5, lead)
    calls["cascade_gauge_aligned"] = lambda: dk.cascade_gauge_aligned(
        fast, res1h // res5, lead)
    # the fast path against the gather path on every row: bit for bit but
    # the sums (rtol 1e-12)
    sum_err = close_sums(fast[0], gather[0])
    for k, name in enumerate(("count", "min", "max", "last_v", "last_ts")):
        assert same_bits(fast[k + 1], gather[k + 1]), \
            f"fast and gather paths differ in {name}"
    rows = np.linspace(0, DS_S - 1, DS_ORACLE_ROWS).astype(np.int64)
    ts_h, v_h = ts[rows].cpu().numpy(), vals[rows].cpu().numpy()
    f_h = [a[rows].cpu().numpy() for a in fast]
    c_h = [a[rows].cpu().numpy() for a in coarse]
    Q = c_h[0].shape[1]
    oracle_err = 0.0
    for i in range(rows.size):
        for got, base, res, nper in ((f_h, base5, res5, P),
                                     (c_h, base1h, res1h, nper1h)):
            o = dk.downsample_gauge_oracle(ts_h[i], v_h[i], base, res, nper)
            n = min(nper, got[0].shape[1])
            has = o[1][:n] > 0
            assert np.array_equal(got[1][i][:n], o[1][:n]), "counts"
            for k in (2, 3, 4, 5):
                assert np.array_equal(got[k][i][:n][has], o[k][:n][has]), k
            rel = np.abs(got[0][i][:n][has] - o[0][:n][has]) \
                / np.abs(o[0][:n][has])
            oracle_err = max(oracle_err, float(rel.max()))
    assert oracle_err <= 1e-12, f"sums vs the oracle: rtol {oracle_err}"
    del gather
    # the most allocated at once over the timed calls, everything resident
    # included (ROADMAP C.23: what earlier phases leave allocated adds here)
    abs_peak = 0
    for name, fn in calls.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
        ms = time_ms(fn, reps=5, warm=1)
        abs_peak = max(abs_peak, torch.cuda.max_memory_allocated())
        peak = torch.cuda.max_memory_allocated() / 2**30 - resident
        shape_n, shape_p = (Q, P) if name == "cascade_gauge_aligned" \
            else (DS_N, P)
        nbytes, bound = ds_bound(name, DS_S, shape_n, shape_p, bw)
        out[name] = {"ms": ms, "bound_ms": bound, "bytes": nbytes,
                     "bound_share": bound / ms, "peak_gib": peak}
    del fast, coarse, ts, vals
    torch.cuda.empty_cache()
    ts, vals, lens = ds_batch(gen, dev, counter=True)
    mask = dk.counter_emit_mask(ts, vals, lens, base5, res5, P)
    m_h = mask[rows].cpu().numpy()
    ts_h, v_h = ts[rows].cpu().numpy(), vals[rows].cpu().numpy()
    for i in range(rows.size):
        assert np.array_equal(m_h[i], emit_mask_rule(ts_h[i], v_h[i], base5,
                                                     res5, P)), "emit mask"
    kept = int(mask.sum())
    del mask
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    ms = time_ms(lambda: dk.counter_emit_mask(ts, vals, lens, base5, res5,
                                              P), reps=5, warm=1)
    abs_peak = max(abs_peak, torch.cuda.max_memory_allocated())
    nbytes, bound = ds_bound("counter_emit_mask", DS_S, DS_N, P, bw)
    out["counter_emit_mask"] = {
        "ms": ms, "bound_ms": bound, "bytes": nbytes,
        "bound_share": bound / ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 - resident}
    del ts, vals, lens
    torch.cuda.empty_cache()
    log(f"phase 12: (a) peak allocated {abs_peak / 2**30:.3f} GiB over the "
        f"timed calls, everything resident included")
    for name, r in out.items():
        log(f"phase 12: {name} at [{DS_S}, {DS_N}]: {r['ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bytes'] / 1e9:.3f} GB at "
            f"{bw / 1e12:.2f} TB/s, {100 * r['bound_share']:.1f} %), peak "
            f"{r['peak_gib']:.2f} GiB above what was resident")
    return {"shape": [DS_S, DS_N], "periods_5m": P, "periods_1h": Q,
            "counter_kept": kept, "fast_vs_gather_sum_rtol": sum_err,
            "oracle_rows": int(rows.size), "oracle_sum_rtol": oracle_err,
            "peak_allocated_gib": abs_peak / 2**30, "functions": out}


def read_ds_rows(data_dir: str, res: int, wanted) -> dict:
    """{(metric, instance): (ts, [data columns])} of the wanted series in
    the <dataset>_ds_<res> dataset of the data-dir, decoded from its
    chunks."""
    from filodb_tpu_torch.core.record import PartKey
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.downsample import ds_dataset
    from filodb_tpu_torch.memory import vectors as bv
    from filodb_tpu_torch.store import FlatFileColumnStore

    cs = FlatFileColumnStore(data_dir)
    name = ds_dataset(DS_DATASET, res)
    out = {}
    for shard in range(WRITE_CONFIG["num-shards"]):
        for e in cs.scan_part_keys(name, shard):
            lm = PartKey.from_bytes(e.part_key).label_map
            key = (lm["_metric_"], lm["instance"])
            if wanted is not None and key not in wanted:
                continue
            schema = DEFAULT_SCHEMAS.by_id(
                PartKey.from_bytes(e.part_key).schema_id)
            chunks = cs.read_chunks(name, shard, e.part_key)
            ts = np.concatenate([bv.decode_longs(c.vectors[0])
                                 for c in chunks])
            order = np.argsort(ts, kind="stable")
            cols = [np.concatenate([bv.decode_doubles(c.vectors[j + 1])
                                    for c in chunks])[order]
                    for j in range(len(schema.data_columns))]
            out[key] = (ts[order], cols)
    cs.close()
    return out


class JobSplit:
    """Wall seconds of the downsampler job by stage, by
    time.perf_counter around the calls (the calls unchanged): chunk reads
    from the column store, chunk decode, the device functions
    (synchronised), the output shards' flush (ds chunk encode and write),
    and the fsyncs among all of it (with their count)."""

    def __init__(self):
        from filodb_tpu_torch.core.memstore import TimeSeriesShard
        from filodb_tpu_torch.downsample import kernels as dk
        from filodb_tpu_torch.memory import vectors as bv
        from filodb_tpu_torch.store import FlatFileColumnStore

        self.secs = {"read_s": 0.0, "decode_s": 0.0, "device_s": 0.0,
                     "flush_s": 0.0, "fsync_s": 0.0}
        self.fsyncs = 0
        targets = [(FlatFileColumnStore, "read_chunks", "read_s", False),
                   (bv, "decode_longs", "decode_s", False),
                   (bv, "decode_doubles", "decode_s", False),
                   (TimeSeriesShard, "flush_all", "flush_s", False),
                   (os, "fsync", "fsync_s", False)]
        targets += [(dk, n, "device_s", True) for n in (
            "downsample_gauge_tiles", "downsample_gauge_fast",
            "cascade_gauge_aligned", "counter_emit_mask")]
        self.originals = []
        for obj, name, label, sync in targets:
            fn = getattr(obj, name)
            self.originals.append((obj, name, fn))
            setattr(obj, name, self._wrap(fn, label, sync))

    def _wrap(self, fn, label, sync):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                self.secs[label] += time.perf_counter() - t0
                if label == "fsync_s":
                    self.fsyncs += 1
        return call

    def restore(self) -> None:
        for obj, name, fn in self.originals:
            setattr(obj, name, fn)

    def split(self, total_s: float) -> dict:
        s = dict(self.secs, fsyncs=self.fsyncs, total_s=total_s)
        s["other_host_s"] = (total_s - s["read_s"] - s["decode_s"]
                             - s["device_s"] - s["flush_s"])
        return s


def ds_job(data_dir: str, rows: dict) -> dict:
    """Phase 12(b): one in DS_GAUGE_STRIDE of phase 5's gauges backfilled
    into the copy of phase 8's data-dir, then DownsamplerJob over all 4
    shards at both resolutions on the card; DS_CHECK_SERIES gauges held
    against downsample_gauge_oracle and as many counters (a quarter of
    them irregular) against the emit rule, both computed from the raw
    rows."""
    from filodb_tpu_torch.downsample import DownsamplerJob
    from filodb_tpu_torch.downsample import kernels as dk
    from filodb_tpu_torch.store import FlatFileColumnStore

    gauge_rows = rows["gauges"][::DS_GAUGE_STRIDE]
    bf = backfill(data_dir, {"gauges": gauge_rows},
                  series=(("gauges", "gauge"),))
    log(f"phase 12: gauge backfill {bf['samples']} samples in "
        f"{bf['seconds']:.1f} s")
    before = dir_bytes(data_dir)
    cs = FlatFileColumnStore(data_dir)
    split = JobSplit()
    t0 = time.perf_counter()
    try:
        job = DownsamplerJob(cs, resolutions=DS_RES)
        stats = [job.run(DS_DATASET, s)
                 for s in range(WRITE_CONFIG["num-shards"])]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        split.restore()
    cs.close()
    out = {"seconds": secs, "backfill_s": bf["seconds"],
           "backfill_samples": bf["samples"],
           "partitions_read": sum(s.partitions_read for s in stats),
           "samples_read": sum(s.samples_read for s in stats),
           "samples_written": sum(s.samples_written for s in stats),
           "chunks_written": sum(s.chunks_written for s in stats),
           "bytes_on_disk": dir_bytes(data_dir) - before,
           "split": split.split(secs)}
    n_c = DS_CHECK_SERIES - DS_CHECK_SERIES // 4
    pick_g = np.linspace(0, len(gauge_rows) - 1,
                         DS_CHECK_SERIES).astype(int)
    pick_c = np.linspace(0, len(rows["counters"]) - 1, n_c).astype(int)
    pick_i = np.linspace(0, len(rows["irregular"]) - 1,
                         DS_CHECK_SERIES - n_c).astype(int)
    gauges = {(lab["_metric_"], lab["instance"]): (t, v) for lab, t, v in
              (gauge_rows[i] for i in pick_g)}
    counters = {(lab["_metric_"], lab["instance"]): (t, v) for lab, t, v in
                [rows["counters"][i] for i in pick_c]
                + [rows["irregular"][i] for i in pick_i]}
    sum_err = 0.0
    for res in DS_RES:
        got = read_ds_rows(data_dir, res, set(gauges) | set(counters))
        for key, (t, v) in gauges.items():
            base = (int(t[0]) // res) * res
            o = dk.downsample_gauge_oracle(t, v, base, res,
                                           (int(t[-1]) - base) // res + 1)
            has = o[1] > 0
            gts, (mn, mx, sm, cnt, avg) = got[key]
            assert np.array_equal(gts, o[5][has]), (key, res, "ts")
            for name, a, b in (("min", mn, o[2]), ("max", mx, o[3]),
                               ("count", cnt, o[1])):
                assert np.array_equal(a, b[has]), (key, res, name)
            for a, b in ((sm, o[0][has]), (avg, o[0][has] / o[1][has])):
                sum_err = max(sum_err, float(np.max(np.abs(a - b)
                                                    / np.abs(b))))
        for key, (t, v) in counters.items():
            m = emit_mask_rule(t, v, (int(t[0]) // res) * res, res, 1 << 40)
            gts, (gv,) = got[key]
            assert np.array_equal(gts, t[m]) and np.array_equal(gv, v[m]), \
                (key, res)
    assert sum_err <= 1e-12, f"ds sums vs the oracle: rtol {sum_err}"
    out["checked"] = {"gauges": len(gauges), "counters": len(counters),
                      "sum_rtol": sum_err}
    log(f"phase 12: DownsamplerJob over {out['partitions_read']} "
        f"partitions, {out['samples_read']} samples in {secs:.1f} s -> "
        f"{out['samples_written']} ds samples, {out['chunks_written']} "
        f"chunks, {out['bytes_on_disk']} bytes; split {out['split']}")
    return out


def check_tier_answer(q: str, got, want, variants=None) -> dict:
    """One side of a tiered answer against the engine's numpy oracle over
    that side's rows (rtol 1e-5). For the grouped counter rate, the cells
    where a series' extrapolation branch is a knife edge are allowed the
    spread of that series' branch variants summed over its group, as
    check_engine_answer allows them: a side may mix the fused group-sum
    (which decides on integer ms) with per-series rates (decided in f64),
    so no variant is singled out; the oracle itself must lie within that
    spread of the integer-rule oracle."""
    assert [dict(k) for k in got.keys] == [dict(k) for k in want.keys], q
    gv, wv = got.values, want.values
    assert gv.shape == wv.shape, (q, gv.shape, wv.shape)
    nan = np.isnan(wv)
    assert np.array_equal(np.isnan(gv), nan), q
    assert np.isfinite(gv).any(), q
    allow = np.zeros(wv.shape)
    out = {"knife_cells": 0}
    if variants is not None:
        spread = np.nan_to_num(np.nanmax(variants, axis=0)
                               - np.nanmin(variants, axis=0), nan=0.0)
        gid = np.arange(variants.shape[1]) % G
        jobs = [int(k["job"][3:]) for k in got.keys]
        allow = _group_sum(spread, gid)[:, jobs].T
        nom = _group_sum(variants[0], gid)[:, jobs].T
        assert (nan | (np.abs(wv - nom) <= 1e-9 * np.abs(nom) + allow
                       + 1e-9)).all(), f"{q}: the oracles disagree"
        out["knife_cells"] = int(((allow > 0) & ~nan).sum())
    err = np.abs(gv - wv)
    assert (nan | (err <= 1e-5 * np.abs(wv) + allow + 1e-9)).all(), \
        f"{q}: max abs err {np.nanmax(err)}"
    with np.errstate(all="ignore"):
        out["max_rel_err"] = float(np.nanmax(err / np.abs(wv)))
    return out


def padded_rows(series: dict, keys) -> tuple:
    """[S, N] (ts, values) of the given series in order, each row padded
    past its end (timestamps 2^60, values held) for _oracle_rates."""
    n = max(series[k][0].size for k in keys)
    ts = np.full((len(keys), n), 1 << 60, np.int64)
    vals = np.empty((len(keys), n))
    for i, k in enumerate(keys):
        t, v = series[k]
        ts[i, :t.size], vals[i, :t.size], vals[i, t.size:] = t, v, v[-1]
    return ts, vals


class TierCapture:
    """Records, while it is on, the exec each planner materializes, the
    ds store's lookups that found no mapping, and the kernel launches
    made inside each side's LocalEngineExec (ds: its shards are a
    downsample dataset's)."""

    def __init__(self):
        from filodb_tpu_torch.downsample.store import \
            DownsampledTimeSeriesStore
        from filodb_tpu_torch.query import kernels as kn
        from filodb_tpu_torch.query import planner as qp

        self.kn, self.qp, self.store_cls = kn, qp, DownsampledTimeSeriesStore
        self.execs, self.fallbacks = [], 0
        self.side = {"ds": {}, "raw": {}}
        self.orig = (qp.QueryPlanner.materialize, qp.LocalEngineExec.execute,
                     DownsampledTimeSeriesStore.plan_query)
        mat, exe, plan_query = self.orig
        cap = self

        def materialize(planner, plan):
            ex = mat(planner, plan)
            cap.execs.append(ex)
            return ex

        def execute(ex):
            before = dict(kn.LAUNCHES)
            out = exe(ex)
            side = "ds" if any("_ds_" in s.ref.dataset
                               for s in ex.shards) else "raw"
            for k, n in kn.LAUNCHES.items():
                cap.side[side][k] = cap.side[side].get(k, 0) \
                    + n - before.get(k, 0)
            return out

        def lookup(store, plan, window_ms, step_ms):
            got = plan_query(store, plan, window_ms, step_ms)
            if got is None:
                cap.fallbacks += 1
            return got

        qp.QueryPlanner.materialize = materialize
        qp.LocalEngineExec.execute = execute
        DownsampledTimeSeriesStore.plan_query = lookup

    def restore(self) -> None:
        (self.qp.QueryPlanner.materialize, self.qp.LocalEngineExec.execute,
         self.store_cls.plan_query) = self.orig


def narrowed(plan, label: str, value: str):
    """The plan with label=value added to every raw selector's filters."""
    import dataclasses

    from filodb_tpu_torch.core.index import ColumnFilter
    from filodb_tpu_torch.query import logical as lp

    if isinstance(plan, lp.RawSeriesPlan):
        return dataclasses.replace(plan, filters=tuple(plan.filters) + (
            ColumnFilter.eq(label, value),))
    changes = {}
    for f in getattr(plan, "__dataclass_fields__", ()):
        v = getattr(plan, f)
        if hasattr(v, "__dataclass_fields__") \
                and not isinstance(v, ColumnFilter):
            changes[f] = narrowed(v, label, value)
    return dataclasses.replace(plan, **changes) if changes else plan


def tier_query(srv, cap, rows, ds_counters, q, s, e, step) -> dict:
    """One tiered query over HTTP (&cache=false): its StitchExec, the
    boundary read from the raw side's plan, each side held against the
    numpy oracle over that side's rows, each side's kernel launches."""
    from types import SimpleNamespace

    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.planner import StitchExec, plan_range

    cap.execs.clear()
    cap.side = {"ds": {}, "raw": {}}
    payload, ms, nbytes = http_json(
        srv.port, "/promql/timeseries/api/v1/query_range",
        {"query": q, "start": s, "end": e, "step": step, "cache": "false"})
    stitched = [x for x in cap.execs if isinstance(x, StitchExec)]
    assert len(stitched) == 1, f"{q}: {[type(x).__name__ for x in cap.execs]}"
    ex = stitched[0]
    tree = ex.plan_tree()
    got = grid_from_json(payload, s, e, step)
    T = got.values.shape[1]
    ds_end = plan_range(ex.ds_exec.plan)[2]
    if ex.raw_exec is not None:
        boundary = plan_range(ex.raw_exec.plan)[0]
        assert ds_end == boundary - step * 1000, (q, ds_end, boundary)
    else:
        boundary = e * 1000 + step * 1000
        assert ds_end == e * 1000, (q, ds_end)
    k_b = (boundary - s * 1000) // (step * 1000)
    assert 0 < k_b <= T, (q, k_b, T)
    by_key = {tuple(sorted(k.items())): i for i, k in enumerate(got.keys)}
    r = {"q": q, "ms": ms, "bytes": nbytes, "boundary_ms": boundary,
         "ds_steps": int(k_b), "raw_steps": int(T - k_b),
         "resolution_ms": int(ex.ds_exec.shards[0].ref.dataset
                              .rsplit("_", 1)[1]),
         "launches_ds": dict(cap.side["ds"]),
         "launches_raw": dict(cap.side["raw"])}
    grouped = q.startswith("sum by (job) (rate(http_requests_total")
    sides = [("ds", ex.ds_exec, 0, k_b, s * 1000)]
    if ex.raw_exec is not None:
        sides.append(("raw", ex.raw_exec, k_b, T, boundary))
    # the gauges' oracle loops per window: held on part="p0" (one gauge
    # in GAUGE_PARTS), as phase 5 holds its order statistics
    sub = GAUGE in q
    shown_rows = np.isfinite(got.values).any(axis=1) if not sub else \
        np.asarray([k.get("part") == "p0" for k in got.keys])
    for name, side, c0, c1, w0e in sides:
        t_or = time.perf_counter()
        plan = narrowed(side.plan, "part", "p0") if sub else side.plan
        want = json_order(QueryEngine(side.shards).execute(plan))
        r[f"oracle_{name}_s"] = time.perf_counter() - t_or
        rows_g = [by_key[tuple(sorted(k.items()))] for k in want.keys]
        # every series with a value on this side is in the side's oracle
        shown = np.isfinite(got.values[:, c0:c1]).any(axis=1) & shown_rows
        assert int(shown.sum()) == len(rows_g), (q, name)
        part = SimpleNamespace(keys=want.keys,
                               values=got.values[rows_g][:, c0:c1])
        variants = None
        if grouped:
            if name == "raw":
                vts, vv = rows["ts"][:, :N_FULL], rows["vals"][:, :N_FULL]
            else:
                vts, vv = ds_counters
            variants = _oracle_rates(vts, vv, w0e, c1 - c0,
                                     knife_ms=KNIFE_MS, window=1_800_000,
                                     step=step * 1000)
        r[f"oracle_{name}"] = check_tier_answer(q, part, want, variants)
    log(f"phase 12: {q}: {tree}")
    log(f"phase 12: {q}: {json.dumps(r)}")
    return r


def tier_server(wdir: dict, rows: dict) -> dict:
    """Phase 12(c): a FiloServer on the card over the data-dir with
    raw-retention-s set from the wall clock (the boundary about 4 h before
    the data's last sample) and flush-downsample on; the tiered queries
    over HTTP; then the counter tails of DS_TAIL_SERIES series through
    POST /api/v1/ingest/influx, a flush (a clean stop), and the emitted
    ds samples read back from the 5 m and 1 h datasets."""
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.standalone.server import FiloServer

    retention_s = int(time.time()) - (BASE // 1000 + TIER_RAW_S)
    t0 = time.perf_counter()
    srv = FiloServer(dict(WRITE_CONFIG, **{
        "data-dir": wdir["data"], "stream-dir": wdir["stream"],
        "raw-retention-s": retention_s, "flush-downsample": True}))
    srv.start()
    wait_for(lambda: all(srv.mapper.status(s).value == "active"
                         for s in range(WRITE_CONFIG["num-shards"])),
             "shards active")
    start_s = time.perf_counter() - t0
    counters = rows["counters"]
    keys = [("http_requests_total", f"i{i}") for i in range(len(counters))]
    ds_rows = read_ds_rows(wdir["data"], DS_RES[0], set(keys))
    ds_counters = padded_rows({k: (ds_rows[k][0], ds_rows[k][1][0])
                               for k in keys}, keys)
    del ds_rows
    cap = TierCapture()
    calls, originals = record_kernel_calls()
    kn.reset_launches()
    out = {"server_start_s": start_s, "retention_s": retention_s}
    try:
        try:
            out["queries"] = [tier_query(srv, cap, rows, ds_counters, *qq)
                              for qq in tier_queries()]
            launches = dict(kn.LAUNCHES)
        finally:
            restore_kernels(originals)
            cap.restore()
        out["fallbacks"] = cap.fallbacks
        # the tails of DS_TAIL_SERIES counters, one POST per scrape
        tails = rows["counter_tails"][:DS_TAIL_SERIES]
        t1 = time.perf_counter()
        for k in range(ENGINE_TAIL):
            body = "\n".join(influx_line(lab, t[k], v[k])
                             for lab, t, v in tails).encode()
            code, resp, _ = http_post(srv.port, "/api/v1/ingest/influx",
                                      body, "text/plain")
            assert code == 200, (k, code, resp[:300])
        wait_for(lambda: drivers_caught_up(srv), "drivers caught up")
        out["tail_ingest_s"] = time.perf_counter() - t1
    finally:
        t2 = time.perf_counter()
        srv.stop()      # the drivers flush: flush-time ds emission
        out["stop_flush_s"] = time.perf_counter() - t2
    emitted = sum(s.flush_downsampler.samples_emitted
                  for s in srv.store.shards(srv.ref))
    assert emitted > 0, "flush-time emission wrote nothing"
    back = 0
    for res in DS_RES:
        got = read_ds_rows(wdir["data"], res,
                           {(lab["_metric_"], lab["instance"])
                            for lab, _, _ in tails})
        for lab, t, v in tails:
            gts, (gv,) = got[(lab["_metric_"], lab["instance"])]
            new = gts >= t[0]
            keep = flush_counter_rule(t, v, res)
            assert np.array_equal(gts[new], t[keep]) \
                and np.array_equal(gv[new], v[keep]), (lab, res)
            back += int(new.sum())
    assert back == emitted, (back, emitted)
    out.update(samples_emitted=emitted, read_back=back)
    errs = check_kernel_calls(calls, originals, "phase 12")
    for name in ("counter_groupsum", "window_extract"):
        assert launches.get(name, 0) > 0, \
            f"{name} was not launched in phase 12"
    ds_total = sum(sum(r["launches_ds"].values()) for r in out["queries"])
    assert ds_total > 0, "no kernel launched on the ds side"
    out["launches"] = launches
    log(f"phase 12: {len(out['queries'])} tiered queries, launches "
        f"{launches} ({ds_total} on the ds side), {cap.fallbacks} "
        f"fallbacks to raw; {emitted} ds samples emitted at the flush, "
        f"all read back")
    return {"launches": launches, "errs": errs, "server": out}


def phase_downsample(gen, dev, rows: dict, wdir: dict, bw: float,
                     smi: str) -> dict:
    """Phase 12: (a) the B.7 device functions at full width, (b) the
    batch job over phase 8's column store (a copy) with phase 5's gauges
    added, (c) the tiered server over that data-dir."""
    t0 = time.perf_counter()
    fns = ds_functions(gen, dev, bw)
    fns["seconds"] = time.perf_counter() - t0
    job = ds_job(wdir["data"], rows)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    srv = tier_server(wdir, rows)
    srv["server"]["seconds"] = time.perf_counter() - t1
    secs = time.perf_counter() - t0
    log(f"phase 12: {secs:.1f} s (functions {fns['seconds']:.1f} s, "
        f"tiered server {srv['server']['seconds']:.1f} s)")
    return {"launches": srv["launches"], "errs": srv["errs"],
            "downsample": {"seconds": secs, "functions": fns, "job": job,
                           "tiered": srv["server"], "card": smi}}


# ---------------------------------------------------------------------------
# phase 13: the certification rail on the card
# ---------------------------------------------------------------------------

CERT_ENGINE_T = 469     # the group-sum claim at the engine's grid as well
# the counter claims at the engine's width (their harnesses' own grid)
CERT_COUNTER_CLAIMS = ("counter-exact-slot-index", "counter-fast-hybrid",
                       "counter-slide-hybrid")


def scalar_division(dev) -> dict:
    """The card's division by a Python scalar, apart: integer ms as f64
    and f32 divided by 1000.0 (ms to s, as the counter evaluators and the
    epilogue divide) on the card, with the divisor a Python scalar, a
    0-dim tensor on the card, and as a multiply by its reciprocal; each
    held bit for bit against the CPU's division. Returns the elements
    that differ."""
    ms = np.random.default_rng(0xD1).integers(-10 ** 7, 10 ** 7, 1 << 20)
    out = {"values": int(ms.size)}
    for dtype in (torch.float64, torch.float32):
        x = torch.as_tensor(ms, dtype=dtype)
        cpu = x / 1000.0
        xd = x.to(dev)
        got = {"scalar": xd / 1000.0,
               "tensor": xd / torch.tensor(1000.0, dtype=dtype, device=dev),
               "reciprocal": xd * (1.0 / 1000.0)}
        row = {f"{k}_vs_cpu": int((v.cpu() != cpu).sum())
               for k, v in got.items()}
        row["scalar_vs_reciprocal"] = int(
            (got["scalar"] != got["reciprocal"]).sum())
        out[str(dtype).replace("torch.", "")] = row
    return out


def certify_on_card(dev, smi: str) -> dict:
    """13(a): every @precision harness with device="cuda" (what the card
    runs: the torch ops and, for groupsum-recombine-f32, the group-sum
    kernel over the harness's full-span world), then at the engine's
    width: the three counter claims over S_ENGINE series, and the
    group-sum claim at S_ENGINE series, a 5 m window every 60 s over
    CERT_ENGINE_T steps, one group per series. Any miss raises. Then the
    card's scalar division apart (``scalar_division``)."""
    from filodb_tpu_torch.lint import ulpcert
    from filodb_tpu_torch.query import kernels as kn

    kn.reset_launches()
    runs = [(r.name, r) for r in ulpcert.certify_all(str(dev))]
    for name in CERT_COUNTER_CLAIMS:
        runs.append((f"{name}@{S_ENGINE}",
                     ulpcert.certify(name, str(dev), S=S_ENGINE)))
    runs.append((f"groupsum-recombine-f32@{S_ENGINE}x{CERT_ENGINE_T}",
                 ulpcert.certify(
                     "groupsum-recombine-f32", str(dev), S=S_ENGINE,
                     N=N_FULL, step_slots=STEP // DT,
                     window_slots=WINDOW // DT, nsteps=CERT_ENGINE_T)))
    claims = {}
    for name, r in runs:
        claims[name] = {"worst_ulps": r.measured, "budget": r.claimed,
                        "ok": r.ok, "detail": r.detail}
        log(f"phase 13: {name}: {r.measured:.4g} ulps on the card, "
            f"budget {r.claimed:g} ({r.detail})")
    launches = dict(kn.LAUNCHES)
    missed = [n for n, c in claims.items() if not c["ok"]]
    assert not missed, f"claims missed on the card: " \
        f"{ {n: claims[n] for n in missed} }"
    # the full-span world and the engine's: two launches of the kernel
    assert launches["counter_groupsum"] >= 2, launches
    div = scalar_division(dev)
    log(f"phase 13: division by 1000.0, elements that differ of "
        f"{div['values']}: {div}")
    return {"claims": claims, "launches": launches, "division": div,
            "card": smi}


def soak_on_card(dev) -> dict:
    """13(b): the generated soak (filodb_tpu_torch/testing/soak.py) over
    both worlds on TorchBackend(dev) (CUDA), with the cache off and then
    through the results cache (cold, warm), each answer held to ref_eval
    within its routes' budgets; the kernels' launches counted over the
    soak (reset just before, read just after) and every kernel call held
    against its plain version afterwards."""
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query.backend import TorchBackend
    from filodb_tpu_torch.testing import soak

    worlds = {"regular": soak.regular_world, "reference":
              soak.reference_world}
    shards = {}
    for name, make in worlds.items():
        rows, ref = make()
        shards[name] = (soak.build_shard(rows), ref)
    counters = ("tile_builds", "aligned_evals", "fused_aggs",
                "packed_dispatches")
    out, totals = {}, dict.fromkeys(counters, 0)
    calls, originals = record_kernel_calls()
    try:
        kn.reset_launches()
        for name, (shard, ref) in shards.items():
            be = TorchBackend(dev)
            try:
                res = soak.run_soak(shard, ref, be, tag=f"card-{name}")
                cres, cache = soak.run_cache_soak(shard, ref, be,
                                                  tag=f"card-cache-{name}")
            finally:
                be.batcher.executor.stop(WAIT_S)
                be.release()
            cnt = {c: getattr(be, c) for c in counters}
            for c in counters:
                totals[c] += cnt[c]
            out[name] = {
                "queries": res.queries, "cells": res.cells,
                "queries_per_route": dict(sorted(res.routes.items())),
                "f32_route_queries": res.f32_queries,
                "worst_f32_ulps": res.worst_ulps,
                "worst_query": res.worst_query,
                "knife_edges": res.knife_edges + cres.knife_edges,
                "seconds": res.seconds,
                "cache": {"queries": cres.queries, "cells": cres.cells,
                          "worst_f32_ulps": cres.worst_ulps,
                          "hits": cache.hits,
                          "steps_served": cache.cached_steps_served,
                          "seconds": cres.seconds},
                "backend": cnt,
                "failures": (res.failures + cres.failures)[:10]}
            log(f"phase 13: soak over the {name} world: {res.queries} "
                f"queries in {res.seconds:.1f} s and again through the "
                f"results cache (cold, warm) in {cres.seconds:.1f} s, "
                f"{len(res.failures) + len(cres.failures)} failures, "
                f"worst f32-route error "
                f"{max(res.worst_ulps, cres.worst_ulps):.4g} ulps, knife "
                f"edges {len(out[name]['knife_edges'])}, {cnt}")
            assert not res.failures and not cres.failures, \
                "\n".join((res.failures + cres.failures)[:10])
            assert cache.hits > 0, "the warm pass never hit the cache"
        launches = dict(kn.LAUNCHES)
    finally:
        restore_kernels(originals)
    assert all(v > 0 for v in totals.values()), totals
    assert all(v > 0 for v in launches.values()), \
        f"a kernel never launched in the soak: {launches}"
    errs = check_kernel_calls(calls, originals, "the phase-13 soak")
    return {"worlds": out, "backend": totals, "launches": launches,
            "errs": errs}


def phase_certification(dev, smi: str) -> dict:
    """Phase 13: the precision claims on the card, then the soak."""
    t0 = time.perf_counter()
    cert = certify_on_card(dev, smi)
    t1 = time.perf_counter()
    sk = soak_on_card(dev)
    secs = time.perf_counter() - t0
    log(f"phase 13: {secs:.1f} s (claims {t1 - t0:.1f} s, soak "
        f"{secs - (t1 - t0):.1f} s)")
    return {"launches": sk["launches"], "errs": sk["errs"],
            "certification": {
                "seconds": secs, "claims_seconds": t1 - t0,
                "claims": cert["claims"],
                "claims_launches": cert["launches"],
                "scalar_division": cert["division"],
                "soak": sk["worlds"], "soak_backend": sk["backend"],
                "soak_launches": sk["launches"],
                "knife_edges": {w: v["knife_edges"]
                                for w, v in sk["worlds"].items()},
                "card": smi}}


# ---------------------------------------------------------------------------
# Phase 14: the mesh, the sharded tile store and the two-process aggregate
# ---------------------------------------------------------------------------

# (shard, time) partitions of the one card, laid as make_mesh lays them
MESH_LAYOUTS = ((1, 1), (2, 1), (4, 1), (2, 2))
MESH_ALIGNED = ("sum_over_time", "avg_over_time", "count_over_time",
                "last_over_time", "stddev_over_time")
MESH_GROUP_AGGS = ("sum", "avg", "min", "max", "count")
MESH_BATCH = 4          # grids of the mesh-shaped micro-batch
MESH_APPEND = 30        # slots appended in place to the resident store
MESH_TIMING_REPS = 5    # CUDA-event reps of each evaluator timing
# (b): a mesh-enabled server under this many partitions of the card
MESH_SERVER_PARTITIONS = 4
# (b): the counters' last hour of phase 4's history (cut in depth from
# its 8 h to keep phase 14 inside 45 s: two servers load it)
MESH_SERVER_SLOTS = 360
# (b): tests/test_mesh_serving.py's queries, per series then grouped
MESH_SERVER_SERIES = ("rate(http_requests_total[5m])",
                      "increase(http_requests_total[5m])",
                      "delta(heap_usage[5m])",
                      "sum_over_time(heap_usage[5m])",
                      "avg_over_time(heap_usage[2m])")
MESH_SERVER_GROUPED = (
    ("sum(rate(http_requests_total[5m])) by (instance)", "sum", "instance"),
    ("avg(rate(http_requests_total[5m])) by (instance)", "avg", "instance"),
    ("count(rate(http_requests_total[5m]))", "count", None))
MESH_DIST_TIMEOUT_S = 120.0     # (c): each rank process's bound


def same_values(a, b) -> bool:
    """Bit for bit, NaN where NaN (dtype too)."""
    a = a.detach().cpu() if isinstance(a, torch.Tensor) else a
    b = b.detach().cpu() if isinstance(b, torch.Tensor) else b
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


def oracle_grouped(rates: np.ndarray, gids: np.ndarray, G_: int,
                   agg: str) -> np.ndarray:
    """[T, S] rates -> [G, T] numpy f64 aggregate by group (NaN where a
    group has no value)."""
    out = np.full((G_, rates.shape[0]), np.nan)
    for g in range(G_):
        rows = rates[:, gids == g].astype(np.float64)
        ok = ~np.isnan(rows)
        cnt = ok.sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            v = {"sum": lambda: np.where(ok, rows, 0.0).sum(axis=1),
                 "avg": lambda: np.where(ok, rows, 0.0).sum(axis=1) / cnt,
                 "count": lambda: cnt.astype(np.float64),
                 "min": lambda: np.where(ok, rows, np.inf).min(axis=1),
                 "max": lambda: np.where(ok, rows, -np.inf).max(axis=1)
                 }[agg]()
        out[g] = np.where(cnt > 0, v, np.nan)
    return out


def rel_err(got, want) -> float:
    """max |got - want| / |want| over the cells where want is finite
    (NaN structure must agree)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want)), "NaN structure"
    m = np.isfinite(want)
    if not m.any():
        return 0.0
    return float(np.max(np.abs(got[m] - want[m])
                        / np.maximum(np.abs(want[m]), 1e-300)))


def mesh_rows_read(n_slots: int, grid: tuple) -> int:
    """Distinct slot rows the counter evaluator reads over the grid
    (w0s, w0e, step, T): each window's boundary rows kc, kc - 1, kl and
    kl + 1 (a row shared by two windows counts once)."""
    w0s, w0e, step, T = grid
    t = np.arange(T, dtype=np.int64)
    kc = np.floor(((w0e - BASE) + t * step + DT / 2.0) / DT).astype(np.int64)
    kl = np.ceil(((w0s - BASE) + t * step - DT / 2.0) / DT).astype(np.int64)
    rows = np.unique(np.clip(np.concatenate([kc, kc - 1, kl, kl + 1]), 0,
                             n_slots - 1))
    return int(rows.size)


def mesh_module(data: dict, dev, bw: float, smi: str) -> dict:
    """14(a): the sharded tile store at the engine's width: phase 4's
    S_ENGINE counters x N_FULL slots as dense aligned tiles on the card,
    placed on each of MESH_LAYOUTS; every per-series family bit for bit
    the single-device evaluators, a batch bit for bit its members, the
    grouped pair and every grouped aggregate by job within 1e-12 of the
    numpy f64 oracle over the single-device rates (counts exact), the
    in-place append, the residency bytes, the scatter-gather executor on
    the irregular series against the numpy oracle; each evaluator timed
    by CUDA events beside the single-device path's time and its bound."""
    from filodb_tpu_torch.lint import capacity as cap
    from filodb_tpu_torch.parallel.mesh import MeshExecutor, make_mesh
    from filodb_tpu_torch.parallel.shardstore import (ShardedTileEvaluator,
                                                      ShardedTiles)
    from filodb_tpu_torch.query import rangefn as rf
    from filodb_tpu_torch.query import tilestore as tst
    from filodb_tpu_torch.query.model import RangeParams, RawSeries

    S, N = S_ENGINE, N_FULL
    keys = [dict(lab) for lab, _, _ in data["counters"]]
    ts = data["ts"][:, :N]
    vals = data["vals"][:, :N]
    tiles = tst.AlignedTiles(keys, BASE, DT, np.ones((S, N), bool), ts,
                             vals, device=dev)
    start, fe, _ = engine_grid()
    steps = np.arange(start * 1000, fe * 1000 + 1, STEP, dtype=np.int64)
    T = steps.size
    gids = np.arange(S) % G
    grid = (int(steps[0]) - WINDOW, int(steps[0]), STEP, T)
    rows_read = mesh_rows_read(N, grid)
    # bytes each evaluator must move: its boundary rows of the int32
    # times and the f64 values once, its output once
    counter_bytes = rows_read * S * (4 + 8) + T * S * 4
    bounds = {"counters": counter_bytes / bw * 1e3,
              "grouped_pair": (counter_bytes - T * S * 4
                               + 2 * T * G * 8) / bw * 1e3}
    single = {}
    ref = {f: tst.evaluate_counters_t(tiles, f, steps, WINDOW)
           for f in ("rate", "increase", "delta")}
    single["counters_ms"] = time_ms(
        lambda: tst.evaluate_counters_t(tiles, "rate", steps, WINDOW),
        reps=MESH_TIMING_REPS, warm=1)
    ref_al = {f: tst.evaluate_aligned(tiles, f, steps, WINDOW)
              for f in MESH_ALIGNED}
    single["aligned_ms"] = time_ms(
        lambda: tst.evaluate_aligned(tiles, "sum_over_time", steps, WINDOW),
        reps=MESH_TIMING_REPS, warm=1)
    al_arrays = tst._tiles_arrays(tiles, "sum_over_time")
    # the aligned family reads its row-major channels at the window's
    # boundary columns, each once, and writes its [S, T] f64 out
    bounds["aligned"] = (rows_read * S * 8 * len(al_arrays)
                         + T * S * 8) / bw * 1e3
    # the batch's grids: the engine grid and up to MESH_BATCH - 1 steps
    # earlier (a dashboard's refreshes), all inside the tiles
    w0s_l = [grid[0] - k * STEP for k in range(MESH_BATCH)]
    w0e_l = [grid[1] - k * STEP for k in range(MESH_BATCH)]
    # the batch reads the union of its grids' boundary rows (the grids
    # overlap but for MESH_BATCH - 1 steps) and writes B outputs
    rows_b = mesh_rows_read(N, (grid[0] - (MESH_BATCH - 1) * STEP,
                                grid[1] - (MESH_BATCH - 1) * STEP, STEP,
                                T + MESH_BATCH - 1))
    bounds["batch"] = (rows_b * S * (4 + 8)
                       + MESH_BATCH * T * S * 4) / bw * 1e3
    fam = tst.counters_batch_family(tiles, "rate", steps, WINDOW, 0)
    ref_b = tst.evaluate_counters_t_batch(tiles, "rate", fam, T, STEP,
                                          w0s_l, w0e_l)
    single["batch_ms"] = time_ms(
        lambda: tst.evaluate_counters_t_batch(tiles, "rate", fam, T, STEP,
                                              w0s_l, w0e_l),
        reps=MESH_TIMING_REPS, warm=1)
    onehot = np.zeros((S, G), np.float32)
    onehot[np.arange(S), gids] = 1.0
    # the single-device path's grouped sum: the group-sum kernel
    single["grouped_pair_ms"] = time_ms(
        lambda: tst.groupsum_counters(tiles, "rate", steps, WINDOW, onehot),
        reps=MESH_TIMING_REPS, warm=1)
    rates = ref["rate"].cpu().numpy()
    want = {a: oracle_grouped(rates, gids, G, a) for a in MESH_GROUP_AGGS}
    reset_free = ~(np.diff(vals, axis=1) < 0).any(axis=1)

    # the irregular series: 4 shard groups, grouped by job
    irr = [RawSeries(dict(lab), t, v, is_counter=True)
           for lab, t, v in data["irregular"]]
    irr_groups = [irr[i::4] for i in range(4)]
    irr_gids = [[int(s.labels["job"][3:]) for s in row]
                for row in irr_groups]
    params = RangeParams(int(steps[0]), STEP, int(steps[-1]))
    # the scatter-gather must read every sample its windows hold (an i64
    # time and an f64 value) once, and write the [G, T] f64 out
    in_span = sum(int(((s.ts >= grid[0]) & (s.ts <= int(steps[-1]))).sum())
                  for s in irr)
    bounds["window_aggregate"] = (in_span * 16 + G * T * 8) / bw * 1e3
    irr_oracle = {}
    for func, agg in (("max_over_time", "max"), ("sum_over_time", "sum")):
        per = np.vstack([rf.evaluate(func, s.ts, s.values, params.start_ms,
                                     STEP, params.end_ms, WINDOW)
                         for row in irr_groups for s in row])
        g_all = np.concatenate([np.asarray(g) for g in irr_gids])
        irr_oracle[func] = (per, oracle_grouped(per.T, g_all, G, agg))

    layouts = {}
    for ns, nt in MESH_LAYOUTS:
        name = f"{ns}x{nt}"
        mesh = make_mesh(ns, nt, [dev] * (ns * nt))
        ev = ShardedTileEvaluator(mesh)
        st = ev.place(tiles)
        assert st is not None, f"{name}: tiles not placed"
        # the store's own residency: 20 B a padded slot of its three
        # channels (tsr i32, v and cv f64), before any aligned placement
        mine = cap._RESIDENT[("shardstore-resident-channels",
                              str(ns))][st._res_key[2]]
        assert st.S_pad == S and st.cap == 4096, (st.S_pad, st.cap)
        assert mine == 20 * st.cap * st.S_pad, (mine, st.cap, st.S_pad)
        row = {"partitions": ns * nt, "resident_bytes": mine}
        for f in ("rate", "increase", "delta"):
            assert same_values(st.eval_counters(f, steps, WINDOW), ref[f]), \
                f"{name}: {f} not bit for bit the single-device answer"
        for f in MESH_ALIGNED:
            assert same_values(st.eval_aligned(tiles, f, steps, WINDOW),
                               ref_al[f]), \
                f"{name}: {f} not bit for bit the single-device answer"
        got_b = st.eval_counters_batch("rate", T, STEP, w0s_l, w0e_l)
        assert same_values(got_b, ref_b), f"{name}: batch"
        for k in range(MESH_BATCH):
            one = tst.evaluate_counters_t(tiles, "rate", steps - k * STEP,
                                          WINDOW)
            assert same_values(got_b[k], one), f"{name}: member {k}"
        sums, cnts = st.eval_grouped_pair("rate", steps, WINDOW, gids, G)
        row["grouped_pair_rel_err"] = rel_err(sums.T, want["sum"])
        assert row["grouped_pair_rel_err"] <= 1e-12, row
        assert np.array_equal(cnts.T, want["count"]), f"{name}: counts"
        row["grouped_rel_err"] = {}
        for agg in MESH_GROUP_AGGS:
            got = st.eval_grouped("rate", steps, WINDOW, gids, G, agg)
            e = rel_err(got, want[agg])
            row["grouped_rel_err"][agg] = e
            assert e <= (0.0 if agg in ("count", "min", "max") else 1e-12), \
                (name, agg, e)
        row["resident_bytes_with_aligned"] = cap._RESIDENT[
            ("shardstore-resident-channels", str(ns))][st._res_key[2]]
        row["ms"] = {
            "counters": time_ms(lambda: st.eval_counters(
                "rate", steps, WINDOW), reps=MESH_TIMING_REPS, warm=1),
            "aligned": time_ms(lambda: st.eval_aligned(
                tiles, "sum_over_time", steps, WINDOW),
                reps=MESH_TIMING_REPS, warm=1),
            "batch": time_ms(lambda: st.eval_counters_batch(
                "rate", T, STEP, w0s_l, w0e_l), reps=MESH_TIMING_REPS,
                warm=1),
            "grouped_pair": time_ms(lambda: st.eval_grouped_pair(
                "rate", steps, WINDOW, gids, G), reps=MESH_TIMING_REPS,
                warm=1)}
        # the scatter-gather executor over the irregular series
        ex = MeshExecutor(mesh)
        row["window_aggregate_rel_err"] = {}
        for func, agg in (("max_over_time", "max"),
                          ("sum_over_time", "sum")):
            got = ex.window_aggregate(irr_groups, params, func, WINDOW, agg,
                                      irr_gids, G)
            e = rel_err(got, irr_oracle[func][1])
            row["window_aggregate_rel_err"][func] = e
            assert e <= (0.0 if agg == "max" else 1e-9), (name, func, e)
        row["ms"]["window_aggregate"] = time_ms(
            lambda: ex.window_aggregate(irr_groups, params, "max_over_time",
                                        WINDOW, "max", irr_gids, G),
            reps=2, warm=1)
        vals_k, ids, s_pad = ex.window_topk(
            irr_groups, params, "max_over_time", WINDOW, 3, False,
            [[0] * len(r) for r in irr_groups], 1)
        per = irr_oracle["max_over_time"][0]
        flat = [s for r in irr_groups for s in r]
        index = {id(s): n for n, s in enumerate(flat)}
        for t in range(T):
            col = np.where(np.isnan(per[:, t]), -np.inf, per[:, t])
            top = set(np.argsort(-col, kind="stable")[:3].tolist())
            got = {index[id(irr_groups[r // s_pad][r % s_pad])]
                   for r in ids[0, t] if r >= 0}
            assert got == top, f"{name}: topk winners at step {t}"
            assert np.array_equal(np.sort(vals_k[0, t])[::-1],
                                  np.sort(col[list(top)])[::-1]), t
        log(f"phase 14: {name} ({ns * nt} partitions of the card): per "
            f"series bit for bit, grouped rel err "
            f"{max(row['grouped_rel_err'].values()):.3g}, ms {row['ms']} "
            f"(single device: {single}) [{smi}]")
        layouts[name] = row
        del st, ev, ex
    # the in-place append of MESH_APPEND slots, against a fresh placement
    n0 = N - MESH_APPEND
    prefix = tst.AlignedTiles(keys, BASE, DT, np.ones((S, n0), bool),
                              ts[:, :n0], vals[:, :n0], device=dev)
    mesh = make_mesh(2, 2, [dev] * 4)
    ev = ShardedTileEvaluator(mesh)
    st = ev.place(prefix)
    ptrs = [t.data_ptr() for name in ("tsr", "v", "cv")
            for r in st._chan[name] for t in r]
    t0 = time.perf_counter()
    assert ev.refresh(prefix, tiles), "the in-place append refused"
    append_ms = 1e3 * (time.perf_counter() - t0)
    assert ev.place(tiles) is st and [t.data_ptr() for name in
                                      ("tsr", "v", "cv")
                                      for r in st._chan[name]
                                      for t in r] == ptrs
    fresh = ShardedTiles(mesh, tiles)
    ulps = 0.0
    for name in ("tsr", "v", "cv"):
        for i in range(st.n_shard):
            a = st._chan[name][i][0][:N]
            b = fresh._chan[name][i][0][:N]
            sl = slice(i * st.S_l, (i + 1) * st.S_l)
            free = torch.as_tensor(reset_free[sl], device=a.device)
            assert torch.equal(a[:, free], b[:, free]), \
                f"append: {name} not bitwise a rebuild on reset-free series"
            if name == "cv" and bool((~free).any()):
                d = (a[:, ~free] - b[:, ~free]).abs()
                sp = torch.as_tensor(np.spacing(b[:, ~free].abs().cpu()
                                                .numpy()), device=a.device)
                ulps = max(ulps, float((d / sp).max()))
    # series with a reset before the append point: the same carry, added
    # in another order (append-carry-exact's own statement)
    assert ulps <= 2.0, f"append: {ulps} f64 ulps on the reset series"
    got = st.eval_counters("rate", steps, WINDOW).cpu().numpy()
    assert np.array_equal(got[:, reset_free], rates[:, reset_free],
                          equal_nan=True), "append: rates"
    append = {"slots": MESH_APPEND, "ms": append_ms,
              "data_ptr_unchanged": True,
              "reset_free_series": int(reset_free.sum()),
              "reset_series_cv_max_ulps": ulps}
    del st, fresh, ev, prefix
    return {"layouts": layouts, "single_device_ms": single,
            "bound_ms": bounds, "rows_read": rows_read, "T": T, "S": S,
            "append": append}


def mesh_server_data(data: dict):
    """14(b)'s rows: the counters' last MESH_SERVER_SLOTS slots, and the
    (start, end) in seconds of a 60 s grid over them."""
    lo = N_FULL - MESH_SERVER_SLOTS
    rows = [(lab, t[lo:], v[lo:]) for lab, t, v in data["counters"]]
    t_lo = BASE + lo * DT
    return rows, t_lo, (t_lo // 1000 + 600,
                        (BASE + (N_FULL - 10) * DT) // 1000)


def mesh_server(data: dict, smi: str) -> dict:
    """14(b): a plain port server and one with mesh-enabled under
    MESH_SERVER_PARTITIONS partitions of the card, over the same rows:
    the per-series queries' data sections byte for byte the same, the
    grouped ones within 1e-12 of the numpy f64 aggregation of the plain
    server's per-series rates, mesh dispatches, mesh-tiles executables in
    &explain=analyze, and no group-sum launch on the mesh's grouped
    route."""
    from filodb_tpu_torch import state
    from filodb_tpu_torch.parallel.mesh import PARTITIONS_ENV
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.standalone.server import FiloServer

    rows, t_lo, (start, end) = mesh_server_data(data)
    srvs = {}
    t0 = time.perf_counter()
    os.environ[PARTITIONS_ENV] = str(MESH_SERVER_PARTITIONS)
    try:
        for name, mesh in (("plain", False), ("mesh", True)):
            srv = FiloServer({"num-shards": 4, "port": 0, "grpc-port": None,
                              "results-cache-mb": 0, "mesh-enabled": mesh,
                              "query-sample-limit": 0})
            srvs[name] = srv
            srv.start()
            state.load_into_store(srv.store, srv.ref, rows, "prom-counter",
                                  True, num_shards=4, spread=1)
            srv.seed_dev_data(n_samples=MESH_SERVER_SLOTS, start_ms=t_lo)
    except BaseException:
        for srv in srvs.values():
            srv.stop()
        raise
    finally:
        os.environ.pop(PARTITIONS_ENV, None)
    load_s = time.perf_counter() - t0
    out = {"load_s": load_s, "partitions": MESH_SERVER_PARTITIONS,
           "queries": {}}
    path = "/promql/timeseries/api/v1/query_range"
    try:
        plain, meshed = srvs["plain"], srvs["mesh"]
        assert meshed.backend.mesh_eval is not None
        assert meshed.mesh_executor.ndev == MESH_SERVER_PARTITIONS
        per_series = {}
        for q in MESH_SERVER_SERIES:
            args = {"query": q, "start": start, "end": end, "step": 60}
            a, ms_a, nbytes = http_json(plain.port, path, args)
            b, ms_b, _ = http_json(meshed.port, path, args)
            same = json.dumps(a["data"], sort_keys=True) == \
                json.dumps(b["data"], sort_keys=True)
            assert same, f"14(b): {q}: data sections differ"
            assert a["data"]["result"], q
            per_series[q] = a
            out["queries"][q] = {"plain_ms": ms_a, "mesh_ms": ms_b,
                                 "bytes": nbytes, "byte_identical": same}
        rate = grid_from_json(per_series[MESH_SERVER_SERIES[0]], start, end,
                              60)
        for q, agg, by in MESH_SERVER_GROUPED:
            args = {"query": q, "start": start, "end": end, "step": 60}
            n0 = kn.LAUNCHES["counter_groupsum"]
            _, ms_a, _ = http_json(plain.port, path, args)
            n1 = kn.LAUNCHES["counter_groupsum"]
            b, ms_b, _ = http_json(meshed.port, path, args)
            plain_gs, mesh_gs = n1 - n0, kn.LAUNCHES["counter_groupsum"] - n1
            assert mesh_gs == 0, f"14(b): {q}: the group-sum launched " \
                f"{mesh_gs} times on the mesh's grouped route"
            got = grid_from_json(b, start, end, 60)
            labels = [k.get(by, "") if by else "" for k in rate.keys]
            names = sorted(set(labels))
            gid = np.array([names.index(x) for x in labels])
            want = oracle_grouped(rate.values.T, gid, len(names), agg)
            idx = {(k.get(by, "") if by else ""): i
                   for i, k in enumerate(got.keys)}
            assert set(idx) == set(names), q
            e = rel_err(np.vstack([got.values[idx[n]] for n in names]),
                        want)
            assert e <= 1e-12, f"14(b): {q}: rel err {e}"
            out["queries"][q] = {"plain_ms": ms_a, "mesh_ms": ms_b,
                                 "rel_err": e,
                                 "plain_groupsum_launches": plain_gs,
                                 "mesh_groupsum_launches": mesh_gs}
        az, _, _ = http_json(meshed.port, path, {
            "query": MESH_SERVER_SERIES[0], "start": start, "end": end,
            "step": 60, "explain": "analyze", "cache": "false"})
        execs = [e for e in az["analyze"]["device"]["executables"]
                 if e["site"] == "mesh-tiles"]
        assert execs, "14(b): no mesh-tiles executable in the analyze"
        out["analyze_mesh_tiles"] = [e["executable"] for e in execs]
        out["mesh_dispatches"] = meshed.backend.mesh_dispatches
        assert out["mesh_dispatches"] > 0
        out["placements"] = meshed.backend.mesh_eval.snapshot()
        log(f"phase 14: (b) servers loaded in {load_s:.1f} s; "
            f"{out['mesh_dispatches']} mesh dispatches; per query "
            f"{ {q: v for q, v in out['queries'].items()} } [{smi}]")
    finally:
        for srv in srvs.values():
            srv.stop()
    return out


MESH_RANK_SCRIPT = r"""
import json, pickle, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[5])
from filodb_tpu_torch.parallel.distributed import (
    init_process, window_aggregate_distributed)
from filodb_tpu_torch.parallel.mesh import MeshExecutor, make_mesh
from filodb_tpu_torch.query.model import RangeParams, RawSeries
rank, addr, pkl, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4]
with open(pkl, "rb") as f:
    d = pickle.load(f)
dev = torch.device(sys.argv[6])
backend = init_process(addr, 2, rank, dev)
ex = MeshExecutor(make_mesh(2, 1, [dev, dev]))
groups = [[RawSeries(lab, t, v, is_counter=True) for lab, t, v in g]
          for g in d["groups"]]
mine = slice(2 * rank, 2 * rank + 2)
t0 = time.perf_counter()
res = window_aggregate_distributed(
    ex, groups[mine], d["gids"][mine], RangeParams(*d["params"]), "rate",
    "sum", d["window"], d["G"])
secs = time.perf_counter() - t0
np.save(out, res)
import torch.distributed as dist
dist.destroy_process_group()
print(json.dumps({"rank": rank, "backend": backend, "seconds": secs}))
"""


def mesh_ranks_start(data: dict, dev) -> dict:
    """14(c), started first: the two rank processes of
    window_aggregate_distributed (sum by (job) of rate over the
    ENGINE_IRREGULAR irregular series in 4 shard groups, 2 per rank, each
    rank a mesh of 2 partitions of the card, joined over gloo: the ranks
    share one card). They meet through a rendezvous file in the phase's
    temporary directory, so no port is picked ahead of its use. Their
    CUDA start-up overlaps 14(a) and 14(b); ``mesh_ranks_finish``
    collects them. Returns the handles."""
    import pickle
    import tempfile

    start, fe, _ = engine_grid()
    params = (start * 1000, STEP, fe * 1000)
    irr = list(data["irregular"])
    groups = [irr[i::4] for i in range(4)]
    gids = [[int(lab["job"][3:]) for lab, _, _ in g] for g in groups]
    tmp = tempfile.mkdtemp(prefix="filodb-phase14-")
    pkl = os.path.join(tmp, "world.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"groups": groups, "gids": gids, "params": params,
                     "window": WINDOW, "G": G}, f)
    addr = "file://" + os.path.join(tmp, "rendezvous")
    procs = []
    for r in range(2):
        # each rank's output to a file: a rank that cannot reach its peer
        # logs every retry, more than a pipe holds unread
        with open(os.path.join(tmp, f"rank{r}.log"), "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", MESH_RANK_SCRIPT, str(r), addr,
                 pkl, os.path.join(tmp, f"rank{r}.npy"), REPO, str(dev)],
                cwd=REPO, stdout=out, stderr=subprocess.STDOUT))
    return {"procs": procs, "tmp": tmp, "groups": groups, "gids": gids,
            "params": params, "t0": time.perf_counter()}


def mesh_ranks_stop(ranks: dict) -> None:
    """End both rank processes (if still running) and drop their files."""
    import shutil

    for p in ranks["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(ranks["tmp"], ignore_errors=True)


def mesh_ranks_finish(ranks: dict, dev, smi: str) -> dict:
    """14(c): both ranks' answers, each equal to the single-process
    4-partition mesh's within 1e-12; each rank bounded by
    MESH_DIST_TIMEOUT_S from its start."""
    from filodb_tpu_torch.parallel.mesh import MeshExecutor, make_mesh
    from filodb_tpu_torch.query.model import RangeParams, RawSeries

    ex = MeshExecutor(make_mesh(4, 1, [dev] * 4))
    want = ex.window_aggregate(
        [[RawSeries(dict(lab), t, v, is_counter=True) for lab, t, v in g]
         for g in ranks["groups"]], RangeParams(*ranks["params"]), "rate",
        WINDOW, "sum", ranks["gids"], G)
    assert np.isfinite(want).any()
    procs = ranks["procs"]
    # both ranks to their end, a failing one ending the other at once
    while time.perf_counter() - ranks["t0"] < MESH_DIST_TIMEOUT_S:
        codes = [p.poll() for p in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            break
        time.sleep(0.05)
    wall = time.perf_counter() - ranks["t0"]
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    outs, rows = [], []
    for r in range(2):
        with open(os.path.join(ranks["tmp"], f"rank{r}.log")) as f:
            outs.append(f.read())
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"14(c): rank {r} exit " \
            f"{p.returncode}:\n{outs[r][-3000:]}"
        rows.append(json.loads(outs[r].strip().splitlines()[-1]))
        got = np.load(os.path.join(ranks["tmp"], f"rank{r}.npy"))
        rows[-1]["rel_err"] = rel_err(got, want)
        assert rows[-1]["rel_err"] <= 1e-12, f"14(c): rank {r}: {rows[-1]}"
    log(f"phase 14: (c) 2 processes x 2 partitions over gloo, "
        f"{wall:.1f} s from their start: "
        f"{rows} [{smi}]")
    return {"processes": 2, "partitions_each": 2, "wall_s": wall,
            "series": sum(len(g) for g in ranks["groups"]), "ranks": rows}


def phase_mesh(data: dict, dev, bw: float, smi: str) -> dict:
    """Phase 14: (a) the sharded tile store and the scatter-gather at the
    engine's width on 1, 2, 4 and 2 x 2 partitions of the card, with the
    mesh's three claims certified on it; (b) a mesh-enabled server; (c)
    the two-process aggregate, its processes started first."""
    from filodb_tpu_torch.query import kernels as kn

    t0 = time.perf_counter()
    kn.reset_launches()
    ranks = mesh_ranks_start(data, dev)
    try:
        out = _phase_mesh(data, dev, bw, smi, ranks, t0)
    finally:
        mesh_ranks_stop(ranks)
    return out


def _phase_mesh(data: dict, dev, bw: float, smi: str, ranks: dict,
                t0: float) -> dict:
    from filodb_tpu_torch.lint import ulpcert
    from filodb_tpu_torch.query import kernels as kn

    claims = {}
    for name in ("append-carry-exact", "grouped-reduce-psum",
                 "grouped-pair-psum"):
        r = ulpcert.certify(name, str(dev))
        claims[name] = {"measured": r.measured, "claimed": r.claimed,
                        "ok": r.ok, "detail": r.detail}
        assert r.ok, f"14: {name} missed on the card: {r.detail}"
    module = mesh_module(data, dev, bw, smi)
    t1 = time.perf_counter()
    server = mesh_server(data, smi)
    t2 = time.perf_counter()
    dist = mesh_ranks_finish(ranks, dev, smi)
    secs = time.perf_counter() - t0
    launches = dict(kn.LAUNCHES)
    log(f"phase 14: {secs:.1f} s ((a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} "
        f"s, (c) {secs - (t2 - t0):.1f} s) [{smi}]")
    return {"launches": launches, "mesh": {
        "seconds": secs, "module_s": t1 - t0, "server_s": t2 - t1,
        "distributed_s": secs - (t2 - t0), "claims": claims,
        "module": module, "server": server, "distributed": dist,
        "card": smi}}


# ---------------------------------------------------------------------------
# Phase 15: capacity and contracts
# ---------------------------------------------------------------------------

CAP_PARTITIONS = (1, 2, 4)      # ShardedTiles on these partitions of the card
CAP_DS_BATCH = 256              # the downsampler job's batch (batch_series)
CAP_WALK_SLACK = 512            # B per storage: the allocator's rounding
# a cached large block is handed out whole when at most 1 MiB would remain
CAP_BLOCK_SLACK = 1 << 20


def cap_rows(data: dict):
    """Phase 4's flushed counters as dense rows (base, dt, valid, ts,
    vals): the engine shape, S_ENGINE series x N_FULL slots."""
    ts = data["ts"][:, :N_FULL]
    vals = data["vals"][:, :N_FULL]
    return BASE, DT, np.ones(ts.shape, bool), ts, vals


def cap_tile_entries(data: dict):
    """The selections phase 4's tile cache held: the counters' (whose
    tiles its grouped and per-series rates read) and the irregular
    series' (no shared cadence: no tiles), as RawSeries over the flushed
    samples."""
    from filodb_tpu_torch.query.model import RawSeries

    return [[RawSeries(lab, ts, vals, True)
             for lab, ts, vals in data[key]]
            for key in ("counters", "irregular")]


def cap_ds_batch(data: dict):
    """One downsampler batch of phase 12(b)'s backfilled gauges (one in
    DS_GAUGE_STRIDE), as the job's _pack takes it."""
    rows = data["gauges"][::DS_GAUGE_STRIDE][:CAP_DS_BATCH]
    return [(f"pk{i}", lab, ts, vals) for i, (lab, ts, vals) in
            enumerate(rows)]


def capacity_reading(name: str, dev, smi: str, total: int,
                     counts=None, **shape) -> dict:
    """Certify one claim on the card at ``shape`` (``counts`` partitions
    for the sharded one) and hold the storage walk against the
    allocator around the build: the bytes its tensors requested within
    CAP_WALK_SLACK a storage of the walk, and memory_allocated's delta
    at least the walk and at most CAP_BLOCK_SLACK a storage above it
    (the unsplit remainders of the blocks it was handed)."""
    from filodb_tpu_torch.lint import capacity as cmod
    from filodb_tpu_torch.lint import memcert

    torch.cuda.empty_cache()
    r = memcert.certify(name, str(dev), counts=counts, **shape)
    claim = cmod.capacity_claim(name)
    row = memcert.ledger_row(claim, r, N_FULL, total)
    row.update({
        "ok": r.ok, "detail": r.detail, "walk_bytes": r.measured,
        "claimed_bytes": r.claimed, "storages": r.storages,
        "alloc_delta_bytes": r.alloc_delta,
        "requested_delta_bytes": r.requested_delta,
        "bytes_per_padded_slot": (r.measured / r.n_samples
                                  if r.n_samples else None),
        "card": smi})
    log(f"phase 15: {name} {shape and list(shape) or ''} "
        f"{counts or ''}: walk {r.measured:.0f} B in {r.storages} "
        f"storages, requested delta {r.requested_delta}, memory_allocated "
        f"delta {r.alloc_delta}, claimed {r.claimed:.0f} B "
        f"({r.detail}); {row['projected_series_per_device']} series of "
        f"{N_FULL} samples per card of {total} B [{smi}]")
    assert r.ok, f"15: {name} failed certification on the card: {r.detail}"
    assert abs(r.requested_delta - r.measured) \
        <= CAP_WALK_SLACK * r.storages, \
        f"15: {name}: the allocator's requested bytes disagree with the walk"
    assert 0 <= r.alloc_delta - r.measured \
        <= CAP_BLOCK_SLACK * r.storages, \
        f"15: {name}: memory_allocated's delta disagrees with the walk"
    return row


def capacity_on_card(data: dict, dev, smi: str, tile_cache: list) -> dict:
    """15(a): every @capacity claim certified on the card at full width."""
    from filodb_tpu_torch.lint import capacity as cmod
    from filodb_tpu_torch.lint import memcert

    total = memcert.device_memory_bytes(str(dev))
    rows = cap_rows(data)
    out = {"tilestore-aligned-tiles": capacity_reading(
        "tilestore-aligned-tiles", dev, smi, total, rows=rows)}
    entries = cap_tile_entries(data)
    cache = capacity_reading("device-tile-cache", dev, smi, total,
                             entries=entries)
    # the harness held what phase 4's cache held (tiles of S x N each)
    want = sorted(s[0] * s[1] for s in tile_cache if s)
    assert cache["harness_n_samples"] == sum(want), (cache, tile_cache)
    out["device-tile-cache"] = cache
    for n in CAP_PARTITIONS:
        out[f"shardstore-resident-channels@{n}"] = capacity_reading(
            "shardstore-resident-channels", dev, smi, total, counts=(n,),
            rows=rows)
    out["downsample-pack-buffers"] = capacity_reading(
        "downsample-pack-buffers", dev, smi, total,
        batch=cap_ds_batch(data))
    cmod.import_annotated_modules()
    read = {k.split("@")[0] for k in out}
    assert read == set(cmod.CAPACITY), (read, set(cmod.CAPACITY))
    return {"claims": out, "total_memory": total}


def device_limits(dev) -> dict:
    """The card's shared-memory and register limits, read from the card."""
    props = torch.cuda.get_device_properties(dev)
    return {"smem_per_block_optin": props.shared_memory_per_block_optin,
            "smem_per_block": props.shared_memory_per_block,
            "regs_per_sm": props.regs_per_multiprocessor,
            "sm_count": props.multi_processor_count}


def _call_shape(name: str, sig, a, kw, n_sm: int) -> Optional[tuple]:
    """A kernel wrapper call's shape as its contract's ``launches``
    keywords (sorted items), or None where the call launches nothing."""
    b = sig.bind(*a, **kw).arguments
    if name == "counter_groupsum":
        v_p = b["v_p"]
        if v_p.device.type != "cuda":
            return None
        shape = {"n_s": int(v_p.shape[0]), "T": int(b["nsteps"]),
                 "G": int(b["onehot"].shape[1]),
                 "hi_mode": int(b["hi_mode"]), "lo_mode": int(b["lo_mode"]),
                 "n_sm": n_sm}
    else:
        pay = b["pay"]
        S, _, N = pay.shape
        if pay.device.type != "cuda" or S == 0 or int(b["nsteps"]) == 0:
            return None
        shape = {"S": int(S), "N": int(N), "T": int(b["nsteps"])}
    return tuple(sorted(shape.items()))


def record_launch_shapes():
    """Wrap both kernel wrappers for phases 3-14: each call that launched
    counts its shape, and keeps no tensor -> (shapes, originals). Phase
    15 asks each library what it launched at every shape."""
    from filodb_tpu_torch.query import kernels as kn

    shapes = {"counter_groupsum": {}, "window_extract": {}}
    originals = {name: getattr(kn, name) for name in shapes}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def recorder(name):
        sig = inspect.signature(originals[name])

        def call(*a, **kw):
            out = originals[name](*a, **kw)
            key = _call_shape(name, sig, a, kw, n_sm)
            if key is not None:
                shapes[name][key] = shapes[name].get(key, 0) + 1
            return out
        return call

    for name in shapes:
        setattr(kn, name, recorder(name))
    return shapes, originals


def library_attrs(lib, name: str) -> list:
    """(name, registers, static shared bytes, most threads per block) of
    each __global__ instance of a kernel library, as the card loaded it."""
    import ctypes

    fn = getattr(lib, f"{name}_attrs")
    out = []
    while True:
        kname, vals = ctypes.c_char_p(), (ctypes.c_int * 3)()
        rc = fn(len(out), ctypes.byref(kname), vals)
        if rc == -1:
            return out
        assert rc == 0, f"15: {name}_attrs({len(out)}): cudaError {rc}"
        out.append((kname.value.decode(), *vals))


def library_launches(lib, name: str, shape: dict) -> list:
    """What a kernel library launches for one call of ``shape``, as it
    reports it (``*_geometry``, the launcher's own arithmetic)."""
    import ctypes
    from filodb_tpu_torch.lint.contracts import Launch
    from filodb_tpu_torch.query import kernels as kn

    if name == "counter_groupsum":
        lp = kn.groupsum_launch_plan(**shape)
        v = (ctypes.c_int * 10)()
        rc = lib.counter_groupsum_geometry(
            shape["n_s"], shape["G"], shape["T"], shape["hi_mode"],
            shape["lo_mode"], lp["chunk"], lp["stages"], v)
        assert rc == 0, f"15: the library refuses the plan at {shape}"
        return [Launch("groupsum_partial_kernel", tuple(v[0:3]), v[3], v[4]),
                Launch("groupsum_reduce_kernel", tuple(v[5:8]), v[8], v[9])]
    v = (ctypes.c_int * 5)()
    rc = lib.window_extract_geometry(shape["S"], shape["N"], shape["T"], v)
    assert rc == 0, f"15: window_extract_geometry at {shape}: {rc}"
    return [Launch("window_extract_kernel", tuple(v[0:3]), v[3], v[4])]


def contracts_on_card(dev, smi: str, shapes: dict) -> dict:
    """15(b): each CUDA contract against the ptxas report of the build and
    its functions' attributes on the card, its budget against the card's
    opt-in limit, and, at every shape phases 3-14 launched, what the
    library launches against the contract's plan and limits."""
    from filodb_tpu_torch.lint import rules_kernel
    from filodb_tpu_torch.lint.contracts import CONTRACTS
    from filodb_tpu_torch.query import kernels as kn

    limits = device_limits(dev)
    libs = kn.build_kernels()
    out = {}
    for name in ("counter_groupsum", "window_extract"):
        c = CONTRACTS[("filodb_tpu_torch.query.kernels", name)]
        kernels, bad = rules_kernel.check_build(
            c, rules_kernel.ptxas_report(kn.BUILD_LOG[name]),
            library_attrs(libs[name], name), limits["smem_per_block_optin"])
        assert not bad, f"15: {name} disagrees with its build: {bad}"
        for k in c.kernels:
            assert k.registers * k.threads <= limits["regs_per_sm"], k.name
        launches, by_kernel = [], {}
        for key, n in shapes[name].items():
            shape = dict(key)
            got = library_launches(libs[name], name, shape)
            bad = rules_kernel.check_launches(c, shape, got)
            assert not bad, f"15: {name} launched outside its contract: " \
                f"{bad}"
            launches.extend(got)
            for lnch in got:
                by_kernel[lnch.kernel] = by_kernel.get(lnch.kernel, 0) + n
        assert by_kernel.get(c.kernels[0].name, 0) > 0, \
            f"15: no {name} launch recorded in phases 3-14"
        out[name] = {"kernels": kernels, "smem_budget": c.smem_budget,
                     "launches_admitted": by_kernel,
                     "shapes": len(shapes[name]),
                     "max_plan_smem": max(lnch.smem for lnch in launches),
                     "max_grid": [max(lnch.grid[i] for lnch in launches)
                                  for i in range(3)]}
        log(f"phase 15: contract {name}: {json.dumps(out[name])}")
    return {"contracts": out, "limits": limits, "card": smi}


# the families of the analyser's `seen` counts, by key prefix
LINT_FAMILIES = (("numerics_", "numerics"), ("trace_", "trace"),
                 ("spmd_", "spmd"), ("inplace_", "spmd"),
                 ("residency_", "capacity"), ("kernel_", "kernel"),
                 ("cuda_", "kernel"))


def lint_on_card(smi: str) -> dict:
    """15(c): the port's static analyser over filodb_tpu_torch/ with its
    contracts and both certification rails, as `python -m
    filodb_tpu_torch.lint` runs it: it must report nothing."""
    from filodb_tpu_torch.lint import NOT_PORTED, run_lint

    t0 = time.perf_counter()
    res = run_lint()
    secs = time.perf_counter() - t0
    for f in res.findings:
        log(f"phase 15: lint finding {f.render()}")
    seen: dict = {}
    for k, n in sorted(res.seen.items()):
        fam = next((f for p, f in LINT_FAMILIES if k.startswith(p)),
                   "other")
        seen.setdefault(fam, {})[k] = n
    out = {"files": res.files, "findings": len(res.findings),
           "baselined": len(res.baselined), "suppressed": res.suppressed,
           "seen": seen, "not_ported": sorted(NOT_PORTED),
           "seconds": round(secs, 2), "card": smi}
    log(f"phase 15: lint {json.dumps(out)}")
    assert not res.findings, \
        f"15: the analyser reports {len(res.findings)} finding(s)"
    assert seen["numerics"]["numerics_precision_sites"] == 8 \
        and seen["numerics"]["numerics_order_sites"] == 2, seen
    assert seen["trace"]["trace_bodies"] == 4, seen
    assert seen["spmd"]["spmd_wrapper_calls"] == 3, seen
    return out


def phase_capacity(data: dict, dev, smi: str, tile_cache: list,
                   shapes: dict) -> dict:
    """Phase 15: (a) the capacity claims, (b) the kernel contracts, (c)
    the port's analyser. It runs no query on the card and launches no
    kernel."""
    from filodb_tpu_torch.query import kernels as kn

    t0 = time.perf_counter()
    launched = dict(kn.LAUNCHES)
    cap = capacity_on_card(data, dev, smi, tile_cache)
    t1 = time.perf_counter()
    con = contracts_on_card(dev, smi, shapes)
    t2 = time.perf_counter()
    lint = lint_on_card(smi)
    secs = time.perf_counter() - t0
    assert dict(kn.LAUNCHES) == launched, "15: phase 15 launched a kernel"
    log(f"phase 15: {secs:.1f} s (capacity {t1 - t0:.1f} s, contracts "
        f"{t2 - t1:.1f} s, lint {secs - (t2 - t0):.1f} s) [{smi}]")
    return {"capacity": dict(cap, seconds=t1 - t0, card=smi),
            "contracts": dict(con, seconds=t2 - t1),
            "lint": lint}


# allocated device memory (live tensors) a stopped server or a finished
# phase may leave behind (ROADMAP C.23)
MEM_SLACK = 256 << 20
# phase 12 alone starts with next to nothing allocated; after phases 1-11
# it must start within this of that
MEM_BEFORE_PHASE12 = 1 << 30


def mem_log(what: str) -> int:
    """Log the card's allocated memory on a line of its own -> bytes."""
    n = torch.cuda.memory_allocated()
    log(f"memory: {what}: {n / 2**30:.3f} GiB allocated ({n} B)")
    return n


def mem_released(level: int, what: str) -> int:
    """Collect garbage, then hold the allocated memory to within MEM_SLACK
    of `level`, its reading before the server or phase started."""
    import gc

    gc.collect()
    mem_log(f"{what}, after gc.collect()")
    torch.cuda.empty_cache()
    n = mem_log(f"{what}, after empty_cache()")
    assert n - level <= MEM_SLACK, \
        f"{what}: {(n - level) / 2**20:.1f} MiB more allocated than before"
    return n


def emit(key: str, value) -> None:
    """One result line on standard output, as its phase ends."""
    print(json.dumps({key: value}), flush=True)


def run_phase(n: int, name: str, fn, *args):
    """fn(*args), with a log line naming the phase before its exception
    goes on (uncaught) to end the run with a non-zero exit."""
    try:
        return fn(*args)
    except BaseException as e:
        log(f"phase {n} ({name}) failed: {type(e).__name__}: {e}")
        raise


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from filodb_tpu_torch.query import kernels as kn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, f32_rate = card_rates(name)
    log(f"phase 1: card {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    run_phase(1, "build", kn.build_kernels)
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s into "
        f"{os.path.relpath(kn.BUILD_DIR, REPO)}")
    for k, out in kn.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "smem" in line:
                log(f"phase 1: ptxas {k}: {line.strip()}")
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    memory = {"phase1": mem_log("after phase 1")}
    run_phase(2, "kernel parity", phase_parity, gen, dev)
    memory["phase2"] = mem_log("after phase 2")
    # phase 15 holds every launch of phases 3-14 to its contract
    shapes, wrappers = record_launch_shapes()
    rows = run_phase(3, "real size", phase_real_size, gen, dev, bw,
                     f32_rate)
    memory["phase3"] = mem_log("after phase 3")
    eng = run_phase(4, "engine", phase_engine,
                    np.random.default_rng(args.seed))
    memory["phase4"] = mem_log("after phase 4")
    fns = run_phase(5, "functions", phase_functions, eng, bw)
    memory["phase5"] = mem_log("after phase 5")
    print(json.dumps({"functions": fns["functions"],
                      "queries": fns["queries"],
                      "phase5_peak_gib": fns["peak_gib"]}), flush=True)
    srv = run_phase(6, "serving", phase_serving, eng)
    emit("serving", dict(srv["serving"], card=smi))
    memory["phase6"] = mem_log("after phase 6")
    eng["backend"].batcher.executor.stop(WAIT_S)
    # phase 7 builds its own backend: drop phases 4-6's and their tiles
    data = eng.pop("rows")
    for k in ("backend", "shard"):
        del eng[k]
    memory["phases4_6_dropped"] = mem_released(
        memory["phase1"], "phases 4-6's backend and shard dropped")
    before = memory["phases4_6_dropped"]
    # phase 10 runs on phase 7's server, which starts with the rules (the
    # alert's threshold fixed from the oracle first) and self-monitoring
    sink = WebhookSink()
    threshold = rule_threshold(data)
    log(f"phase 7: alert threshold X = {threshold!r} (median of the "
        f"{G} jobs' oracle rates at the first rule tick)")
    span_start = int(time.time())
    try:
        psrv, loaded = run_phase(7, "server", start_server, data,
                                 rules_config(threshold, sink.url))
        try:
            server = run_phase(7, "server", phase_server, psrv, loaded, data,
                               smi)
            emit("server", server["server"])
            rules = run_phase(10, "rules", phase_rules, psrv, data, sink,
                              span_start, smi)
            emit("rules", rules["rules"])
        finally:
            psrv.stop()
            memory["phase7_stop"] = mem_log("after psrv.stop()")
    finally:
        sink.close()
    del psrv, loaded
    memory["phases7_10"] = before = mem_released(
        before, "phases 7 and 10: the server stopped and dropped")
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="filodb-phase8-")
    wdir = {d: os.path.join(root, d) for d in ("data", "stream")}
    try:
        write = run_phase(8, "write path", phase_write_path, data, wdir, smi)
        emit("durability", write["durability"])
        memory["phase8"] = before = mem_released(
            before, "phase 8: servers A and B stopped")
        # phase 9 drains, stops and restarts nodes on wdir: phase 11's
        # workers start from a copy of what phase 9's nodes start from,
        # and phase 12 from a copy of the data-dir (its own counter tails
        # come over HTTP into fresh stream logs)
        sdir = {d: os.path.join(root, "supervisor", d) for d in wdir}
        for d in wdir:
            shutil.copytree(wdir[d], sdir[d])
        tdir = {d: os.path.join(root, "downsample", d) for d in wdir}
        shutil.copytree(wdir["data"], tdir["data"])
        os.makedirs(tdir["stream"])
        cluster = run_phase(9, "cluster", phase_cluster, data, wdir,
                            write.pop("answers_b"), smi)
        emit("cluster", cluster["cluster"])
        memory["phase9"] = before = mem_released(
            before, "phase 9: both nodes stopped")
        supervised = run_phase(11, "supervisor", phase_supervisor, sdir,
                               cluster, smi)
        emit("supervisor", supervised)
        memory["phase11"] = before = mem_released(
            before, "phase 11: the supervisor and its workers ended")
        assert before <= MEM_BEFORE_PHASE12, \
            f"{before / 2**30:.3f} GiB allocated before phase 12"
        gen12 = torch.Generator(device=dev)
        gen12.manual_seed(args.seed)
        ds = run_phase(12, "downsample", phase_downsample, gen12, dev, data,
                       tdir, bw, smi)
        emit("downsample", ds["downsample"])
        memory["phase12"] = before = mem_released(
            before, "phase 12: its server stopped")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cert = run_phase(13, "certification", phase_certification, dev, smi)
    emit("certification", cert["certification"])
    memory["phase13"] = before = mem_released(
        before, "phase 13: its backends released")
    mesh = run_phase(14, "mesh", phase_mesh, data, dev, bw, smi)
    emit("mesh", mesh["mesh"])
    memory["phase14"] = before = mem_released(
        before, "phase 14: its stores dropped and its servers stopped")
    restore_kernels(wrappers)
    cap = run_phase(15, "capacity and contracts", phase_capacity, data, dev,
                    smi, eng["tile_cache"], shapes)
    emit("capacity", cap["capacity"])
    emit("contracts", cap["contracts"])
    emit("lint", cap["lint"])
    memory["phase15"] = mem_released(
        before, "phase 15: its stores dropped")
    emit("memory", {"allocated_bytes": memory, "slack_bytes": MEM_SLACK,
                    "card": smi})
    kernels = []
    for kname in ("counter_groupsum", "window_extract"):
        r = dict(rows[kname])
        r["launches"] = eng["launches"][kname]
        r["launches_phase5"] = fns["launches"][kname]
        r["launches_phase6"] = srv["launches"][kname]
        r["launches_phase7"] = server["launches"][kname]
        r["launches_phase8"] = write["launches"][kname]
        r["launches_phase9"] = cluster["launches"][kname]
        r["launches_phase10"] = rules["launches"][kname]
        # counted inside the worker processes: the dispatches of the
        # kernel's site in each private query's &explain=analyze
        r["launches_phase11"] = supervised["launches"][kname]
        r["launches_phase12"] = ds["launches"].get(kname, 0)
        r["launches_phase13"] = cert["launches"][kname]
        r["launches_phase14"] = mesh["launches"][kname]
        r["max_abs_err"] = max(r["max_abs_err"], eng["errs"][kname],
                               ds["errs"].get(kname, 0.0),
                               cert["errs"].get(kname, 0.0),
                               fns["errs"].get(kname, 0.0),
                               srv["errs"].get(kname, 0.0),
                               server["errs"].get(kname, 0.0),
                               write["errs"].get(kname, 0.0),
                               cluster["errs"].get(kname, 0.0),
                               rules["errs"].get(kname, 0.0))
        kernels.append(r)
    emit("kernels", kernels)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
