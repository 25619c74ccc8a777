#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (filodb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, none of whose failures is caught:
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
     (8,192 series, T = 469); the boundary extract at 65,536 x 512 samples
     x 128 windows;
  4. the engine end to end (the main path): a TimeSeriesShard with 8,192
     flushed counter series, an unflushed 30-sample tail and 1,024 series of
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
     engine clients, a flush with its stale serve and rebuild: the
     `serving` line);
  7. the standalone server (`filodb_tpu_torch.standalone.server`) on the
     card, holding phase 4's data routed over 4 shards as the reference
     routes it, plus seed_dev_data(): PromQL over HTTP (the default
     sample limit's 422, each query held against the numpy oracle with
     the kernels it launched, again from the results cache and with
     &cache=false), /metrics, 8 HTTP clients (the `server` line);
  8. the write path and durability: phase 4's flushed history (the
     counters and the irregular series) backfilled into a fresh data-dir
     through the memstore and a FlatFileColumnStore; server A on the card
     over that data-dir, a fresh stream-dir and a gateway (WRITE_CONFIG:
     fsync per append, no timed flush) takes the counters' 30-sample tail
     through POST /api/v1/ingest/influx, one POST of 8,192 lines per
     scrape, and an irregular tail through the TCP gateway; its grouped
     sum and average of rate (the fused group-sum), one job's rate into
     the tail and the irregular rate into the tail (the boundary extract)
     are held against the numpy oracle, and a remote read of 64 series
     must give back every sample written; A's drivers stop without a
     flush (a crash: the tail lives only in the stream logs); server B on
     the same directories goes through RECOVERY to ACTIVE, and must give
     A's answers bit for bit and the same remote-read bytes, through both
     kernels (the `durability` line);
  then the `kernels` line: launches (phase 4, and phases 5-8 as
  `launches_phase5` to `launches_phase8`), max error, kernel and plain
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

The last line of standard output is {"ok": true, "device": {...}}; the
script exits non-zero, printing no result, when there is no CUDA device.
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
S_ENGINE = 8_192
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
                  knife_ms: Optional[int] = None) -> np.ndarray:
    """Straightforward f64 Prometheus rate per series and window -> [S, T]
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
    wend = w0e + np.arange(T, dtype=np.int64) * STEP
    wstart = wend - WINDOW
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
            rate = delta * extrap / sampled / (WINDOW / 1000.0)
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
    bytes2 = S2 * N2 * 4 + nonempty * 2 * C * 4 + S2 * T2 * (12 + 8 * C)
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
ENGINE_IRREGULAR = 1_024


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
    return {"launches": launches, "errs": errs, "ingest_s": ingest_s,
            "shard": shard, "backend": be, "irr": irr, "ts": ts,
            "vals": vals, "rows": rows, "first_query_split": split}


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

BURST = 8               # queries released together by a barrier
BURST_ROUNDS = 1        # bursts of each key with the batcher on (cut
                        # from 2 to keep phase 6 near 90 s)
CLIENTS = 16            # free-running engine clients
CLIENT_WARM = 1         # first queries of each client, left out (warm-up)
CLIENT_QUERIES = 3      # queries of each client that are measured (cut
                        # from 10 to make room for phase 7)
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


def burst(be, series, func: str, params):
    """One periodic_samples per grid on its own thread, all released by a
    barrier at the backend -> (answers, latencies s)."""
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
    run_threads(len(params), one)
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
    bursts); batched answers held bit for bit to the unbatched ones (the
    packed rate: the difference between its two routes measured), the
    first member of each against the oracle -> (readings, the widest
    batch of each key, to be timed later)."""
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
                rounds.append(burst(be, series, func, params))
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
    on grids that end up to BURST - 1 steps early: CLIENT_WARM queries
    each, left out, then CLIENT_QUERIES measured. Latencies are those of
    the measured queries; queries/s counts the measured queries that end
    in the steady window, from the last client's end of warm-up to the
    first client's last query, over its length."""
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
              for q, end in qs] for j in range(BURST)]
    spans = [[] for _ in range(CLIENTS)]    # per client: (start, end) s
    t0 = time.perf_counter()

    def client(k):
        eng = QueryEngine([shard], backend=be)
        for i in range(k, k + CLIENT_WARM + CLIENT_QUERIES):
            tq = time.perf_counter()
            got = eng.execute(plans[k % BURST][i % len(qs)])
            spans[k].append((tq, time.perf_counter()))
            assert np.isfinite(got.values).any()
    run_threads(CLIENTS, client)
    wall = time.perf_counter() - t0
    measured = [q for c in spans for q in c[CLIENT_WARM:]]
    w0 = max(c[CLIENT_WARM - 1][1] for c in spans)
    w1 = min(c[-1][1] for c in spans)
    assert w1 > w0, "no steady window: a client ended before another " \
        "finished its warm-up"
    done = sum(1 for _, e in measured if w0 < e <= w1)
    ms = 1e3 * np.asarray([e - b for b, e in measured])
    return {"clients": CLIENTS, "warmup_queries": CLIENTS * CLIENT_WARM,
            "queries": len(measured), "wall_s": wall,
            "window_s": w1 - w0, "window_queries": done,
            "qps": done / (w1 - w0),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max())}


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

SERVER_CLIENTS = 8          # HTTP client threads
SERVER_CLIENT_QUERIES = 3   # queries of each client, over phase 6's mix
# the server's config: the reference's defaults but for these keys, each
# with its reason
SERVER_CONFIG = {
    "num-shards": 4, "port": 0,
    # one query scans 23.6 M samples here: the default 1,000,000 answers
    # 422 (asserted first, on an HTTP edge at the default over the same
    # shards)
    "query-sample-limit": 0,
    # a per-series answer at 8,192 series holds a slot 8-10 s (its JSON
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


def server_queries_http(srv, rows, engine_time) -> list:
    """Phase 7's range queries and one instant query over HTTP. Each range
    query goes three times in a row: first (the kernels it launched
    counted), again as it was (the results cache answers: a full hit where
    the grid ends at or below every shard's ingest watermark), and with
    &cache=false (the engine and the device again); all three answers
    alike. Then each first answer is held against the numpy oracle as
    phases 4-5 hold theirs -> readings."""
    from filodb_tpu_torch.promql.parser import (TimeStepParams, parse_query,
                                                parse_query_range)
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query.engine import QueryEngine

    step = STEP // 1000
    path = "/promql/timeseries/api/v1/query_range"
    start, fe, _ = engine_grid()
    answers = []
    for q, s, e in server_queries():
        params = {"query": q, "start": s, "end": e, "step": step}
        before = dict(kn.LAUNCHES)
        engine_time.take()
        payload, ms, nbytes = http_json(srv.port, path, params)
        engine_s = engine_time.take()
        r = {"q": q, "first_ms": ms, "bytes": nbytes,
             "launches": {k: kn.LAUNCHES[k] - before[k] for k in before},
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


def server_clients(srv) -> dict:
    """SERVER_CLIENTS threads over HTTP, each SERVER_CLIENT_QUERIES queries
    cycling phase 6's mix on grids shifted by up to BURST - 1 steps, with
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
            j = k % BURST
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


def phase_server(rows: dict, smi: str) -> dict:
    """Phase 7: the port's FiloServer on CUDA (SERVER_CONFIG), loaded with
    the engine phases' rows through state.load_into_store (routed to their
    shards as the reference routes them) plus seed_dev_data(), then
    PromQL over HTTP: the default sample limit's 422, every query held
    against the numpy oracle with the kernels it launched, the results
    cache and its bypass, /metrics, and concurrent clients. Kernel launch
    counts are set to 0 before the first query and read after the
    clients; every kernel call is held against its plain version."""
    from filodb_tpu_torch import state
    from filodb_tpu_torch.http.server import FiloHttpServer
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query.model import QueryLimits
    from filodb_tpu_torch.standalone.server import DEFAULTS, FiloServer

    t0 = time.perf_counter()
    for key, why in (("query-sample-limit", "23.6 M samples a query"),
                     ("admission-wait-s", "a per-series answer holds a "
                      "slot 8-10 s")):
        log(f"phase 7: config {key} = {SERVER_CONFIG[key]} (default "
            f"{DEFAULTS[key]}): {why}")
    srv = FiloServer(SERVER_CONFIG).start()
    try:
        for key, schema, flush in LOAD_ORDER:
            state.load_into_store(srv.store, srv.ref, rows[key], schema,
                                  flush, num_shards=4, spread=1)
        dev_rows = srv.seed_dev_data()
        load_s = time.perf_counter() - t0
        per_shard = {s.shard_num: len(s.partitions)
                     for s in srv.store.shards(srv.ref)}
        log(f"phase 7: server on :{srv.port}, data loaded in {load_s:.1f} s "
            f"(+{dev_rows} dev samples), series per shard {per_shard}")
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
        engine_time = EngineTime()
        kn.reset_launches()
        try:
            readings = server_queries_http(srv, rows, engine_time)
            clients = server_clients(srv)
        finally:
            engine_time.restore()
            restore_kernels(originals)
        launches = dict(kn.LAUNCHES)
        log(f"phase 7: {SERVER_CLIENTS} HTTP clients: "
            f"{json.dumps(clients)}")
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
        for name, n in launches.items():
            assert n > 0, f"{name} was not launched in phase 7"
        errs = check_kernel_calls(calls, originals, "phase 7")
    finally:
        srv.stop()
    secs = time.perf_counter() - t0
    first = readings[0]
    split = {"wall_ms": first["first_ms"], "engine_ms": first["engine_ms"],
             "handler_outside_engine_ms":
                 first["handler_outside_engine_ms"],
             "timings": first["timings"]}
    log(f"phase 7: {secs:.1f} s; kernel launches {launches}")
    return {"launches": launches, "errs": errs,
            "server": {"seconds": secs, "load_s": load_s,
                       "series_per_shard": per_shard,
                       "queries": readings, "first_grouped_split": split,
                       "clients": clients, "metrics_moved": moved,
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


def backfill(data_dir: str, rows: dict) -> dict:
    """Phase 4's flushed history (the counters and the irregular series)
    written into a fresh data-dir through the port's memstore with a
    FlatFileColumnStore, routed to the 4 shards as the gateway routes, as
    a previous run's flushes would leave it."""
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
    for key in ("counters", "irregular"):
        n += state.load_into_store(store, ref, rows[key], "prom-counter",
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


def phase_write_path(rows: dict, smi: str) -> dict:
    """Phase 8: backfill the history into a data-dir; server A ingests
    the tail through POST /api/v1/ingest/influx (the counters, one POST
    per scrape) and the TCP gateway (the irregular series), answers
    phase 8's queries (held against the numpy oracle) and a remote read;
    it crashes (drivers stopped without a flush); server B recovers from
    the same directories and must answer bit for bit as A did, through
    both kernels. Kernel launch counts are set to 0 before A's first
    query and read after B's last; every kernel call is held against its
    plain version."""
    import shutil
    import tempfile

    from filodb_tpu_torch.gateway.server import send_lines
    from filodb_tpu_torch.query import kernels as kn

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="filodb-phase8-")
    data_dir, stream_dir = (os.path.join(root, d) for d in ("data",
                                                             "stream"))
    irr_tail = irregular_tail(np.random.default_rng(8), rows["irregular"])
    truth = {}
    for hist, tail in (("counters", "counter_tails"),
                       ("irregular", None)):
        tails = rows[tail] if tail else irr_tail
        for (lab, t, v), (_, tt, tv) in zip(rows[hist], tails):
            truth[(lab["_metric_"], lab["instance"])] = (
                np.concatenate([t, tt]).astype(np.int64),
                np.concatenate([v, tv]).astype(np.float64))
    try:
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
                srv.stop()
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
    finally:
        shutil.rmtree(root, ignore_errors=True)
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
    return {"launches": launches, "errs": errs, "durability": durability}


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
    kn.build_kernels()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s into "
        f"{os.path.relpath(kn.BUILD_DIR, REPO)}")
    for k, out in kn.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "smem" in line:
                log(f"phase 1: ptxas {k}: {line.strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    phase_parity(gen, dev)
    rows = phase_real_size(gen, dev, bw, f32_rate)
    eng = phase_engine(np.random.default_rng(args.seed))
    fns = phase_functions(eng, bw)
    srv = phase_serving(eng)
    eng["backend"].batcher.executor.stop(WAIT_S)
    # phase 7 builds its own backend: drop phases 4-6's and their tiles
    data = eng.pop("rows")
    for k in ("backend", "shard"):
        del eng[k]
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    server = phase_server(data, smi)
    gc.collect()
    torch.cuda.empty_cache()
    write = phase_write_path(data, smi)
    kernels = []
    for kname in ("counter_groupsum", "window_extract"):
        r = dict(rows[kname])
        r["launches"] = eng["launches"][kname]
        r["launches_phase5"] = fns["launches"][kname]
        r["launches_phase6"] = srv["launches"][kname]
        r["launches_phase7"] = server["launches"][kname]
        r["launches_phase8"] = write["launches"][kname]
        r["max_abs_err"] = max(r["max_abs_err"], eng["errs"][kname],
                               fns["errs"].get(kname, 0.0),
                               srv["errs"].get(kname, 0.0),
                               server["errs"].get(kname, 0.0),
                               write["errs"].get(kname, 0.0))
        kernels.append(r)
    print(smi, flush=True)
    print(json.dumps({"functions": fns["functions"],
                      "queries": fns["queries"],
                      "phase5_peak_gib": fns["peak_gib"]}), flush=True)
    print(json.dumps({"durability": write["durability"]}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"serving": dict(srv["serving"], card=smi)}),
          flush=True)
    print(json.dumps({"server": server["server"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
