"""Device downsample functions: per-period aggregates over [S, N] tiles, as
torch ops on the device (the counterpart of ``filodb_tpu.downsample.kernels``).

The reference computes one value per chunk per period with per-row iterator
``ChunkDownsampler``s (core/downsample/ChunkDownsampler.scala:38-353)
driven by ``DownsamplePeriodMarker`` row ranges (time-aligned, plus
counter-correction boundaries for counters).

Here a whole batch is a handful of device ops: period assignment is integer
arithmetic per sample, the per-period aggregates come from the query
engine's window machinery with window == step == res (int64 histogram
bounds + f64 prefix sums + a bounded [S, P, W] gather for min/max), and
counter period boundaries come out as an emit mask. A batch whose rows
share one scrape cadence takes a reshape fast path instead of the gather
(``downsample_gauge_fast``), and coarser resolutions that nest the finer
one reduce the finer level's outputs (``cascade_gauge_aligned``).

Every function is f64 like the reference's. Counts, minima, maxima, last
values, last timestamps and the emit mask are bit for bit the reference's;
sums add in another order (prefix differences or row sums).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from filodb_tpu_torch.lint.contracts import kernel_contract
from filodb_tpu_torch.query.backend import (_GATHER_ELT_BYTES,
                                            GATHER_BUDGET_BYTES, _bounds,
                                            _prefix, _take)

F64 = torch.float64
I64 = torch.int64
_SENT = 1 << 60         # padding timestamp: past every period
_SENT_LO = 1 << 59      # timestamps at or above this are padding


def _ex_tiles(device, S=8, N=64):
    """Example [S, N] int64 / f64 tiles and full lengths."""
    ts = (torch.arange(N, dtype=I64, device=device)[None, :] * 10_000
          + torch.zeros((S, 1), dtype=I64, device=device))
    vals = torch.ones((S, N), dtype=F64, device=device)
    lens = torch.full((S,), N, dtype=torch.int32, device=device)
    return ts, vals, lens


def _six_expect(S, P):
    """The (sum, count, min, max, last_v, last_ts) output family."""
    def expect(out):
        shapes = [tuple(o.shape) for o in out]
        if shapes != [(S, P)] * 6:
            return f"outputs {shapes} != 6x({S}, {P})"
        if out[-1].dtype != I64 or any(o.dtype != F64 for o in out[:5]):
            return "dtypes != (5x f64, i64)"
        return None
    return expect


@kernel_contract(
    "downsample_gauge", kind="eager",
    example=lambda device: (_ex_tiles(device) + (0, 300_000),
                            {"nperiods": 16, "w_bound": 8}),
    expect=_six_expect(8, 16),
    notes="general gather path: [S, P, W] bounded gather for order "
          "statistics, prefix sums for sum/count; rows cut so the gather's "
          "intermediates stay under GATHER_BUDGET_BYTES")
def downsample_gauge_tiles(ts: torch.Tensor, vals: torch.Tensor,
                           lens: torch.Tensor, base: int, res: int,
                           nperiods: int, w_bound: int = 64):
    """Per-period (sum, count, min, max, last_v, last_ts) for gauge tiles.

    Period p = (ts - base) // res; samples outside [0, nperiods) and row
    padding are dropped; empty periods are NaN (count 0, last_ts 0).
    Timestamps are sorted per row, so periods are contiguous index ranges:
    the query engine's uniform window bounds with window == step == res,
    prefix sums for the sums, and a [S, P, W] bounded gather for the order
    statistics (``w_bound`` caps the samples per period it reads)."""
    S, N = ts.shape
    dev = ts.device
    base, res = int(base), int(res)
    idx = torch.arange(N, device=dev)[None, :]
    valid = idx < lens.to(I64)[:, None]
    ts = torch.where(valid, ts, torch.full((), _SENT, dtype=I64, device=dev))
    lo, hi = _bounds(ts, base, base + res - 1, res, nperiods)   # [S, P]
    counts = (hi - lo + 1).to(F64)
    has = counts >= 1
    v = torch.where(valid, vals, torch.zeros((), dtype=F64, device=dev))
    cs = _prefix(v)
    sums = (_take(cs, torch.clamp(hi + 1, 0, N))
            - _take(cs, torch.clamp(lo, 0, N)))
    hi_c = torch.clamp(hi, 0, N - 1)
    last_v = _take(vals, hi_c)
    last_ts = _take(ts, hi_c)
    mins, maxs = _order_stats(vals, lens.to(I64), lo, hi, w_bound)
    nan = torch.full((), float("nan"), dtype=F64, device=dev)
    zero = torch.zeros((), dtype=F64, device=dev)
    return (torch.where(has, sums, nan), torch.where(has, counts, zero),
            torch.where(has, mins, nan), torch.where(has, maxs, nan),
            torch.where(has, last_v, nan),
            torch.where(has, last_ts, torch.zeros((), dtype=I64,
                                                  device=dev)))


def _order_stats(vals, lens, lo, hi, w_bound: int):
    """[S, P] min and max over each period's index range [lo, hi], at most
    ``w_bound`` samples from lo, cut into row chunks whose [rows, P, W]
    intermediates fit GATHER_BUDGET_BYTES (every op is row-local)."""
    S, N = vals.shape
    P = lo.shape[1]
    rows = max(1, GATHER_BUDGET_BYTES // (max(P, 1) * w_bound
                                          * _GATHER_ELT_BYTES))
    offs = torch.arange(w_bound, device=vals.device)
    inf = torch.full((), float("inf"), dtype=F64, device=vals.device)
    mins, maxs = [], []
    for i in range(0, S, rows):
        lo_i, hi_i = lo[i:i + rows], hi[i:i + rows]
        gidx = lo_i[:, :, None] + offs[None, None, :]         # [s, P, W]
        in_p = (gidx <= hi_i[:, :, None]) \
            & (gidx < lens[i:i + rows, None, None])
        g = torch.gather(vals[i:i + rows], 1,
                         torch.clamp(gidx, 0, N - 1).reshape(
                             gidx.shape[0], -1)).reshape(gidx.shape)
        mins.append(torch.where(in_p, g, inf).amin(dim=2))
        maxs.append(torch.where(in_p, g, -inf).amax(dim=2))
    return torch.cat(mins, dim=0), torch.cat(maxs, dim=0)


def cascade_gauge(prev, base: int, res: int, nperiods: int, w_bound: int):
    """Downsample one resolution level from the previous level's outputs
    (sum of sums, count of counts, min of mins, max of maxes, last of
    lasts): only the finest level reads raw samples. ``prev`` is the
    previous level's 6-tuple."""
    p_sums, p_cnts, p_mins, p_maxs, p_last_v, p_last_ts = prev
    S, P = p_sums.shape
    dev = p_sums.device
    has = p_cnts > 0
    pts = torch.where(has, p_last_ts,
                      torch.full((), _SENT, dtype=I64, device=dev))
    lens = torch.full((S,), P, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=F64, device=dev)

    def run(chan):
        return downsample_gauge_tiles(pts, torch.where(has, chan, zero),
                                      lens, base, res, nperiods, w_bound)

    s_out = run(p_sums)
    c_out = run(p_cnts)
    m_out = run(p_mins)
    x_out = run(p_maxs)
    l_out = run(p_last_v)
    counts = torch.where(torch.isnan(c_out[0]), zero, c_out[0])
    return (s_out[0], counts, m_out[2], x_out[3], l_out[4], s_out[5])


@kernel_contract(
    "counter_emit_mask", kind="eager",
    example=lambda device: (_ex_tiles(device) + (0, 300_000),
                            {"nperiods": 16}),
    expect=lambda out: None if tuple(out.shape) == (8, 64)
    and out.dtype == torch.bool else f"mask {out.shape}/{out.dtype}",
    notes="pure lane arithmetic (no scatter): last-of-period + both "
          "sides of every counter reset")
def counter_emit_mask(ts: torch.Tensor, vals: torch.Tensor,
                      lens: torch.Tensor, base: int, res: int,
                      nperiods: int) -> torch.Tensor:
    """Emit mask for counter downsampling: keep the LAST sample of every
    period plus BOTH sides of every reset — the peak right before it and
    the reset sample itself (DownsamplePeriodMarker counter boundaries;
    dLast of prom-counter). Emitting both sides makes every drop visible to
    query-time counter correction even when the counter climbs back above
    the old peak before the period ends."""
    S, N = ts.shape
    dev = ts.device
    idx = torch.arange(N, device=dev)[None, :]
    valid = idx < lens.to(I64)[:, None]
    p = torch.div(ts - int(base), max(int(res), 1), rounding_mode="floor")
    p_ok = valid & (p >= 0) & (p < nperiods)
    # rows are time-sorted: a sample is last-in-period iff its successor is
    # invalid or falls in a different period
    nxt_p = torch.cat([p[:, 1:], torch.full((S, 1), -1, dtype=p.dtype,
                                            device=dev)], dim=1)
    nxt_valid = torch.cat([valid[:, 1:], torch.zeros((S, 1), dtype=torch.bool,
                                                     device=dev)], dim=1)
    is_last = ~nxt_valid | (nxt_p != p)
    nxt = torch.cat([vals[:, 1:], vals[:, -1:]], dim=1)
    peak = (nxt < vals) & nxt_valid                       # next is a reset
    prev = torch.cat([vals[:, :1], vals[:, :-1]], dim=1)
    is_reset = (vals < prev) & (idx > 0) & valid          # first after drop
    return (is_last | peak | is_reset) & p_ok


# ---------------------------------------------------------------------------
# Regular-cadence fast path: reshape instead of gather
# ---------------------------------------------------------------------------
# For a batch whose rows share one scrape cadence (nominal ticks
# t0 + i*dt, |jitter| < dt/2) every period's samples form a constant-length
# run of R = res//dt sample indices, with at most ONE boundary slot per
# period whose jitter can push it into a neighbouring period, and the grid
# phase decides statically which direction that is. So the per-period
# aggregation is a reshape and row reductions, streaming each sample once.


@kernel_contract(
    "downsample_regular", kind="eager",
    example=lambda device: (_ex_tiles(device)[:2] + (0, 40_000),
                            {"R": 4, "nperiods": 8, "c0": 2,
                             "down": False}),
    expect=_six_expect(8, 8),
    notes="regular-cadence reshape fast path; dispatch gated by "
          "regular_cadence (every sample within dt/2 of its tick, "
          "res % dt == 0)")
def _ds_regular(ts: torch.Tensor, vals: torch.Tensor, base: int, res: int,
                R: int, nperiods: int, c0: int, down: bool):
    S, N = ts.shape
    dev = ts.device
    base, res = int(base), int(res)
    P = nperiods
    if c0 < 0:
        ts = torch.cat([torch.full((S, -c0), _SENT, dtype=I64, device=dev),
                        ts], dim=1)
        vals = torch.cat([torch.zeros((S, -c0), dtype=F64, device=dev),
                          vals], dim=1)
        N -= c0
        c0 = 0
    need = c0 + P * R
    if need > N:
        ts = torch.cat([ts, torch.full((S, need - N), _SENT, dtype=I64,
                                       device=dev)], dim=1)
        vals = torch.cat([vals, torch.zeros((S, need - N), dtype=F64,
                                            device=dev)], dim=1)
    tw = ts[:, c0:c0 + P * R].reshape(S, P, R)
    vw = vals[:, c0:c0 + P * R].reshape(S, P, R)
    valid = tw < _SENT_LO
    pb = base + torch.arange(P, dtype=I64, device=dev) * res  # starts
    f0 = torch.zeros((), dtype=F64, device=dev)
    i0 = torch.zeros((), dtype=I64, device=dev)
    inf = torch.full((), float("inf"), dtype=F64, device=dev)
    nan = torch.full((), float("nan"), dtype=F64, device=dev)
    # the tick just OUTSIDE the reshape slice can jitter into a covered edge
    # period: in up-mode tick c0-1 into period 0, in down-mode tick
    # c0 + P*R into period P-1
    if down:
        inside = ts.shape[1] > c0 + P * R
        e_ts = ts[:, c0 + P * R] if inside \
            else torch.full((S,), _SENT, dtype=I64, device=dev)
        e_v = vals[:, c0 + P * R] if inside \
            else torch.zeros((S,), dtype=F64, device=dev)
        e_ok = (e_ts < _SENT_LO) & (e_ts < base + P * res) \
            & (e_ts >= base + (P - 1) * res)
        e_period = P - 1
    else:
        e_ts = ts[:, c0 - 1] if c0 >= 1 \
            else torch.full((S,), _SENT, dtype=I64, device=dev)
        e_v = vals[:, c0 - 1] if c0 >= 1 \
            else torch.zeros((S,), dtype=F64, device=dev)
        e_ok = (e_ts < _SENT_LO) & (e_ts >= base) & (e_ts < base + res)
        e_period = 0
    if down:
        # only the FIRST slot of a period can cross (into the previous)
        bpos = 0
        b_ts, b_v, b_ok = tw[:, :, 0], vw[:, :, 0], valid[:, :, 0]
        crossed = b_ts < pb[None, :]
    else:
        # only the LAST slot can cross (into the next)
        bpos = R - 1
        b_ts, b_v, b_ok = tw[:, :, -1], vw[:, :, -1], valid[:, :, -1]
        crossed = b_ts >= (pb + res)[None, :]
    own_ok = b_ok & ~crossed
    mv_ok = b_ok & crossed
    # full member mask of period p's OWN samples: every valid slot, with
    # the boundary slot gated on not-crossed
    pos = torch.arange(R, device=dev)
    member_ok = torch.where(pos[None, None, :] == bpos, own_ok[:, :, None],
                            valid)

    def nb(arr, fill):
        """The neighbour period's view of the moved boundary sample."""
        pad = torch.full_like(arr[:, :1], fill)
        if down:        # b_{p+1} moves INTO p
            return torch.cat([arr[:, 1:], pad], dim=1)
        return torch.cat([pad, arr[:, :-1]], dim=1)   # b_{p-1} INTO p

    mv_ok_n = nb(mv_ok, False)
    mv_v_n = nb(torch.where(mv_ok, b_v, f0), 0.0)
    cnt = (member_ok.sum(dim=2) + mv_ok_n).to(F64)
    sums = torch.where(member_ok, vw, f0).sum(dim=2) + mv_v_n
    mins = torch.minimum(torch.where(member_ok, vw, inf).amin(dim=2),
                         nb(torch.where(mv_ok, b_v, inf), float("inf")))
    maxs = torch.maximum(torch.where(member_ok, vw, -inf).amax(dim=2),
                         nb(torch.where(mv_ok, b_v, -inf), float("-inf")))
    # latest own sample: masked ts-max (periods at the batch tail end in
    # padding, so a fixed slot index would miss it), then the value at
    # that (unique, strictly increasing) timestamp
    imin = torch.full((), -(1 << 62), dtype=I64, device=dev)
    own_last_ts = torch.where(member_ok, tw, imin).amax(dim=2)
    own_last_v = torch.where(member_ok & (tw == own_last_ts[:, :, None]),
                             vw, f0).sum(dim=2)
    own_has = member_ok.any(dim=2)
    mv_ts_n = nb(torch.where(mv_ok, b_ts, i0), 0)
    if down:
        # an incoming crossed boundary (index (p+1)R + c0) postdates every
        # own sample
        last_ts = torch.where(mv_ok_n, mv_ts_n,
                              torch.where(own_has, own_last_ts, i0))
        last_v = torch.where(mv_ok_n, mv_v_n,
                             torch.where(own_has, own_last_v, nan))
    else:
        # an incoming crossed boundary (index pR + c0 - 1) PREdates every
        # own sample: the latest only for periods with no own members
        last_ts = torch.where(own_has, own_last_ts,
                              torch.where(mv_ok_n, mv_ts_n, i0))
        last_v = torch.where(own_has, own_last_v,
                             torch.where(mv_ok_n, mv_v_n, nan))
    # fold the out-of-slice edge tick into its edge period
    ecol = torch.zeros((P,), dtype=torch.bool, device=dev)
    ecol[e_period] = True
    e_in = e_ok[:, None] & ecol[None, :]
    e_col = e_v[:, None]
    cnt = cnt + e_in
    sums = sums + torch.where(e_in, e_col, f0)
    mins = torch.minimum(mins, torch.where(e_in, e_col, inf))
    maxs = torch.maximum(maxs, torch.where(e_in, e_col, -inf))
    if down:
        # the edge tick postdates every covered sample of period P-1
        last_ts = torch.where(e_in, e_ts[:, None], last_ts)
        last_v = torch.where(e_in, e_col, last_v)
    else:
        # the edge tick (c0-1) PREdates period 0's own samples: the latest
        # only when the period had none
        e_only = e_in & (last_ts == 0)
        last_ts = torch.where(e_only, e_ts[:, None], last_ts)
        last_v = torch.where(e_only, e_col, last_v)
    has = cnt > 0
    return (torch.where(has, sums, nan), cnt,
            torch.where(has & torch.isfinite(mins), mins, nan),
            torch.where(has & torch.isfinite(maxs), maxs, nan),
            torch.where(has, last_v, nan),
            torch.where(has, last_ts, i0))


def regular_cadence(ts_pad, lens, res: int) -> Optional[Tuple[int, int]]:
    """Host-side gate for the reshape fast path: dense rows sharing one
    nominal tick grid t0 + i*dt with max |jitter| strictly under dt/2,
    and res a whole number of ticks. Returns (t0, dt) or None."""
    ts = ts_pad.cpu().numpy() if isinstance(ts_pad, torch.Tensor) \
        else np.asarray(ts_pad)
    lens = lens.cpu().numpy() if isinstance(lens, torch.Tensor) \
        else np.asarray(lens)
    S, N = ts.shape
    if S == 0 or N < 2 or not bool((lens == N).all()):
        return None
    dt_raw = float(ts[0, -1] - ts[0, 0]) / (N - 1)
    # jitter makes the raw estimate off by a few ms: snap to round
    # cadences and let the jitter bound (the actual correctness gate) pick
    # the first that fits
    cands = []
    for m in (60_000, 30_000, 15_000, 10_000, 5_000, 1_000, 500, 100,
              10, 1):
        c = int(round(dt_raw / m)) * m
        if c > 0 and c not in cands:
            cands.append(c)
    idx = np.arange(N, dtype=np.int64)
    for dt in cands:
        if res % dt != 0:
            continue
        t0 = int(np.round((ts - idx[None, :] * dt).mean()))
        j = np.abs(ts - (t0 + idx[None, :] * dt)).max()
        if j < dt / 2:
            return t0, dt
    return None


def downsample_gauge_fast(ts_pad: torch.Tensor, vals_pad: torch.Tensor,
                          lens: torch.Tensor, base: int, res: int,
                          nperiods: int, cadence=None):
    """Dispatch the reshape fast path when the batch qualifies
    (regular_cadence); None -> the caller falls back to the gather path.
    ``cadence=(t0, dt)`` skips the host gate for callers that know the grid
    by construction (the gate reads the whole ts tile on the host)."""
    rc = cadence if cadence is not None \
        else regular_cadence(ts_pad, lens, int(res))
    if rc is None:
        return None
    t0, dt = rc
    if int(res) % dt != 0:
        return None
    R = int(res) // dt
    if R < 2:
        return None
    o0 = t0 - int(base)
    c0 = -(-(-o0) // dt)                 # ceil(-o0 / dt)
    d1 = o0 + c0 * dt                    # grid phase within the period
    down = d1 < dt / 2
    return _ds_regular(ts_pad, vals_pad, int(base), int(res), R, nperiods,
                       c0, down)


@kernel_contract(
    "cascade_aligned", kind="eager",
    example=lambda device: (
        (tuple(torch.ones((8, 16), dtype=F64, device=device)
               for _ in range(5))
         + (torch.ones((8, 16), dtype=I64, device=device),), 4, 1), {}),
    expect=_six_expect(8, 5),       # Q = ceil((16 + 1) / 4)
    notes="nested-resolution cascade: reshape + NaN-aware reduce over "
          "ratio consecutive fine periods")
def cascade_gauge_aligned(prev, ratio: int, lead: int):
    """Coarse level from a fine level when the resolutions nest
    (res_coarse % res_fine == 0): each coarse period is ``ratio``
    consecutive fine periods (offset by ``lead`` fine periods for the base
    alignment), a reshape and NaN-aware reductions."""
    p_sums, p_cnts, p_mins, p_maxs, p_last_v, p_last_ts = prev
    S, P = p_sums.shape
    dev = p_sums.device
    Q = -(-(P + lead) // ratio)
    padR = Q * ratio - P - lead
    inf = float("inf")

    def grp(a, fill):
        a = torch.cat([torch.full((S, lead), fill, dtype=a.dtype, device=dev),
                       a,
                       torch.full((S, padR), fill, dtype=a.dtype,
                                  device=dev)], dim=1)
        return a.reshape(S, Q, ratio)

    f0 = torch.zeros((), dtype=F64, device=dev)
    finf = torch.full((), inf, dtype=F64, device=dev)
    nan = torch.full((), float("nan"), dtype=F64, device=dev)
    i0 = torch.zeros((), dtype=I64, device=dev)
    g_cnt = grp(p_cnts, 0.0)
    has = g_cnt > 0
    cnt = torch.where(has, g_cnt, f0).sum(dim=2)
    sums = torch.where(has, grp(torch.nan_to_num(p_sums), 0.0), f0).sum(dim=2)
    mins = torch.where(has, grp(torch.nan_to_num(p_mins, nan=inf), inf),
                       finf).amin(dim=2)
    maxs = torch.where(has, grp(torch.nan_to_num(p_maxs, nan=-inf), -inf),
                       -finf).amax(dim=2)
    lts = torch.where(has, grp(p_last_ts, 0), i0)
    lv = grp(torch.nan_to_num(p_last_v), 0.0)
    # latest non-empty fine period wins (fine last_ts increase with index)
    pick = torch.argmax(
        torch.where(has, torch.arange(ratio, dtype=torch.int32,
                                      device=dev)[None, None, :],
                    torch.full((), -1, dtype=torch.int32, device=dev)),
        dim=2)
    last_ts = torch.gather(lts, 2, pick[:, :, None])[:, :, 0]
    last_v = torch.gather(lv, 2, pick[:, :, None])[:, :, 0]
    okp = cnt > 0
    return (torch.where(okp, sums, nan), cnt,
            torch.where(okp & torch.isfinite(mins), mins, nan),
            torch.where(okp & torch.isfinite(maxs), maxs, nan),
            torch.where(okp, last_v, nan),
            torch.where(okp, last_ts, i0))


# ---------------------------------------------------------------------------
# numpy oracle (parity model for the device functions)
# ---------------------------------------------------------------------------

def downsample_gauge_oracle(ts: np.ndarray, vals: np.ndarray, base: int,
                            res: int, nperiods: int
                            ) -> Tuple[np.ndarray, ...]:
    """Reference semantics, one series, plain numpy loops."""
    sums = np.full(nperiods, np.nan)
    cnts = np.zeros(nperiods)
    mins = np.full(nperiods, np.nan)
    maxs = np.full(nperiods, np.nan)
    last_v = np.full(nperiods, np.nan)
    last_ts = np.zeros(nperiods, dtype=np.int64)
    for t, v in zip(ts, vals):
        p = (int(t) - base) // res
        if not (0 <= p < nperiods):
            continue
        if cnts[p] == 0:
            sums[p] = v
            mins[p] = v
            maxs[p] = v
        else:
            sums[p] += v
            mins[p] = min(mins[p], v)
            maxs[p] = max(maxs[p], v)
        cnts[p] += 1
        last_v[p] = v
        last_ts[p] = t
    return sums, cnts, mins, maxs, last_v, last_ts
