"""PyTorch device backend for the query engine (counterpart of
``filodb_tpu.query.tpu``).

``TorchBackend`` is the engine's device hook. It has the two methods the
engine calls, ``periodic_samples`` and ``fused_groupsum``, and serves every
function of DEVICE_FUNCS by the reference's routes:

  * regular-cadence series ride cached aligned tiles
    (``query/tilestore.py``): the rate family by the counter evaluators
    (grouped sums by the fused group-sum kernel), the other functions of
    ``ALIGNED_FUNCS`` by ``evaluate_aligned``;
  * steps whose windows reach the unflushed write-buffer tail, series of
    irregular cadence, and the functions no aligned tile can answer take
    the packed path: ragged series padded into [S, N] tiles, then the
    boundary-extract kernel and the f64 extrapolation (rate family), the
    order-statistic gather (min/max/quantile_over_time) or the endpoint
    and prefix-sum family (everything else).

Concurrent queries go through a micro-batcher (``query/batcher.py``) that
runs same-shaped dispatches as one, and the tile cache serves the previous
snapshot's tiles across a flush while the rebuild runs in the background.

Other functions (deriv, predict_linear, holt_winters, mad_over_time, ...)
return None, and the engine's numpy oracle answers them. Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from filodb_tpu_torch.query import kernels as kn
from filodb_tpu_torch.query import qos
from filodb_tpu_torch.query import tilestore as tst
from filodb_tpu_torch.query.batcher import MicroBatcher, SplitResult
from filodb_tpu_torch.query.model import GridResult, RangeParams, RawSeries

F64 = torch.float64
I64 = torch.int64

# sentinel timestamp for padding: larger than any real ms timestamp
_TS_PAD = np.int64(1) << 60

# functions this backend serves on the device; the rest go to the oracle
DEVICE_FUNCS = frozenset({
    "rate", "increase", "delta", "irate", "idelta",
    "sum_over_time", "count_over_time", "avg_over_time",
    "stddev_over_time", "stdvar_over_time", "z_score",
    "min_over_time", "max_over_time", "last_sample", "last_over_time",
    "first_over_time", "changes", "resets", "timestamp",
    "rate_over_delta", "increase_over_delta", "quantile_over_time",
    "present_over_time", "absent_over_time",
})

_ENDPOINT_RATE = {"rate": (True, True), "increase": (True, False),
                  "delta": (False, False)}


def _next_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def clean_rows(series: Sequence[RawSeries], drop_nan: bool
               ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], int]:
    """Per-series NaN-drop (stale markers) shared by all packers.
    Returns (rows, max_len)."""
    cleaned: List[Tuple[np.ndarray, np.ndarray]] = []
    maxlen = 1
    for s in series:
        if drop_nan:
            m = ~np.isnan(s.values)
            ts, vals = s.ts[m], s.values[m]
        else:
            ts, vals = s.ts, s.values
        cleaned.append((ts, vals))
        maxlen = max(maxlen, ts.size)
    return cleaned, maxlen


def pack_series(series: Sequence[RawSeries], drop_nan: bool = True
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack ragged raw series into padded [S, N] tiles (host side).
    Returns (ts_pad i64, vals f64, lens i32)."""
    cleaned, maxlen = clean_rows(series, drop_nan)
    N = _next_pow2(maxlen)
    S = len(series)
    ts_pad = np.full((S, N), _TS_PAD, dtype=np.int64)
    vals_pad = np.zeros((S, N), dtype=np.float64)
    lens = np.zeros(S, dtype=np.int32)
    for i, (ts, vals) in enumerate(cleaned):
        n = ts.size
        ts_pad[i, :n] = ts
        vals_pad[i, :n] = vals
        lens[i] = n
    return ts_pad, vals_pad, lens


def _pad_series_rows(ts: np.ndarray, vals: np.ndarray, lens: np.ndarray,
                     s_bucket: int):
    """Pad the series axis to a pow2 bucket: pad rows are
    all-sentinel/empty, produce all-NaN outputs, and are sliced off by the
    caller."""
    S, N = ts.shape
    ts2 = np.full((s_bucket, N), _TS_PAD, dtype=np.int64)
    vals2 = np.zeros((s_bucket, N), dtype=np.float64)
    lens2 = np.zeros(s_bucket, dtype=np.int32)
    ts2[:S] = ts
    vals2[:S] = vals
    lens2[:S] = lens
    return ts2, vals2, lens2


def _window_sample_bound(series, window_ms: int, n_cap: int) -> int:
    """Static upper bound on samples per window: window / min-interval."""
    min_dt = None
    for s in series:
        if s.ts.size >= 2:
            d = np.diff(s.ts).min()
            if d > 0:
                min_dt = d if min_dt is None else min(min_dt, d)
    if min_dt is None or min_dt <= 0:
        return n_cap
    bound = int(window_ms // int(min_dt)) + 2
    return min(_next_pow2(bound, 4), max(n_cap, 4))


# ---------------------------------------------------------------------------
# Device computations (tensor ops)
# ---------------------------------------------------------------------------

def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """[S, N] -> inclusive cumulative sums along each row, added left to
    right whatever S is. On CUDA a scan along the last dim splits each row
    into chunks sized from the number of rows, so a row's rounding would
    depend on the rows stacked with it (a micro-batch); a scan along the
    first dim runs each column on one thread in order. So the rows are
    scanned as the columns of the transpose, as the CPU scans them (for
    S > 1: a single column takes the parallel 1-D scan)."""
    return torch.cumsum(x.T, dim=0).T


def _correction(vals: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Counter-reset correction per sample: cumsum of drop magnitudes."""
    idx = torch.arange(vals.shape[1], device=vals.device)
    valid = idx[None, :] < lens[:, None]
    prev = torch.cat([vals[:, :1], vals[:, :-1]], dim=1)
    dropped = (vals < prev) & valid & (idx[None, :] > 0)
    drops = torch.where(dropped, prev, torch.zeros((), dtype=vals.dtype,
                                                   device=vals.device))
    return _row_cumsum(drops)


def _extrapolated_rate(wstart, wend, counts, t1, v1, t2, v2, is_counter,
                       is_rate):
    """Prometheus extrapolated rate in f64 (rangefn/RateFunctions.scala:37
    semantics). Shape-agnostic: callers broadcast wstart/wend against
    their tile orientation ([S, T] or [T, S])."""
    dev = v1.device
    counts = counts.to(F64)
    dstart = (t1 - wstart).to(F64) / 1000.0
    dend = (wend - t2).to(F64) / 1000.0
    sampled = (t2 - t1).to(F64) / 1000.0
    avg_dur = sampled / (counts - 1.0)
    delta = v2 - v1
    nan = torch.full((), float("nan"), dtype=F64, device=dev)
    if is_counter:
        inf = torch.full((), float("inf"), dtype=F64, device=dev)
        dzero = torch.where((delta > 0) & (v1 >= 0),
                            sampled * (v1 / torch.where(delta == 0, nan,
                                                        delta)),
                            inf)
        dstart = torch.minimum(dstart, dzero)
    thresh = avg_dur * 1.1
    half = avg_dur / 2.0
    extrap = sampled + torch.where(dstart < thresh, dstart, half) \
        + torch.where(dend < thresh, dend, half)
    scaled = delta * (extrap / sampled)
    if is_rate:
        scaled = scaled / (wend - wstart).to(F64) * 1000.0
    return torch.where(counts >= 2, scaled, nan)


def _colify(x):
    """Grid scalars may arrive per row ([S] tensors) when the micro-batcher
    stacks queries with different windows along the series axis; reshape
    those to a broadcastable [S, 1] column (scalars pass through)."""
    return x[:, None] if isinstance(x, torch.Tensor) and x.dim() == 1 else x


def _grid(w0s, w0e, step, nsteps: int, device):
    """The uniform window grid: ([1, T], [1, T]) window starts and ends
    for scalar inputs, ([S, T], [S, T]) for per-row ([S]) inputs."""
    t = torch.arange(nsteps, dtype=I64, device=device)
    step = _colify(step)
    ws = _colify(w0s) + t * step
    we = _colify(w0e) + t * step
    return (ws if ws.dim() == 2 else ws[None, :],
            we if we.dim() == 2 else we[None, :])


def _bounds(ts: torch.Tensor, w0s, w0e, step, nsteps: int):
    """[S, T] window index bounds for a UNIFORM step grid (scalars, or [S]
    per-row grids), by arithmetic window assignment + a per-row histogram
    + cumsum:

    lo[s,t] = #{i: ts[s,i] <  wstart[t]}   (searchsorted side='left')
    hi[s,t] = #{i: ts[s,i] <= wend[t]} - 1 (searchsorted side='right' - 1)
    """
    S, N = ts.shape
    if isinstance(step, torch.Tensor):
        step = _colify(torch.clamp(step, min=1))
    else:
        step = max(int(step), 1)
    w0s, w0e = _colify(w0s), _colify(w0e)
    b_lo = torch.clamp(torch.div(ts - w0s, step, rounding_mode="floor") + 1,
                       0, nsteps)
    b_hi = torch.clamp(-torch.div(w0e - ts, step, rounding_mode="floor"),
                       0, nsteps)
    ones = torch.ones((S, N), dtype=I64, device=ts.device)
    hist_lo = torch.zeros((S, nsteps + 1), dtype=I64, device=ts.device)
    hist_hi = torch.zeros((S, nsteps + 1), dtype=I64, device=ts.device)
    hist_lo.scatter_add_(1, b_lo, ones)
    hist_hi.scatter_add_(1, b_hi, ones)
    lo = torch.cumsum(hist_lo, dim=1)[:, :nsteps]
    hi = torch.cumsum(hist_hi, dim=1)[:, :nsteps] - 1
    return lo, hi


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(arr, 1, idx)


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """[S, N] -> [S, N+1] exclusive prefix sums."""
    return torch.cat([torch.zeros((x.shape[0], 1), dtype=x.dtype,
                                  device=x.device),
                      _row_cumsum(x)], dim=1)


def _window_endpoint(func: str, ts, vals, lens, w0s, w0e, step,
                     nsteps: int) -> torch.Tensor:
    """Endpoint + prefix-sum family over padded [S, N] i64/f64 tiles on a
    uniform window grid (wstart[t] = w0s + t*step, wend[t] = w0e + t*step)
    -> [S, T] f64. The grid arguments may instead be [S] tensors, one grid
    per row (the micro-batcher's stacked queries); every op is row-local,
    so a stacked row's output is bit for bit the single query's."""
    S, N = ts.shape
    dev = ts.device
    ws2, we2 = _grid(w0s, w0e, step, nsteps, dev)
    lo, hi = _bounds(ts, w0s, w0e, step, nsteps)
    counts = hi - lo + 1
    has = counts >= 1
    lo_c = torch.clamp(lo, 0, N - 1)
    hi_c = torch.clamp(hi, 0, N - 1)
    nan = torch.full((), float("nan"), dtype=F64, device=dev)
    zero = torch.zeros((), dtype=F64, device=dev)
    one = torch.ones((), dtype=F64, device=dev)

    if func in _ENDPOINT_RATE:
        counter, is_rate = _ENDPOINT_RATE[func]
        v = vals + _correction(vals, lens) if counter else vals
        out = _extrapolated_rate(ws2, we2, counts,
                                 _take(ts, lo_c), _take(v, lo_c),
                                 _take(ts, hi_c), _take(v, hi_c),
                                 counter, is_rate)
        return torch.where(has, out, nan)

    if func in ("irate", "idelta"):
        ok = counts >= 2
        hi2 = torch.clamp(hi, 1, N - 1)
        v2 = _take(vals, hi2)
        v1 = _take(vals, hi2 - 1)
        dv = v2 - v1
        if func == "irate":
            dv = torch.where(dv < 0, v2, dv)
            dt = (_take(ts, hi2) - _take(ts, hi2 - 1)).to(F64) / 1000.0
            res = dv / torch.where(dt == 0, nan, dt)
        else:
            res = dv
        return torch.where(ok, res, nan)

    if func in ("last_sample", "last_over_time"):
        return torch.where(has, _take(vals, hi_c), nan)
    if func == "first_over_time":
        return torch.where(has, _take(vals, lo_c), nan)
    if func == "timestamp":
        return torch.where(has, _take(ts, hi_c).to(F64) / 1000.0, nan)
    if func == "present_over_time":
        return torch.where(has, one, nan)
    if func == "absent_over_time":
        return torch.where(has, nan, one)

    if func in ("changes", "resets"):
        prev = torch.cat([vals[:, :1], vals[:, :-1]], dim=1)
        idx = torch.arange(N, device=dev)
        valid = (idx[None, :] < lens[:, None]) & (idx[None, :] > 0)
        if func == "changes":
            ev = (vals != prev) & valid
        else:
            ev = (vals < prev) & valid
        cs = _prefix(ev.to(F64))
        lo1 = torch.clamp(lo + 1, 0, N)
        out = _take(cs, torch.clamp(hi + 1, 0, N)) - _take(cs, lo1)
        return torch.where(has, out, nan)

    # prefix-sum family
    hi1 = torch.clamp(hi + 1, 0, N)
    lo0 = torch.clamp(lo, 0, N)
    cs = _prefix(vals)
    s = _take(cs, hi1) - _take(cs, lo0)
    cnt = counts.to(F64)
    if func in ("sum_over_time", "increase_over_delta"):
        out = s
    elif func == "rate_over_delta":
        out = s / (we2 - ws2) * 1000.0
    elif func == "count_over_time":
        out = cnt
    elif func == "avg_over_time":
        out = s / cnt
    else:
        # E[x^2] - mean^2, as the reference's packed path computes it
        # (unshifted: see ROADMAP C on its cancellation at large offsets)
        cs2 = _prefix(vals * vals)
        s2 = _take(cs2, hi1) - _take(cs2, lo0)
        mean = s / cnt
        var = torch.maximum(s2 / cnt - mean * mean, zero)
        if func == "stdvar_over_time":
            out = var
        elif func == "stddev_over_time":
            out = torch.sqrt(var)
        elif func == "z_score":
            out = (_take(vals, hi_c) - mean) / torch.sqrt(var)
        else:
            raise ValueError(f"unhandled device func {func}")
    return torch.where(has, out, nan)


# Budget for the [S, T, W] intermediates of one _window_gather chunk, and
# the most bytes per [S, T, W] element alive at once (the i64 window index,
# the mask, the gathered f64 values, the masked f64 copy, and for quantile
# the sorted f64 values with their i64 indices plus the sort's scratch).
GATHER_BUDGET_BYTES = 2 << 30
_GATHER_ELT_BYTES = 64


def _gather_rows(func: str, w_bound: int, ts, vals, lens, w0s, w0e, step,
                 nsteps: int, scalar: float) -> torch.Tensor:
    """_window_gather on one chunk of rows."""
    S, N = ts.shape
    dev = ts.device
    nan = torch.full((), float("nan"), dtype=F64, device=dev)
    inf = torch.full((), float("inf"), dtype=F64, device=dev)
    lo, hi = _bounds(ts, w0s, w0e, step, nsteps)   # [S, T]
    has = hi >= lo
    offs = torch.arange(w_bound, device=dev)
    gidx = lo[:, :, None] + offs[None, None, :]    # [S, T, W]
    in_win = (gidx <= hi[:, :, None]) & (gidx < lens[:, None, None])
    gidx.clamp_(0, N - 1)
    g = _take(vals, gidx.reshape(S, -1)).reshape(gidx.shape)
    del gidx
    if func == "min_over_time":
        out = torch.amin(torch.where(in_win, g, inf), dim=2)
        out = torch.where(torch.isinf(out), nan, out)
    elif func == "max_over_time":
        out = torch.amax(torch.where(in_win, g, -inf), dim=2)
        out = torch.where(torch.isinf(out), nan, out)
    elif func == "quantile_over_time":
        q = min(max(scalar, 0.0), 1.0)
        big = torch.where(in_win, g, inf)
        del g
        srt = torch.sort(big, dim=2).values        # valid values first
        del big
        cnt = in_win.sum(dim=2)                    # [S, T]
        rank = q * (cnt - 1).to(F64)
        lo_r = torch.floor(rank).to(I64)
        hi_r = torch.ceil(rank).to(I64)
        frac = rank - lo_r
        v_lo = torch.gather(srt, 2, torch.clamp(lo_r, 0, w_bound - 1)
                            [..., None])[..., 0]
        v_hi = torch.gather(srt, 2, torch.clamp(hi_r, 0, w_bound - 1)
                            [..., None])[..., 0]
        out = v_lo + (v_hi - v_lo) * frac
        out = torch.where(cnt > 0, out, nan)
        if scalar > 1:
            out = torch.full_like(out, float("inf"))
        if scalar < 0:
            out = torch.full_like(out, float("-inf"))
    else:
        raise ValueError(f"unhandled gather func {func}")
    return torch.where(has, out, nan)


def _window_gather(func: str, w_bound: int, ts, vals, lens, w0s, w0e, step,
                   nsteps: int, scalar: float) -> torch.Tensor:
    """Order-statistic family (min/max/quantile_over_time; ``scalar`` is
    quantile's q): gather [S, T, W] window tiles, reduce over W -> [S, T]
    f64. W (``w_bound``) bounds the samples per window; the grid arguments
    are scalars or [S] per-row tensors, as for _window_endpoint. Every op
    is row-local, so the series axis is cut into chunks whose
    intermediates fit GATHER_BUDGET_BYTES (per-row grids cut with their
    rows): the answers are those of one pass."""
    S = ts.shape[0]
    rows = max(1, GATHER_BUDGET_BYTES
               // (nsteps * w_bound * _GATHER_ELT_BYTES))

    def cut(x, i):
        return x[i:i + rows] if isinstance(x, torch.Tensor) \
            and x.dim() == 1 else x

    return torch.cat([
        _gather_rows(func, w_bound, ts[i:i + rows], vals[i:i + rows],
                     lens[i:i + rows], cut(w0s, i), cut(w0e, i),
                     cut(step, i), nsteps, scalar)
        for i in range(0, S, rows)], dim=0)


_GATHER_FUNCS = frozenset({"min_over_time", "max_over_time",
                           "quantile_over_time"})


def _extract_rate(func: str, ts, vals, lens, w0s: int, w0e: int,
                  step: int, nsteps: int) -> torch.Tensor:
    """Rate family through the boundary-extract kernel: counter
    correction + exact f64 -> 3xf32 split in, f64 extrapolation out."""
    S, N = ts.shape
    dev = ts.device
    in_len = torch.arange(N, device=dev)[None, :] < lens[:, None]
    is_counter = func != "delta"
    v = vals + _correction(vals, lens) if is_counter else vals
    pad = torch.full((), int(kn.TR_PAD), dtype=I64, device=dev)
    tr = torch.where(in_len, ts - w0s, pad).to(torch.int32)
    pay = kn.split3(torch.where(in_len, v, torch.zeros((), dtype=F64,
                                                       device=dev)))
    cnt, tlo, thi, plo, phi = kn.window_extract(
        tr.contiguous(), pay.contiguous(), step, w0e - w0s, nsteps)
    t = torch.arange(nsteps, dtype=I64, device=dev)
    wstart = w0s + t * step
    wend = w0e + t * step
    t1 = tlo.to(I64) + w0s
    t2 = thi.to(I64) + w0s
    v1 = kn.combine3(plo)
    v2 = kn.combine3(phi)
    out = _extrapolated_rate(wstart[None, :], wend[None, :], cnt, t1, v1,
                             t2, v2, is_counter, func == "rate")
    return torch.where(cnt >= 1, out, torch.full((), float("nan"),
                                                 dtype=F64, device=dev))


def _extract_span_ok(ts: np.ndarray, lens: np.ndarray, w0s: int, w0e: int,
                     step: int, nsteps: int) -> Optional[bool]:
    """Whether the packed grid fits the kernel's int31 relative times;
    None when there are no samples at all."""
    mask = np.arange(ts.shape[1])[None, :] < lens[:, None]
    if not mask.any():
        return None
    t_min, t_max = int(ts[mask].min()), int(ts[mask].max())
    return (abs(t_min - w0s) < 2**31 - 2
            and abs(t_max - w0s) < 2**31 - 2
            and (w0e - w0s) + (nsteps - 1) * step < 2**31 - 2)


class _TileEntry:
    """One tile-cache entry: device tiles over an immutable prefix, whether
    that prefix holds a NaN stale marker, the series it was built from
    when the key is object identity (so ids cannot be recycled), the
    coverage bound that makes stale serves correct (first ms NOT in the
    tiles; None = all) and the selection identity it is filed under."""

    __slots__ = ("tiles", "idx", "prefix_has_nan", "refs", "cov_min_ms",
                 "ident_key")

    def __init__(self, tiles, idx, prefix_has_nan, refs, cov_min_ms,
                 ident_key=None):
        self.tiles = tiles
        self.idx = idx
        self.prefix_has_nan = prefix_has_nan
        self.refs = refs
        self.cov_min_ms = cov_min_ms
        self.ident_key = ident_key


class _PackedMember:
    """One query's packed tile and grid scalars inside a packed batch."""

    __slots__ = ("ts", "vals", "lens", "w0s", "w0e", "step", "nsteps",
                 "w_bound")

    def __init__(self, ts, vals, lens, w0s, w0e, step, nsteps, w_bound):
        self.ts = ts
        self.vals = vals
        self.lens = lens
        self.w0s = w0s
        self.w0e = w0e
        self.step = step
        self.nsteps = nsteps
        self.w_bound = w_bound


# position of the chunk count in each snapshot-key layout the engine
# attaches: select_raw_series' (ds, shard, part, num_chunks, col) and
# select_span_series' (node, ds, shard, part, num_chunks, col, start, end)
_CHUNK_COUNT_AT = {5: 3, 8: 4}


def _selection_ident(series) -> Optional[Tuple]:
    """The selection's identity across flushes: every snapshot key with its
    chunk count taken out (None when a key has another layout, which then
    never serves stale tiles)."""
    out = []
    for s in series:
        at = _CHUNK_COUNT_AT.get(len(s.snapshot_key))
        if at is None:
            return None
        out.append(s.snapshot_key[:at] + s.snapshot_key[at + 1:])
    return tuple(out)


_COUNTER_FUNCS = ("rate", "increase", "delta")


class TorchBackend:
    """Pluggable device backend for QueryEngine, in PyTorch.

    ``device=None`` means CUDA, and raises when no CUDA device is present;
    pass ``device="cpu"`` to run the plain versions on the CPU.

    ``batcher`` (query/batcher.py ``MicroBatcher``, built for the device
    by default) is the serving fast path's admission layer: concurrent
    queries with the same batch key share one device dispatch, along the
    grid axis for the aligned evaluators and along the series axis for
    the packed path. It also gives the tile cache its background
    rebuilds. Pass ``batcher=None`` or ``MicroBatcher(enabled=False)`` to
    take the single-query paths only; whoever owns the backend calls
    ``batcher.executor.stop()`` before the process exits. No mesh yet."""

    _TILE_CACHE_MAX = 16

    def __init__(self, device=None, batcher: Optional[object] = "default"):
        self.device = tst.resolve_device(device)
        self._tile_cache: Dict = {}
        # guards cache get/insert/evict against concurrent query threads
        # (a FIFO evict could KeyError, inserts overshoot the cap)
        self._tile_lock = threading.Lock()
        # selection identity (snapshot keys minus chunk counts) -> the
        # latest cache key: lets a post-flush query serve the previous
        # snapshot's tiles while the rebuild runs in the background
        self._tile_ident: Dict = {}
        self._tile_refreshing: set = set()
        self._count_lock = threading.Lock()
        self.tile_builds = 0    # observability: device tile (re)builds
        self.tile_hits = 0      # observability: cache hits (stale included)
        self.fused_aggs = 0     # observability: fused group-sum queries
        self.packed_dispatches = 0   # observability: packed-path dispatches
        self.aligned_evals = 0  # observability: evaluate_aligned(_batch)
        if batcher == "default":
            batcher = MicroBatcher(device=self.device)
        self.batcher = batcher

    def _count(self, name: str, n: int = 1) -> None:
        with self._count_lock:
            setattr(self, name, getattr(self, name) + n)

    # -- engine hooks ------------------------------------------------------

    def periodic_samples(self, series: Sequence[RawSeries],
                         params: RangeParams, function: str, window_ms: int,
                         func_args: Sequence[float] = (),
                         offset_ms: int = 0) -> Optional[GridResult]:
        """[S, T] grid of a DEVICE_FUNCS function, or None (the engine's
        oracle answers: other functions, histograms, empty selections)."""
        func = function or "last_sample"
        if func not in DEVICE_FUNCS or not series:
            return None
        if any(s.values.ndim != 1 for s in series):
            return None
        steps = params.steps
        nsteps = steps.size
        keys = [dict(s.labels) for s in series]
        if nsteps == 0:
            return GridResult(steps, keys,
                              np.empty((len(series), 0), dtype=np.float64))
        if self.batcher is not None:
            self.batcher.enter()
        try:
            aligned = self._try_aligned(series, func, steps, params.step_ms,
                                        window_ms, offset_ms)
            if aligned is not None:
                return GridResult(steps, keys, aligned)
            out = self._general(series, func, steps, params.step_ms,
                                window_ms, offset_ms, func_args)
        finally:
            if self.batcher is not None:
                self.batcher.exit()
        return GridResult(steps, keys, out)

    def fused_groupsum(self, series, func: str, steps: np.ndarray,
                       window_ms: int, offset_ms: int,
                       gids: np.ndarray, G: int):
        """`sum/avg/count by (g)` of rate/increase/delta fused on the
        device: the group-sum kernel consumes the cached aligned tiles and
        only [T, G] group sums + counts leave the device. Returns (sums,
        cnts) as [T, G] numpy, or None when ineligible (the engine falls
        back to periodic_samples + grouping over the same selection)."""
        if func not in _COUNTER_FUNCS or not len(series):
            return None
        entry = self._tile_entry(series)
        tiles, idx = entry.tiles, entry.idx
        if tiles is None or len(idx) != len(series):
            return None
        # every window must resolve on the tiles' covered prefix: fused
        # results can't splice a host-side tail scan per group (a stale
        # entry serving across a flush covers less than the current chunk
        # prefix: cov_min_ms is the binding bound)
        if entry.cov_min_ms is not None and steps.size and \
                int(steps[-1] - offset_ms) >= entry.cov_min_ms:
            return None
        for s in series:
            cl = self._prefix_len(s)
            if cl < s.ts.size and steps.size and \
                    int(steps[-1] - offset_ms) >= int(s.ts[cl]):
                return None
        gvec = np.asarray(gids)[np.asarray(idx)]
        onehot = np.zeros((len(series), G), np.float32)
        onehot[np.arange(len(series)), gvec] = 1.0
        res = tst.groupsum_counters(tiles, func, steps, window_ms, onehot,
                                    offset_ms)
        if res is None:
            return None
        self._count("fused_aggs")
        return res[0].cpu().numpy(), res[1].cpu().numpy()

    # -- tile cache ----------------------------------------------------------

    @staticmethod
    def _prefix_len(s) -> int:
        return s.chunk_len if s.chunk_len >= 0 else s.ts.size

    def _build_tile_entry(self, series, use_snap: bool) -> _TileEntry:
        """Tiles over the series' immutable chunk prefixes. ``cov_min_ms``
        is the first timestamp NOT covered (None = full coverage):
        consumers route steps whose windows reach past it through the
        packed path, which is what makes serving a STALE entry correct
        while a flush's rebuild runs in the background."""
        prefix = [
            RawSeries(s.labels, s.ts[:self._prefix_len(s)],
                      s.values[:self._prefix_len(s)], s.is_counter,
                      s.bucket_les)
            for s in series
        ]
        cov_min = None
        for s in series:
            cl = self._prefix_len(s)
            if cl < s.ts.size:
                tm = int(s.ts[cl])
                cov_min = tm if cov_min is None else min(cov_min, tm)
        tiles, idx = tst.build_aligned_tiles(prefix, device=self.device)
        self._count("tile_builds")
        prefix_has_nan = any(np.isnan(p.values).any() for p in prefix)
        return _TileEntry(tiles, idx, prefix_has_nan,
                          None if use_snap else list(series), cov_min)

    def _insert_tile_entry(self, key, ident, entry: _TileEntry) -> None:
        # a key already cached (two threads built it at once) is replaced
        # in place: evicting for it would drop a live entry
        with self._tile_lock:
            while key not in self._tile_cache \
                    and len(self._tile_cache) >= self._TILE_CACHE_MAX:
                old_key = next(iter(self._tile_cache))
                old = self._tile_cache.pop(old_key)
                if self._tile_ident.get(old.ident_key) == old_key:
                    self._tile_ident.pop(old.ident_key, None)
            entry.ident_key = ident
            self._tile_cache[key] = entry
            if ident is not None:
                self._tile_ident[ident] = key

    def _tile_entry(self, series) -> _TileEntry:
        """Cache of tiles built over each series' IMMUTABLE chunk prefix.
        Keyed by store snapshot keys when the selection carries them
        (pinned content: hits until a flush publishes new chunks), else by
        object identity (holding the series so ids can't be recycled).
        Bounded FIFO.

        After a flush the key changes. The PREVIOUS snapshot's entry for
        the same selection identity (the same partitions and column, chunk
        counts taken out) keeps serving, its ``cov_min_ms`` bounding the
        device steps, while the rebuild runs once per key on the batcher's
        executor at background priority; queries swap to the fresh tiles
        when it lands. Without a batcher the rebuild runs inline."""
        use_snap = all(s.snapshot_key is not None for s in series)
        if use_snap:
            key = tuple(s.snapshot_key for s in series)
            ident = _selection_ident(series)
        else:
            key = tuple(id(s) for s in series)
            ident = None
        with self._tile_lock:
            entry = self._tile_cache.get(key)
            stale = None
            if entry is None and ident is not None:
                old_key = self._tile_ident.get(ident)
                if old_key is not None:
                    stale = self._tile_cache.get(old_key)
        if entry is not None:
            self._count("tile_hits")
            return entry
        if stale is not None and self.batcher is not None:
            self._count("tile_hits")
            with self._tile_lock:
                if key in self._tile_refreshing:
                    return stale
                self._tile_refreshing.add(key)
            held = list(series)     # pin arrays until the rebuild lands

            def refresh():
                try:
                    self._insert_tile_entry(
                        key, ident, self._build_tile_entry(held, use_snap))
                finally:
                    with self._tile_lock:
                        self._tile_refreshing.discard(key)
            # background class: a rebuild improves FUTURE queries and must
            # never delay a queued interactive dispatch
            self.batcher.executor.submit(refresh,
                                         priority=qos.PRIORITY_BACKGROUND)
            return stale
        entry = self._build_tile_entry(series, use_snap)
        self._insert_tile_entry(key, ident, entry)
        return entry

    # -- aligned path ------------------------------------------------------

    def _try_aligned(self, series, func: str, steps: np.ndarray,
                     step_ms: int, window_ms: int,
                     offset_ms: int) -> Optional[np.ndarray]:
        """Aligned-tile path: regular-cadence series over cached tiles
        (the counter family by evaluate_counters_t, every other function
        of ALIGNED_FUNCS by evaluate_aligned). Tiles cover only published
        chunks (and, for a stale entry, only what was published when it
        was built); steps whose window reaches past that are computed by
        the packed path over the live data and spliced on."""
        if func not in tst.ALIGNED_FUNCS:
            return None
        entry = self._tile_entry(series)
        tiles, idx = entry.tiles, entry.idx
        if func == "last_sample":
            # stale markers must stay visible to the step; the immutable
            # prefix's flag is cached with the tiles, only tails re-scan
            if entry.prefix_has_nan or any(
                    np.isnan(s.values[self._prefix_len(s):]).any()
                    for s in series):
                return None
        if tiles is None or len(idx) != len(series):
            return None     # partial alignment: keep one result path
        tail_min = entry.cov_min_ms
        for s in series:
            cl = self._prefix_len(s)
            if cl < s.ts.size:
                tm = int(s.ts[cl])
                tail_min = tm if tail_min is None else min(tail_min, tm)
        wends = steps - offset_ms
        t_dev = (steps.size if tail_min is None
                 else int(np.searchsorted(wends, tail_min, side="left")))
        if t_dev == 0:
            return None     # every window touches live data
        res = self._aligned_dispatch(tiles, func, steps[:t_dev], window_ms,
                                     offset_ms)
        if len(idx) != res.shape[0]:
            return None
        # restore original series order (build may drop/reorder rows)
        full = np.empty((len(series), steps.size), dtype=np.float64)
        dev = np.empty((len(series), t_dev), dtype=np.float64)
        dev[np.asarray(idx)] = res
        full[:, :t_dev] = dev
        if t_dev < steps.size:
            full[:, t_dev:] = self._general(series, func, steps[t_dev:],
                                            step_ms, window_ms, offset_ms)
        return full

    def _aligned_dispatch(self, tiles, func: str, steps: np.ndarray,
                          window_ms: int, offset_ms: int) -> np.ndarray:
        """Aligned evaluation -> [S, T] numpy. With the batcher on,
        concurrent queries over the SAME cached tiles that share (func,
        step count, step, window, counter family) run as one batched
        evaluation along the grid axis; a lone query (or batcher off) takes
        the scalar evaluator."""
        nsteps = steps.size
        family = (tst.counters_batch_family(tiles, func, steps, window_ms,
                                            offset_ms)
                  if func in _COUNTER_FUNCS else None)
        w0e = int(steps[0] - offset_ms)
        w0s = w0e - int(window_ms)
        step = int(steps[1] - steps[0]) if nsteps > 1 else 1
        run = functools.partial(self._aligned_run, tiles, func, family,
                                nsteps, step, window_ms, offset_ms)
        b = self.batcher
        if b is not None and b.enabled:
            # id(tiles) is safe in the key: members hold the tiles, so the
            # id cannot be recycled while the batch is open
            key = ("aligned", id(tiles), func, nsteps, step, window_ms,
                   family)
            return b.submit(key, (w0s, w0e, steps, tiles), run)
        return run([(w0s, w0e, steps, tiles)]).get(0)

    def _aligned_run(self, tiles, func: str, family, nsteps: int, step: int,
                     window_ms: int, offset_ms: int,
                     members) -> SplitResult:
        """One aligned batch: B = 1 takes the scalar evaluator, B >= 2 one
        batched evaluation computing every member's grid."""
        counters = func in _COUNTER_FUNCS
        if not counters:
            self._count("aligned_evals")
        if len(members) == 1:
            steps0 = members[0][2]
            if counters:
                return SplitResult(
                    tst.evaluate_counters_t(tiles, func, steps0, window_ms,
                                            offset_ms), 1,
                    split=lambda h, i: h.T)
            return SplitResult(
                tst.evaluate_aligned(tiles, func, steps0, window_ms,
                                     offset_ms), 1, split=lambda h, i: h)
        w0s_list = [m[0] for m in members]
        w0e_list = [m[1] for m in members]
        if counters:
            # [B, T, S] -> member i's [S, T]
            return SplitResult(
                tst.evaluate_counters_t_batch(tiles, func, family, nsteps,
                                              step, w0s_list, w0e_list),
                len(members), split=lambda h, i: h[i].T)
        return SplitResult(
            tst.evaluate_aligned_batch(tiles, func, nsteps, step, w0s_list,
                                       w0e_list), len(members))

    # -- packed path -------------------------------------------------------

    def _general(self, series, func: str, steps: np.ndarray, step_ms: int,
                 window_ms: int, offset_ms: int, func_args=()) -> np.ndarray:
        """Packed path (any cadence) over padded [S, N] tiles. ``steps``
        may be any contiguous slice of a uniform grid. Host-side packing
        runs on the calling thread; under the batcher it overlaps the
        device work of the previous batch."""
        from filodb_tpu_torch.query.engine import clip_series

        nsteps = steps.size
        w0e = int(steps[0] - offset_ms)
        w0s = w0e - int(window_ms)
        step = int(step_ms if nsteps > 1 else 1)
        # pack only the span the grid can touch
        series = clip_series(series, w0s, int(steps[-1] - offset_ms))
        # the instant selector keeps NaNs: a stale marker makes its step
        # stale
        ts, vals, lens = pack_series(series,
                                     drop_nan=func != "last_sample")
        scalar = float(func_args[0]) if func_args else 0.0
        w_bound = (_window_sample_bound(series, window_ms, ts.shape[1])
                   if func in _GATHER_FUNCS else 0)
        b = self.batcher
        if b is not None and b.enabled:
            # concurrent queries sharing (func, N, T bucket) stack along
            # the series axis and run as ONE dispatch
            t_bucket = _next_pow2(nsteps, 8)
            key = ("packed", func, ts.shape[1], t_bucket,
                   func != "last_sample", scalar)
            member = _PackedMember(ts, vals, lens, w0s, w0e, step, nsteps,
                                   w_bound)
            return b.submit(key, member, functools.partial(
                self._packed_run, func, t_bucket, scalar))
        return self._packed_single(func, ts, vals, lens, w0s, w0e, step,
                                   nsteps, scalar, w_bound)

    def _packed_single(self, func: str, ts, vals, lens, w0s: int, w0e: int,
                       step: int, nsteps: int, scalar: float,
                       w_bound: int) -> np.ndarray:
        """One packed dispatch with pow2 bucketing of the series axis (and
        of the step axis off the boundary-extract path): the order
        statistics by _window_gather; the rate family by the
        boundary-extract kernel when the span fits int31 ms; everything
        else (and the rate family past int31 ms) by _window_endpoint."""
        S, N = ts.shape
        s_bucket = _next_pow2(S, 8)
        if s_bucket != S:
            ts, vals, lens = _pad_series_rows(ts, vals, lens, s_bucket)
        self._count("packed_dispatches")
        dev = self.device
        ts_t = torch.as_tensor(ts, device=dev)
        vals_t = torch.as_tensor(vals, device=dev)
        lens_t = torch.as_tensor(lens, device=dev)
        if func in _ENDPOINT_RATE and _extract_span_ok(ts, lens, w0s, w0e,
                                                       step, nsteps):
            out = _extract_rate(func, ts_t, vals_t, lens_t, w0s, w0e, step,
                                nsteps)
            return out.cpu().numpy()[:S]
        t_bucket = _next_pow2(nsteps, 8)
        if func in _GATHER_FUNCS:
            out = _window_gather(func, w_bound, ts_t, vals_t, lens_t, w0s,
                                 w0e, step, t_bucket, scalar)
        else:
            out = _window_endpoint(func, ts_t, vals_t, lens_t, w0s, w0e,
                                   step, t_bucket)
        return out.cpu().numpy()[:S, :nsteps]

    def _packed_run(self, func: str, t_bucket: int, scalar: float,
                    members) -> SplitResult:
        """One packed batch: member tiles stacked along the series axis,
        ONE dispatch with per-row grid vectors, split by segment offsets.
        A batch of one takes the single-query path (and so the
        boundary-extract kernel for the rate family). Eager PyTorch
        compiles nothing, so the stack is not padded to a bucket."""
        if len(members) == 1:
            m = members[0]
            out = self._packed_single(func, m.ts, m.vals, m.lens, m.w0s,
                                      m.w0e, m.step, m.nsteps, scalar,
                                      m.w_bound)
            return SplitResult(out, 1, split=lambda h, i: h)
        sizes = [m.ts.shape[0] for m in members]
        offs = np.cumsum([0] + sizes)
        dev = self.device

        def rows(attr, dtype):
            # each member copied to the device as it is, then stacked
            # there: a host-side concatenation of the padded tiles first
            # cost more than the batched dispatch saved
            return torch.cat([torch.as_tensor(np.asarray(getattr(m, attr),
                                                         dtype), device=dev)
                              for m in members])

        def per_row(attr):
            return torch.as_tensor(np.repeat(
                np.array([getattr(m, attr) for m in members], np.int64),
                sizes), device=dev)

        ts, vals, lens = (rows("ts", np.int64), rows("vals", np.float64),
                          rows("lens", np.int32))
        w0s_v, w0e_v, step_v = per_row("w0s"), per_row("w0e"), \
            per_row("step")
        self._count("packed_dispatches")
        if func in _GATHER_FUNCS:
            w_bound = max(m.w_bound for m in members)
            out = _window_gather(func, w_bound, ts, vals, lens, w0s_v, w0e_v,
                                 step_v, t_bucket, scalar)
        else:
            # rate-family members ride _window_endpoint here (the
            # boundary-extract kernel takes scalar grids)
            out = _window_endpoint(func, ts, vals, lens, w0s_v, w0e_v,
                                   step_v, t_bucket)
        nst = [m.nsteps for m in members]

        def split(host: np.ndarray, i: int) -> np.ndarray:
            o = int(offs[i])
            return host[o:o + sizes[i], :nst[i]]

        return SplitResult(out, len(members), split=split)
