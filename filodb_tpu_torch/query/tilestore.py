"""Aligned device tiles and their evaluators, in PyTorch (counterpart
of ``filodb_tpu.query.tilestore``).

Each series of a cohort sharing one scrape cadence ``dt`` is a row of a
cadence-aligned tile: slot ``i`` nominally holds the sample scraped at
``base + i*dt``. Every window boundary then maps to the SAME slot column for
all series (+/-1 for scrape jitter), so the windowed evaluators read shared
rows instead of per-series gathers:

  * pack time (once per tile build): validity mask, true timestamps,
    counter-reset correction (``cv``), forward/backward fills, prefix sums,
    the slot-major ``[N, S]`` transposes and the stride-permuted layouts;
  * query time: boundary slots from closed-form arithmetic, 2-candidate
    jitter resolution and the Prometheus extrapolation epilogue.

``evaluate_aligned`` serves every other function of ``ALIGNED_FUNCS``
(endpoint selections and prefix-sum windows over row-major tiles).
``groupsum_counters`` feeds the hand-written group-sum kernel
(``query/kernels.counter_groupsum``). Series that do not fit a shared
cadence take the packed path of ``query/backend.py``.

PyTorch runs eagerly, so the reference's compiled-executable dispatch
tables have no counterpart here: each evaluator is called directly.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from filodb_tpu_torch.query import kernels as kn
from filodb_tpu_torch.query.model import RawSeries

F64 = torch.float64
F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

_SENT_LO = -(2 ** 31)           # "no sample at or before this slot"
_SENT_HI = 2 ** 31 - 1          # "no sample at or after this slot"

ArrayLike = Union[np.ndarray, torch.Tensor]

# functions servable from aligned tiles (everything endpoint- or
# prefix-sum-expressible; order statistics take the packed gather path)
ALIGNED_FUNCS = frozenset({
    "rate", "increase", "delta",
    "sum_over_time", "count_over_time", "avg_over_time",
    "stddev_over_time", "stdvar_over_time", "z_score",
    "changes", "resets", "timestamp",
    "last_sample", "last_over_time", "first_over_time",
    "present_over_time", "absent_over_time",
    "rate_over_delta", "increase_over_delta",
})


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent;
    there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    return dev


def _ffill_idx(valid: torch.Tensor) -> torch.Tensor:
    """[S,N] bool -> j_last[s,i] = last valid slot <= i (-1 if none)."""
    idx = torch.arange(valid.shape[1], dtype=I64, device=valid.device)
    neg = torch.full((), -1, dtype=I64, device=valid.device)
    return torch.cummax(torch.where(valid, idx[None, :], neg), dim=1).values


def _nan_col(src: torch.Tensor) -> torch.Tensor:
    return torch.full_like(src[:, :1], float("nan"))


class AlignedTiles:
    """One cohort of series sharing cadence dt, as device tiles.

    ``valid``/``ts_true``/``vals`` are [S, N] arrays (numpy or tensors);
    they are moved to ``device`` (default: the device of a tensor input,
    else CUDA)."""

    def __init__(self, keys: List[Dict[str, str]], base_ms: int, dt_ms: int,
                 valid: ArrayLike, ts_true: ArrayLike, vals: ArrayLike,
                 device=None):
        if device is None and isinstance(valid, torch.Tensor):
            device = valid.device
        dev = resolve_device(device)
        self.device = dev
        self.keys = keys
        self.base_ms = int(base_ms)          # time of slot 0
        self.dt_ms = int(dt_ms)
        valid_t = torch.as_tensor(valid, device=dev).to(torch.bool)
        S, N = valid_t.shape
        self.num_slots = N
        self.valid = valid_t
        # true timestamps as f64 ms (exact to 2^53); invalid -> NaN so
        # boundary conditions (ts <= wend) are false on gaps
        nan = torch.full((), float("nan"), dtype=F64, device=dev)
        self.ts = torch.where(valid_t, torch.as_tensor(ts_true, device=dev)
                              .to(F64), nan)
        self.vals = torch.where(valid_t, torch.as_tensor(vals, device=dev)
                                .to(F64), torch.zeros((), dtype=F64,
                                                      device=dev))
        self._channels: Dict[str, torch.Tensor] = {}
        self._ff: Dict[str, torch.Tensor] = {}
        self._bf: Dict[str, torch.Tensor] = {}
        self._ps: Dict[str, torch.Tensor] = {}
        self._tch: Dict[str, torch.Tensor] = {}
        self._tff: Dict[str, torch.Tensor] = {}
        self._tbf: Dict[str, torch.Tensor] = {}
        self._tps: Dict[str, torch.Tensor] = {}
        self._tperm: Dict[Tuple, object] = {}
        self._jitter = None
        self._jl = None
        self._jf = None
        self._dense = bool(valid_t.all())

    # -- pack-time derived channels (cached) ---------------------------------

    def channel(self, name: str) -> torch.Tensor:
        """Per-slot f64 channel (0 at invalid slots)."""
        c = self._channels.get(name)
        if c is not None:
            return c
        v, valid = self.vals, self.valid
        zero = torch.zeros((), dtype=F64, device=self.device)
        if name == "v":
            c = v
        elif name == "ones":
            c = valid.to(F64)
        elif name == "vc2":
            # squared deviation from a per-series shift (the series mean):
            # windowed variance from prefix sums of (x-c)^2 avoids the
            # catastrophic cancellation of the E[x^2]-mean^2 form
            d = torch.where(valid, v - self.vshift[:, None], zero)
            c = d * d
        elif name == "cv":                      # counter-reset corrected
            prev = self.ff("v")[:, :-1]
            prev = torch.cat([_nan_col(prev), prev], dim=1)
            drop = valid & (v < prev) & ~torch.isnan(prev)
            c = v + torch.cumsum(torch.where(drop, prev, zero), dim=1)
            c = torch.where(valid, c, zero)
        elif name in ("ev_change", "ev_reset"):
            # event vs the previous valid sample, attributed to the later
            # one (changes()/resets() semantics)
            prev = self.ff("v")[:, :-1]
            prev = torch.cat([_nan_col(prev), prev], dim=1)
            if name == "ev_change":
                ev = valid & (v != prev) & ~torch.isnan(prev)
            else:
                ev = valid & (v < prev) & ~torch.isnan(prev)
            c = ev.to(F64)
        else:
            raise KeyError(name)
        self._channels[name] = c
        return c

    @property
    def vshift(self) -> torch.Tensor:
        """Per-series shift for stable variance: mean of valid samples."""
        c = self._channels.get("_vshift")
        if c is None:
            okf = self.valid & torch.isfinite(self.vals)
            cnt = torch.clamp(okf.sum(dim=1), min=1)
            c = torch.where(okf, self.vals, torch.zeros(
                (), dtype=F64, device=self.device)).sum(dim=1) / cnt
            self._channels["_vshift"] = c
        return c

    def ff(self, name: str) -> torch.Tensor:
        """Forward fill: channel value at last valid slot <= i (NaN none)."""
        if self._dense:
            # fully-valid tiles: the fill is the channel itself (aliased)
            return self.ts if name == "ts" else self.channel(name)
        c = self._ff.get(name)
        if c is None:
            if self._jl is None:
                self._jl = _ffill_idx(self.valid)
            src = self.channel(name) if name != "ts" else self.ts
            c = torch.gather(torch.cat([_nan_col(src), src], dim=1), 1,
                             self._jl + 1)
            self._ff[name] = c
        return c

    def bf(self, name: str) -> torch.Tensor:
        """Backward fill: channel value at first valid slot >= i."""
        if self._dense:
            return self.ts if name == "ts" else self.channel(name)
        c = self._bf.get(name)
        if c is None:
            if self._jf is None:
                rev = torch.flip(self.valid, dims=[1])
                self._jf = (self.valid.shape[1] - 1
                            - torch.flip(_ffill_idx(rev), dims=[1]))
            src = self.channel(name) if name != "ts" else self.ts
            N = src.shape[1]
            c = torch.gather(torch.cat([src, _nan_col(src)], dim=1), 1,
                             torch.clamp(self._jf, 0, N))
            self._bf[name] = c
        return c

    def prefix(self, name: str) -> torch.Tensor:
        """Inclusive prefix sum of a channel, with a leading 0 column:
        ps[:, k+1] = sum of slots 0..k. Shape [S, N+1]."""
        c = self._ps.get(name)
        if c is None:
            cs = torch.cumsum(self.channel(name), dim=1)
            c = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
            self._ps[name] = c
        return c

    # -- transposed (slot-major) channels --------------------------------
    # [N, S] layout: one query step's shared slot column is a contiguous
    # row, so the per-step reads of the windowed evaluator are sequential.

    def _t(self, cache_name: str, name: str, builder) -> torch.Tensor:
        cache = getattr(self, cache_name)
        c = cache.get(name)
        if c is None:
            c = builder(name).T.contiguous()
            cache[name] = c
        return c

    def t_ts(self) -> torch.Tensor:
        return self._t("_tch", "ts_nan", lambda _: self.ts)

    def t_channel(self, name: str) -> torch.Tensor:
        return self._t("_tch", name, self.channel)

    def t_ff(self, name: str) -> torch.Tensor:
        if self._dense:     # alias: no second transposed copy
            return self.t_ts() if name == "ts" else self.t_channel(name)
        return self._t("_tff", name, self.ff)

    def t_bf(self, name: str) -> torch.Tensor:
        if self._dense:
            return self.t_ts() if name == "ts" else self.t_channel(name)
        return self._t("_tbf", name, self.bf)

    def t_prefix(self, name: str) -> torch.Tensor:
        return self._t("_tps", name, self.prefix)

    # -- int32 relative-time channels for the f32-hybrid fast path -------
    # Timestamps as int32 ms relative to base_ms: exact under the
    # dispatcher's span guard (< 2^31 ms), and boundary compares and
    # subtractions become int32 ops.

    def t_tsr_i32(self) -> torch.Tensor:
        """[N, S] int32: ts - base_ms (0 at invalid slots)."""
        c = self._tch.get("tsr_i32")
        if c is None:
            rel = torch.where(self.valid, self.ts - self.base_ms,
                              torch.zeros((), dtype=F64, device=self.device))
            c = rel.T.contiguous().to(I32)
            self._tch["tsr_i32"] = c
        return c

    def _t_fill_tsr_i32(self, key: str, fill: torch.Tensor,
                        sentinel: int) -> torch.Tensor:
        c = self._tch.get(key)
        if c is None:
            sent = torch.full((), float(sentinel), dtype=F64,
                              device=self.device)
            rel = torch.where(torch.isnan(fill), sent, fill - self.base_ms)
            c = rel.T.contiguous().to(I32)
            self._tch[key] = c
        return c

    def t_ff_tsr_i32(self) -> torch.Tensor:
        """Forward-filled relative ts; INT32_MIN where no valid slot <= i."""
        if self._dense:
            return self.t_tsr_i32()
        return self._t_fill_tsr_i32("ff_tsr_i32", self.ff("ts"), _SENT_LO)

    def t_bf_tsr_i32(self) -> torch.Tensor:
        """Backward-filled relative ts; INT32_MAX where no valid slot >= i."""
        if self._dense:
            return self.t_tsr_i32()
        return self._t_fill_tsr_i32("bf_tsr_i32", self.bf("ts"), _SENT_HI)

    def t_ones_i8(self) -> torch.Tensor:
        c = self._tch.get("ones_i8")
        if c is None:
            c = self.valid.T.contiguous().to(torch.int8)
            self._tch["ones_i8"] = c
        return c

    def t_ps_ones_i32(self) -> torch.Tensor:
        """[N+1, S] int32 inclusive prefix count with leading 0 row."""
        c = self._tch.get("ps_ones_i32")
        if c is None:
            cs = torch.cumsum(self.valid.to(I32), dim=1, dtype=I32)
            ps = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
            c = ps.T.contiguous()
            self._tch["ps_ones_i32"] = c
        return c

    # -- stride-permuted channels ----------------------------------------
    # For a regular query grid (step % dt == 0, stride st = step // dt) the
    # T boundary rows of one family are k0, k0+st, ...; storing the [N, S]
    # channel permuted by residue class as [st, G, S] (row k at
    # [k % st, k // st]) makes each family ONE contiguous slice.

    def t_perm(self, name: str, st: int, src: torch.Tensor) -> torch.Tensor:
        key = (name, st)
        c = self._tperm.get(key)
        if c is None:
            N = src.shape[0]
            G = -(-N // st)
            pad = G * st - N
            if pad:
                fill = torch.zeros((pad,) + tuple(src.shape[1:]),
                                   dtype=src.dtype, device=src.device)
                src = torch.cat([src, fill], dim=0)
            c = src.reshape(G, st, *src.shape[1:]).transpose(0, 1) \
                .contiguous()
            self._tperm[key] = c
        return c

    @staticmethod
    def _perm_tiled_rows(N: int, st: int) -> int:
        # the permuted slot axis is padded past every tail tile exactly as
        # the reference layout pads it, so both packages' channels agree
        return -(-N // st) + kn.GS_TT_WIDE + 2 * kn.GS_AL + kn.GS_DSPAN_MAX

    def _fill_perm_tiled(self, out: torch.Tensor, src: torch.Tensor,
                         st: int) -> None:
        """Write [N, S] ``src`` into ``out`` [n_s, st, G, SS] (row k of
        series si*SS + j at out[si, k % st, k // st, j]; zero padding)."""
        N, S = src.shape
        n_s, _, G, ss = out.shape
        full = torch.zeros((G * st, n_s * ss), dtype=src.dtype,
                           device=src.device)
        full[:N, :S] = src
        out.copy_(full.reshape(G, st, n_s, ss).permute(2, 1, 0, 3))

    def t_perm_tiled(self, name: str, st: int, src: torch.Tensor
                     ) -> torch.Tensor:
        """Stride-permuted, s-tile-major channel [n_s, st, G, SS] (the
        layout of the reference's group-sum kernel input): within one
        (s-tile, residue) plane, consecutive G rows are contiguous."""
        key = (name + "#tiled", st)
        c = self._tperm.get(key)
        if c is None:
            N, S = src.shape
            G = self._perm_tiled_rows(N, st)
            n_s = -(-S // kn.GS_SS)
            c = torch.empty((n_s, st, G, kn.GS_SS), dtype=src.dtype,
                            device=src.device)
            self._fill_perm_tiled(c, src, st)
            self._tperm[key] = c
        return c

    def _fixed_channels(self, vch: str):
        """Per-series 61-bit fixed-point encoding of a value channel for
        the group-sum kernel: each series is rebased to its in-tile
        midpoint and scaled by a per-series power of two 2^s chosen so
        |v - mid| * 2^s <= 2^60, then split as hi*2^31 + lo with lo in
        [0, 2^31). Integer boundary subtractions in the kernel are then
        exact; only the final f32 recombine rounds, relative to the delta.

        Returns (hi [N,S] i32, lo [N,S] i32, mid_f32 [S], s [S] i32) or
        None when the channel has non-finite values or a span too wide for
        the encoding."""
        key = (vch, "#fixed")
        c = self._tperm.get(key)
        if c is None:
            v = self.t_channel(vch)                      # [N, S] f64
            vmax = torch.amax(v, dim=0)
            vmin = torch.amin(v, dim=0)
            if not bool(torch.isfinite(vmax).all()
                        & torch.isfinite(vmin).all()):
                self._tperm[key] = (None,)
                return None
            mid = (vmax + vmin) * 0.5
            # host-side scale selection ([S]-sized): span2 <= 2^e with
            # frexp's m in [0.5, 1)
            span2 = np.maximum((vmax - vmin).cpu().numpy() * 0.5,
                               2.0 ** -130)
            _, e = np.frexp(span2)
            if np.any(60 - e < -96):
                # a span this wide (> 2^156) cannot be represented in the
                # 61-bit channel at any in-range scale: clipping the
                # exponent would wrap int64 — refuse instead
                self._tperm[key] = (None,)
                return None
            s_np = np.clip(60 - e, -96, 126).astype(np.int32)
            scale = torch.as_tensor(np.ldexp(1.0, s_np), device=v.device)
            x = v - mid[None, :]
            x.mul_(scale[None, :])
            x.round_()
            fixed = x.to(I64)
            del x
            hi64 = fixed >> 31
            lo = (fixed - (hi64 << 31)).to(I32)
            del fixed
            c = (hi64.to(I32), lo, mid.to(F32),
                 torch.as_tensor(s_np, device=v.device))
            self._tperm[key] = c
        return None if c == (None,) else c

    def t_perm_fixed_tiled(self, vch: str, st: int) -> torch.Tensor:
        """The group-sum kernel's packed channel: s-tile-major
        stride-permuted [n_s, st, G, 3*SS] i32 where plane 0 is the int32
        relative timestamp and planes 1-2 are the fixed-point hi/lo split
        of the value channel (_fixed_channels). One contiguous row per
        boundary holds timestamps and values."""
        key = (vch + "#fixed_tiled", st)
        c = self._tperm.get(key)
        if c is None:
            fx = self._fixed_channels(vch)
            assert fx is not None, "dispatcher must gate on finiteness"
            N, S = fx[0].shape
            G = self._perm_tiled_rows(N, st)
            n_s = -(-S // kn.GS_SS)
            c = torch.empty((n_s, st, G, 3 * kn.GS_SS), dtype=I32,
                            device=fx[0].device)
            for i, ch in enumerate((self.t_tsr_i32(), fx[0], fx[1])):
                self._fill_perm_tiled(
                    c[..., i * kn.GS_SS:(i + 1) * kn.GS_SS], ch, st)
            self._tperm[key] = c
        return c

    def t_fixed_base(self, vch: str) -> torch.Tensor:
        """[n_s, 8, SS] f32 companion of t_perm_fixed_tiled: row 0 =
        per-series rebase midpoint (f32, used only by the counter-zero
        extrapolation limiter), row 1 = 2^(31-s), row 2 = 2^-s."""
        key = (vch + "#fixed_base", 0)
        c = self._tperm.get(key)
        if c is None:
            fx = self._fixed_channels(vch)
            assert fx is not None
            mid, s = fx[2], fx[3].cpu().numpy()
            one = np.float32(1.0)
            c1 = torch.as_tensor(np.ldexp(one, 31 - s).astype(np.float32))
            c2 = torch.as_tensor(np.ldexp(one, -s).astype(np.float32))
            S = mid.shape[0]
            n_s = -(-S // kn.GS_SS)
            rows = torch.zeros((8, n_s * kn.GS_SS), dtype=F32,
                               device=mid.device)
            rows[0, :S] = mid
            rows[1, :S] = c1.to(mid.device)
            rows[2, :S] = c2.to(mid.device)
            c = rows.reshape(8, n_s, kn.GS_SS).permute(1, 0, 2).contiguous()
            self._tperm[key] = c
        return c

    def jitter_ms(self) -> float:
        """Max |ts - nominal slot tick| over valid slots: the bound the
        group-sum dispatcher uses to elide jitter-fallback families when
        the query grid phase statically clears it."""
        if self._jitter is None:
            ticks = (self.base_ms
                     + torch.arange(self.num_slots, dtype=F64,
                                    device=self.device) * self.dt_ms)
            d = torch.where(self.valid, torch.abs(self.ts - ticks[None, :]),
                            torch.zeros((), dtype=F64, device=self.device))
            self._jitter = float(torch.max(d)) if d.numel() else 0.0
        return self._jitter


def _estimate_dt_candidates(series: Sequence[RawSeries]) -> List[int]:
    """Scrape-cadence estimate robust to gaps and jitter: iteratively
    refine the pooled diff median by dividing each diff by its rounded
    multiple (a k-sample gap contributes diff/k), then offer round-number
    snaps (real scrape intervals are round) ordered most-likely first."""
    diffs = []
    for s in series:
        if s.ts.size >= 2:
            d = np.diff(s.ts).astype(np.float64)
            diffs.append(d[d > 0])
    if not diffs:
        return []
    d = np.concatenate(diffs)
    if d.size == 0:
        return []
    dt = float(np.median(d))
    for _ in range(3):
        k = np.maximum(np.round(d / dt), 1.0)
        dt = float(np.median(d / k))
    if dt <= 0:
        return []
    cands: List[int] = []
    for q in (60_000, 10_000, 5_000, 1_000, 500, 100, 1):
        c = int(round(dt / q) * q)
        if c > 0 and abs(c - dt) <= dt * 0.25 and c not in cands:
            cands.append(c)
    return cands


def _align_rows(series: Sequence[RawSeries], dt: int):
    rows, aligned_idx = [], []
    lo = hi = None
    for i, s in enumerate(series):
        m = ~np.isnan(s.values)
        ts, vals = s.ts[m], s.values[m]
        if ts.size == 0:
            continue
        slots = np.round(ts / dt).astype(np.int64)
        if np.unique(slots).size != slots.size:
            continue                      # slot collision -> irregular
        if np.abs(ts - slots * dt).max() >= dt / 2:
            continue
        rows.append((i, slots, ts, vals))
        aligned_idx.append(i)
        lo = slots[0] if lo is None else min(lo, slots[0])
        hi = slots[-1] if hi is None else max(hi, slots[-1])
    return rows, aligned_idx, lo, hi


def build_aligned_tiles(series: Sequence[RawSeries], device=None,
                        ) -> Tuple[Optional[AlignedTiles], List[int]]:
    """Try to align series onto a shared cadence grid.

    Returns (tiles, aligned_indices). Series that don't fit (slot
    collisions after NaN-drop, or no shared dt) are excluded; the caller
    routes them through the packed path. Returns (None, []) if fewer than
    half the series align or cadence can't be established."""
    if not series:
        return None, []
    dt_cands = _estimate_dt_candidates(series)
    if not dt_cands:
        return None, []
    best = None
    for dt in dt_cands:
        attempt = _align_rows(series, dt)
        if best is None or len(attempt[0]) > len(best[0][0]):
            best = (attempt, dt)
        if len(attempt[0]) == len(series):
            break
    (rows, aligned_idx, lo, hi), dt = best
    if not rows or len(rows) * 2 < len(series):
        return None, []
    base = int(lo * dt)
    N = int(hi - lo + 1)
    S = len(rows)
    valid = np.zeros((S, N), dtype=bool)
    ts_true = np.zeros((S, N), dtype=np.float64)
    vals_g = np.zeros((S, N), dtype=np.float64)
    keys = []
    for r, (i, slots, ts, vals) in enumerate(rows):
        pos = slots - lo
        valid[r, pos] = True
        ts_true[r, pos] = ts
        vals_g[r, pos] = vals
        keys.append(dict(series[i].labels))
    return (AlignedTiles(keys, base, dt, valid, ts_true, vals_g,
                         device=device), aligned_idx)


# ---------------------------------------------------------------------------
# Aligned evaluator over row-major tiles -> [S, T] (shared-column takes)
# ---------------------------------------------------------------------------

def _take(arr: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[S, N] x [T] shared columns -> [S, T]."""
    return torch.index_select(arr, 1, cols)


def _select_last(arrs, names, num_slots: int, k_hi, wend):
    """Channel values at the LAST sample with ts <= wend_t, per series:
    2-candidate select between slot K_hi's forward fill and K_hi-1's."""
    N = num_slots
    kc = torch.clamp(k_hi, 0, N - 1)
    kp = torch.clamp(k_hi - 1, 0, N - 1)
    none = (k_hi < 0)[None, :]
    nan = torch.full((), float("nan"), dtype=F64, device=k_hi.device)
    use1 = _take(arrs["ff_ts"], kc) <= wend.to(F64)[None, :]   # NaN: False
    out = []
    for n in names:
        a = arrs["ff_" + n]
        v = torch.where(use1, _take(a, kc), _take(a, kp))
        out.append(torch.where(none, nan, v))
    return out


def _select_first(arrs, names, num_slots: int, k_lo, wstart):
    """Channel values at the FIRST sample with ts >= wstart_t."""
    N = num_slots
    kc = torch.clamp(k_lo, 0, N - 1)
    kn_ = torch.clamp(k_lo + 1, 0, N - 1)
    none = (k_lo > N - 1)[None, :]
    nan = torch.full((), float("nan"), dtype=F64, device=k_lo.device)
    use1 = _take(arrs["bf_ts"], kc) >= wstart.to(F64)[None, :]
    out = []
    for n in names:
        a = arrs["bf_" + n]
        v = torch.where(use1, _take(a, kc), _take(a, kn_))
        out.append(torch.where(none, nan, v))
    return out


def _window_sum(arrs, name: str, num_slots: int, k_lo, k_hi, wstart, wend):
    """Exact sum of a channel over samples with ts in [wstart_t, wend_t]:
    prefix difference over slots [K_lo, K_hi] minus edge-slot samples that
    jitter outside the window."""
    N = num_slots
    ps = arrs["ps_" + name]
    ch = arrs["ch_" + name]
    zero = torch.zeros((), dtype=F64, device=k_lo.device)
    hi_i = torch.clamp(k_hi, -1, N - 1) + 1
    lo_i = torch.clamp(k_lo, 0, N)
    s = _take(ps, hi_i) - _take(ps, lo_i)
    khx = torch.clamp(k_hi, 0, N - 1)
    k_hi_ok = ((k_hi >= 0) & (k_hi <= N - 1))[None, :]
    over = k_hi_ok & (_take(arrs["ts"], khx) > wend.to(F64)[None, :])
    s = s - torch.where(over, _take(ch, khx), zero)
    klx = torch.clamp(k_lo, 0, N - 1)
    k_lo_ok = ((k_lo >= 0) & (k_lo <= N - 1))[None, :]
    under = k_lo_ok & (_take(arrs["ts"], klx) < wstart.to(F64)[None, :])
    return s - torch.where(under, _take(ch, klx), zero)


# channels each function needs: (ff/bf endpoint channels, prefix channels)
_ENDPOINT_CH = {
    "last_sample": ["v"], "last_over_time": ["v"],
    "first_over_time": ["v"], "timestamp": ["ts"],
    "changes": ["ev_change"], "resets": ["ev_reset"], "z_score": ["v"],
}
_PREFIX_CH = {
    "sum_over_time": ["v"], "avg_over_time": ["v"],
    "rate_over_delta": ["v"], "increase_over_delta": ["v"],
    "stddev_over_time": ["v", "vc2"], "stdvar_over_time": ["v", "vc2"],
    "z_score": ["v", "vc2"], "changes": ["ev_change"],
    "resets": ["ev_reset"],
}


def _tiles_arrays(tiles: AlignedTiles, func: str) -> Dict[str, torch.Tensor]:
    """Collect (and lazily pack) the device arrays `func` needs."""
    arrs: Dict[str, torch.Tensor] = {
        "ts": tiles.ts,
        "ps_ones": tiles.prefix("ones"),
        "ch_ones": tiles.channel("ones"),
    }
    ep = _ENDPOINT_CH.get(func, ())
    if ep:
        arrs["ff_ts"] = tiles.ff("ts")
        arrs["bf_ts"] = tiles.bf("ts")
    for n in ep:
        if func in ("changes", "resets", "first_over_time"):
            arrs["bf_" + n] = tiles.bf(n)
        else:
            arrs["ff_" + n] = tiles.ff(n)
    for n in _PREFIX_CH.get(func, ()):
        arrs["ps_" + n] = tiles.prefix(n)
        arrs["ch_" + n] = tiles.channel(n)
    if "vc2" in _PREFIX_CH.get(func, ()):
        arrs["vshift"] = tiles.vshift
    return arrs


def _eval_core(func: str, nsteps: int, arrs: Dict[str, torch.Tensor],
               num_slots: int, base: int, dt: int, w0s: int, w0e: int,
               step: int) -> torch.Tensor:
    """One windowed range function over row-major aligned tiles -> [S, T]
    f64 (the reference's jitted evaluation body, as eager tensor ops). The
    rate family is evaluate_counters_t's."""
    dev = arrs["ts"].device
    wend, wstart, k_hi, k_lo = _slot_bounds(nsteps, base, dt, w0s, w0e,
                                            step, dev)
    N = num_slots
    counts = _window_sum(arrs, "ones", N, k_lo, k_hi, wstart, wend)
    has = counts >= 0.5
    nan = torch.full((), float("nan"), dtype=F64, device=dev)
    one = torch.ones((), dtype=F64, device=dev)
    zero = torch.zeros((), dtype=F64, device=dev)

    if func in ("last_sample", "last_over_time"):
        (v2,) = _select_last(arrs, ["v"], N, k_hi, wend)
        return torch.where(has, v2, nan)
    if func == "first_over_time":
        (v1,) = _select_first(arrs, ["v"], N, k_lo, wstart)
        return torch.where(has, v1, nan)
    if func == "timestamp":
        (t2,) = _select_last(arrs, ["ts"], N, k_hi, wend)
        return torch.where(has, t2 / 1000.0, nan)
    if func == "present_over_time":
        return torch.where(has, one, nan)
    if func == "absent_over_time":
        return torch.where(has, nan, one)

    if func in ("changes", "resets"):
        ch = "ev_change" if func == "changes" else "ev_reset"
        total = _window_sum(arrs, ch, N, k_lo, k_hi, wstart, wend)
        (ev_first,) = _select_first(arrs, [ch], N, k_lo, wstart)
        out = total - torch.where(torch.isnan(ev_first), zero, ev_first)
        return torch.where(has, out, nan)

    if func == "count_over_time":
        return torch.where(has, counts, nan)
    s = _window_sum(arrs, "v", N, k_lo, k_hi, wstart, wend)
    if func in ("sum_over_time", "increase_over_delta"):
        out = s
    elif func == "rate_over_delta":
        out = s / (wend - wstart).to(F64)[None, :] * 1000.0
    elif func == "avg_over_time":
        out = s / counts
    else:
        s2 = _window_sum(arrs, "vc2", N, k_lo, k_hi, wstart, wend)
        mean = s / counts
        dmean = mean - arrs["vshift"][:, None]
        var = torch.maximum(s2 / counts - dmean * dmean, zero)
        if func == "stdvar_over_time":
            out = var
        elif func == "stddev_over_time":
            out = torch.sqrt(var)
        elif func == "z_score":
            (v2,) = _select_last(arrs, ["v"], N, k_hi, wend)
            out = (v2 - mean) / torch.sqrt(var)
        else:
            raise ValueError(f"aligned path cannot evaluate {func}")
    return torch.where(has, out, nan)


def evaluate_aligned(tiles: AlignedTiles, func: str, steps: np.ndarray,
                     window_ms: int, offset_ms: int = 0) -> torch.Tensor:
    """One windowed range function of ALIGNED_FUNCS, other than the rate
    family, over aligned tiles -> [S, T] f64 tensor on the tiles' device.
    Numerics match the oracle (rangefn) modulo prefix-sum rounding."""
    if func not in ALIGNED_FUNCS or func in ("rate", "increase", "delta"):
        raise ValueError(f"evaluate_aligned cannot evaluate {func}")
    nsteps = steps.size
    w0e = int(steps[0] - offset_ms)
    w0s = w0e - int(window_ms)
    step = int(steps[1] - steps[0]) if nsteps > 1 else 1
    return _eval_core(func, nsteps, _tiles_arrays(tiles, func),
                      tiles.num_slots, tiles.base_ms, tiles.dt_ms, w0s, w0e,
                      step)


# ---------------------------------------------------------------------------
# Counter evaluators over transposed tiles -> [T, S]
# ---------------------------------------------------------------------------

def _tiles_arrays_t(tiles: AlignedTiles, func: str) -> Dict[str, torch.Tensor]:
    vch = "cv" if func in ("rate", "increase") else "v"
    if tiles._dense:
        # fully-valid tiles: fills alias the channels and sample counts
        # are slot arithmetic — only (ts, value) tiles are read
        return {"ts": tiles.t_ts(), "ff_v": tiles.t_channel(vch)}
    return {
        "ts": tiles.t_ts(),
        "ps_ones": tiles.t_prefix("ones"),
        "ch_ones": tiles.t_channel("ones"),
        "ff_ts": tiles.t_ff("ts"),
        "bf_ts": tiles.t_bf("ts"),
        "ff_v": tiles.t_ff(vch),
        "bf_v": tiles.t_bf(vch),
    }


def _slot_bounds(nsteps: int, base: int, dt: int, w0s: int, w0e: int,
                 step: int, device):
    """Per-step window ends/starts (i64) and the highest slot that could
    hold a sample <= wend / lowest that could hold one >= wstart (scrape
    jitter < dt/2 each side)."""
    t = torch.arange(nsteps, dtype=I64, device=device)
    wend = w0e + t * step
    wstart = w0s + t * step
    k_hi = torch.floor(((wend - base).to(F64) + dt / 2.0) / dt).to(I64)
    k_lo = torch.ceil(((wstart - base).to(F64) - dt / 2.0) / dt).to(I64)
    return wend, wstart, k_hi, k_lo


def _eval_counter_t(func: str, nsteps: int, arrs: Dict[str, torch.Tensor],
                    num_slots: int, base: int, dt: int, w0s: int, w0e: int,
                    step: int) -> torch.Tensor:
    """rate/increase/delta over transposed tiles -> [T, S] f64 (exact
    family: every value and time stays f64)."""
    from filodb_tpu_torch.query.backend import _extrapolated_rate

    N = num_slots
    dense = "ps_ones" not in arrs
    dev = arrs["ts"].device
    wend, wstart, k_hi, k_lo = _slot_bounds(nsteps, base, dt, w0s, w0e,
                                            step, dev)

    def TK(a, k):                                   # [T, S] rows
        return torch.index_select(a, 0, k)

    zero = torch.zeros((), dtype=F64, device=dev)
    nan = torch.full((), float("nan"), dtype=F64, device=dev)
    wend_d = wend.to(F64)[:, None]
    wstart_d = wstart.to(F64)[:, None]
    hi_i = torch.clamp(k_hi, -1, N - 1) + 1
    lo_i = torch.clamp(k_lo, 0, N)
    if dense:
        counts = (hi_i - lo_i).to(F64)[:, None]
        one = torch.ones((), dtype=F64, device=dev)
    else:
        counts = TK(arrs["ps_ones"], hi_i) - TK(arrs["ps_ones"], lo_i)
    khx = torch.clamp(k_hi, 0, N - 1)
    k_hi_ok = ((k_hi >= 0) & (k_hi <= N - 1))[:, None]
    over = k_hi_ok & (TK(arrs["ts"], khx) > wend_d)
    counts = counts - torch.where(
        over, one if dense else TK(arrs["ch_ones"], khx), zero)
    klx = torch.clamp(k_lo, 0, N - 1)
    k_lo_ok = ((k_lo >= 0) & (k_lo <= N - 1))[:, None]
    under = k_lo_ok & (TK(arrs["ts"], klx) < wstart_d)
    counts = counts - torch.where(
        under, one if dense else TK(arrs["ch_ones"], klx), zero)
    has = counts >= 0.5
    ff_ts = arrs["ts"] if dense else arrs["ff_ts"]
    bf_ts = arrs["ts"] if dense else arrs["bf_ts"]
    bf_v = arrs["ff_v"] if dense else arrs["bf_v"]
    # last sample <= wend (2-candidate select)
    kc = torch.clamp(k_hi, 0, N - 1)
    kp = torch.clamp(k_hi - 1, 0, N - 1)
    none_hi = (k_hi < 0)[:, None]
    ts1 = TK(ff_ts, kc)
    use1 = ts1 <= wend_d
    t2 = torch.where(none_hi, nan, torch.where(use1, ts1, TK(ff_ts, kp)))
    v2 = torch.where(none_hi, nan,
                     torch.where(use1, TK(arrs["ff_v"], kc),
                                 TK(arrs["ff_v"], kp)))
    # first sample >= wstart
    kcl = torch.clamp(k_lo, 0, N - 1)
    kn_ = torch.clamp(k_lo + 1, 0, N - 1)
    none_lo = (k_lo > N - 1)[:, None]
    tsb = TK(bf_ts, kcl)
    useb = tsb >= wstart_d
    t1 = torch.where(none_lo, nan, torch.where(useb, tsb, TK(bf_ts, kn_)))
    v1 = torch.where(none_lo, nan,
                     torch.where(useb, TK(bf_v, kcl), TK(bf_v, kn_)))
    is_counter = func != "delta"
    out = _extrapolated_rate(wstart_d, wend_d, counts, t1, v1, t2, v2,
                             is_counter, func == "rate")
    return torch.where(has, out, nan)


def _tiles_arrays_fast(tiles: AlignedTiles, func: str
                       ) -> Dict[str, torch.Tensor]:
    """Channels for the f32-hybrid counter evaluator: int32 relative
    timestamps + the exact f64 value tile."""
    vch = "cv" if func in ("rate", "increase") else "v"
    if tiles._dense:
        return {"tsr": tiles.t_tsr_i32(), "ff_v": tiles.t_channel(vch)}
    return {
        "tsr": tiles.t_tsr_i32(),
        "ones": tiles.t_ones_i8(),
        "ps_ones": tiles.t_ps_ones_i32(),
        "ff_tsr": tiles.t_ff_tsr_i32(),
        "bf_tsr": tiles.t_bf_tsr_i32(),
        "ff_v": tiles.t_ff(vch),
        "bf_v": tiles.t_bf(vch),
    }


def _wdur_s(w0s, w0e, device) -> torch.Tensor:
    """Window length in seconds as an f32 scalar: f32(window) / 1000."""
    d = w0e - w0s
    if not isinstance(d, torch.Tensor):
        d = torch.tensor(d, dtype=I64, device=device)
    return d.to(F32) / 1000.0


def _eval_counter_fast(func: str, nsteps: int, arrs: Dict[str, torch.Tensor],
                       num_slots: int, base: int, dt: int, w0s: int,
                       w0e: int, step: int) -> torch.Tensor:
    """rate/increase/delta over transposed tiles -> [T, S] f32.

    The f32-hybrid path: int32 relative timestamps (exact under the span
    guard), the boundary value delta in f64 from the f64 value tile, and
    the extrapolation epilogue in f32."""
    N = num_slots
    dense = "ps_ones" not in arrs
    dev = arrs["tsr"].device
    _, _, k_hi, k_lo = _slot_bounds(nsteps, base, dt, w0s, w0e, step, dev)
    t = torch.arange(nsteps, dtype=I64, device=dev)
    wend_r = (w0e - base + t * step).to(I32)[:, None]       # guarded i32
    wstart_r = (w0s - base + t * step).to(I32)[:, None]

    def TK(a, k):
        return torch.index_select(a, 0, k)

    nan = torch.full((), float("nan"), dtype=F64, device=dev)
    kc = torch.clamp(k_hi, 0, N - 1)
    kp = torch.clamp(k_hi - 1, 0, N - 1)
    kcl = torch.clamp(k_lo, 0, N - 1)
    kn_ = torch.clamp(k_lo + 1, 0, N - 1)

    if dense:
        ts_kc = TK(arrs["tsr"], kc)
        ts_kp = TK(arrs["tsr"], kp)
        tsb_kcl = TK(arrs["tsr"], kcl)
        tsb_kn = TK(arrs["tsr"], kn_)
        raw_kc, raw_kcl = ts_kc, tsb_kcl
    else:
        ts_kc = TK(arrs["ff_tsr"], kc)
        ts_kp = TK(arrs["ff_tsr"], kp)
        tsb_kcl = TK(arrs["bf_tsr"], kcl)
        tsb_kn = TK(arrs["bf_tsr"], kn_)
        raw_kc = TK(arrs["tsr"], kc)
        raw_kcl = TK(arrs["tsr"], kcl)
    v_kc = TK(arrs["ff_v"], kc)
    v_kp = TK(arrs["ff_v"], kp)
    bf_v = arrs["ff_v"] if dense else arrs["bf_v"]
    v_kcl = TK(bf_v, kcl)
    v_kn = TK(bf_v, kn_)

    # counts: slot arithmetic (dense) / prefix diff, minus edge-slot
    # samples that jitter outside the window
    hi_i = torch.clamp(k_hi, -1, N - 1) + 1
    lo_i = torch.clamp(k_lo, 0, N)
    k_hi_ok = ((k_hi >= 0) & (k_hi <= N - 1))[:, None]
    k_lo_ok = ((k_lo >= 0) & (k_lo <= N - 1))[:, None]
    if dense:
        counts = (hi_i - lo_i).to(I32)[:, None]
        over = k_hi_ok & (raw_kc > wend_r)
        under = k_lo_ok & (raw_kcl < wstart_r)
    else:
        counts = TK(arrs["ps_ones"], hi_i) - TK(arrs["ps_ones"], lo_i)
        ones_kc = TK(arrs["ones"], kc) > 0
        ones_kcl = TK(arrs["ones"], kcl) > 0
        over = k_hi_ok & ones_kc & (raw_kc > wend_r)
        under = k_lo_ok & ones_kcl & (raw_kcl < wstart_r)
    counts = counts - over.to(I32) - under.to(I32)

    # last sample <= wend (2-candidate select; sentinel/NaN-filled
    # boundaries propagate through the f64 value channel)
    none_hi = (k_hi < 0)[:, None]
    use1 = ts_kc <= wend_r
    t2 = torch.where(use1, ts_kc, ts_kp)
    v2 = torch.where(none_hi, nan, torch.where(use1, v_kc, v_kp))
    none_lo = (k_lo > N - 1)[:, None]
    useb = tsb_kcl >= wstart_r
    t1 = torch.where(useb, tsb_kcl, tsb_kn)
    v1 = torch.where(none_lo, nan, torch.where(useb, v_kcl, v_kn))
    return _f32_epilogue(func, counts, t1, v1, t2, v2, wstart_r, wend_r,
                         _wdur_s(w0s, w0e, dev))


def _tiles_arrays_slide(tiles: AlignedTiles, func: str, st: int
                        ) -> Dict[str, torch.Tensor]:
    """Stride-permuted channels for the slide evaluator (dense tiles
    only): int32 relative timestamps + the exact f64 value channel,
    each as [st, G, S]."""
    vch = "cv" if func in ("rate", "increase") else "v"
    return {
        "tsr_p": tiles.t_perm("tsr_i32", st, tiles.t_tsr_i32()),
        "ff_v_p": tiles.t_perm(vch, st, tiles.t_channel(vch)),
    }


def _eval_counter_slide(func: str, nsteps: int, st: int,
                        arrs: Dict[str, torch.Tensor], num_slots: int,
                        base: int, dt: int, w0s: int, w0e: int,
                        step: int) -> torch.Tensor:
    """rate/increase/delta on a REGULAR grid over dense tiles -> [T, S]
    f32. Same numerics as ``_eval_counter_fast``, but every boundary row
    read is one contiguous slice of the stride-permuted [st, G, S]
    channel. The dispatcher (_slide_eligible) guarantees every index is in
    bounds, so the clip/sentinel masks of the gather path vanish.

    Under ``torch.func.vmap`` (evaluate_counters_t_batch) ``w0s``/``w0e``
    are 0-d tensors: the first boundary slots are then tensors too, and
    the same rows are taken by index, since a slice cannot start at a
    batched offset."""
    T = nsteps
    dev = arrs["tsr_p"].device
    if isinstance(w0e, torch.Tensor):
        k_c0 = torch.floor(((w0e - base).to(F64) + dt / 2.0) / dt).to(I64)
        k_l0 = torch.ceil(((w0s - base).to(F64) - dt / 2.0) / dt).to(I64)
        counts = (k_c0 + 1 - k_l0).to(I32)
        t_idx = torch.arange(T, dtype=I64, device=dev)

        def rows(perm, k0):
            return perm[k0 % st].index_select(0, k0 // st + t_idx)
    else:
        k_c0 = int(np.floor((w0e - base + dt / 2.0) / dt))
        k_l0 = int(np.ceil((w0s - base - dt / 2.0) / dt))
        counts = torch.full((), k_c0 + 1 - k_l0, dtype=I32, device=dev)

        def rows(perm, k0):
            return perm[k0 % st, k0 // st:k0 // st + T]

    ts_kc = rows(arrs["tsr_p"], k_c0)
    ts_kp = rows(arrs["tsr_p"], k_c0 - 1)
    tsb_kcl = rows(arrs["tsr_p"], k_l0)
    tsb_kn = rows(arrs["tsr_p"], k_l0 + 1)
    v_kc = rows(arrs["ff_v_p"], k_c0)
    v_kp = rows(arrs["ff_v_p"], k_c0 - 1)
    v_kcl = rows(arrs["ff_v_p"], k_l0)
    v_kn = rows(arrs["ff_v_p"], k_l0 + 1)

    t = torch.arange(T, dtype=I64, device=dev)
    wend_r = (w0e - base + t * step).to(I32)[:, None]
    wstart_r = (w0s - base + t * step).to(I32)[:, None]
    over = ts_kc > wend_r
    under = tsb_kcl < wstart_r
    counts = counts - over.to(I32) - under.to(I32)
    use1 = ts_kc <= wend_r
    t2 = torch.where(use1, ts_kc, ts_kp)
    v2 = torch.where(use1, v_kc, v_kp)
    useb = tsb_kcl >= wstart_r
    t1 = torch.where(useb, tsb_kcl, tsb_kn)
    v1 = torch.where(useb, v_kcl, v_kn)
    return _f32_epilogue(func, counts, t1, v1, t2, v2, wstart_r, wend_r,
                         _wdur_s(w0s, w0e, dev))


def _f32_epilogue(func, counts, t1, v1, t2, v2, wstart_r, wend_r, wdur_s):
    """Shared f32 extrapolation epilogue: exact f64 delta, f32 factor."""
    dev = counts.device
    nan = torch.full((), float("nan"), dtype=F32, device=dev)
    inf = torch.full((), float("inf"), dtype=F32, device=dev)
    delta = (v2 - v1).to(F32)                       # exact f64 difference
    sampled = (t2 - t1).to(F32) / 1000.0            # exact i32 difference
    dstart = (t1 - wstart_r).to(F32) / 1000.0
    dend = (wend_r - t2).to(F32) / 1000.0
    counts_f = counts.to(F32)
    avg_dur = sampled / (counts_f - 1.0)
    if func != "delta":                             # counter zero-clamp
        v1f = v1.to(F32)
        dzero = torch.where((delta > 0) & (v1f >= 0),
                            sampled * (v1f / torch.where(delta == 0, nan,
                                                         delta)),
                            inf)
        dstart = torch.minimum(dstart, dzero)
    thresh = avg_dur * 1.1
    half = avg_dur * 0.5
    extrap = sampled + torch.where(dstart < thresh, dstart, half) \
        + torch.where(dend < thresh, dend, half)
    factor = extrap / sampled
    if func == "rate":
        factor = factor / wdur_s
    out = delta * factor
    return torch.where(counts >= 2, out, nan)


def _slide_eligible(tiles: AlignedTiles, nsteps: int, w0s: int, w0e: int,
                    last_ms: int, step: int):
    """Shared dispatch guard for the slide evaluator AND the group-sum
    kernel: a REGULAR grid (step % dt == 0) over dense tiles, entirely
    interior (no index clipping: kp = kc-1 >= 0 ... kn = kcl+1 <= N-1),
    with every relative time in int32 ms. Returns (st, k_c0, k_l0) or
    None. Both consumers dispatch off this one predicate so they agree on
    the in-bounds proof."""
    N, dt = tiles.num_slots, tiles.dt_ms
    if nsteps < 2 or not tiles._dense or step % dt != 0:
        return None
    lo_rel = w0s - tiles.base_ms
    hi_rel = last_ms - tiles.base_ms
    if not (_SENT_LO < lo_rel and hi_rel < _SENT_HI
            and N * dt + dt < _SENT_HI):
        return None
    st = step // dt
    k_c0 = int(np.floor((w0e - tiles.base_ms + dt / 2.0) / dt))
    k_l0 = int(np.ceil((w0s - tiles.base_ms - dt / 2.0) / dt))
    span = (nsteps - 1) * st
    if not (st >= 1 and k_c0 >= 1 and k_l0 >= 0
            and k_c0 + span <= N - 1 and k_l0 + 1 + span <= N - 1):
        return None
    return st, k_c0, k_l0


def evaluate_counters_t(tiles: AlignedTiles, func: str, steps: np.ndarray,
                        window_ms: int, offset_ms: int = 0) -> torch.Tensor:
    """rate/increase/delta on the transposed path -> [T, S] tensor.

    Dispatch: the slide evaluator when _slide_eligible proves a regular
    interior grid, else the f32-hybrid evaluator (f32 output) when the
    query grid and tile span fit int32 ms relative to the tile base, else
    the exact all-f64 evaluator (f64 output)."""
    assert func in ("rate", "increase", "delta")
    nsteps = steps.size
    w0e = int(steps[0] - offset_ms)
    w0s = w0e - int(window_ms)
    step = int(steps[1] - steps[0]) if nsteps > 1 else 1
    lo_rel = w0s - tiles.base_ms
    hi_rel = int(steps[-1] - offset_ms) - tiles.base_ms
    fits_i32 = (_SENT_LO < lo_rel and hi_rel < _SENT_HI
                and tiles.num_slots * tiles.dt_ms + tiles.dt_ms < _SENT_HI)
    args = (tiles.num_slots, tiles.base_ms, tiles.dt_ms, w0s, w0e, step)
    el = _slide_eligible(tiles, nsteps, w0s, w0e,
                         int(steps[-1] - offset_ms), step)
    if el is not None:
        st = el[0]
        return _eval_counter_slide(func, nsteps, st,
                                   _tiles_arrays_slide(tiles, func, st),
                                   *args)
    if fits_i32:
        return _eval_counter_fast(func, nsteps,
                                  _tiles_arrays_fast(tiles, func), *args)
    return _eval_counter_t(func, nsteps, _tiles_arrays_t(tiles, func), *args)


def groupsum_plan(tiles: AlignedTiles, func: str, steps: np.ndarray,
                  window_ms: int, offset_ms: int = 0) -> Optional[dict]:
    """The group-sum kernel's static arguments for one query, or None when
    the reference's semantic preconditions do not hold: the slide guard
    (dense tiles, regular interior grid in int32 ms), a window that spans
    a whole number of steps, window/step <= GS_DSPAN_MAX, and finite
    values."""
    assert func in ("rate", "increase", "delta")
    nsteps = steps.size
    if nsteps < 2:
        return None
    w0e = int(steps[0] - offset_ms)
    w0s = w0e - int(window_ms)
    step = int(steps[1] - steps[0])
    el = _slide_eligible(tiles, nsteps, w0s, w0e,
                         int(steps[-1] - offset_ms), step)
    if el is None:
        return None
    st, k_c0, k_l0 = el
    # merged-stream contract: the window must span a whole number of
    # steps so the kc/kl families share a stride-residue plane
    d = k_c0 - k_l0
    if d % st != 0 or not (0 <= d // st <= kn.GS_DSPAN_MAX):
        return None
    if st == 1 and k_l0 < 1:
        return None              # the reference layout's lead row
    vch = "cv" if func in ("rate", "increase") else "v"
    if tiles._fixed_channels(vch) is None:
        return None              # non-finite values: exact f64 fallback
    # static jitter-phase elision: when the grid phase clears the tile's
    # max |ts - tick|, the boundary-sample choice is the same for every
    # series and step, and the fallback family is never read
    dt = tiles.dt_ms
    J = tiles.jitter_ms()
    phase_e = (w0e - tiles.base_ms) - k_c0 * dt
    phase_s = k_l0 * dt - (w0s - tiles.base_ms)
    hi_mode = (kn.GS_CUR if phase_e >= J else
               kn.GS_ALT if phase_e < -J else kn.GS_BOTH)
    lo_mode = (kn.GS_CUR if phase_s >= J else
               kn.GS_ALT if phase_s < -J else kn.GS_BOTH)
    return {"func": func, "st": st, "dspan": d // st, "hi_mode": hi_mode,
            "lo_mode": lo_mode, "kl0": k_l0,
            "w0e_rel": w0e - tiles.base_ms, "window": int(window_ms),
            "step": step, "nsteps": nsteps, "vch": vch}


def groupsum_counters(tiles: AlignedTiles, func: str, steps: np.ndarray,
                      window_ms: int, onehot: ArrayLike, offset_ms: int = 0
                      ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """`sum by (g) (rate/increase/delta(sel[w]))` fused on the device by
    the group-sum kernel -> (sums f32 [T, G], counts f32 [T, G]), or None
    when the preconditions don't hold (the caller falls back to
    evaluate_counters_t + grouping). Any S works: pad series get all-zero
    one-hot rows. A kernel that fails raises; nothing here hides it."""
    plan = groupsum_plan(tiles, func, steps, window_ms, offset_ms)
    if plan is None:
        return None
    v_p = tiles.t_perm_fixed_tiled(plan["vch"], plan["st"])
    base = tiles.t_fixed_base(plan["vch"])
    S = len(tiles.keys)
    oh = torch.as_tensor(onehot, device=tiles.device).to(F32)
    S_pad = v_p.shape[0] * kn.GS_SS
    if S_pad != S:
        oh = torch.cat([oh, torch.zeros((S_pad - S, oh.shape[1]), dtype=F32,
                                        device=oh.device)], dim=0)
    return kn.counter_groupsum(
        plan["func"], plan["st"], plan["dspan"], plan["hi_mode"],
        plan["lo_mode"], v_p, base, oh.contiguous(), plan["kl0"],
        plan["w0e_rel"], plan["window"], plan["step"], plan["nsteps"])


# ---------------------------------------------------------------------------
# Micro-batched (multi-grid) evaluation
# ---------------------------------------------------------------------------
#
# The micro-batcher (query/batcher.py) stacks concurrent queries that share
# (tiles, func, nsteps, step, window) but differ in grid position (w0s,
# w0e): the dashboard-refresh shape. Each batched evaluator below is the
# SAME body as its scalar dispatch under torch.func.vmap over the (w0s,
# w0e) scalars only, so member i of a batch is bit for bit the scalar
# path's output: the batch axis adds a leading dim and every op stays
# row-local. The reference pads the batch to a coarse power-of-two width
# to bound its XLA compiles; eager PyTorch compiles nothing, so exactly B
# members run.

def counters_batch_family(tiles: AlignedTiles, func: str,
                          steps: np.ndarray, window_ms: int,
                          offset_ms: int = 0) -> Tuple:
    """Hashable dispatch-family key of one counter query: two queries may
    share a batched evaluation only when their families match (the family
    fixes which evaluator the scalar path would pick)."""
    nsteps = steps.size
    w0e = int(steps[0] - offset_ms)
    w0s = w0e - int(window_ms)
    step = int(steps[1] - steps[0]) if nsteps > 1 else 1
    el = _slide_eligible(tiles, nsteps, w0s, w0e,
                         int(steps[-1] - offset_ms), step)
    if el is not None:
        return ("slide", el[0])
    lo_rel = w0s - tiles.base_ms
    hi_rel = int(steps[-1] - offset_ms) - tiles.base_ms
    fits_i32 = (_SENT_LO < lo_rel and hi_rel < _SENT_HI
                and tiles.num_slots * tiles.dt_ms + tiles.dt_ms < _SENT_HI)
    return ("fast",) if fits_i32 else ("t",)


def _vmap_grids(body, w0s_list: Sequence[int], w0e_list: Sequence[int],
                step: int, device) -> torch.Tensor:
    """``body(w0s, w0e, step)`` for every member grid, as one batched
    evaluation with a leading [B] axis."""
    w0s_v = torch.tensor(list(w0s_list), dtype=I64, device=device)
    w0e_v = torch.tensor(list(w0e_list), dtype=I64, device=device)
    return torch.func.vmap(lambda s, e: body(s, e, step))(w0s_v, w0e_v)


def evaluate_counters_t_batch(tiles: AlignedTiles, func: str,
                              family: Tuple, nsteps: int, step: int,
                              w0s_list: Sequence[int],
                              w0e_list: Sequence[int]) -> torch.Tensor:
    """B counter grids over shared tiles in one batched evaluation ->
    [B, T, S] tensor. All members share ``family``
    (counters_batch_family)."""
    assert func in ("rate", "increase", "delta")
    args = (tiles.num_slots, tiles.base_ms, tiles.dt_ms)
    kind = family[0]
    if kind == "slide":
        st = family[1]
        body = functools.partial(_eval_counter_slide, func, nsteps, st,
                                  _tiles_arrays_slide(tiles, func, st),
                                  *args)
    elif kind == "fast":
        body = functools.partial(_eval_counter_fast, func, nsteps,
                                  _tiles_arrays_fast(tiles, func), *args)
    else:
        body = functools.partial(_eval_counter_t, func, nsteps,
                                  _tiles_arrays_t(tiles, func), *args)
    return _vmap_grids(body, w0s_list, w0e_list, step, tiles.device)


def evaluate_aligned_batch(tiles: AlignedTiles, func: str, nsteps: int,
                           step: int, w0s_list: Sequence[int],
                           w0e_list: Sequence[int]) -> torch.Tensor:
    """B aligned grids of a non-counter function over shared tiles in one
    batched evaluation -> [B, S, T] tensor."""
    if func not in ALIGNED_FUNCS or func in ("rate", "increase", "delta"):
        raise ValueError(f"evaluate_aligned_batch cannot evaluate {func}")
    body = functools.partial(_eval_core, func, nsteps,
                              _tiles_arrays(tiles, func), tiles.num_slots,
                              tiles.base_ms, tiles.dt_ms)
    return _vmap_grids(body, w0s_list, w0e_list, step, tiles.device)
