"""ULP-certification rail of the port: every ``@precision`` claim
declared in ``filodb_tpu_torch`` is measured against an f64 reference.

:mod:`filodb_tpu_torch.lint.numerics` makes each hybrid f32/int32 site
declare its budget; this module makes the declarations HONEST. For each
registered claim a harness evaluates the annotated site on seeded inputs
shaped by its static bound (dense tiles, monotone counters, windows with
>= 2 samples, branch conditions away from knife edges) and returns
``(prod, ref, floor)``: the site's output, an f64 reference (the
exact-f64 twin evaluator, the pure-Python ``promql/refeval`` window
loop, or a straight f64 formula, always computed on the CPU) and an
absolute error floor. The worst error is measured in output-dtype ulps;
``rel_ulps=0`` claims are certified BITWISE.

Every harness takes a ``device``: ``"cpu"`` runs the port's plain
versions, ``"cuda"`` runs what the card runs. For
``groupsum-recombine-f32`` that is the group-sum kernel's own output
(``query/kernels.counter_groupsum``, a CUDA launch on a CUDA tensor),
over a world whose windows start and end on samples, so that each group
(one series) reports its recombined boundary delta exactly.

By default each harness runs the reference's world. ``certify(name,
device, **shape)`` widens it where the harness has a width: ``S`` series
for the three counter evaluators, the engine's grid for the group-sum
(``groupsum_delta_world``). ``chip_smoke.py`` certifies those at the
engine's width on the card.

A claim whose measurement exceeds its declared tolerance, or that has no
registered harness, fails: a port that misses a claim is at fault, never
the claim.

The ``@order_insensitive`` claims of the mesh (``grouped-reduce-psum`` on
``parallel/mesh._grouped_reduce``, ``grouped-pair-psum`` on
``parallel/shardstore._grouped_pair``) are certified as the reference
certifies them: their harness runs the site at 1, 2, 4 and 8 partitions
(``DEVICE_COUNTS``, laid on ``device``: the CPU here, one card's
partitions in chip_smoke), and the worst relative deviation of each
output from the 1-partition one must stay within the claim's tolerance.
``append-carry-exact`` (``parallel/shardstore._append_step``) is a
``rel_ulps=0`` claim: certified bitwise against the from-scratch
rebuild.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.lint import numerics as nmod

# claim name -> harness(device, **shape) -> (prod, ref, floor)
HARNESSES: Dict[str, Callable] = {}
# order claim name -> harness(ndev, device) -> output tuple at ndev
# partitions of ``device``
ORDER_HARNESSES: Dict[str, Callable] = {}

# the partition counts an order claim is certified across
DEVICE_COUNTS: Tuple[int, ...] = (1, 2, 4, 8)


def precision_harness(name: str) -> Callable:
    def deco(fn):
        HARNESSES[name] = fn
        return fn
    return deco


def order_harness(name: str) -> Callable:
    def deco(fn):
        ORDER_HARNESSES[name] = fn
        return fn
    return deco


@dataclass
class CertResult:
    name: str
    kind: str                   # precision | order
    ok: bool
    measured: float             # worst ulps observed
    claimed: float
    detail: str = ""
    device: str = "cpu"


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _measure_precision(claim: nmod.PrecisionClaim, prod, ref,
                       floor=0.0) -> CertResult:
    prod = np.asarray(prod)
    ref = np.asarray(ref)
    if prod.shape != ref.shape:
        return CertResult(claim.name, "precision", False, math.inf,
                          claim.rel_ulps,
                          f"shape mismatch {prod.shape} vs {ref.shape}")
    if np.issubdtype(prod.dtype, np.floating):
        nan_p, nan_r = np.isnan(prod), np.isnan(ref)
        if not np.array_equal(nan_p, nan_r):
            return CertResult(claim.name, "precision", False, math.inf,
                              claim.rel_ulps, "NaN structure differs "
                              "between production and reference")
        m = ~nan_p
        if claim.rel_ulps == 0:
            same = np.array_equal(prod[m], ref[m].astype(prod.dtype))
            return CertResult(
                claim.name, "precision", same, 0.0 if same else math.inf,
                0.0, "bitwise" if same else "exact claim but values "
                "differ from the reference")
        pf = prod.astype(np.float64)[m]
        rf = np.asarray(ref, np.float64)[m]
        fl = np.broadcast_to(np.asarray(floor, np.float64), m.shape)[m]
        err = np.maximum(np.abs(pf - rf) - fl, 0.0)
        # one ulp of the reference in the PRODUCTION dtype
        sp = np.spacing(np.abs(rf).astype(prod.dtype)).astype(np.float64)
        sp = np.maximum(sp, float(np.finfo(prod.dtype).tiny))
        ulps = float(np.max(err / sp)) if err.size else 0.0
        return CertResult(
            claim.name, "precision", ulps <= claim.rel_ulps, ulps,
            claim.rel_ulps,
            f"max {ulps:.3g} ulps over {int(m.sum())} values")
    same = np.array_equal(prod, ref)
    return CertResult(claim.name, "precision", same,
                      0.0 if same else math.inf, claim.rel_ulps,
                      "bitwise" if same else "integer outputs differ")


def _rel_dev(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    if not np.array_equal(nan_a, nan_b):
        return math.inf
    m = ~nan_a
    if not m.any():
        return 0.0
    diff = np.abs(a[m] - b[m])
    scale = np.maximum(np.maximum(np.abs(a[m]), np.abs(b[m])), 1e-300)
    return float(np.max(diff / scale))


def _measure_order(claim: nmod.OrderClaim, harness, counts: Sequence[int],
                   device) -> CertResult:
    """Each output of the harness at every partition count against the
    first count's: within the claim's relative tolerance (bitwise for a
    0 tolerance)."""
    results = {}
    for n in counts:
        out = harness(n, device)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        results[n] = [np.asarray(o) for o in out]
    base = results[counts[0]]
    worst = 0.0
    for n in counts[1:]:
        for a, b in zip(base, results[n]):
            if claim.tolerance == 0.0:
                if not np.array_equal(a, b, equal_nan=np.issubdtype(
                        a.dtype, np.floating)):
                    return CertResult(
                        claim.name, "order", False, math.inf, 0.0,
                        f"byte-identity claim but {counts[0]} vs {n} "
                        f"partitions differ", str(device))
            else:
                worst = max(worst, _rel_dev(a, b))
    return CertResult(claim.name, "order", worst <= claim.tolerance, worst,
                      claim.tolerance,
                      f"max rel deviation {worst:.3g} across partition "
                      f"counts {tuple(counts)}", str(device))


# ---------------------------------------------------------------------------
# certify
# ---------------------------------------------------------------------------

def certify_order(name: str, device: str = "cpu") -> CertResult:
    """Certify one registered ``@order_insensitive`` claim across
    ``DEVICE_COUNTS`` partitions of ``device``."""
    nmod.import_annotated_modules()
    claim = nmod.ORDER[name]
    fn = ORDER_HARNESSES.get(name)
    if fn is None:
        return CertResult(name, "order", False, math.inf, claim.tolerance,
                          "no certification harness registered",
                          str(device))
    try:
        return _measure_order(claim, fn, DEVICE_COUNTS, device)
    except Exception as e:  # noqa: BLE001 — a gate must not crash
        return CertResult(name, "order", False, math.inf, claim.tolerance,
                          f"harness crashed: {type(e).__name__}: {e}",
                          str(device))


def certify(name: str, device: str = "cpu", **shape) -> CertResult:
    """Certify one registered ``@precision`` claim on ``device``, its
    harness's world widened by ``shape`` where the harness takes one (the
    counter claims' ``S`` series, the group-sum world's grid); an
    ``@order_insensitive`` claim by :func:`certify_order`. A harness
    that raises, the kernel's build or launch included, is a failed
    certification."""
    nmod.import_annotated_modules()
    if name in nmod.ORDER:
        return certify_order(name, device, **shape)
    claim = nmod.PRECISION[name]
    fn = HARNESSES.get(name)
    if fn is None:
        return CertResult(name, "precision", False, math.inf,
                          claim.rel_ulps, "no certification harness "
                          "registered — an annotation the rail cannot "
                          "evaluate cannot ship", device)
    try:
        prod, ref, floor = fn(device, **shape)
    except Exception as e:  # noqa: BLE001 — a gate must not crash
        return CertResult(name, "precision", False, math.inf,
                          claim.rel_ulps, f"harness crashed: "
                          f"{type(e).__name__}: {e}", device)
    res = _measure_precision(claim, prod, ref, floor)
    res.device = str(device)
    return res


def certify_all(device: str = "cpu") -> List[CertResult]:
    """Certify every registered claim on ``device``."""
    nmod.import_annotated_modules()
    out = [certify(name, device) for name in sorted(nmod.PRECISION)]
    out += [certify_order(name, device) for name in sorted(nmod.ORDER)]
    return out


# ---------------------------------------------------------------------------
# in-tree harnesses
# ---------------------------------------------------------------------------
#
# The seeded worlds are the reference's (filodb_tpu/lint/ulpcert.py), so
# both packages' sites are certified on identical inputs.

_SEED = 0x0DD5


def _tensor(a, device, dtype=None):
    import torch
    return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)


def _numpy(t):
    return t.detach().cpu().numpy()


def _counter_world(jitter: bool = True, S: int = 8):
    """Shared synthetic world: [N, S] transposed dense counter tiles
    with large-magnitude values (the catastrophic-cancellation regime
    the f64 value channel exists for). ``S`` = 8 is the reference's
    world; a wider one has the same grid and more series."""
    rng = np.random.default_rng(_SEED)
    N = 128
    dt = 10_000
    base = 1_700_000_000_000
    jit_ms = rng.integers(-2000, 2001, (N, S)) if jitter \
        else np.zeros((N, S), dtype=np.int64)
    ts = base + np.arange(N, dtype=np.int64)[:, None] * dt + jit_ms
    # counters starting at ~1e12 with ~O(10) increments: deltas are
    # exact in f64, catastrophically cancelled in a pure-f32 channel
    v = (1e12 + rng.uniform(0, 1e3, S)[None, :]
         + np.cumsum(rng.uniform(1.0, 20.0, (N, S)), axis=0))
    grid = dict(num_slots=N, base=base, dt=dt,
                w0s=base + 20 * dt + 1_500, w0e=base + 26 * dt + 1_500,
                step=2 * dt, nsteps=16)
    return ts, v, grid


KNIFE_MS = 1        # an edge gap within 1 ms of its threshold


def _off_knife_edges(prod, ref, ts, grid):
    """``prod`` and ``ref`` with every window whose extrapolation branch
    is a knife edge (a start or end gap within KNIFE_MS of 1.1 times the
    average interval, where an f32 and an f64 evaluation may take
    different branches) set to NaN in both: the claims bound rounding,
    not a branch taken the other way (the generated soak counts those
    apart). None in the reference's worlds; a wider world has a few."""
    prod = np.array(prod, dtype=np.float64 if prod.dtype == np.float64
                    else np.float32)
    ref = np.array(ref, dtype=np.float64)
    for t in range(grid["nsteps"]):
        ws = grid["w0s"] + t * grid["step"]
        we = grid["w0e"] + t * grid["step"]
        m = (ts >= ws) & (ts <= we)
        n = m.sum(axis=0)
        first = np.where(m, ts, np.iinfo(np.int64).max).min(axis=0)
        last = np.where(m, ts, np.iinfo(np.int64).min).max(axis=0)
        ok = n >= 2
        thr = 1.1 * (last - first) / np.maximum(n - 1, 1)
        knife = ok & ((np.abs((first - ws) - thr) <= KNIFE_MS)
                      | (np.abs((we - last) - thr) <= KNIFE_MS))
        prod[t, knife] = np.nan
        ref[t, knife] = np.nan
    return prod, ref


def _ref_windows(ts, v, grid, func="rate"):
    """Pure-Python per-window reference (promql/refeval semantics) ->
    [T, S] f64."""
    from filodb_tpu_torch.promql.refeval import eval_range_fn
    T, S = grid["nsteps"], ts.shape[1]
    out = np.full((T, S), np.nan)
    for s in range(S):
        ts_l = [int(x) for x in ts[:, s]]
        v_l = [float(x) for x in v[:, s]]
        for t in range(T):
            we = grid["w0e"] + t * grid["step"]
            ws = grid["w0s"] + t * grid["step"]
            out[t, s] = eval_range_fn(func, ts_l, v_l, ws, we)
    return out


def _exact_rate(ts, v, g):
    """The exact-f64 evaluator on the CPU: the reference side of the
    hybrid claims, whatever device the hybrid ran on."""
    import torch

    from filodb_tpu_torch.query.tilestore import _eval_counter_t
    arrs = {"ts": torch.as_tensor(ts, dtype=torch.float64),
            "ff_v": torch.as_tensor(v)}
    return _numpy(_eval_counter_t(
        "rate", g["nsteps"], arrs, g["num_slots"], g["base"], g["dt"],
        g["w0s"], g["w0e"], g["step"]))


@precision_harness("counter-exact-slot-index")
def _h_counter_exact(device="cpu", S=8):
    import torch

    from filodb_tpu_torch.query.tilestore import _eval_counter_t
    ts, v, g = _counter_world(S=S)
    arrs = {"ts": _tensor(ts, device, torch.float64),
            "ff_v": _tensor(v, device)}
    prod = _numpy(_eval_counter_t(
        "rate", g["nsteps"], arrs, g["num_slots"], g["base"], g["dt"],
        g["w0s"], g["w0e"], g["step"]))
    return (*_off_knife_edges(prod, _ref_windows(ts, v, g), ts, g), 0.0)


@precision_harness("counter-fast-hybrid")
def _h_counter_fast(device="cpu", S=8):
    from filodb_tpu_torch.query.tilestore import _eval_counter_fast
    ts, v, g = _counter_world(S=S)
    tsr = (ts - g["base"]).astype(np.int32)
    prod = _numpy(_eval_counter_fast(
        "rate", g["nsteps"], {"tsr": _tensor(tsr, device),
                              "ff_v": _tensor(v, device)},
        g["num_slots"], g["base"], g["dt"], g["w0s"], g["w0e"],
        g["step"]))
    return (*_off_knife_edges(prod, _exact_rate(ts, v, g), ts, g), 0.0)


@precision_harness("counter-slide-hybrid")
def _h_counter_slide(device="cpu", S=8):
    from filodb_tpu_torch.query.tilestore import _eval_counter_slide
    ts, v, g = _counter_world(jitter=False, S=S)    # regular grid: st = 2
    st = g["step"] // g["dt"]
    N = ts.shape[0]

    def perm(a, dtype):
        G = -(-N // st) + g["nsteps"] + 4
        pad = G * st - N
        ap = np.concatenate([a, np.zeros((pad, S), a.dtype)], axis=0)
        return _tensor(np.ascontiguousarray(
            ap.reshape(G, st, S).swapaxes(0, 1).astype(dtype)), device)

    tsr = (ts - g["base"]).astype(np.int32)
    arrs = {"tsr_p": perm(tsr, np.int32), "ff_v_p": perm(v, np.float64)}
    prod = _numpy(_eval_counter_slide(
        "rate", g["nsteps"], st, arrs, g["num_slots"], g["base"],
        g["dt"], g["w0s"], g["w0e"], g["step"]))
    return (*_off_knife_edges(prod, _exact_rate(ts, v, g), ts, g), 0.0)


@precision_harness("counter-epilogue-f32")
def _h_epilogue(device="cpu"):
    """_f32_epilogue vs the f64 reference formula. Inputs keep the
    extrapolation branches away from knife edges (dstart/dend well
    under threshold, dzero far above) so production and reference take
    the SAME branch and only rounding differs."""
    import torch

    from filodb_tpu_torch.query.tilestore import _f32_epilogue, _wdur_s
    rng = np.random.default_rng(_SEED + 1)
    T, S = 48, 8
    counts = rng.integers(5, 50, (T, S)).astype(np.int32)
    wstart = (np.arange(T, dtype=np.int64)[:, None] * 60_000)
    wdur = 300_000
    wend = wstart + wdur
    t1 = (wstart + rng.integers(100, 400, (T, S))).astype(np.int64)
    t2 = (wend - rng.integers(100, 400, (T, S))).astype(np.int64)
    v1 = 1e6 + rng.uniform(0, 1e3, (T, S))
    v2 = v1 + rng.uniform(5.0, 500.0, (T, S))
    i32 = torch.int32
    prod = _numpy(_f32_epilogue(
        "rate", _tensor(counts, device), _tensor(t1, device, i32),
        _tensor(v1, device), _tensor(t2, device, i32), _tensor(v2, device),
        _tensor(wstart, device, i32), _tensor(wend, device, i32),
        _wdur_s(0, wdur, device)))
    # f64 reference, same formula
    delta = v2 - v1
    sampled = (t2 - t1) / 1000.0
    dstart = (t1 - wstart) / 1000.0
    dend = (wend - t2) / 1000.0
    avg_dur = sampled / (counts - 1.0)
    dzero = np.where((delta > 0) & (v1 >= 0),
                     sampled * (v1 / np.where(delta == 0, np.nan,
                                              delta)), np.inf)
    dstart = np.minimum(dstart, dzero)
    thresh = avg_dur * 1.1
    extrap = sampled \
        + np.where(dstart < thresh, dstart, avg_dur * 0.5) \
        + np.where(dend < thresh, dend, avg_dur * 0.5)
    ref = delta * (extrap / sampled) / (wdur / 1000.0)
    ref = np.where(counts >= 2, ref, np.nan)
    return prod, ref, 0.0


def _fixed_tiles(vals, dt, device):
    """Exact-grid dense tiles over ``vals`` [S, N] (slot k at k*dt)."""
    from filodb_tpu_torch.query.tilestore import AlignedTiles
    S, N = vals.shape
    ts = (np.arange(N, dtype=np.int64)[None, :] * dt
          + np.zeros((S, 1), np.int64)) * 1.0
    return AlignedTiles([{"i": str(i)} for i in range(S)], 0, dt,
                        np.ones((S, N), dtype=bool), ts, vals,
                        device=device)


@precision_harness("fixed-point-split")
def _h_fixed_split(device="cpu"):
    """The 61-bit hi/lo split (computed on ``device``) + the kernel's
    f32 recombine (dh*2^(31-s) + dl*2^-s) vs the direct f64 boundary
    delta, with the declared span*2^-59 quantization floor."""
    rng = np.random.default_rng(_SEED + 2)
    N, S = 64, 8
    # mixed magnitudes: huge counters, small gauges, negatives
    scales = np.array([1e12, 1e6, 1.0, 1e-3, 5e8, 42.0, 1e10, 7.0])
    vals = (scales[:, None]
            * (1.0 + np.cumsum(rng.uniform(0, 1e-4, (S, N)), axis=1)))
    vals[2] = rng.uniform(-50, 50, N)                # sign-mixed gauge
    fx = _fixed_tiles(vals, 10_000, device)._fixed_channels("v")
    assert fx is not None
    hi, lo, _mid, s = (_numpy(x) for x in fx)        # [N, S], [S]
    c1 = np.ldexp(np.float32(1.0), 31 - s).astype(np.float32)
    c2 = np.ldexp(np.float32(1.0), -s).astype(np.float32)
    i, j = 10, 50                                    # boundary pair
    dh = (hi[j] - hi[i]).astype(np.float32)
    dl = (lo[j] - lo[i]).astype(np.float32)
    prod = dh * c1 + dl * c2                         # [S] f32
    ref = (vals[:, j] - vals[:, i])                  # [S] f64
    span = vals.max(axis=1) - vals.min(axis=1)
    floor = span * 2.0 ** -59
    return prod, ref, floor


def groupsum_delta_world(device="cpu", S: int = 8, N: int = 64,
                         step_slots: Optional[int] = None,
                         window_slots: Optional[int] = None,
                         nsteps: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``delta`` through ``counter_groupsum`` over ``S`` exact-grid dense
    series of ``N`` slots, one group per series, every window starting
    and ending on a sample: the extrapolation factor is then exactly 1
    and each group's sum its one series' recombined delta, so the
    kernel's output is the recombine itself. The default is the
    reference harness's world: the one full-span window, slots 0 to
    N-1 (dl wide enough to round in f32). With ``step_slots`` and
    ``window_slots`` the grid is the engine's (a window of
    ``window_slots`` slots every ``step_slots``, ``nsteps`` steps or as
    many as the tile holds). Returns (prod f32 [T, S], ref f64 [T, S],
    floor [S])."""
    import torch

    from filodb_tpu_torch.query import kernels as kn
    rng = np.random.default_rng(_SEED + 6)
    dt = 10_000
    scales = np.array([1e12, 1e6, 1.0, 1e-3, 5e8, 42.0, 1e10, 7.0])
    scales = np.resize(scales, S)
    vals = (scales[:, None]
            * (1.0 + np.cumsum(rng.uniform(0, 0.2, (S, N)), axis=1)))
    tiles = _fixed_tiles(vals, dt, device)
    if step_slots is None:
        st, dspan, kl0, T = N - 1, 1, 0, 1
    else:
        st = step_slots
        assert window_slots % st == 0
        dspan = window_slots // st
        kl0 = 1
        T = (N - 1 - kl0 - dspan * st) // st + 1
        assert nsteps is None or 1 <= nsteps <= T, "grid outside the tile"
        T = nsteps or T
    kc0 = kl0 + dspan * st
    v_p = tiles.t_perm_fixed_tiled("v", st)
    base = tiles.t_fixed_base("v")
    S_pad = v_p.shape[0] * kn.GS_SS
    onehot = torch.zeros((S_pad, S), dtype=torch.float32, device=device)
    onehot[torch.arange(S, device=device),
           torch.arange(S, device=device)] = 1.0
    sums, cnts = kn.counter_groupsum(
        "delta", st, dspan, kn.GS_CUR, kn.GS_CUR, v_p, base, onehot, kl0,
        kc0 * dt, dspan * st * dt, st * dt, T)
    assert bool((cnts == 1.0).all()), "a window lost its samples"
    t = np.arange(T)
    ref = vals[:, kc0 + t * st].T - vals[:, kl0 + t * st].T   # [T, S]
    span = vals.max(axis=1) - vals.min(axis=1)
    return _numpy(sums), ref, span * 2.0 ** -59


@precision_harness("groupsum-recombine-f32")
def _h_groupsum_recombine(device="cpu", **grid):
    """The group-sum kernel's recombine (csrc/counter_groupsum.cu:
    ``delta = dh * c1 + dl * c2``): exact int32 hi/lo deltas over
    FULL-SPAN boundary pairs (dl wide enough to round in f32),
    recombined in f32 by the kernel (its plain version on the CPU), vs
    the direct f64 delta; ``grid`` widens the world to the engine's
    (``groupsum_delta_world``)."""
    prod, ref, floor = groupsum_delta_world(device, **grid)
    return prod, ref, floor[None, :]


@precision_harness("extrapolated-rate-f64")
def _h_extrapolated_rate(device="cpu"):
    """backend._extrapolated_rate (the shared f64 formula) vs the
    pure-Python reference loop (promql/refeval._extrapolated) on the
    same boundary tuples."""
    import torch

    from filodb_tpu_torch.promql.refeval import _extrapolated
    from filodb_tpu_torch.query.backend import _extrapolated_rate
    rng = np.random.default_rng(_SEED + 7)
    T, S = 32, 8
    wstart = np.arange(T, dtype=np.int64)[:, None] * 60_000
    wend = wstart + 300_000
    counts = rng.integers(2, 40, (T, S))
    t1 = wstart + rng.integers(50, 2_000, (T, S))
    t2 = wend - rng.integers(50, 2_000, (T, S))
    v1 = 1e9 + rng.uniform(0, 1e3, (T, S))
    v2 = v1 + rng.uniform(0.0, 800.0, (T, S))
    f64 = torch.float64
    prod = _numpy(_extrapolated_rate(
        _tensor(wstart, device, f64), _tensor(wend, device, f64),
        _tensor(counts, device), _tensor(t1, device, f64),
        _tensor(v1, device), _tensor(t2, device, f64), _tensor(v2, device),
        True, True))
    ref = np.full((T, S), np.nan)
    for t in range(T):
        for si in range(S):
            n = int(counts[t, si])
            sts = [int(t1[t, si])] + [int(t1[t, si])] * max(n - 2, 0) \
                + [int(t2[t, si])]
            svs = [float(v1[t, si])] * max(n - 1, 1) \
                + [float(v2[t, si])]
            ref[t, si] = _extrapolated(
                int(wstart[t, 0]), int(wend[t, 0]), sts[:n], svs[:n],
                is_counter=True, is_rate=True) if n >= 2 else np.nan
    return prod, ref, 0.0


@precision_harness("append-carry-exact")
def _h_append_carry(device="cpu"):
    """In-place append vs from-scratch rebuild, reset-free block:
    bitwise (the annotation's exact claim)."""
    import torch

    from filodb_tpu_torch.parallel.shardstore import _append_step
    rng = np.random.default_rng(_SEED + 3)
    C, S, n, K = 64, 8, 40, 12
    v_full = np.cumsum(rng.uniform(0.5, 10.0, (n + K, S)), axis=0) + 1e9
    tsr = np.zeros((C, S), np.int32)
    v = np.zeros((C, S))
    cv = np.zeros((C, S))
    v[:n] = v_full[:n]
    cv[:n] = v_full[:n]            # no resets: corrected == raw
    new_tsr = np.arange(K, dtype=np.int32)[:, None] + np.zeros(
        (1, S), np.int32)
    _, _, out_cv = _append_step(
        _tensor(tsr, device), _tensor(v, device), _tensor(cv, device),
        _tensor(new_tsr, device), _tensor(v_full[n:], device), n)
    prod = _numpy(out_cv)[n:n + K]
    ref = v_full[n:]               # rebuild: no resets -> cv == v
    assert out_cv.dtype == torch.float64
    return prod, ref, 0.0


def _partition_mesh(ndev: int, device):
    """``ndev`` shard partitions of ``device`` (time axis 1)."""
    import torch

    from filodb_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(ndev, 1, [torch.device(device)] * ndev)


@order_harness("grouped-reduce-psum")
def _h_grouped_reduce(ndev: int, device="cpu"):
    """``_grouped_reduce`` of the reference harness's seeded [16, 12]
    world (10 % stale entries, two padding rows) for sum and avg, its
    rows split over ``ndev`` partitions as the reference's shard_map
    splits them."""
    from filodb_tpu_torch.parallel.mesh import _grouped_reduce
    rng = np.random.default_rng(_SEED + 4)
    S, T, G = 16, 12, 4
    local = rng.normal(0, 1e3, (S, T))
    local[rng.random((S, T)) < 0.1] = np.nan         # stale entries
    gids = rng.integers(0, G, S).astype(np.int32)
    gids[-2:] = -1                                    # padding rows
    mesh = _partition_mesh(ndev, device)
    rows = S // ndev
    locs = [_tensor(local[i * rows:(i + 1) * rows], mesh.devices[i, 0])
            for i in range(ndev)]
    gs = [_tensor(gids[i * rows:(i + 1) * rows], mesh.devices[i, 0])
          for i in range(ndev)]
    return tuple(_numpy(_grouped_reduce(locs, gs, G, agg))
                 for agg in ("sum", "avg"))


@order_harness("grouped-pair-psum")
def _h_grouped_pair(ndev: int, device="cpu"):
    """The fused grouped pair (``ShardedTiles.eval_grouped_pair``, rate)
    over the counter world, its series in 3 seeded groups, at ``ndev``
    shard partitions."""
    from filodb_tpu_torch.parallel.shardstore import ShardedTiles
    from filodb_tpu_torch.query.tilestore import AlignedTiles
    ts, v, g = _counter_world()
    N, S = ts.shape
    rng = np.random.default_rng(_SEED + 5)
    gids = rng.integers(0, 3, S).astype(np.int32)
    tiles = AlignedTiles([{"i": str(i)} for i in range(S)], g["base"],
                         g["dt"], np.ones((S, N), bool), ts.T * 1.0, v.T,
                         device=device)
    st = ShardedTiles(_partition_mesh(ndev, device), tiles)
    steps = g["w0e"] + np.arange(g["nsteps"], dtype=np.int64) * g["step"]
    return st.eval_grouped_pair("rate", steps, g["w0e"] - g["w0s"], gids, 3)

