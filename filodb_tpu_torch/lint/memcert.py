"""Capacity-certification rail of the port: every ``@capacity`` residency
claim declared in ``filodb_tpu_torch`` is built by its harness and its
device bytes measured — the memory twin of
:mod:`filodb_tpu_torch.lint.ulpcert`.

:mod:`filodb_tpu_torch.lint.rules_capacity` makes a ``@capacity`` claim
mandatory wherever a device tensor escapes into a long-lived store; this
module makes the claims HONEST. For each registered claim a harness
builds the annotated structure on a device (seeded sizes by default, the
engine's widths when asked) and the rail measures the device bytes it
retains: a walk over the store's object graph that counts each distinct
tensor STORAGE once, at the storage's full size (a narrow view keeps its
whole storage resident), on the harness's device only (tensors elsewhere
and numpy arrays do not count). The claim is then checked two-sided:

  * ``measured > claimed`` — the store is bigger than declared: the
    capacity planning the ledger feeds (resident series per card) would
    overcommit device memory;
  * ``claimed > 1.25 x measured`` — the claim pads more than 25 % over
    reality: a slack claim hides regressions exactly the way a slack ULP
    tolerance does.

On CUDA the rail also reads the caching allocator before and after each
harness build and reports two deltas beside the walk, independent
measures of what the build keeps: the bytes its tensors requested
(``requested_bytes.all.current`` of ``torch.cuda.memory_stats``), which
chip_smoke holds to the walk within 512 B per storage, and
``torch.cuda.memory_allocated()``, the blocks handed out, which may
exceed the request by a block's unsplit remainder (up to 1 MiB a
storage: the allocator splits a cached large block only when more than
1 MiB would remain).

Sharded claims (``sharded=True``) certify at 1, 2, 4 and 8 partitions of
the device (as ``ulpcert._partition_mesh`` lays them) — shard-alignment
padding must be priced at every mesh width. A claim with no harness, or
whose harness crashes, fails: an annotation the rail cannot evaluate
cannot ship. Failures surface as ``capacity-certification`` findings of
``python -m filodb_tpu_torch.lint``. Results are memoized per process
and device (claims are fixed at import time).

:func:`capacity_ledger` renders the certified inventory: per claim the
certified bytes budget and the projected resident series per card of
``hbm_bytes`` (the card's ``total_memory`` on CUDA).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from filodb_tpu_torch.lint import Finding, register_rule
from filodb_tpu_torch.lint import capacity as cmod

register_rule("capacity-certification", "capacity",
              "a @capacity residency claim failed dynamic "
              "certification (measured device bytes above the claim, "
              "claim >1.25x over measured, or no harness) — the "
              "declared bytes budget is a lie")

DEVICE_COUNTS: Tuple[int, ...] = (1, 2, 4, 8)

# a claim may pad at most 25% over the measured footprint
OVERCLAIM_RATIO = 1.25

# claim name -> harness. Sharded harnesses take (ndev, device, **shape),
# the others (device, **shape). Both return (store, n_samples,
# n_series): ``store`` is walked for device bytes (or is already a byte
# count), ``n_samples``/``n_series`` are the PADDED logical sizes the
# claim is evaluated at.
HARNESSES: Dict[str, Callable] = {}


def capacity_harness(name: str) -> Callable:
    def deco(fn):
        HARNESSES[name] = fn
        return fn
    return deco


@dataclass
class CapResult:
    name: str
    ok: bool
    measured: float             # worst-case live device bytes observed
    claimed: float              # claim total at the harness sizes
    n_samples: int = 0
    n_series: int = 0
    detail: str = ""
    device_counts: Tuple[int, ...] = ()
    device: str = "cpu"
    storages: int = 0           # distinct storages the walk counted
    # CUDA only, after the build less before, at the same partition
    # count as ``measured``: torch.cuda.memory_allocated() and the
    # allocator's requested bytes
    alloc_delta: Optional[int] = None
    requested_delta: Optional[int] = None


# ---------------------------------------------------------------------------
# live-storage walk
# ---------------------------------------------------------------------------


def _same_device(dev, want) -> bool:
    if want is None:
        return True
    want = str(want)
    if ":" not in want:
        return dev.type == want
    return str(dev) == want


def storage_walk(obj, device=None, max_depth: int = 10
                 ) -> Tuple[int, int]:
    """(bytes, storages) of every distinct tensor storage on ``device``
    (any device when None) reachable from ``obj``: dicts, sequences,
    object attributes (``__dict__`` and ``__slots__``), and function
    closures. A storage counts once, at its full ``nbytes``, however
    many views reach it; numpy arrays never count."""
    import torch
    seen_objs: set = set()
    stores: Dict[Tuple[str, int], int] = {}
    stack: List[Tuple[object, int]] = [(obj, 0)]
    while stack:
        cur, depth = stack.pop()
        if cur is None or depth > max_depth:
            continue
        oid = id(cur)
        if oid in seen_objs:
            continue
        seen_objs.add(oid)
        if isinstance(cur, torch.Tensor):
            if _same_device(cur.device, device) \
                    and cur.device.type != "meta":
                st = cur.untyped_storage()
                stores[(str(cur.device), st.data_ptr())] = st.nbytes()
            continue
        if isinstance(cur, (str, bytes, int, float, bool, complex)):
            continue
        if type(cur).__module__ == "numpy":
            continue
        if isinstance(cur, dict):
            stack.extend((v, depth + 1) for v in cur.values())
            continue
        if isinstance(cur, (list, tuple, set, frozenset)):
            stack.extend((v, depth + 1) for v in cur)
            continue
        d = getattr(cur, "__dict__", None)
        if isinstance(d, dict):
            stack.extend((v, depth + 1) for v in d.values())
        for klass in type(cur).__mro__:
            for slot in getattr(klass, "__slots__", ()):
                try:
                    stack.append((getattr(cur, slot), depth + 1))
                except AttributeError:
                    pass
        cells = getattr(cur, "__closure__", None)
        if cells:
            for cell in cells:
                try:
                    stack.append((cell.cell_contents, depth + 1))
                except ValueError:      # empty cell
                    pass
    return sum(stores.values()), len(stores)


def device_bytes(obj, device=None) -> int:
    """Bytes of the distinct storages on ``device`` reachable from
    ``obj`` (:func:`storage_walk`)."""
    return storage_walk(obj, device)[0]


def _allocator(device) -> Optional[Tuple[int, int]]:
    """(memory_allocated, requested bytes) of the CUDA caching allocator,
    None off CUDA."""
    import torch
    if not str(device).startswith("cuda"):
        return None
    torch.cuda.synchronize(device)
    stats = torch.cuda.memory_stats(device)
    return (int(stats["allocated_bytes.all.current"]),
            int(stats["requested_bytes.all.current"]))


def _measure(harness: Callable, args: tuple, device, shape: dict
             ) -> Tuple[float, int, int, int, Optional[Tuple[int, int]]]:
    """Build through ``harness(*args, **shape)`` and measure: (walk
    bytes, n_samples, n_series, storages, the allocator's (allocated,
    requested) deltas or None). The store is dropped before returning."""
    before = _allocator(device)
    store, ns, nr = harness(*args, **shape)
    after = _allocator(device)
    if isinstance(store, (int, float)):
        measured, n_st = float(store), 0
    else:
        b, n_st = storage_walk(store, device)
        measured = float(b)
    del store
    delta = None if before is None else (after[0] - before[0],
                                         after[1] - before[1])
    return measured, int(ns), int(nr), n_st, delta


# ---------------------------------------------------------------------------
# certify
# ---------------------------------------------------------------------------

_MEMO: Dict[str, List[CapResult]] = {}


def _check(claim: cmod.CapacityClaim, measured: float, n_samples: int,
           n_series: int, counts: Tuple[int, ...]) -> CapResult:
    claimed = claim.claimed_total(n_samples, n_series)
    if measured > claimed:
        return CapResult(
            claim.name, False, measured, claimed, n_samples, n_series,
            f"store holds {measured:.0f} device bytes, claim covers "
            f"{claimed:.0f} at {n_samples} samples x {n_series} series "
            f"— residency above budget", counts)
    if claimed > OVERCLAIM_RATIO * max(measured, 1.0):
        return CapResult(
            claim.name, False, measured, claimed, n_samples, n_series,
            f"claim {claimed:.0f} is {claimed / max(measured, 1.0):.2f}x "
            f"the measured {measured:.0f} bytes — slack claims hide "
            f"regressions", counts)
    return CapResult(claim.name, True, measured, claimed, n_samples,
                     n_series, f"{measured:.0f} bytes measured vs "
                     f"{claimed:.0f} claimed", counts)


def certify(name: str, device: str = "cpu",
            counts: Optional[Sequence[int]] = None, **shape) -> CapResult:
    """Certify one registered claim on ``device``, its harness widened by
    ``shape``; a sharded claim at each of ``counts`` partitions (default
    :data:`DEVICE_COUNTS`), the worst reading kept (the first failing
    one, else the largest). A harness that raises fails the claim."""
    cmod.import_annotated_modules()
    claim = cmod.CAPACITY[name]
    harness = HARNESSES.get(name)
    if harness is None:
        return CapResult(
            name, False, math.inf, 0.0,
            detail="no certification harness registered — an "
                   "annotation the rail cannot evaluate cannot ship",
            device=str(device))
    try:
        if claim.sharded:
            counts = tuple(counts or DEVICE_COUNTS)
            worst: Optional[CapResult] = None
            for n in counts:
                measured, ns, nr, n_st, delta = _measure(
                    harness, (n, device), device, shape)
                r = _check(claim, measured, ns, nr, counts)
                r.storages = n_st
                if delta is not None:
                    r.alloc_delta, r.requested_delta = delta
                if worst is None or (not r.ok) or \
                        (worst.ok and r.measured > worst.measured):
                    worst = r
                if not r.ok:
                    worst.detail += f" (at {n} partition(s))"
                    break
            worst.device = str(device)
            return worst
        measured, ns, nr, n_st, delta = _measure(harness, (device,),
                                                 device, shape)
        r = _check(claim, measured, ns, nr, ())
        r.storages, r.device = n_st, str(device)
        if delta is not None:
            r.alloc_delta, r.requested_delta = delta
        return r
    except Exception as e:  # noqa: BLE001 — a gate must not crash
        return CapResult(name, False, math.inf, 0.0,
                         detail=f"harness crashed: "
                                f"{type(e).__name__}: {e}",
                         device=str(device))


def certify_all(device: str = "cpu", force: bool = False
                ) -> List[CapResult]:
    """Certify every registered claim on ``device`` at the harnesses'
    default sizes. Memoized per process and device."""
    key = str(device)
    if key in _MEMO and not force:
        return _MEMO[key]
    cmod.import_annotated_modules()
    out = [certify(name, device) for name in sorted(cmod.CAPACITY)]
    _MEMO[key] = out
    return out


def _claim_anchor(claim, mods) -> Tuple[Optional[str], int]:
    relpath = claim.module.replace(".", "/") + ".py"
    for mod in mods or ():
        if mod.relpath == relpath:
            for i, line in enumerate(mod.lines, start=1):
                if claim.name in line:
                    return relpath, i
            return relpath, 1
    return relpath, 1


def check_certifications(mods=None
                         ) -> List[Tuple[Optional[str], Finding]]:
    """Lint-facing entry: one finding per failed certification on the
    CPU."""
    out: List[Tuple[Optional[str], Finding]] = []
    for res in certify_all("cpu"):
        if res.ok:
            continue
        claim = cmod.CAPACITY.get(res.name)
        if claim is None:
            continue
        relpath, line = _claim_anchor(claim, mods)
        out.append((relpath, Finding(
            rule="capacity-certification", path=relpath or "?",
            line=line,
            message=(f"capacity claim {res.name!r} failed "
                     f"certification: measured {res.measured:.4g} vs "
                     f"claimed {res.claimed:.4g} bytes — {res.detail}"),
            context=f"memcert:{res.name}")))
    return out


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


def ledger_row(claim: cmod.CapacityClaim, r: Optional[CapResult],
               samples_per_series: int = 2880,
               hbm_bytes: int = cmod.HBM_BYTES_PER_CHIP) -> Dict[str, object]:
    """One claim's row: its budget, the certification's reading, and the
    projected resident series on a card of ``hbm_bytes``."""
    return {
        "family": claim.name,
        "module": claim.module,
        "qualname": claim.qualname,
        "sharded": claim.sharded,
        "certified": bool(r and r.ok),
        "claimed_bytes_per_sample": claim.bytes_per_sample,
        "claimed_bytes_per_series": claim.bytes_per_series,
        "claimed_overhead_bytes": claim.overhead_bytes,
        "measured_bytes": (None if r is None or
                           not math.isfinite(r.measured) else r.measured),
        "alloc_delta_bytes": r.alloc_delta if r else None,
        "requested_delta_bytes": r.requested_delta if r else None,
        "storages": r.storages if r else 0,
        "harness_n_samples": r.n_samples if r else 0,
        "harness_n_series": r.n_series if r else 0,
        "measured_bytes_per_sample": (r.measured / r.n_samples
                                      if r and r.n_samples
                                      and math.isfinite(r.measured)
                                      else None),
        "device_counts": list(r.device_counts) if r else [],
        "device": r.device if r else None,
        "hbm_bytes": int(hbm_bytes),
        "samples_per_series": int(samples_per_series),
        "projected_series_per_device":
            claim.projected_series_per_chip(samples_per_series, hbm_bytes),
        "reason": claim.reason,
    }


def device_memory_bytes(device: str = "cpu") -> int:
    """The card's ``total_memory`` on CUDA, else the default card size
    of :data:`~filodb_tpu_torch.lint.capacity.HBM_BYTES_PER_CHIP`."""
    if str(device).startswith("cuda"):
        import torch
        return int(torch.cuda.get_device_properties(
            torch.device(device)).total_memory)
    return cmod.HBM_BYTES_PER_CHIP


def capacity_ledger(samples_per_series: int = 2880,
                    hbm_bytes: Optional[int] = None,
                    device: str = "cpu") -> List[Dict[str, object]]:
    """Certified inventory: per claim the claimed budget, the measured
    bytes at the harness sizes on ``device``, and the projected resident
    series per card of ``hbm_bytes`` (default: the device's memory) at
    ``samples_per_series`` retained samples (8 h at 10 s)."""
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes(device)
    results = {r.name: r for r in certify_all(device)}
    return [ledger_row(claim, results.get(name), samples_per_series,
                       hbm_bytes)
            for name, claim in sorted(cmod.CAPACITY.items())]


# ---------------------------------------------------------------------------
# in-tree harnesses
# ---------------------------------------------------------------------------
#
# The reference's seeds and sizes (filodb_tpu/lint/memcert.py): the padded
# layout is exercised (pow2 slot capacity above the logical slot count,
# series counts divisible by every certified partition count). Each
# harness takes the device and, where the claim has widths, the shape
# chip_smoke certifies at full width.

_SEED = 0x0DD5


def seed_rows(S: int = 16, N: int = 56):
    """Dense counter rows: S series x N slots at 10 s +/-2 s -> (base,
    dt, valid, ts, vals) as numpy (N need not be a power of two, so the
    pow2 capacity pad is live in the shardstore's measurement)."""
    import numpy as np
    rng = np.random.default_rng(_SEED)
    base, dt = 1_000_000_000_000, 10_000
    ts = (base + np.arange(N, dtype=np.float64)[None, :] * dt
          + rng.integers(-2000, 2001, (S, N)))
    vals = np.cumsum(rng.uniform(0, 5, (S, N)), axis=1)
    return base, dt, np.ones((S, N), bool), ts, vals


def _seed_tiles(device, S: int = 16, N: int = 56, rows=None):
    from filodb_tpu_torch.query.tilestore import AlignedTiles
    base, dt, valid, ts, vals = rows if rows is not None \
        else seed_rows(S, N)
    return AlignedTiles([{"i": str(i)} for i in range(valid.shape[0])],
                        base, dt, valid, ts, vals, device=device)


def _partition_mesh(ndev: int, device):
    """``ndev`` shard partitions of ``device`` (time axis 1)."""
    import torch

    from filodb_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(ndev, 1, [torch.device(device)] * ndev)


@capacity_harness("shardstore-resident-channels")
def _h_shardstore(ndev: int, device="cpu", S: int = 16, N: int = 56,
                  rows=None):
    """The resident store itself: [cap, S_pad] int32 rel-ts + raw f64 +
    corrected f64 = 20 B per padded slot, at every partition count."""
    from filodb_tpu_torch.parallel.shardstore import ShardedTiles
    tiles = _seed_tiles(device, S, N, rows)     # cap pads 56 -> 64
    st = ShardedTiles(_partition_mesh(ndev, device), tiles)
    return st, st.cap * st.S_pad, st.S_pad


@capacity_harness("tilestore-aligned-tiles")
def _h_aligned_tiles(device="cpu", S: int = 8, N: int = 64, rows=None):
    """Single-device aligned tiles: valid bool + ts f64 + vals f64 =
    17 B per slot (the lazy channel caches empty at build)."""
    tiles = _seed_tiles(device, S, N, rows)
    S, N = tiles.valid.shape
    return tiles, S * N, S


@capacity_harness("device-tile-cache")
def _h_tile_cache(device="cpu", S: int = 8, N: int = 64, entries=None):
    """The backend tile cache retains whole AlignedTiles cohorts per
    selection snapshot (FIFO-capped at _TILE_CACHE_MAX). ``entries``:
    lists of RawSeries, one cache entry built over each (phase 4's
    selections in chip_smoke); by default one seeded cohort."""
    import numpy as np

    from filodb_tpu_torch.query import backend as bmod
    from filodb_tpu_torch.query.model import RawSeries
    be = bmod.TorchBackend(device=device, batcher=None)
    if entries is None:
        base, dt, valid, ts, vals = seed_rows(S, N)
        entries = [[RawSeries({"i": str(i)}, ts[i].astype(np.int64),
                              vals[i], True) for i in range(S)]]
    n_samples = n_series = 0
    for i, series in enumerate(entries):
        entry = be._build_tile_entry(series, False)
        be._insert_tile_entry(("memcert", "tile-cache", i), None, entry)
        if entry.tiles is not None:     # no shared cadence: no tiles
            S_e, N_e = entry.tiles.valid.shape
            n_samples += S_e * N_e
            n_series += S_e
    cache = be._tile_cache
    return cache, n_samples, n_series


@capacity_harness("downsample-pack-buffers")
def _h_downsample_pack(device="cpu", S: int = 4, N: int = 48,
                       batch=None):
    """The downsampler's padded staging block as the batch evaluation
    places it on the device: int64 ts + f64 vals = 16 B per padded slot.
    ``batch``: (key, labels, ts, vals) rows (phase 12's in chip_smoke);
    by default the reference's four seeded series of 48 samples."""
    import numpy as np

    from filodb_tpu_torch.downsample.job import DownsamplerJob
    job = DownsamplerJob(None, device=device)
    if batch is None:
        rng = np.random.default_rng(_SEED)
        batch = []
        for i in range(S):
            ts = (1_000_000_000_000
                  + np.arange(N, dtype=np.int64) * 10_000 + i)
            batch.append((f"pk{i}", None, ts, rng.uniform(0, 1, N)))
    ts_pad, vals_pad, lens, t_lo, t_hi = job._pack(batch)
    placed = job._on_device(ts_pad, vals_pad)
    return placed, ts_pad.size, len(batch)
