"""Device-memory residency & capacity annotations (the port's copy of
``filodb_tpu/lint/capacity.py``).

Every allocation that escapes into a long-lived device store declares
its bytes budget with :func:`capacity`, and two rails hold the
declaration to account:

  * statically — :mod:`filodb_tpu_torch.lint.rules_capacity` follows
    torch device allocations into object attributes and
    ``@cache_registry`` stores and errors on any escape without a
    ``@capacity`` claim;
  * dynamically — :mod:`filodb_tpu_torch.lint.memcert` builds every
    annotated structure, measures the device bytes it retains (distinct
    tensor storages; on CUDA also the allocator) and CERTIFIES the
    claim: measured bytes above it, or a claim more than 1.25x over
    measured, is a ``capacity-certification`` finding. Sharded claims
    certify at 1, 2, 4 and 8 partitions.

The claim model is affine in the store's logical contents:

    claimed_bytes(n_samples, n_series) =
        bytes_per_sample * n_samples
        + bytes_per_series * n_series
        + overhead_bytes

``bytes_per_sample`` prices the PADDED layout (pow2 slot capacity):
padding is real device memory.

This module also carries the RUNTIME residency registry: annotated
stores report their live device bytes via :func:`record_resident`, and
a metrics collector exposes them as the
``filodb_device_memory_bytes{family,shard}`` gauge.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

HBM_BYTES_PER_CHIP = 80 << 30       # H100 SXM: 80 GB of HBM3


@dataclass(frozen=True)
class CapacityClaim:
    """One ``@capacity`` declaration."""
    name: str
    bytes_per_sample: float         # priced at the PADDED device layout
    reason: str
    bytes_per_series: float = 0.0
    overhead_bytes: int = 0
    sharded: bool = False           # certify at 1/2/4/8 virtual devices
    module: str = ""
    qualname: str = ""

    def claimed_total(self, n_samples: int, n_series: int = 0) -> float:
        """Claimed device footprint for a store holding ``n_samples``
        logical samples across ``n_series`` series."""
        return (self.bytes_per_sample * n_samples
                + self.bytes_per_series * n_series
                + self.overhead_bytes)

    def projected_series_per_chip(self, samples_per_series: int,
                                  hbm_bytes: int = HBM_BYTES_PER_CHIP
                                  ) -> int:
        """Resident series one chip can hold under this claim at
        ``samples_per_series`` retained samples each."""
        per_series = (self.bytes_per_sample * samples_per_series
                      + self.bytes_per_series)
        if per_series <= 0:
            return 0
        return int((hbm_bytes - self.overhead_bytes) // per_series)


# claim name -> claim (names are globally unique — the memcert harness
# registry, the runtime residency gauge, and the ledger key on them)
CAPACITY: Dict[str, CapacityClaim] = {}


def _register(claim: CapacityClaim) -> None:
    prev = CAPACITY.get(claim.name)
    if prev is not None and prev.qualname != claim.qualname:
        raise ValueError(
            f"capacity claim {claim.name!r} declared twice "
            f"({prev.qualname} and {claim.qualname})")
    CAPACITY[claim.name] = claim


def capacity(name: Optional[str] = None, *, bytes_per_sample: float,
             reason: str, bytes_per_series: float = 0.0,
             overhead_bytes: int = 0, sharded: bool = False) -> Callable:
    """Declare a long-lived device-resident store's bytes budget (see
    module docstring). Applies to the function or class whose body
    performs the retained allocation; ``reason`` must be non-empty
    prose naming what the bytes buy."""
    if not reason or not reason.strip():
        raise ValueError("@capacity requires a non-empty reason")

    def deco(obj):
        claim = CapacityClaim(
            name=name or getattr(obj, "__qualname__",
                                 getattr(obj, "__name__", "?")),
            bytes_per_sample=float(bytes_per_sample), reason=reason,
            bytes_per_series=float(bytes_per_series),
            overhead_bytes=int(overhead_bytes), sharded=bool(sharded),
            module=getattr(obj, "__module__", "") or "",
            qualname=getattr(obj, "__qualname__",
                             getattr(obj, "__name__", "?")))
        _register(claim)
        try:
            obj.__capacity__ = claim
        except (AttributeError, TypeError):   # functools.partial etc.
            pass
        return obj
    return deco


def capacity_claim(name: str) -> CapacityClaim:
    """Look up a registered ``@capacity`` claim by name (importing the
    engine modules that declare in-tree claims first)."""
    if name not in CAPACITY:
        import_annotated_modules()
    return CAPACITY[name]


# the modules carrying in-tree @capacity annotations; memcert + the
# lookup helpers import these so the registry is populated without
# executing anything device-side
ANNOTATED_MODULES: Tuple[str, ...] = (
    "filodb_tpu_torch.downsample.job",
    "filodb_tpu_torch.parallel.shardstore",
    "filodb_tpu_torch.query.backend",
    "filodb_tpu_torch.query.tilestore",
)


def import_annotated_modules() -> None:
    import importlib
    for m in ANNOTATED_MODULES:
        importlib.import_module(m)


def claim_inventory() -> Dict[str, CapacityClaim]:
    """All registered claims (README ledger table / debugging)."""
    import_annotated_modules()
    return dict(CAPACITY)


# ---------------------------------------------------------------------------
# runtime residency registry — live device bytes per (family, shard)
# ---------------------------------------------------------------------------

_RES_LOCK = threading.Lock()
# (family, shard) -> (token, bytes); token disambiguates multiple live
# stores of the same family (id-based; paired with a weakref finalizer
# at the annotated store so a collected store drops its bytes)
_RESIDENT: Dict[Tuple[str, str], Dict[int, int]] = {}


def record_resident(family: str, shard: str, token: int,
                    nbytes: int) -> None:
    """Report ``nbytes`` of live device memory held by the store
    instance identified by ``token`` under ``family``/``shard``.
    Re-recording the same token replaces its contribution (append /
    refresh paths)."""
    with _RES_LOCK:
        _RESIDENT.setdefault((family, str(shard)), {})[token] = int(nbytes)


def drop_resident(family: str, shard: str, token: int) -> None:
    """Forget one store instance's contribution (weakref finalizer)."""
    with _RES_LOCK:
        cell = _RESIDENT.get((family, str(shard)))
        if cell is not None:
            cell.pop(token, None)
            if not cell:
                _RESIDENT.pop((family, str(shard)), None)


def residency_snapshot() -> Dict[str, Dict[str, int]]:
    """Live device bytes, family -> shard -> bytes (the
    ``&explain=analyze`` residency section)."""
    out: Dict[str, Dict[str, int]] = {}
    with _RES_LOCK:
        for (family, shard), cell in _RESIDENT.items():
            out.setdefault(family, {})[shard] = sum(cell.values())
    return {f: dict(sorted(s.items())) for f, s in sorted(out.items())}


def _collect_residency(builder) -> None:
    for family, shards in residency_snapshot().items():
        for shard, nbytes in shards.items():
            builder.sample(
                "filodb_device_memory_bytes",
                {"family": family, "shard": shard}, str(nbytes),
                mtype="gauge",
                help="live device bytes held by @capacity-annotated "
                     "resident stores")


_COLLECTOR_REGISTERED = False


def ensure_residency_collector() -> None:
    """Register the ``filodb_device_memory_bytes`` gauge collector with
    the global metrics registry (idempotent; collectors survive
    registry resets)."""
    global _COLLECTOR_REGISTERED
    if _COLLECTOR_REGISTERED:
        return
    from filodb_tpu_torch.obs.metrics import GLOBAL_REGISTRY
    GLOBAL_REGISTRY.register_collector(_collect_residency)
    _COLLECTOR_REGISTERED = True
