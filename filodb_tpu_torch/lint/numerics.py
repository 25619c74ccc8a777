"""Numeric-precision and determinism annotations (the port's copy of
the reference's ``lint/numerics.py``).

The engine's correctness story rests on precision invariants: the
f32-hybrid counter path carries exact int32 hi/lo splits with an f32
recombine (the group-sum kernel), timestamps ride int32 milliseconds
under a dispatcher span guard, and the extrapolation epilogue of the
hybrid evaluators runs in f32. These annotations make every such hybrid
site DECLARE its budget, and :mod:`filodb_tpu_torch.lint.ulpcert` holds
each declaration to account: it evaluates every annotated site on seeded
inputs, in the production dtype against an f64 reference, on the CPU
(the plain versions) or on the card (what the card runs, the kernels
included), and CERTIFIES the claimed tolerance. A claim the rail cannot
certify fails the port's tests: a lie in a ``@precision`` is a fault,
not a comment.

Annotations:

  * :func:`precision` — the site narrows a value with f64/int64
    provenance into an f32/int32 op on purpose, with a stated budget:

      - ``bits`` — the significand/width budget the narrow
        representation must cover (31 for the int31 relative-timestamp
        span guard, 24 for an f32 epilogue, 61 for the fixed-point
        hi/lo split);
      - ``rel_ulps`` — claimed max error of the site's output vs the
        f64 reference, in output-dtype ulps (0 = exact, certified
        bitwise);
      - ``accum_terms`` — static bound on the number of terms any
        reduction at the site accumulates (``accum_terms <=
        2**mantissa`` for the accumulator dtype: 2**24 for an f32 sum);
      - ``compensated`` — the site uses an f64 accumulator or a
        compensated sum, exempting it from the mantissa bound;
      - ``reason`` — required prose: WHY the narrowing is safe (which
        dispatcher guard, which exactness argument).

  * :func:`order_insensitive` — the site's reduction grouping depends
    on the partition count (a cross-partition sum over float) and claims
    its result moves less than ``tolerance`` (max relative deviation)
    across groupings. ``tolerance=0.0`` is a byte-identity claim. No
    site of the port declares one yet: the sharded evaluators that
    would are not ported.

All decorators are runtime-neutral: they attach ``__precision__`` /
``__order_insensitive__`` and register the claim for the rail.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

# f32 significand: 24 bits (1 implicit); one ulp of a normalized value
# is at most 2**-23 of the value
F32_MANTISSA_BITS = 24
F32_REL_ULP = 2.0 ** -23
F64_MANTISSA_BITS = 53

MANTISSA_BITS = {"float32": F32_MANTISSA_BITS,
                 "float64": F64_MANTISSA_BITS,
                 "bfloat16": 8, "float16": 11}


@dataclass(frozen=True)
class PrecisionClaim:
    """One ``@precision`` declaration."""
    name: str
    bits: int
    reason: str
    rel_ulps: float = 0.0           # 0 = exact (certified bitwise)
    accum_terms: Optional[int] = None
    compensated: bool = False
    module: str = ""
    qualname: str = ""

    def rel_bound(self, cross_program: bool = False) -> float:
        """Relative error bound implied by the claim for an f32-output
        site. ``cross_program=True`` doubles it: two independent
        evaluations of the site (two packages, or the CPU's plain
        version and the card's kernel) each within ``rel_ulps`` of the
        correctly-rounded reference differ by at most twice the claim."""
        k = 2.0 if cross_program else 1.0
        return k * max(self.rel_ulps, 1.0) * F32_REL_ULP


@dataclass(frozen=True)
class OrderClaim:
    """One ``@order_insensitive`` declaration."""
    name: str
    tolerance: float                # max rel deviation across groupings
    reason: str
    module: str = ""
    qualname: str = ""


# claim name -> claim (names are globally unique — the ulpcert harness
# registry and the test helpers key on them)
PRECISION: Dict[str, PrecisionClaim] = {}
ORDER: Dict[str, OrderClaim] = {}


def _register(table: Dict, claim, fn) -> None:
    prev = table.get(claim.name)
    if prev is not None and prev.qualname != claim.qualname:
        raise ValueError(
            f"numerics claim {claim.name!r} declared twice "
            f"({prev.qualname} and {claim.qualname})")
    table[claim.name] = claim


def precision(name: Optional[str] = None, *, bits: int, reason: str,
              rel_ulps: float = 0.0,
              accum_terms: Optional[int] = None,
              compensated: bool = False) -> Callable:
    """Declare a deliberate precision-narrowing site (see module
    docstring). ``reason`` must be non-empty prose."""
    if not reason or not reason.strip():
        raise ValueError("@precision requires a non-empty reason")

    def deco(fn):
        claim = PrecisionClaim(
            name=name or getattr(fn, "__qualname__",
                                 getattr(fn, "__name__", "?")),
            bits=int(bits), reason=reason, rel_ulps=float(rel_ulps),
            accum_terms=accum_terms, compensated=bool(compensated),
            module=getattr(fn, "__module__", "") or "",
            qualname=getattr(fn, "__qualname__",
                             getattr(fn, "__name__", "?")))
        _register(PRECISION, claim, fn)
        try:
            fn.__precision__ = claim
        except (AttributeError, TypeError):   # functools.partial etc.
            pass
        return fn
    return deco


def order_insensitive(name: Optional[str] = None, *, tolerance: float,
                      reason: str) -> Callable:
    """Declare a partition-count-dependent float reduction with its
    claimed cross-grouping tolerance (0.0 = byte-identity, certified
    bitwise at 1, 2, 4 and 8 partitions)."""
    if not reason or not reason.strip():
        raise ValueError("@order_insensitive requires a non-empty reason")

    def deco(fn):
        claim = OrderClaim(
            name=name or getattr(fn, "__qualname__",
                                 getattr(fn, "__name__", "?")),
            tolerance=float(tolerance), reason=reason,
            module=getattr(fn, "__module__", "") or "",
            qualname=getattr(fn, "__qualname__",
                             getattr(fn, "__name__", "?")))
        _register(ORDER, claim, fn)
        try:
            fn.__order_insensitive__ = claim
        except (AttributeError, TypeError):
            pass
        return fn
    return deco


def precision_claim(name: str) -> PrecisionClaim:
    """Look up a registered ``@precision`` claim by name (importing the
    engine modules that declare in-tree claims first)."""
    if name not in PRECISION:
        import_annotated_modules()
    return PRECISION[name]


def order_claim(name: str) -> OrderClaim:
    if name not in ORDER:
        import_annotated_modules()
    return ORDER[name]


# the modules carrying in-tree annotations; ulpcert + the claim lookup
# helpers import these so the registry is populated without executing
# anything device-side
ANNOTATED_MODULES: Tuple[str, ...] = (
    "filodb_tpu_torch.query.tilestore",
    "filodb_tpu_torch.query.kernels",
    "filodb_tpu_torch.query.backend",
    "filodb_tpu_torch.parallel.mesh",
    "filodb_tpu_torch.parallel.shardstore",
)


def import_annotated_modules() -> None:
    import importlib
    for m in ANNOTATED_MODULES:
        importlib.import_module(m)


def claim_inventory() -> Dict[str, object]:
    """All registered claims (README table / debugging)."""
    import_annotated_modules()
    return {"precision": dict(PRECISION), "order": dict(ORDER)}
