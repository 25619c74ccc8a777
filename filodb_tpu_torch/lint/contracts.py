"""Kernel contract declarations (the port's copy of
``filodb_tpu/lint/contracts.py``).

A :func:`kernel_contract` decorator sits on a device-function entry point
and states, in one checkable place, what its docstring promises: the
kind of entry point, an ``example()`` of inputs and an ``expect(out)``
predicate on the outputs' shapes and dtypes.

The port's examples are torch tensors. The JAX package's graftlint
imports a module that mentions ``kernel_contract`` but checks only the
contracts registered in its own registry, so the port's contracts are
checked by :func:`check_contract`, which runs each example on a device
that computes nothing (``meta``) or on the CPU (tests/test_torch_*).

This module is imported by the device modules, so it stays
dependency-free and does nothing at import beyond attaching the
declaration and registering it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

VMEM, SMEM, HBM, ANY, SEM = "vmem", "smem", "hbm", "any", "semaphore"


@dataclass(frozen=True)
class Block:
    """One declared array block (input, output, or scratch).

    ``shape`` is the worst-case BLOCK shape resident on chip at once
    (double buffering spelled out in the shape, e.g. leading 2).
    ``array_shape`` + ``index_map`` (block-index convention, as in
    ``pl.BlockSpec``) opt the block into the grid-bounds check.
    ``tiled=False`` exempts a VMEM block from the (sublane, 128) check —
    scalars/params and 1-D vectors."""
    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"
    space: str = VMEM
    tiled: bool = True
    array_shape: Optional[Tuple[int, ...]] = None
    index_map: Optional[Callable] = None

    def itemsize(self) -> int:
        import numpy as np
        return int(np.dtype(self.dtype).itemsize)

    def nbytes(self) -> int:
        n = self.itemsize()
        for d in self.shape:
            n *= int(d)
        return n


@dataclass
class KernelContract:
    """The checked declaration attached to a kernel entry point."""
    name: str
    kind: str                          # eager (torch ops) | dispatch
    fn: Callable = None
    module: str = ""
    qualname: str = ""
    grid: Optional[Tuple[int, ...]] = None
    blocks: Tuple[Block, ...] = ()
    scratch: Tuple[Block, ...] = ()
    outputs: Tuple[Block, ...] = ()
    vmem_budget: Optional[int] = None
    # inputs are int32 offsets relative to a base: the dispatcher
    # predicate named here must prove the whole span fits rel_time_bits
    rel_time_bits: Optional[int] = None
    span_guard: Optional[str] = None
    # example(device) -> (args, kwargs) of tensors/static values;
    # expect(out) -> error string or None
    example: Optional[Callable[[], Tuple[tuple, dict]]] = None
    expect: Optional[Callable[[object], Optional[str]]] = None
    # fully custom abstract check (mesh/axis contexts): -> error or None
    check: Optional[Callable[[], Optional[str]]] = None
    notes: str = ""

    def all_vmem_blocks(self) -> Tuple[Block, ...]:
        return tuple(b for b in (*self.blocks, *self.scratch,
                                 *self.outputs) if b.space == VMEM)

    def vmem_footprint(self) -> int:
        return sum(b.nbytes() for b in self.all_vmem_blocks())


# (module, name) -> contract; keyed so re-execution of a module (tests,
# importlib.reload) replaces rather than duplicates
CONTRACTS: Dict[Tuple[str, str], KernelContract] = {}


def kernel_contract(name: str, *, kind: str,
                    grid: Optional[Tuple[int, ...]] = None,
                    blocks: Sequence[Block] = (),
                    scratch: Sequence[Block] = (),
                    outputs: Sequence[Block] = (),
                    vmem_budget: Optional[int] = None,
                    rel_time_bits: Optional[int] = None,
                    span_guard: Optional[str] = None,
                    example: Optional[Callable] = None,
                    expect: Optional[Callable] = None,
                    check: Optional[Callable] = None,
                    notes: str = ""):
    """Attach and register a :class:`KernelContract`.

    Stack outermost (closest to the reader) so the registered callable is
    the entry point the rest of the code calls."""
    def deco(fn):
        c = KernelContract(
            name=name, kind=kind, fn=fn,
            module=getattr(fn, "__module__", "") or "",
            qualname=getattr(fn, "__qualname__",
                             getattr(fn, "__name__", name)),
            grid=tuple(grid) if grid is not None else None,
            blocks=tuple(blocks), scratch=tuple(scratch),
            outputs=tuple(outputs), vmem_budget=vmem_budget,
            rel_time_bits=rel_time_bits, span_guard=span_guard,
            example=example, expect=expect, check=check, notes=notes)
        CONTRACTS[(c.module, name)] = c
        try:
            fn.__kernel_contract__ = c
        except (AttributeError, TypeError):   # e.g. functools.partial
            pass
        return fn
    return deco


def contracts_for_module(module: str):
    return [c for (m, _), c in sorted(CONTRACTS.items()) if m == module]


def check_contract(c: KernelContract, device="meta") -> Optional[str]:
    """Run one contract's example on ``device`` and return what its
    ``expect`` says of the outputs (None: the contract holds)."""
    if c.check is not None:
        return c.check()
    if c.example is None or c.expect is None:
        return f"contract {c.name!r} has no example/expect"
    args, kwargs = c.example(device)
    return c.expect(c.fn(*args, **kwargs))
