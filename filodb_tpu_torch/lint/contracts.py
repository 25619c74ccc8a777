"""Kernel contract declarations (the port's counterpart of
``filodb_tpu/lint/contracts.py``).

A :func:`kernel_contract` decorator sits on a device-function entry point
and states, in one checkable place, what its docstring promises. Two
kinds:

  * ``kind="eager"`` (torch ops) and ``"dispatch"``: an ``example`` of
    inputs and an ``expect(out)`` predicate on the outputs' shapes and
    dtypes (or a custom ``check``), run on the CPU by
    :func:`check_contract`;
  * ``kind="cuda"``: a wrapper that launches hand-written CUDA kernels
    (``filodb_tpu_torch/csrc/``). It declares each ``__global__``
    function it launches (:class:`CudaKernel`: threads per block, the
    registers and static shared bytes ptxas reports), the shared-memory
    budget a block may use (static plus dynamic, at most
    :data:`SMEM_OPTIN_BYTES`), its launch plan (``launches(**workload)``
    -> :class:`Launch` list, the grid, block and dynamic shared memory
    the wrapper asks for) at the declared worst-case ``workloads``, the
    int31 span guard, and an ``example`` whose plain version
    (``plain``) runs on ``device="meta"`` (shapes and dtypes, no
    computation) for ``expect``. :meth:`KernelContract.admits` holds one
    launch to the declaration (chip_smoke holds every launch of a run
    to it on the card).

``filodb_tpu_torch.lint.rules_kernel`` checks every registered contract
on the CPU. This module is imported by the device modules, so it stays
dependency-free and does nothing at import beyond attaching the
declaration and registering it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

VMEM, SMEM, HBM, ANY, SEM = "vmem", "smem", "hbm", "any", "semaphore"

# Hopper (sm_90) launch limits: a block's shared memory with the
# cudaFuncAttributeMaxDynamicSharedMemorySize opt-in, and without it
SMEM_OPTIN_BYTES = 232_448
SMEM_DEFAULT_BYTES = 49_152
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65_535
THREADS_MAX = 1_024
REGS_PER_SM = 65_536


@dataclass(frozen=True)
class CudaKernel:
    """One ``__global__`` function a CUDA contract launches. ptxas
    reports it under its mangled name, which contains ``name``."""
    name: str
    threads: int                    # threads per block, the most asked
    registers: int                  # per thread, as ptxas reports them
    static_smem: int = 0            # static shared bytes per block


@dataclass(frozen=True)
class Launch:
    """One kernel launch of a plan: grid (x, y, z), threads per block and
    dynamic shared bytes per block."""
    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int = 0


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
    kind: str                          # eager (torch ops) | dispatch | cuda
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
    # kind="cuda": the kernels source, the __global__ functions, the
    # per-block shared-memory budget, the launch plan and the worst-case
    # workloads it is checked at, and the plain version of the wrapper
    source: str = ""
    kernels: Tuple[CudaKernel, ...] = ()
    smem_budget: Optional[int] = None
    launches: Optional[Callable[..., Sequence[Launch]]] = None
    workloads: Tuple[dict, ...] = ()
    plain: Optional[Callable] = None

    def kernel(self, name: str) -> Optional[CudaKernel]:
        for k in self.kernels:
            if k.name == name:
                return k
        return None

    def admits(self, launch: Launch) -> Optional[str]:
        """Why ``launch`` lies outside this contract (None: admitted):
        a kernel it does not declare, a grid outside the per-axis
        limits, more threads than declared, registers past one SM's
        file, or static plus dynamic shared memory past the budget."""
        k = self.kernel(launch.kernel)
        if k is None:
            return f"launches undeclared kernel {launch.kernel!r}"
        x, y, z = launch.grid
        if not (1 <= x <= GRID_X_MAX and 1 <= y <= GRID_YZ_MAX
                and 1 <= z <= GRID_YZ_MAX):
            return (f"{launch.kernel} grid {launch.grid} outside (x < 2^31,"
                    f" y, z <= {GRID_YZ_MAX})")
        if not 1 <= launch.threads <= min(k.threads, THREADS_MAX):
            return (f"{launch.kernel} block of {launch.threads} threads, "
                    f"declared {k.threads}")
        if k.registers * k.threads > REGS_PER_SM:
            return (f"{launch.kernel}: {k.registers} registers x "
                    f"{k.threads} threads exceed one SM's {REGS_PER_SM}")
        total = k.static_smem + launch.smem
        if self.smem_budget is None or total > self.smem_budget:
            return (f"{launch.kernel} asks {total} B of shared memory, "
                    f"budget {self.smem_budget}")
        return None

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
                    notes: str = "",
                    source: str = "",
                    kernels: Sequence[CudaKernel] = (),
                    smem_budget: Optional[int] = None,
                    launches: Optional[Callable] = None,
                    workloads: Sequence[dict] = (),
                    plain: Optional[Callable] = None):
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
            example=example, expect=expect, check=check, notes=notes,
            source=source, kernels=tuple(kernels), smem_budget=smem_budget,
            launches=launches, workloads=tuple(workloads), plain=plain)
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
    ``expect`` says of the outputs (None: the contract holds). A CUDA
    contract runs its plain version, which runs on any device."""
    if c.check is not None:
        return c.check()
    if c.example is None or c.expect is None:
        return f"contract {c.name!r} has no example/expect"
    args, kwargs = c.example(device)
    fn = c.plain if c.kind == "cuda" and c.plain is not None else c.fn
    return c.expect(fn(*args, **kwargs))
