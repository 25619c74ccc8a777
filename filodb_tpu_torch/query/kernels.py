"""Hand-written CUDA kernels of the query hot path, each beside its plain
PyTorch version (counterpart of ``filodb_tpu.query.pallas_kernels``).

``counter_groupsum`` and ``window_extract`` keep the input and output
contract of the Pallas kernels they replace, so the two packages can be held
against each other on identical packed inputs. Each wrapper:

  * takes the plain version only when its tensors lie on the CPU; on a CUDA
    tensor it launches the kernel or raises (no fallback);
  * checks device, dtype, shape and contiguity, allocates outputs with
    ``torch.empty`` and launches on the current stream;
  * adds one to ``LAUNCHES[name]`` per launch, and nowhere else.

Each wrapper carries a ``kind="cuda"`` ``@kernel_contract``: the
``__global__`` functions it launches with their threads, registers and
static shared bytes, its shared-memory budget, its launch plan at the
worst-case workloads, the int31 span guard, and an example its plain
version evaluates on ``device="meta"``. ``python -m
filodb_tpu_torch.lint`` checks the contracts on the CPU; chip_smoke holds
them to the ptxas report, to the functions' attributes and the launch
geometry that each library reports on the card (``*_attrs``,
``*_geometry``), and to the card's opt-in shared-memory limit. The
wrappers' ``_require``s are the run-time guard the contracts describe.

The kernels live in ``filodb_tpu_torch/csrc/`` and are compiled with ``nvcc``
for ``sm_90a`` into ``build/kernels/`` at the repository root at first use
(one ``nvcc`` per source, run in parallel), then loaded with ctypes through a
plain C interface whose return value is ``cudaGetLastError()``. nvcc's
report (ptxas registers and shared memory) is kept beside each library
and read back when the library is reused.

f64 payloads ride three f32 channels (``split3``/``combine3``: 24+24+24
mantissa bits >= 53, so both directions are exact).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from filodb_tpu_torch.lint.contracts import (SMEM_DEFAULT_BYTES, CudaKernel,
                                             Launch, kernel_contract)
from filodb_tpu_torch.lint.numerics import precision

# int32 sentinel for padded samples: beyond any valid relative timestamp
TR_PAD = np.int32(2**31 - 1)

# layout constants of the group-sum channel (shared with the JAX package's
# packed layout so both packages build identical tiles)
GS_SS = 512            # series per s-tile
GS_TT_WIDE = 512       # tail padding of the permuted slot axis ...
GS_AL = 8              # ... sized like the reference layout
GS_DSPAN_MAX = 48      # dispatcher cap on window/step rows

# tiling of the group-sum kernel (csrc/counter_groupsum.cu: kTT, kGC,
# kStagesMax, kSmemMax)
GS_TT = 8              # steps per group-product batch
GS_GC = 16             # groups staged in shared memory at a time
GS_STAGES_MAX = 8      # stages of the boundary-row ring
GS_SMEM_MAX = 232_448  # shared memory one block may use on sm_90
GS_ROW_BYTES = 3 * GS_SS * 4   # one boundary row: ts, hi, lo of 512 series
GS_THREADS = GS_SS + 32        # a consumer thread per series + a producer warp
GS_REDUCE_THREADS = 256        # the partial-sum reduction's blocks

# boundary-family modes
GS_BOTH = 0            # jitter straddles the grid phase: select per element
GS_CUR = 1             # the nominal slot is always inside the window
GS_ALT = 2             # the nominal slot is always outside: use kc0-1/kl0+1

# longest row the boundary extract stages in shared memory (kSmemRowMax in
# csrc/window_extract.cu); longer rows are searched in device memory
WX_SMEM_ROW_MAX = 12_288

_FUNC_CODE = {"rate": 0, "increase": 1, "delta": 2}

# launches per kernel, counted by the wrappers (plain-version calls on CPU
# tensors are not launches)
LAUNCHES: Dict[str, int] = {"counter_groupsum": 0, "window_extract": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def split3(v: torch.Tensor) -> torch.Tensor:
    """Exactly split f64 [S, N] into three stacked f32 channels [S, 3, N]:
    v == h + m + l with no rounding."""
    h = v.to(torch.float32)
    r = v - h.to(torch.float64)
    m = r.to(torch.float32)
    lo = (r - m.to(torch.float64)).to(torch.float32)
    return torch.stack([h, m, lo], dim=1)


def combine3(c: torch.Tensor) -> torch.Tensor:
    """[..., 3, T] f32 channels -> f64 (exact)."""
    return (c[..., 0, :].to(torch.float64) + c[..., 1, :].to(torch.float64)
            + c[..., 2, :].to(torch.float64))


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_SOURCES = {"counter_groupsum": "counter_groupsum.cu",
            "window_extract": "window_extract.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_build_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's report per kernel source (ptxas registers / shared memory)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Tuple[str, str]:
    """(source, library) paths; the library is named by a hash of its
    source, so an edited source is rebuilt."""
    src = os.path.join(_CSRC, _SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _log_path(lib: str) -> str:
    """nvcc's report of a library, kept beside it."""
    return lib[:-len(".so")] + ".nvcc.txt"


def _load(name: str) -> ctypes.CDLL:
    return _bind(name, ctypes.CDLL(_lib_path(name)[1]))


def build_kernels() -> Dict[str, ctypes.CDLL]:
    """Compile (once) and load every kernel library: one nvcc per source,
    all started together. A library built before, with its report beside
    it, is reused, and ``BUILD_LOG`` holds that report."""
    with _build_lock:
        if len(_libs) == len(_SOURCES):
            return _libs
        os.makedirs(BUILD_DIR, exist_ok=True)
        pending = []
        for name in _SOURCES:
            src, lib = _lib_path(name)
            if os.path.exists(lib) and os.path.exists(_log_path(lib)):
                with open(_log_path(lib)) as f:
                    BUILD_LOG[name] = f.read()
                continue
            tmp = f"{lib}.{os.getpid()}.tmp"
            # graftlint: disable=lock-blocking-call (one-time kernel build on first use: a second caller must wait for the first build under the lock and never start a second nvcc of the same source)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            pending.append((name, lib, tmp, proc))
        failed = []
        for name, lib, tmp, proc in pending:
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}:\n{out}")
            else:
                with open(_log_path(lib), "w") as f:
                    f.write(out)
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in _SOURCES:
            _libs[name] = _load(name)
        return _libs


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of the library's entry points: the launcher, and
    what its launches would be (``_geometry``) and its functions'
    attributes on the card (``_attrs``)."""
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    IP = ctypes.POINTER(ctypes.c_int)
    if name == "counter_groupsum":
        lib.counter_groupsum_launch.argtypes = [P] * 7 + [I] * 16 + [P]
        lib.counter_groupsum_geometry.argtypes = [I] * 7 + [IP]
    else:
        lib.window_extract_launch.argtypes = [P] * 7 + [I] * 4 + [LL, LL, P]
        lib.window_extract_geometry.argtypes = [I] * 3 + [IP]
    attrs = getattr(lib, f"{name}_attrs")
    attrs.argtypes = [I, ctypes.POINTER(ctypes.c_char_p), IP]
    for fn in ("launch", "geometry", "attrs"):
        getattr(lib, f"{name}_{fn}").restype = I
    return lib


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _route(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); anything else raises."""
    devs = {t.device.type for t in tensors}
    _require(len(devs) == 1, f"tensors on mixed devices: {sorted(devs)}")
    dev = devs.pop()
    _require(dev in ("cpu", "cuda"), f"unsupported device {dev}")
    return dev


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


# ---------------------------------------------------------------------------
# B1: fused counter group-sum
# ---------------------------------------------------------------------------

def _rows(v_p: torch.Tensor, k0: int, st: int, T: int) -> torch.Tensor:
    """Packed rows k0, k0+st, ... (T of them) -> [n_s, T, 3*SS]."""
    k = k0 + torch.arange(T, device=v_p.device, dtype=torch.int64) * st
    return v_p[:, k % st, k // st, :]


def exact_branch_fits(window: int, dspan: int, st: int) -> bool:
    """Whether the extrapolation branch can be decided on integer ms: the
    products 10*(cnt-1)*gap and 11*sampled must fit i32."""
    return 11 * int(window) * (dspan * st + 1) < 2 ** 31


def counter_groupsum_reference(func: str, st: int, dspan: int, hi_mode: int,
                               lo_mode: int, v_p: torch.Tensor,
                               base: torch.Tensor, onehot: torch.Tensor,
                               kl0: int, w0e_rel: int, window: int,
                               step: int, nsteps: int,
                               exact_branch: Optional[bool] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the group-sum kernel: the same f32
    epilogue, element for element, then the group product summed in f64
    and rounded to f32."""
    if exact_branch is None:
        exact_branch = exact_branch_fits(window, dspan, st)
    f32 = torch.float32
    T = nsteps
    n_s = v_p.shape[0]
    kc0 = kl0 + dspan * st
    dev = v_p.device

    def planes(rows):
        return (rows[..., :GS_SS], rows[..., GS_SS:2 * GS_SS],
                rows[..., 2 * GS_SS:])

    ts_kc, hi_kc, lo_kc = planes(_rows(v_p, kc0, st, T))
    ts_kl, hi_kl, lo_kl = planes(_rows(v_p, kl0, st, T))
    t_idx = torch.arange(T, device=dev, dtype=torch.int32)[None, :, None]
    wend_r = w0e_rel + t_idx * step
    wstart_r = wend_r - window
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    one_i = torch.ones((), dtype=torch.int32, device=dev)
    if hi_mode == GS_CUR:
        overc = zero_i
        t2, h2, l2 = ts_kc, hi_kc, lo_kc
    else:
        ts_kp, hi_kp, lo_kp = planes(_rows(v_p, kc0 - 1, st, T))
        if hi_mode == GS_BOTH:
            over = ts_kc > wend_r
            overc = over.to(torch.int32)
            t2 = torch.where(over, ts_kp, ts_kc)
            h2 = torch.where(over, hi_kp, hi_kc)
            l2 = torch.where(over, lo_kp, lo_kc)
        else:
            overc = one_i
            t2, h2, l2 = ts_kp, hi_kp, lo_kp
    if lo_mode == GS_CUR:
        underc = zero_i
        t1, h1, l1 = ts_kl, hi_kl, lo_kl
    else:
        ts_kn, hi_kn, lo_kn = planes(_rows(v_p, kl0 + 1, st, T))
        if lo_mode == GS_BOTH:
            under = ts_kl < wstart_r
            underc = under.to(torch.int32)
            t1 = torch.where(under, ts_kn, ts_kl)
            h1 = torch.where(under, hi_kn, hi_kl)
            l1 = torch.where(under, lo_kn, lo_kl)
        else:
            underc = one_i
            t1, h1, l1 = ts_kn, hi_kn, lo_kn

    counts = (dspan * st + 1) - overc - underc
    b0 = base[:, 0:1, :]
    c1 = base[:, 1:2, :]
    c2 = base[:, 2:3, :]
    milli = torch.tensor(1e-3, dtype=f32, device=dev)
    delta = (h2 - h1).to(f32) * c1 + (l2 - l1).to(f32) * c2
    sampled_i = t2 - t1
    dstart_i = t1 - wstart_r
    dend_i = wend_r - t2
    sampled = sampled_i.to(f32) * milli
    dstart = dstart_i.to(f32) * milli
    dend = dend_i.to(f32) * milli
    counts_f = counts.to(f32)
    avg = sampled / (counts_f - 1.0)
    th = avg * torch.tensor(1.1, dtype=f32, device=dev)
    if exact_branch:
        cm1 = counts - 1
        s11 = 11 * sampled_i
        use_ds = (10 * cm1) * dstart_i <= s11
        use_de = (10 * cm1) * dend_i <= s11
    else:
        use_ds = dstart < th
        use_de = dend < th
    if func != "delta":
        v1f = (h1.to(f32) * c1 + l1.to(f32) * c2) + b0
        nan = torch.tensor(float("nan"), dtype=f32, device=dev)
        inf = torch.tensor(float("inf"), dtype=f32, device=dev)
        dzero = torch.where((delta > 0) & (v1f >= 0),
                            sampled * (v1f / torch.where(delta == 0, nan,
                                                         delta)),
                            inf)
        zlt = dzero < dstart
        dstart = torch.where(zlt, dzero, dstart)
        use_ds = (zlt & (dzero < th)) | (~zlt & use_ds)
    half_avg = avg * 0.5
    extrap = sampled + torch.where(use_ds, dstart, half_avg) \
        + torch.where(use_de, dend, half_avg)
    factor = extrap / sampled
    if func == "rate":
        factor = factor / (torch.tensor(float(window), dtype=f32,
                                        device=dev) * milli)
    out = delta * factor
    ok = (counts >= 2) & ~torch.isnan(out)
    local = torch.where(ok, out, torch.zeros((), dtype=f32, device=dev))
    okf = ok.to(f32)
    # [n_s, T, SS] -> [T, n_s*SS] @ [n_s*SS, G], accumulated in f64
    oh = onehot.to(torch.float64)
    loc2 = local.permute(1, 0, 2).reshape(T, n_s * GS_SS).to(torch.float64)
    ok2 = okf.permute(1, 0, 2).reshape(T, n_s * GS_SS).to(torch.float64)
    # graftlint: disable=precision-narrowing (the kernel's output contract: the group product summed in f64 and rounded once to f32, as csrc/counter_groupsum.cu rounds it; groupsum-recombine-f32 is certified through this plain version on the CPU)
    return (loc2 @ oh).to(f32), (ok2 @ oh).to(f32)


def groupsum_smem(stages: int, fams: int, cw: int, nbuf: int) -> int:
    """Dynamic shared bytes of one group-sum block (csrc/
    counter_groupsum.cu's ``layout(stages, fams, cw, nbuf).total``): the
    ring of ``stages`` x ``fams`` boundary rows, the warps' [32, 2*TT+2]
    rate tiles, ``nbuf`` buffers of their [2*TT, gw] partial products, the
    staged [SS, gw] weights (gw = 4*cw groups) and two mbarriers a
    stage."""
    gw = 4 * cw
    warps = GS_SS // 32
    return (stages * fams * GS_ROW_BYTES
            + warps * 32 * (2 * GS_TT + 2) * 4
            + nbuf * warps * 2 * GS_TT * gw * 4 + GS_SS * gw * 4
            + 2 * stages * 8)


def groupsum_launch_plan(n_s: int, T: int, G: int, hi_mode: int,
                         lo_mode: int, n_sm: int) -> Dict[str, int]:
    """Tiling of one group-sum launch on a card with ``n_sm`` SMs.

    The ring holds ``stages`` steps of ``fams`` boundary rows (kc, kl, and
    kc-1 / kl+1 where the modes read them): as many stages as GS_SMEM_MAX
    leaves beside the rest of the block's shared memory
    (:func:`groupsum_smem`), up to GS_STAGES_MAX. That makes one block per
    SM, so each s-tile's T steps are cut into the fewest chunks that fill
    the last wave of blocks to at least 90 % of the SMs (a chunk is at
    least GS_TT steps). Returns fams, cw, nbuf, stages, smem (bytes),
    chunk and n_chunks; block (c, si) takes steps [c*chunk, min(T,
    (c+1)*chunk))."""
    fams = 2 + (hi_mode != GS_CUR) + (lo_mode != GS_CUR)
    cw = 1
    while 4 * cw < min(G, GS_GC):
        cw *= 2
    nbuf = 2 if G <= GS_GC else 1
    fixed = groupsum_smem(0, fams, cw, nbuf)
    per_stage = groupsum_smem(1, fams, cw, nbuf) - fixed
    # one stage of the widest configuration fits: no shape needs a route
    # the kernel does not have
    assert fixed + per_stage <= GS_SMEM_MAX
    stages = min(GS_STAGES_MAX, (GS_SMEM_MAX - fixed) // per_stage)
    floor = min(T, GS_TT)
    c = 1
    while True:
        chunk = max(-(-T // c), floor)
        items = n_s * -(-T // chunk)
        if chunk == floor or 10 * items >= 9 * n_sm * -(-items // n_sm):
            break
        c += 1
    return {"fams": fams, "cw": cw, "nbuf": nbuf, "stages": stages,
            "smem": groupsum_smem(stages, fams, cw, nbuf), "chunk": chunk,
            "n_chunks": -(-T // chunk)}


def counter_groupsum_launches(n_s: int, T: int, G: int, hi_mode: int,
                              lo_mode: int, n_sm: int) -> List[Launch]:
    """The launches of one group-sum call as the planner means them (the
    card's library reports what it launches: ``counter_groupsum_geometry``):
    the partial kernel over (n_chunks, n_s) blocks with the plan's dynamic
    shared memory, then the reduction over the T*G outputs."""
    lp = groupsum_launch_plan(n_s, T, G, hi_mode, lo_mode, n_sm)
    return [Launch("groupsum_partial_kernel", (lp["n_chunks"], n_s, 1),
                   GS_THREADS, lp["smem"]),
            Launch("groupsum_reduce_kernel",
                   (-(-(T * G) // GS_REDUCE_THREADS), 1, 1),
                   GS_REDUCE_THREADS, 0)]


def _groupsum_example(device):
    """The reference's example: st=1 / dspan=0 / both modes GS_CUR, one
    s-tile, 16 groups, 256 steps."""
    g_perm = 512
    args = ("rate", 1, 0, GS_CUR, GS_CUR,
            torch.empty((1, 1, g_perm, 3 * GS_SS), dtype=torch.int32,
                        device=device),
            torch.empty((1, 8, GS_SS), dtype=torch.float32, device=device),
            torch.empty((GS_SS, 16), dtype=torch.float32, device=device),
            1, 5_000, 5_000, 1_000, 256)
    return args, {}


def _groupsum_expect(out):
    want = ((256, 16), torch.float32)
    for o in out:
        if tuple(o.shape) != want[0] or o.dtype != want[1]:
            return f"output {tuple(o.shape)}/{o.dtype} != {want}"
    return None


@precision(
    "groupsum-recombine-f32", bits=61, rel_ulps=4,
    reason="boundary deltas are exact int32 subtractions of the "
           "fixed-point hi/lo planes; the f32 recombine "
           "dh*2^(31-s) + dl*2^-s (csrc/counter_groupsum.cu) rounds "
           "relative to the delta (wide deltas also round dl itself "
           "into f32), bounded by a few f32 ulps plus the span*2^-59 "
           "quantization floor — certified against the direct f64 "
           "delta over full-span boundary pairs; branch decisions "
           "stay in integer space (exact_branch), which "
           "mixed-dtype-comparison polices")
@kernel_contract(
    "counter_groupsum", kind="cuda",
    source="filodb_tpu_torch/csrc/counter_groupsum.cu",
    kernels=(CudaKernel("groupsum_partial_kernel", GS_THREADS, 94),
             CudaKernel("groupsum_reduce_kernel", GS_REDUCE_THREADS, 32)),
    smem_budget=GS_SMEM_MAX,
    launches=counter_groupsum_launches,
    # the most s-tiles one launch takes (grid.y), the widest grid and
    # group count the engine sends, and the smallest call
    workloads=(dict(n_s=65_535, T=8_192, G=16, hi_mode=GS_BOTH,
                    lo_mode=GS_BOTH, n_sm=132),
               dict(n_s=8, T=469, G=4_096, hi_mode=GS_ALT,
                    lo_mode=GS_CUR, n_sm=132),
               dict(n_s=1, T=1, G=1, hi_mode=GS_CUR, lo_mode=GS_CUR,
                    n_sm=1)),
    rel_time_bits=31,
    span_guard="filodb_tpu_torch.query.tilestore:_slide_eligible",
    example=_groupsum_example, expect=_groupsum_expect,
    plain=counter_groupsum_reference,
    notes="dispatched only via tilestore.groupsum_counters; the launch "
          "planner sizes the boundary-row ring to the block's shared "
          "memory and raises, never falls back, when one stage does not "
          "fit")
def counter_groupsum(func: str, st: int, dspan: int, hi_mode: int,
                     lo_mode: int, v_p: torch.Tensor, base: torch.Tensor,
                     onehot: torch.Tensor, kl0: int, w0e_rel: int,
                     window: int, step: int, nsteps: int,
                     exact_branch: Optional[bool] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum by(group) of rate/increase/delta over stride-permuted dense
    tiles -> (sums f32 [T, G], counts f32 [T, G]; a sum is only meaningful
    where its count > 0).

    v_p: [n_s, st, G_perm, 3*SS] i32 (plane 0 = relative ts, planes 1-2 =
    the fixed-point hi/lo split, AlignedTiles.t_perm_fixed_tiled);
    base: [n_s, 8, SS] f32 (AlignedTiles.t_fixed_base); onehot:
    [n_s*SS, G] f32. kc0 = kl0 + dspan*st; hi_mode/lo_mode must be sound
    for the tiles' jitter (the tilestore dispatcher decides them)."""
    _require(func in _FUNC_CODE, f"unknown func {func}")
    kl0, w0e_rel, window, step = int(kl0), int(w0e_rel), int(window), \
        int(step)
    _require(v_p.dtype == torch.int32 and v_p.dim() == 4
             and v_p.shape[1] == st and v_p.shape[3] == 3 * GS_SS,
             f"v_p must be [n_s, {st}, G_perm, {3 * GS_SS}] int32")
    n_s, _, g_perm, _ = v_p.shape
    _require(base.dtype == torch.float32
             and tuple(base.shape) == (n_s, 8, GS_SS),
             f"base must be [{n_s}, 8, {GS_SS}] float32")
    _require(onehot.dtype == torch.float32 and onehot.dim() == 2
             and onehot.shape[0] == n_s * GS_SS,
             f"onehot must be [{n_s * GS_SS}, G] float32")
    _require(hi_mode in (GS_BOTH, GS_CUR, GS_ALT)
             and lo_mode in (GS_BOTH, GS_CUR, GS_ALT), "bad boundary mode")
    T = int(nsteps)
    G = int(onehot.shape[1])
    kc0 = kl0 + dspan * st
    # every row the selected families touch must lie inside the channel
    k_min = min(kl0, kc0 - 1 if hi_mode != GS_CUR else kc0)
    k_max = max(kc0, kl0 + 1 if lo_mode != GS_CUR else kl0) + (T - 1) * st
    _require(T >= 1 and k_min >= 0 and k_max // st < g_perm,
             "grid reaches outside the packed channel")
    _require(w0e_rel + (T - 1) * step < 2 ** 31, "grid exceeds int31 ms")
    if exact_branch is None:
        exact_branch = exact_branch_fits(window, dspan, st)
    if _route(v_p, base, onehot) == "cpu":
        return counter_groupsum_reference(
            func, st, dspan, hi_mode, lo_mode, v_p, base, onehot, kl0,
            w0e_rel, window, step, T, bool(exact_branch))
    _require(v_p.is_contiguous() and base.is_contiguous()
             and onehot.is_contiguous(), "inputs must be contiguous")
    # the bulk copies need 16-byte aligned rows; grid.y holds the s-tiles
    _require(v_p.data_ptr() % 16 == 0, "v_p must be 16-byte aligned")
    _require(n_s <= 65535, "too many s-tiles for one launch")
    lib = build_kernels()["counter_groupsum"]
    dev = v_p.device
    lp = groupsum_launch_plan(
        n_s, T, G, hi_mode, lo_mode,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    part_sum = torch.empty((n_s, T, G), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((n_s, T, G), dtype=torch.float32, device=dev)
    sums = torch.empty((T, G), dtype=torch.float32, device=dev)
    cnts = torch.empty((T, G), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.counter_groupsum_launch(
            _ptr(v_p), _ptr(base), _ptr(onehot), _ptr(part_sum),
            _ptr(part_cnt), _ptr(sums), _ptr(cnts), n_s, st, g_perm, G, T,
            dspan, hi_mode, lo_mode, _FUNC_CODE[func], int(exact_branch),
            int(kl0), int(w0e_rel), int(window), int(step), lp["chunk"],
            lp["stages"], stream)
    _check_rc("counter_groupsum", rc)
    LAUNCHES["counter_groupsum"] += 1
    return sums, cnts


def counter_groupsum_cost(n_s: int, T: int, G: int, dspan: int,
                          hi_mode: int, lo_mode: int) -> Dict[str, float]:
    """Analytic cost of one group-sum launch over n_s s-tiles: each
    boundary row of the families its modes read once (kc and kl share one
    run of T + dspan rows; an ALT/BOTH side reads T more rows), the base
    and one-hot inputs, the two [T, G] outputs; and its operations."""
    fams = 1 + (hi_mode != GS_CUR) + (lo_mode != GS_CUR)
    rows = (T + dspan) + T * (fams - 1)
    nbytes = (rows * n_s * GS_SS * 12 + n_s * 8 * GS_SS * 4
              + n_s * GS_SS * G * 4 + 2 * T * G * 4)
    ops = T * n_s * GS_SS * (40 + 4 * G)
    return {"flops": float(ops), "bytes_accessed": float(nbytes)}


# ---------------------------------------------------------------------------
# B2: window boundary extract
# ---------------------------------------------------------------------------

def window_extract_cost(S: int, N: int, C: int, T: int) -> Dict[str, float]:
    """Analytic cost of one boundary-extract launch from its shapes: every
    relative timestamp read once, the C payload channels at both
    boundaries of every window (the most the shape can need: every window
    holding a sample), the five outputs; and two binary searches of each
    window."""
    nbytes = S * N * 4 + S * T * 2 * C * 4 + S * T * (12 + 8 * C)
    ops = 2 * S * T * math.ceil(math.log2(N + 1))
    return {"flops": float(ops), "bytes_accessed": float(nbytes)}


def window_extract_launches(S: int, N: int, T: int) -> List[Launch]:
    """The launch of one boundary-extract call as the wrapper means it (the
    card's library reports what it launches: ``window_extract_geometry``):
    one block per row, a thread per window up to 256, the row's timestamps
    staged in shared memory when they fit WX_SMEM_ROW_MAX."""
    threads = min(max(-(-T // 32) * 32, 32), 256)
    smem = N * 4 if N <= WX_SMEM_ROW_MAX else 0
    return [Launch("window_extract_kernel", (S, 1, 1), threads, smem)]


def _extract_example(device):
    """The reference's example: 8 rows of 2,048 samples, 3 payload
    channels, 128 windows."""
    args = (torch.empty((8, 2048), dtype=torch.int32, device=device),
            torch.empty((8, 3, 2048), dtype=torch.float32, device=device))
    return args, {"step": 1_000, "window": 5_000, "nsteps": 128}


def _extract_expect(out):
    want = [((8, 128), torch.int32)] * 3 + [((8, 3, 128), torch.float32)] * 2
    got = [(tuple(o.shape), o.dtype) for o in out]
    if got != want:
        return f"outputs {got} != {want}"
    return None


def window_extract_reference(tr: torch.Tensor, pay: torch.Tensor, step: int,
                             window: int, nsteps: int):
    """Plain PyTorch version of the boundary-extract kernel (the same
    searches, via torch.searchsorted)."""
    S, C, N = pay.shape
    dev = tr.device
    t = torch.arange(nsteps, device=dev, dtype=torch.int64)
    ws = (t * step).expand(S, nsteps).contiguous()
    we = ws + window
    tr64 = tr.to(torch.int64)
    lo = torch.searchsorted(tr64, ws, right=False)
    hi = torch.searchsorted(tr64, we, right=True) - 1
    cnt = torch.clamp(hi - lo + 1, min=0)
    has = cnt > 0
    lo_c = lo.clamp(0, max(N - 1, 0))
    hi_c = hi.clamp(0, max(N - 1, 0))
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    tlo = torch.where(has, torch.gather(tr, 1, lo_c), zi)
    thi = torch.where(has, torch.gather(tr, 1, hi_c), zi)
    idx_lo = lo_c[:, None, :].expand(S, C, nsteps)
    idx_hi = hi_c[:, None, :].expand(S, C, nsteps)
    zf = torch.zeros((), dtype=torch.float32, device=dev)
    plo = torch.where(has[:, None, :], torch.gather(pay, 2, idx_lo) + 0.0, zf)
    phi = torch.where(has[:, None, :], torch.gather(pay, 2, idx_hi) + 0.0, zf)
    return cnt.to(torch.int32), tlo, thi, plo, phi


@kernel_contract(
    "window_extract", kind="cuda",
    source="filodb_tpu_torch/csrc/window_extract.cu",
    kernels=(CudaKernel("window_extract_kernel", 256, 40),),
    # no opt-in attribute: the default per-block limit
    smem_budget=SMEM_DEFAULT_BYTES,
    launches=window_extract_launches,
    # the widest row staged in shared memory, a row searched in device
    # memory, and phase 3's extract shape
    workloads=(dict(S=65_536, N=WX_SMEM_ROW_MAX, T=4_096),
               dict(S=8, N=1 << 20, T=1),
               dict(S=65_536, N=512, T=128)),
    rel_time_bits=31,
    span_guard="filodb_tpu_torch.query.backend:_extract_span_ok",
    example=_extract_example, expect=_extract_expect,
    plain=window_extract_reference,
    notes="rate-family boundary extraction for irregular series; "
          "timestamps are int32 offsets from the first window start "
          "(TR_PAD sentinel for padding)")
def window_extract(tr: torch.Tensor, pay: torch.Tensor, step: int,
                   window: int, nsteps: int):
    """Boundary extract over sorted irregular rows.

    tr:  [S, N] int32 sample times relative to the FIRST window start
         (pad = TR_PAD, rows sorted).
    pay: [S, C, N] f32 payload channels to extract at window boundaries.
    Windows: wstart_t = t*step, wend_t = wstart_t + window.

    Returns (counts i32 [S,T], t_lo i32, t_hi i32, pay_at_lo f32 [S,C,T],
    pay_at_hi f32 [S,C,T]); entries are zero where counts == 0."""
    _require(tr.dtype == torch.int32 and tr.dim() == 2,
             "tr must be [S, N] int32")
    _require(pay.dtype == torch.float32 and pay.dim() == 3
             and pay.shape[0] == tr.shape[0] and pay.shape[2] == tr.shape[1],
             "pay must be [S, C, N] float32 matching tr")
    S, C, N = pay.shape
    T = int(nsteps)
    _require(N >= 1 and T >= 0, "empty sample axis")
    _require(int(window) + (T - 1) * int(step) < 2 ** 31 - 1,
             "grid exceeds int31 ms")
    if _route(tr, pay) == "cpu":
        return window_extract_reference(tr, pay, int(step), int(window), T)
    _require(tr.is_contiguous() and pay.is_contiguous(),
             "inputs must be contiguous")
    dev = tr.device
    cnt = torch.empty((S, T), dtype=torch.int32, device=dev)
    tlo = torch.empty((S, T), dtype=torch.int32, device=dev)
    thi = torch.empty((S, T), dtype=torch.int32, device=dev)
    plo = torch.empty((S, C, T), dtype=torch.float32, device=dev)
    phi = torch.empty((S, C, T), dtype=torch.float32, device=dev)
    if S == 0 or T == 0:
        return cnt, tlo, thi, plo, phi
    lib = build_kernels()["window_extract"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.window_extract_launch(
            _ptr(tr), _ptr(pay), _ptr(cnt), _ptr(tlo), _ptr(thi), _ptr(plo),
            _ptr(phi), S, N, C, T, int(step), int(window), stream)
    _check_rc("window_extract", rc)
    LAUNCHES["window_extract"] += 1
    return cnt, tlo, thi, plo, phi
