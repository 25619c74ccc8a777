"""The port's static analyser (``filodb_tpu_torch.lint``), family by family.

Each family the port retargets to torch has mutated twins in torch idiom:
the violating twin trips exactly its rule, and its priced or evicting
twin passes. The families that carry no device idiom (locks, lock order
and concurrency, cache completeness, spans, the PromQL rule files) must
give the same findings as the reference's analyser on the reference's own
fixture sources (``tests/test_graftlint.py``). The engine's call graph
must reach the port's cache hooks from their publishers, as
``tests/test_lint_v3_engine.py`` shows for the reference."""

import dataclasses
import json
import os
import subprocess
import sys
import types

import pytest
import torch

import test_graftlint as ref_fx
from filodb_tpu_torch.lint import (NOT_PORTED, iter_py_files, load_module,
                                   package_root, rules, run_lint)
from filodb_tpu_torch.lint import callgraph as cgmod
from filodb_tpu_torch.lint import dataflow as dfmod
from filodb_tpu_torch.lint import rules_capacity, rules_kernel
from filodb_tpu_torch.lint.contracts import (SMEM_OPTIN_BYTES, CONTRACTS,
                                             CudaKernel, KernelContract,
                                             Launch)
from filodb_tpu_torch.query import kernels as kn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_src(tmp_path, src, name="fixture.py"):
    p = tmp_path / name
    p.write_text(src)
    rel = os.path.relpath(str(p), package_root()).replace(os.sep, "/")
    # report_only keeps the analysis whole and skips the PromQL soak
    return run_lint([str(p)], baseline=frozenset(), check_contracts=False,
                    report_only=frozenset({rel}))


def rules_of(res):
    return sorted({f.rule for f in res.findings})


# -- residency: hbm-residency-budget -----------------------------------------

RESIDENT_VIOLATION = """
import torch


class Store:
    def __init__(self, dev):
        self._buf = torch.zeros((64, 64), device=dev)
"""

RESIDENT_CLEAN = """
import torch
from filodb_tpu_torch.lint.capacity import capacity


@capacity("fixture-store", bytes_per_sample=4.0,
          reason="one f32 cell per padded slot")
class Store:
    def __init__(self, dev):
        self._buf = torch.zeros((64, 64), device=dev)
"""

RESIDENT_PRAGMA = """
import torch


class Store:
    def __init__(self, dev):
        # graftlint: disable=hbm-residency-budget (fixture: priced elsewhere)
        self._buf = torch.zeros((64, 64), device=dev)
"""

# host memory is not device residency: no device=, no finding
RESIDENT_HOST = """
import torch


class Store:
    def __init__(self):
        self._buf = torch.zeros((64, 64), dtype=torch.float64)
        self._f32 = self._buf.to(torch.float32)
"""

# the store is reached through a constructor's return and a parameter:
# the residency follows the value, not the call that made it
RESIDENT_INTERPROCEDURAL = """
import torch


def make(x, dev):
    return torch.as_tensor(x, device=dev)


class Holder:
    def __init__(self, t):
        self.t = t


class Shelf:
    def __init__(self):
        self._held = {}

    def put(self, key, x, dev):
        self._insert(key, Holder(make(x, dev)))

    def _insert(self, key, entry):
        self._held[key] = entry
"""

RESIDENT_MODULE_GLOBAL = """
import torch

LUT = torch.arange(4096, device="cuda")
"""


def test_hbm_residency_budget(tmp_path):
    assert rules_of(lint_src(tmp_path, RESIDENT_VIOLATION)) \
        == ["hbm-residency-budget"]
    assert not lint_src(tmp_path, RESIDENT_CLEAN).findings
    res = lint_src(tmp_path, RESIDENT_PRAGMA)
    assert not res.findings and res.suppressed == 1
    assert not lint_src(tmp_path, RESIDENT_HOST).findings
    res = lint_src(tmp_path, RESIDENT_MODULE_GLOBAL)
    assert rules_of(res) == ["hbm-residency-budget"]
    assert "process lifetime" in res.findings[0].message


def test_residency_follows_returns_constructors_and_parameters(tmp_path):
    res = lint_src(tmp_path, RESIDENT_INTERPROCEDURAL)
    assert rules_of(res) == ["hbm-residency-budget"]
    stores = sorted(f.context for f in res.findings)
    assert stores == ["Holder.__init__:resident:self.t",
                      "Shelf._insert:resident:self._held[]"], stores


@pytest.mark.parametrize("alloc", [
    "torch.empty(8, device=dev)", "torch.full((8,), 1.0, device=dev)",
    "torch.tensor([1.0], device=dev)", "x.to(dev)", "x.cuda()",
    "torch.where(torch.ones(8, device=dev) > 0, 1.0, 0.0)",
    "torch.cat([torch.zeros(8, device=dev)])"])
def test_each_torch_allocation_is_a_device_value(tmp_path, alloc):
    src = ("import torch\n\n\nclass S:\n    def __init__(self, x, dev):\n"
           f"        self.t = {alloc}\n")
    assert rules_of(lint_src(tmp_path, src)) == ["hbm-residency-budget"]


@pytest.mark.parametrize("pull", ["x.cpu()", "x.numpy()", "x.tolist()",
                                  "x.item()", 'x.to("cpu")',
                                  "x.to(torch.float64)", "x.shape"])
def test_host_values_are_not_residency(tmp_path, pull):
    src = ("import torch\n\n\nclass S:\n    def __init__(self):\n"
           f"        x = torch.ones(8)\n        self.t = {pull}\n")
    assert not lint_src(tmp_path, src).findings


# -- residency: device-buffer-leak -------------------------------------------

LEAK_NO_EVICTION = """
import torch
from filodb_tpu_torch.lint.caches import cache_registry
from filodb_tpu_torch.lint.capacity import capacity


@cache_registry("fixture-tiles", keyed=("selection",))
@capacity("fixture-tile-store", bytes_per_sample=8.0,
          reason="tiles priced per slot")
class TileCache:
    def __init__(self, dev):
        self.dev = dev
        self._tiles = {}

    def insert(self, key):
        self._tiles[key] = torch.zeros((64,), device=self.dev)
"""

LEAK_EVICTED = LEAK_NO_EVICTION + """
    def evict(self, key):
        self._tiles.pop(key, None)
"""

LEAK_DOUBLE_RETENTION = """
import torch
from filodb_tpu_torch.lint.capacity import capacity


@capacity("fixture-pair", bytes_per_sample=8.0, reason="priced")
class Pair:
    def __init__(self, dev):
        buf = torch.zeros((64,), device=dev)
        self._a = buf
        self._b = buf
"""


def test_device_buffer_leak(tmp_path):
    res = lint_src(tmp_path, LEAK_NO_EVICTION)
    assert rules_of(res) == ["device-buffer-leak"]
    assert "no eviction operation" in res.findings[0].message
    assert not lint_src(tmp_path, LEAK_EVICTED).findings
    res = lint_src(tmp_path, LEAK_DOUBLE_RETENTION)
    assert rules_of(res) == ["device-buffer-leak"]
    assert "2 stores" in res.findings[0].message


# -- residency: oversized-transfer -------------------------------------------

TRANSFER_PULL = """
from filodb_tpu_torch.lint.hotpath import hot_path


class Chan:
    @hot_path
    def read_all(self):
        # graftlint: disable=host-transfer-in-hot-loop (fixture: sync noted)
        return self._dev.cpu()
"""

TRANSFER_PULL_SLICED = """
from filodb_tpu_torch.lint.hotpath import hot_path


class Chan:
    @hot_path
    def read_window(self, n):
        # graftlint: disable=host-transfer-in-hot-loop (fixture: sync noted)
        return self._dev[:n].cpu()
"""

TRANSFER_PADDED = """
import numpy as np
import torch
from filodb_tpu_torch.lint.hotpath import hot_path


def _next_pow2(n, lo):
    p = lo
    while p < n:
        p *= 2
    return p


@hot_path
def ship(ts):
    cap = _next_pow2(ts.size, 64)
    buf = np.zeros((cap,))
    buf[:ts.size] = ts
    return torch.as_tensor(buf, device="cuda")
"""

TRANSFER_PADDED_PRICED = TRANSFER_PADDED.replace(
    "@hot_path",
    """from filodb_tpu_torch.lint.capacity import capacity


@capacity("fixture-staged", bytes_per_sample=8.0,
          reason="padded staging block priced per slot")
@hot_path""")


def test_oversized_transfer(tmp_path):
    res = lint_src(tmp_path, TRANSFER_PULL)
    assert rules_of(res) == ["oversized-transfer"]
    assert "whole resident channel" in res.findings[0].message
    assert not lint_src(tmp_path, TRANSFER_PULL_SLICED).findings
    res = lint_src(tmp_path, TRANSFER_PADDED)
    assert rules_of(res) == ["oversized-transfer"]
    assert "pow2-capacity-padded" in res.findings[0].message
    assert not lint_src(tmp_path, TRANSFER_PADDED_PRICED).findings
    moved = TRANSFER_PADDED.replace(
        'torch.as_tensor(buf, device="cuda")', "torch.from_numpy(buf)"
        ".to(\"cuda\")")
    assert rules_of(lint_src(tmp_path, moved)) == ["oversized-transfer"]


# -- residency: smem-frontier-budget -----------------------------------------

SMEM_OVER_BUDGET = """
def plan(nsteps, smem_budget=232_449):
    for stages in (8, 4, 2, 1):
        if stages * 6_160 <= smem_budget:
            return stages
    raise ValueError(nsteps)
"""

SMEM_UNTESTED = """
def plan(nsteps, smem_budget=232_448):
    total = 0
    for stages in (8, 4, 2, 1):
        total += stages * nsteps
    return total
"""

SMEM_CLEAN = """
SMEM = 232_448


def plan(nsteps, smem_budget=SMEM):
    for stages in (8, 4, 2, 1):
        if stages * 6_160 <= smem_budget:
            return stages
    raise ValueError(nsteps)
"""


def test_smem_frontier_budget_ast(tmp_path):
    res = lint_src(tmp_path, SMEM_OVER_BUDGET)
    assert rules_of(res) == ["smem-frontier-budget"]
    assert "exceeds a block's opt-in shared memory" in res.findings[0].message
    res = lint_src(tmp_path, SMEM_UNTESTED)
    assert rules_of(res) == ["smem-frontier-budget"]
    assert "never compares" in res.findings[0].message
    assert not lint_src(tmp_path, SMEM_CLEAN).findings
    over = SMEM_CLEAN.replace("SMEM = 232_448", "SMEM = 232_449")
    assert rules_of(lint_src(tmp_path, over)) == ["smem-frontier-budget"]


def _planner_twin(plan):
    """The kernel module's constants and layout with another launch
    planner."""
    twin = types.SimpleNamespace(**{k: getattr(kn, k) for k in dir(kn)
                                    if k.startswith("GS_")})
    twin.groupsum_smem = kn.groupsum_smem
    twin.groupsum_launch_plan = plan
    return twin


def test_the_groupsum_planner_sweeps_clean():
    assert rules_capacity.sweep_groupsum_frontier(kn, kn.GS_SMEM_MAX) == []


def test_a_planner_that_ignores_its_budget_is_flagged():
    def greedy(n_s, T, G, hi, lo, n_sm):
        lp = kn.groupsum_launch_plan(n_s, T, G, hi, lo, n_sm)
        return dict(lp, stages=kn.GS_STAGES_MAX)
    bad = rules_capacity.sweep_groupsum_frontier(_planner_twin(greedy),
                                                 kn.GS_SMEM_MAX)
    assert bad and {k for k, _ in bad} == {"overflow"}
    # the real planner against a contract budget below its plans, or
    # beside static shared memory that leaves no room for them
    assert {k for k, _ in rules_capacity.sweep_groupsum_frontier(
        kn, 200_000)} == {"overflow"}
    assert {k for k, _ in rules_capacity.sweep_groupsum_frontier(
        kn, kn.GS_SMEM_MAX, static_smem=4_096)} == {"overflow"}


def test_a_planner_that_refuses_a_fitting_workload_is_flagged():
    def timid(n_s, T, G, hi, lo, n_sm):
        if G > 16:
            raise ValueError("too many groups")
        return kn.groupsum_launch_plan(n_s, T, G, hi, lo, n_sm)
    bad = rules_capacity.sweep_groupsum_frontier(_planner_twin(timid),
                                                 kn.GS_SMEM_MAX)
    assert bad and {k for k, _ in bad} == {"premature-refusal"}


def test_the_planner_raises_when_one_stage_does_not_fit(monkeypatch):
    """No fallback: a block whose one stage does not fit its shared
    memory is refused, not planned with no stage."""
    monkeypatch.setattr(kn, "GS_SMEM_MAX", 60_000)
    with pytest.raises(AssertionError):
        kn.groupsum_launch_plan(8, 469, 16, kn.GS_BOTH, kn.GS_BOTH, 132)


# -- kernel contracts --------------------------------------------------------

KERNEL_UNCONTRACTED = """
from filodb_tpu_torch.query.kernels import build_kernels


def run(ptr, n):
    lib = build_kernels()["toy"]
    return lib.toy_launch(ptr, n)
"""

KERNEL_CONTRACTED = """
from filodb_tpu_torch.lint.contracts import kernel_contract
from filodb_tpu_torch.query.kernels import build_kernels


@kernel_contract("toy", kind="cuda", smem_budget=0)
def run(ptr, n):
    lib = build_kernels()["toy"]
    return lib.toy_launch(ptr, n)
"""

KERNEL_INLINE = """
from filodb_tpu_torch.query import kernels


def run(ptr, n):
    return kernels.build_kernels()["toy"].toy_launch(ptr, n)
"""


def test_kernel_contract_missing(tmp_path):
    assert rules_of(lint_src(tmp_path, KERNEL_UNCONTRACTED)) \
        == ["kernel-contract-missing"]
    assert not lint_src(tmp_path, KERNEL_CONTRACTED).findings
    assert rules_of(lint_src(tmp_path, KERNEL_INLINE)) \
        == ["kernel-contract-missing"]


def _toy_contract(**over):
    kw = dict(name="toy", kind="cuda", fn=lambda x: x,
              module="filodb_tpu_torch.query.kernels",
              kernels=(CudaKernel("toy_kernel", 256, 32),),
              smem_budget=49_152,
              launches=lambda S: [Launch("toy_kernel", (S, 1, 1), 256,
                                         4_096)],
              workloads=(dict(S=1024),),
              example=lambda device: ((torch.empty(
                  (8, 4), device=device),), {}),
              expect=lambda out: None if tuple(out.shape) == (8, 4)
              else f"shape {tuple(out.shape)}",
              plain=lambda x: x * 2.0)
    kw.update(over)
    return KernelContract(**kw)


def _rule_set(c):
    return sorted({f.rule for f in rules_kernel.check_contract_decl(c)})


def test_a_toy_contract_checks_clean():
    assert _rule_set(_toy_contract()) == []


def test_a_contract_past_the_optin_limit_is_flagged():
    c = _toy_contract(smem_budget=SMEM_OPTIN_BYTES + 1)
    assert _rule_set(c) == ["kernel-smem-budget"]
    assert SMEM_OPTIN_BYTES + 1 == 232_449
    assert _rule_set(_toy_contract(smem_budget=None)) \
        == ["kernel-smem-budget"]


def test_a_plan_over_its_budget_is_flagged():
    c = _toy_contract(launches=lambda S: [
        Launch("toy_kernel", (S, 1, 1), 256, 49_153)])
    assert _rule_set(c) == ["kernel-smem-budget"]


def test_a_grid_of_65536_on_y_is_flagged():
    c = _toy_contract(launches=lambda S: [
        Launch("toy_kernel", (1, 65_536, 1), 256, 0)])
    assert _rule_set(c) == ["kernel-grid-bounds"]
    ok = _toy_contract(launches=lambda S: [
        Launch("toy_kernel", (2 ** 31 - 1, 65_535, 1), 256, 0)])
    assert _rule_set(ok) == []
    more = _toy_contract(launches=lambda S: [
        Launch("toy_kernel", (S, 1, 1), 512, 0)])
    assert _rule_set(more) == ["kernel-grid-bounds"]
    regs = _toy_contract(kernels=(CudaKernel("toy_kernel", 1024, 65),))
    assert _rule_set(regs) == ["kernel-grid-bounds"]


def test_span_guard_must_resolve():
    c = _toy_contract(rel_time_bits=31,
                      span_guard="filodb_tpu_torch.query.tilestore:nowhere")
    assert _rule_set(c) == ["kernel-span-guard"]
    c = _toy_contract(rel_time_bits=31,
                      span_guard="filodb_tpu_torch.query.tilestore:"
                                 "_slide_eligible")
    assert _rule_set(c) == []


def test_abstract_eval_runs_the_plain_version_on_meta():
    seen = []

    def plain(x):
        seen.append(x.device.type)
        return x[:, :2]
    c = _toy_contract(plain=plain)
    assert _rule_set(c) == ["kernel-abstract-eval"]
    assert seen == ["meta"]


@pytest.mark.parametrize("name", ["counter_groupsum", "window_extract"])
def test_both_cuda_kernels_carry_a_contract_that_checks_clean(name):
    c = CONTRACTS[("filodb_tpu_torch.query.kernels", name)]
    assert c.kind == "cuda" and c.fn is getattr(kn, name)
    assert os.path.exists(os.path.join(REPO, c.source))
    assert c.smem_budget <= SMEM_OPTIN_BYTES
    assert rules_kernel.check_contract_decl(c) == []
    # its example goes through the plain version on meta
    args, kwargs = c.example("meta")
    out = c.plain(*args, **kwargs)
    assert all(o.device.type == "meta" for o in out)
    # every declared worst case is admitted, and the CUDA source
    # names every kernel the contract declares
    src = open(os.path.join(REPO, c.source)).read()
    for k in c.kernels:
        assert k.name in src
    for w in c.workloads:
        assert all(c.admits(lnch) is None for lnch in c.launches(**w))


def test_the_groupsum_contract_matches_the_kernels_limits():
    c = CONTRACTS[("filodb_tpu_torch.query.kernels", "counter_groupsum")]
    assert c.smem_budget == kn.GS_SMEM_MAX == SMEM_OPTIN_BYTES
    assert c.kernel("groupsum_partial_kernel").threads == kn.GS_THREADS
    # the wrapper's own guard: at most 65,535 s-tiles (grid.y)
    lp = c.launches(n_s=65_536, T=8, G=16, hi_mode=kn.GS_CUR,
                    lo_mode=kn.GS_CUR, n_sm=132)
    assert "grid" in c.admits(lp[0])


def test_the_wrappers_count_their_launch_plans(monkeypatch):
    """On a CPU tensor the wrapper takes the plain version: no launch;
    a wrapper keeps no record of its calls' shapes (the card's library
    reports what it launches, phase 15 of chip_smoke); the plan
    functions mirror the CUDA sources' launches."""
    before = dict(kn.LAUNCHES)
    c = CONTRACTS[("filodb_tpu_torch.query.kernels", "window_extract")]
    args, kwargs = c.example("cpu")
    kn.window_extract(torch.zeros_like(args[0]), torch.zeros_like(args[1]),
                      **kwargs)
    assert kn.LAUNCHES == before
    assert not hasattr(kn, "LAUNCH_PLANS")
    (lnch,) = kn.window_extract_launches(8, 2_048, 128)
    assert lnch == Launch("window_extract_kernel", (8, 1, 1), 128, 8_192)
    (big,) = kn.window_extract_launches(8, kn.WX_SMEM_ROW_MAX + 1, 1)
    assert big.smem == 0 and big.threads == 32


# ptxas's report of the kernels as this repo's build prints it (nvcc -Xptxas
# -v), for the declared functions
PTXAS_LOG = {
    "counter_groupsum": "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123"
        f"groupsum_partial_kernelILi{f}ELb{e}EEEvPKiPKfS4_PfS5_6Params' "
        f"for 'sm_90a'\nptxas info    : Used 94 registers, used 1 barriers,"
        f" 496 bytes cmem[0]\n" for f in range(3) for e in range(2))
    + "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122"
      "groupsum_reduce_kernelEPKfS1_PfS2_ii' for 'sm_90a'\n"
      "ptxas info    : Used 32 registers, 392 bytes cmem[0]\n",
    "window_extract":
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121"
        "window_extract_kernelEPKiPKfPiS3_S3_PfS4_iiixx' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, 424 bytes cmem[0]\n",
}
CARD_ATTRS = {"counter_groupsum": [("groupsum_partial_kernel", 94, 0, 544)]
              * 6 + [("groupsum_reduce_kernel", 32, 0, 1024)],
              "window_extract": [("window_extract_kernel", 40, 0, 1024)]}


def _fake_nvcc(tmp_path, ok=True):
    """An nvcc that prints the source's ptxas report and writes its -o
    file (or fails, to show that nothing is rebuilt)."""
    script = tmp_path / ("nvcc" if ok else "nvcc_fails")
    reports = {kn._SOURCES[k]: v for k, v in PTXAS_LOG.items()}
    script.write_text(
        f"#!{sys.executable}\nimport os, sys\n"
        f"reports = {reports!r}\n"
        + ("a = sys.argv\nopen(a[a.index('-o') + 1], 'w').write('lib')\n"
           "print(reports[os.path.basename(a[-1])])\n" if ok
           else "sys.exit(1)\n"))
    script.chmod(0o755)
    return str(script)


def test_a_reused_build_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """A library built before is reused with the report of its build, so
    the contracts are held to ptxas in every run of a checkout."""
    monkeypatch.setattr(kn, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kn, "_load", lambda name: name)
    monkeypatch.setattr(kn, "_nvcc", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setattr(kn, "_libs", {})
    monkeypatch.setattr(kn, "BUILD_LOG", {})
    assert kn.build_kernels() == {k: k for k in kn._SOURCES}
    first = dict(kn.BUILD_LOG)
    # the second run in the same checkout compiles nothing
    monkeypatch.setattr(kn, "_nvcc",
                        lambda: _fake_nvcc(tmp_path, ok=False))
    monkeypatch.setattr(kn, "_libs", {})
    monkeypatch.setattr(kn, "BUILD_LOG", {})
    kn.build_kernels()
    assert kn.BUILD_LOG == first
    for name in kn._SOURCES:
        c = CONTRACTS[("filodb_tpu_torch.query.kernels", name)]
        seen, bad = rules_kernel.check_build(
            c, rules_kernel.ptxas_report(kn.BUILD_LOG[name]),
            CARD_ATTRS[name], SMEM_OPTIN_BYTES)
        assert bad == [], bad
        assert {k: v["ptxas_instances"] for k, v in seen.items()} \
            == {k.name: (6 if "partial" in k.name else 1)
                for k in c.kernels}
    # a library whose report is gone is built again
    lib = kn._lib_path("window_extract")[1]
    os.remove(kn._log_path(lib))
    monkeypatch.setattr(kn, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc failed for window_extract"):
        kn.build_kernels()


@pytest.mark.parametrize("mutation", ["registers", "static", "threads",
                                      "undeclared", "missing", "optin"])
def test_a_build_that_disagrees_with_its_contract_is_flagged(mutation):
    c = CONTRACTS[("filodb_tpu_torch.query.kernels", "counter_groupsum")]
    report = rules_kernel.ptxas_report(PTXAS_LOG["counter_groupsum"])
    attrs = list(CARD_ATTRS["counter_groupsum"])
    optin = SMEM_OPTIN_BYTES
    if mutation == "registers":
        attrs[3] = ("groupsum_partial_kernel", 96, 0, 544)
    elif mutation == "static":
        report = {fn: dict(v, static_smem=16) if "reduce" in fn else v
                  for fn, v in report.items()}
    elif mutation == "threads":
        attrs[0] = ("groupsum_partial_kernel", 94, 0, 512)
    elif mutation == "undeclared":
        attrs.append(("groupsum_tail_kernel", 20, 0, 1024))
    elif mutation == "missing":
        report = {fn: v for fn, v in report.items() if "reduce" not in fn}
    else:
        optin = SMEM_OPTIN_BYTES - 1
    _, bad = rules_kernel.check_build(c, report, attrs, optin)
    assert len(bad) == 1, bad


def test_launches_the_library_reports_are_held_to_the_plan():
    c = CONTRACTS[("filodb_tpu_torch.query.kernels", "counter_groupsum")]
    shape = dict(n_s=8, T=469, G=16, hi_mode=kn.GS_BOTH,
                 lo_mode=kn.GS_BOTH, n_sm=132)
    planned = kn.counter_groupsum_launches(**shape)
    assert rules_kernel.check_launches(c, shape, planned) == []
    # the CUDA layout one mbarrier larger than the planner's
    drift = [dataclasses.replace(planned[0], smem=planned[0].smem + 8),
             planned[1]]
    assert len(rules_kernel.check_launches(c, shape, drift)) == 1
    # a launch the plan also asks for, outside the limits
    wide = dict(shape, n_s=65_536)
    (bad,) = rules_kernel.check_launches(
        c, wide, kn.counter_groupsum_launches(**wide))
    assert "grid" in bad


# -- hot path ----------------------------------------------------------------

HOT_CPU = """
from filodb_tpu_torch.lint.hotpath import hot_path


@hot_path
def serve_query(x):
    return x.cpu()
"""

HOT_SYNC = """
import torch
from filodb_tpu_torch.lint.hotpath import hot_path


@hot_path
def serve_query(x):
    y = x * 2
    torch.cuda.synchronize()
    return y
"""

HOT_COLD = """
import torch


def offline_job(x):
    torch.cuda.synchronize()
    return x.cpu().item()
"""


def test_host_sync_in_hot_loop_learns_torch(tmp_path):
    assert rules_of(lint_src(tmp_path, HOT_CPU)) \
        == ["host-transfer-in-hot-loop"]
    assert rules_of(lint_src(tmp_path, HOT_SYNC)) \
        == ["host-transfer-in-hot-loop"]
    assert rules_of(lint_src(tmp_path, HOT_CPU.replace(
        "x.cpu()", 'x.to("cpu")'))) == ["host-transfer-in-hot-loop"]
    assert rules_of(lint_src(tmp_path, HOT_CPU.replace(
        "x.cpu()", "x.item()"))) == ["host-transfer-in-hot-loop"]
    assert not lint_src(tmp_path, HOT_COLD).findings


# -- the idiom-free families: the reference's fixtures, the same findings ----

PARITY_FIXTURES = (
    "LOCK_ACCESS", "LOCK_ACCESS_CLEAN", "LOCK_BLOCKING",
    "LOCK_BLOCKING_CLEAN", "LOCK_MODULE_GLOBAL",
    "SPAN_BARE_OPEN", "SPAN_BARE_OPEN_CLEAN", "SPAN_DISCARDED",
    "SPAN_HOT_FORMAT", "SPAN_HOT_FORMAT_GUARDED", "SPAN_HOT_RAW_ARGS",
    "SPAN_COLD_FORMAT", "SPAN_HOT_TAG_FORMAT", "SPAN_HOT_FORMAT_PRAGMA",
    "LOCK_ORDER_CYCLE", "LOCK_ORDER_CYCLE_CLEAN", "LOCK_ORDER_POLICY",
    "LOCK_ORDER_POLICY_CLEAN", "DEEP_BLOCKING", "DEEP_BLOCKING_CLEAN",
    "UNGUARDED_SHARED", "UNGUARDED_SHARED_LOCKED",
    "UNGUARDED_SHARED_DECLARED", "UNGUARDED_SINGLE_WRITER",
    "UNGUARDED_ATOMIC_REBIND", "UNGUARDED_THREAD_ROOT_MARKER",
    "CACHE_WIRED", "CACHE_UNWIRED", "CACHE_ROTTED_PULL",
    "CACHE_UNREGISTERED", "CACHE_REGISTERED",
)


def _reference_lint(tmp_path, src):
    from filodb_tpu.lint import run_lint as ref_run_lint
    p = tmp_path / "fixture.py"
    p.write_text(src)
    rel = os.path.relpath(str(p), package_root()).replace(os.sep, "/")
    return ref_run_lint([str(p)], baseline=frozenset(),
                        check_contracts=False,
                        report_only=frozenset({rel}))


def _shape(res):
    return ([(f.rule, f.line, f.severity, f.context)
             for f in res.findings], res.suppressed)


@pytest.mark.parametrize("fixture", PARITY_FIXTURES)
def test_idiom_free_families_match_the_reference(tmp_path, fixture):
    src = getattr(ref_fx, fixture)
    ref = _reference_lint(tmp_path, src)
    port = lint_src(tmp_path, src)
    assert _shape(port) == _shape(ref)


def test_the_parity_fixtures_are_not_vacuous(tmp_path):
    flagged = {name for name in PARITY_FIXTURES
               if lint_src(tmp_path, getattr(ref_fx, name)).findings}
    assert {"LOCK_ACCESS", "LOCK_BLOCKING", "SPAN_BARE_OPEN",
            "LOCK_ORDER_CYCLE", "LOCK_ORDER_POLICY", "DEEP_BLOCKING",
            "UNGUARDED_SHARED", "CACHE_UNWIRED", "CACHE_ROTTED_PULL",
            "CACHE_UNREGISTERED"} <= flagged


BAD_RULE_FILE = """groups:
  - name: broken
    rules:
      - record: job:cpu:rate5m
        expr: rate(cpu_usage[5m])
      - record: job:cpu:rate5m
        expr: rate(cpu_usage[5m])
      - alert: Broken
        expr: sum(rate(http_requests_total[5m]) by (job)
"""


def test_promql_rule_files_match_the_reference(tmp_path):
    from filodb_tpu.lint import rules_promql as ref_promql

    from filodb_tpu_torch.lint import rules_promql
    bad = tmp_path / "bad_rules.yaml"
    bad.write_text(BAD_RULE_FILE)
    shipped = [os.path.join(REPO, "examples", f)
               for f in sorted(os.listdir(os.path.join(REPO, "examples")))
               if f.endswith((".yaml", ".yml", ".json"))]
    for path in shipped + [str(bad)]:
        want = [(f.rule, f.line, f.severity) for _, f in
                ref_promql._rule_file_findings(path, REPO)]
        got = [(f.rule, f.line, f.severity) for _, f in
               rules_promql._rule_file_findings(path, REPO)]
        assert got == want, path
    assert [f for _, f in rules_promql._rule_file_findings(str(bad), REPO)]


# -- the engine over the port's modules ---------------------------------------

@pytest.fixture(scope="module")
def port_df():
    root = package_root()
    files = iter_py_files([os.path.join(root, "filodb_tpu_torch")])
    mods = [m for m in (load_module(p, root=root) for p in files) if m]
    cg = cgmod.build(mods)
    return dfmod.DeviceDataflow(mods, cg), mods


PUB_TOPOLOGY = "filodb_tpu_torch.parallel.shardmapper:ShardMapper.update"
PUB_SCHEMA = ("filodb_tpu_torch.http.server:"
              "FiloHttpServer.invalidate_plan_cache")
HOOK_PLAN = "filodb_tpu_torch.query.plancache:PlanCache.invalidate"
HOOK_RESULTS = "filodb_tpu_torch.query.resultcache:ResultCache.invalidate"


def test_topology_publisher_reaches_both_cache_hooks(port_df):
    flow, _ = port_df
    for hook in (HOOK_PLAN, HOOK_RESULTS):
        assert flow.reaches(PUB_TOPOLOGY, hook) is not None, hook
    path = flow.reaches(PUB_TOPOLOGY, HOOK_RESULTS)
    quals = [flow.cg.funcs[k].qualname for k in path]
    assert "ShardMapper._publish" in quals


def test_schema_publisher_reaches_both_cache_hooks(port_df):
    flow, _ = port_df
    for hook in (HOOK_PLAN, HOOK_RESULTS):
        assert flow.reaches(PUB_SCHEMA, hook) is not None, hook


def test_result_cache_lookups_read_every_pull_source(port_df):
    flow, _ = port_df
    mod = "filodb_tpu_torch.query.resultcache"
    for hook in (f"{mod}:ResultCache.begin", f"{mod}:ResultCache.stale_serve"):
        for src in ("shards_watermark", "watermark_coverage",
                    "shards_epoch", "dispatch_scope"):
            assert flow.reaches(hook, f"{mod}:{src}") is not None, \
                (hook, src)


def test_the_residency_taint_sees_the_ports_stores(port_df):
    """The device stores the reference's jnp-only tables cannot see: the
    aligned tiles' three tensors, the backend's tile cache (through the
    tile build's return and the insert's parameter), the sharded store's
    channels (through the per-partition closure)."""
    flow, _ = port_df
    labels = {(k.split(":")[1], s.label) for k, t in flow.escapes.items()
              for s in t.stores}
    assert {("AlignedTiles.__init__", "self.valid"),
            ("AlignedTiles.__init__", "self.ts"),
            ("AlignedTiles.__init__", "self.vals"),
            ("TorchBackend._insert_tile_entry", "self._tile_cache[]"),
            ("ShardedTiles.__init__", "self._chan[]")} <= labels


def test_the_cache_inventory_names(port_df):
    from filodb_tpu_torch.lint import rules_cache
    flow, mods = port_df
    regs, _ = rules_cache._collect_registries(flow.cg, mods)
    assert {"plan", "results", "device-tile", "tilestore-executables",
            "sharded-tile-placement"} <= {r.name for r in regs}


# -- the runner --------------------------------------------------------------

def test_the_catalog_and_what_is_not_ported():
    cat = rules()
    for rid in ("hbm-residency-budget", "device-buffer-leak",
                "oversized-transfer", "smem-frontier-budget",
                "capacity-certification"):
        assert cat[rid].family == "capacity" and cat[rid].severity == "error"
    for rid in ("kernel-contract-missing", "kernel-smem-budget",
                "kernel-grid-bounds", "kernel-span-guard",
                "kernel-abstract-eval", "kernel-module-import"):
        assert cat[rid].family == "kernel"
    assert "kernel-vmem-budget" not in cat
    assert set(NOT_PORTED) == {"trace-f64-constant",
                               "partition-spec-consistency",
                               "donation-missing"}
    assert not set(NOT_PORTED) & set(cat)


def test_pragma_requires_reason_and_baseline_grandfathers(tmp_path):
    src = RESIDENT_VIOLATION.replace(
        "        self._buf", "        # graftlint: disable=hbm-residency"
        "-budget\n        self._buf")
    assert rules_of(lint_src(tmp_path, src)) == ["pragma-no-reason"]
    res = lint_src(tmp_path, RESIDENT_VIOLATION)
    key = res.findings[0].key()
    p = tmp_path / "fixture.py"
    rel = os.path.relpath(str(p), package_root()).replace(os.sep, "/")
    res2 = run_lint([str(p)], baseline=frozenset([key]),
                    check_contracts=False, report_only=frozenset({rel}))
    assert not res2.findings and len(res2.baselined) == 1


def test_cli_json_github_and_exit_codes(tmp_path):
    p = tmp_path / "viol.py"
    p.write_text(RESIDENT_VIOLATION)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "filodb_tpu_torch.lint", "--json",
         "--no-contracts", str(p)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 1, out.stderr
    payload = json.loads(out.stdout)
    assert [f["rule"] for f in payload["findings"]] \
        == ["hbm-residency-budget"]
    gh = subprocess.run(
        [sys.executable, "-m", "filodb_tpu_torch.lint", "--github",
         "--no-contracts", str(p)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert gh.returncode == 1
    assert gh.stdout.startswith("::error file=") \
        and "graftlint hbm-residency-budget" in gh.stdout


# -- the families taught torch in full: trace, SPMD, numerics ----------------
#
# Each torch twin below states in torch idiom the fact its reference fixture
# (tests/test_graftlint.py, of the same name) states in JAX idiom; the port's
# analyser must find on the twin what the reference's finds on the fixture.

TORCH_TWINS = {
    # trace safety, in a torch.func.vmap body
    "TRACE_SIDE_EFFECT": """
import time
import torch

def f(x):
    return x + time.time()

def run(xs):
    return torch.func.vmap(f)(xs)
""",
    "TRACE_SIDE_EFFECT_CLEAN": """
import time
import torch

def now():
    return time.time()          # host helper, never traced

def f(x):
    return x * 2

def run(xs):
    return torch.func.vmap(f)(xs)
""",
    "TRACE_TRACER_LEAK": """
import torch

def f(x):
    return 1.0 if bool(x) else 0.0

def run(xs):
    return torch.func.vmap(f)(xs)
""",
    "TRACE_TRACER_LEAK_CLEAN": """
import functools
import torch

def f(flag, x):
    return torch.where(torch.tensor(bool(flag)), x, -x)   # bound: fine

def run(xs, flag):
    return torch.func.vmap(functools.partial(f, flag))(xs)
""",
    "TRACE_MUTATE": """
import torch

_seen = []

def f(x):
    _seen.append(x)
    return x

def run(xs):
    return torch.func.vmap(f)(xs)
""",
    "TRACE_MUTATE_CLEAN": """
import torch

def f(x):
    acc = []
    acc.append(x)               # function-local: fine
    return acc[0]

def run(xs):
    return torch.func.vmap(f)(xs)
""",
    # collective balance over torch.distributed
    "SPMD_DIVERGENT": """
import torch
import torch.distributed as dist

def reduce_all(t):
    if dist.get_rank() == 0:
        dist.all_reduce(t.to(torch.int32))
    return t
""",
    "SPMD_DIVERGENT_CLEAN": """
import torch
import torch.distributed as dist
from filodb_tpu_torch.lint.ranks import rank_invariant

@rank_invariant("agg", reason="every rank runs the same query")
def reduce_all(t, agg):
    # the reference's idiom: branching on a value every rank shares
    out = t.to(torch.int32)
    dist.all_reduce(out)
    if agg == "mean":
        dist.all_reduce(out)
    return out
""",
    "SPMD_DIVERGENT_PRAGMA": """
import torch
import torch.distributed as dist

def reduce_all(t):
    if dist.get_rank() == 0:
        # graftlint: disable=spmd-collective-balance (single-rank test rig)
        dist.all_reduce(t.to(torch.int32))
    return t
""",
    "SPMD_BAD_AXIS": """
class Mesh:
    axis_names = ("shard", "time")

    def __init__(self, devices):
        self.shape = dict(zip(self.axis_names, (len(devices), 1)))

def width(mesh):
    return mesh.shape["shards"]
""",
    # a collective reached through a helper, on a data-dependent branch
    "SPMD_COND_BRANCH": """
import torch
import torch.distributed as dist

def then_branch(t):
    dist.all_reduce(t.to(torch.int32))
    return t

def f(t):
    return then_branch(t) if t.sum() > 0 else t
""",
    # in-place writers, the port's counterpart of donation
    "DONATE_USE_AFTER": """
def write_into(buf, new):
    buf[:new.shape[0]].copy_(new)
    return buf

def advance(x, y):
    head = x[:4]
    write_into(x, y)
    return head + 1
""",
    "DONATE_CLEAN": """
def write_into(buf, new):
    buf[:new.shape[0]].copy_(new)
    return buf

def advance(x, y):
    head = x[:4].clone()    # a copy: the write does not reach it
    write_into(x, y)
    return head + x         # the written storage itself: fine
""",
    "DONATE_DOUBLE": """
def write_into(buf, new):
    buf[:new.shape[0]].copy_(new)
    return buf

def advance(x):
    return write_into(x, x)
""",
    "DONATE_ALIASED": """
def append_into(buf, new, n):
    buf[n:n + new.shape[0]].copy_(new)


class Store:
    def __init__(self, buf):
        self.buf = buf
        self.head = None

    def refresh(self):
        self.head = self.buf[:8]

    def append(self, new, n):
        append_into(self.buf, new, n)   # self.head is left as it was
        return n
""",
    # two resident buffers written in place by one call; the refresh
    # idiom takes the cached view again after the write
    "DONATE_TUPLE_CLEAN": """
def append(ts, vals, new, n):
    ts[n:n + new.shape[0]].copy_(new)
    vals[n:n + new.shape[0]].copy_(new)


class Store:
    def __init__(self, ts, vals):
        self.ts = ts
        self.vals = vals
        self.tail = self.vals[-8:]

    def refresh(self, new, n):
        append(self.ts, self.vals, new, n)
        self.tail = self.vals[-8:]
""",
    "DONATE_TUPLE_VIOLATION": """
def append(ts, vals, new, n):
    ts[n:n + new.shape[0]].copy_(new)
    vals[n:n + new.shape[0]].copy_(new)


class Store:
    def __init__(self, ts, vals):
        self.ts = ts
        self.vals = vals
        self.tail = self.vals[-8:]

    def refresh(self, new, n):
        # self.tail, taken from self.vals, is left as it was
        append(self.ts, self.vals, new, n)
""",
    "DONATE_PRAGMA": """
def write_into(buf, new):
    buf[:new.shape[0]].copy_(new)
    return buf

def advance(x, y):
    head = x[:4]
    write_into(x, y)  # graftlint: disable=donation-safety (head provably outside the written rows)
    return head + 1
""",
    # numerics
    "NARROW_VIOLATION": """
import torch

def grid(dev):
    t = torch.arange(16, dtype=torch.int64, device=dev)
    rel = t * 60000 + 5
    return rel.to(torch.int32)
""",
    "NARROW_CLEAN": """
import torch
from filodb_tpu_torch.lint.numerics import precision

@precision("fixture-span-guard", bits=31, rel_ulps=0,
           reason="grid proved inside int32 ms by the dispatcher")
def grid(dev):
    t = torch.arange(16, dtype=torch.int64, device=dev)
    rel = t * 60000 + 5
    return rel.to(torch.int32)
""",
    "NARROW_PRAGMA": """
import torch

def grid(dev):
    t = torch.arange(16, dtype=torch.int64, device=dev)
    rel = t * 60000 + 5
    # graftlint: disable=precision-narrowing (fixture: span guarded upstream)
    return rel.to(torch.int32)
""",
    "NARROW_F64_VIOLATION": """
import torch

def shrink(x, dev):
    v = torch.as_tensor(x, device=dev).double() * 2.0
    return v.float()
""",
    "ACCUM_VIOLATION": """
import torch

def total(x, dev):
    y = torch.as_tensor(x, device=dev).to(torch.float32)
    return torch.sum(y)
""",
    "ACCUM_CLEAN_ANNOTATED": """
import torch
from filodb_tpu_torch.lint.numerics import precision

@precision("fixture-accum", bits=24, rel_ulps=4, accum_terms=1 << 20,
           reason="at most 2**20 window terms by the dispatcher bound")
def total(x, dev):
    y = torch.as_tensor(x, device=dev).to(torch.float32)
    return torch.sum(y)
""",
    "ACCUM_CLEAN_F64": """
import torch

def total(x, dev):
    y = torch.as_tensor(x, device=dev).to(torch.float32)
    return torch.sum(y, dtype=torch.float64)
""",
    "ACCUM_OVERCLAIM": """
import torch
from filodb_tpu_torch.lint.numerics import precision

@precision("fixture-accum-over", bits=24, rel_ulps=4,
           accum_terms=1 << 30,
           reason="bound exceeds the f32 mantissa on purpose")
def total(x, dev):
    y = torch.as_tensor(x, device=dev).to(torch.float32)
    return torch.sum(y)
""",
    "ORDER_VIOLATION": """
import torch.distributed as dist

def total(x):
    dist.all_reduce(x)
    return x
""",
    "ORDER_CLEAN_ANNOTATED": """
import torch.distributed as dist
from filodb_tpu_torch.lint.numerics import order_insensitive

@order_insensitive("fixture-psum", tolerance=1e-12,
                   reason="f64 partials; a few ulps across regroupings")
def total(x):
    dist.all_reduce(x)
    return x
""",
    "ORDER_CLEAN_INT": """
import torch
import torch.distributed as dist

def total(x):
    counts = x.to(torch.int64)
    dist.all_reduce(counts)
    return counts
""",
    "ORDER_PRAGMA": """
import torch.distributed as dist

def total(x):
    # graftlint: disable=reduction-order-determinism (fixture rig)
    dist.all_reduce(x)
    return x
""",
    # the plain version of a CUDA kernel
    "MIXED_CMP_VIOLATION": """
import torch
from filodb_tpu_torch.lint.contracts import kernel_contract

def kern_reference(x):
    idx = torch.arange(8, dtype=torch.int32, device=x.device)
    fidx = idx.to(torch.float32)
    return torch.where(fidx > 3.0, x, 0.0)

@kernel_contract("fixture_kernel", kind="cuda", plain=kern_reference)
def kern(x):
    return kern_reference(x)
""",
    "MIXED_CMP_CLEAN": """
import torch
from filodb_tpu_torch.lint.contracts import kernel_contract

def kern_reference(x):
    idx = torch.arange(8, dtype=torch.int32, device=x.device)
    return torch.where(idx > 3, x, 0.0)

@kernel_contract("fixture_kernel", kind="cuda", plain=kern_reference)
def kern(x):
    return kern_reference(x)
""",
    "MIXED_CMP_PRAGMA": """
import torch
from filodb_tpu_torch.lint.contracts import kernel_contract

def kern_reference(x):
    idx = torch.arange(8, dtype=torch.int32, device=x.device)
    fidx = idx.to(torch.float32)
    # graftlint: disable=mixed-dtype-comparison (indices bounded < 2**24)
    return torch.where(fidx > 3.0, x, 0.0)

@kernel_contract("fixture_kernel", kind="cuda", plain=kern_reference)
def kern(x):
    return kern_reference(x)
""",
}


@pytest.mark.parametrize("name", sorted(TORCH_TWINS))
def test_a_torch_twin_is_flagged_as_the_reference_flags_its_fixture(
        tmp_path, name):
    ref = _reference_lint(tmp_path, getattr(ref_fx, name))
    port = lint_src(tmp_path, TORCH_TWINS[name])
    assert rules_of(port) == rules_of(ref), (name, port.findings)
    assert port.suppressed == ref.suppressed
    assert all(f.severity == "error" for f in port.findings)


def test_the_twins_are_not_vacuous(tmp_path):
    """Every ported rule fires on some twin, and every violating twin
    fires exactly one rule."""
    fired = {}
    for name, src in TORCH_TWINS.items():
        fired[name] = rules_of(lint_src(tmp_path, src))
    assert {r for rs in fired.values() for r in rs} == {
        "trace-side-effect", "trace-tracer-leak", "trace-mutate-capture",
        "spmd-collective-balance", "donation-safety",
        "precision-narrowing", "accumulation-bound",
        "reduction-order-determinism", "mixed-dtype-comparison"}
    for name, got in fired.items():
        if "CLEAN" in name or "PRAGMA" in name:
            assert got == [], name
        else:
            assert len(got) == 1, (name, got)


def test_the_tuple_refresh_names_the_stale_attribute(tmp_path):
    res = lint_src(tmp_path, TORCH_TWINS["DONATE_TUPLE_VIOLATION"])
    assert [f.rule for f in res.findings] == ["donation-safety"]
    assert "self.tail" in res.findings[0].message


def test_the_axis_and_overclaim_messages(tmp_path):
    res = lint_src(tmp_path, TORCH_TWINS["SPMD_BAD_AXIS"])
    assert "'shards'" in res.findings[0].message
    res = lint_src(tmp_path, TORCH_TWINS["ACCUM_OVERCLAIM"])
    assert "2**24" in res.findings[0].message


@pytest.mark.parametrize("fixture,rule", [
    ("TRACE_F64", "trace-f64-constant"),
    ("SPEC_ARITY", "partition-spec-consistency"),
    ("SPEC_BAD_MESH_AXIS", "partition-spec-consistency"),
    ("SPEC_OUT_ARITY", "partition-spec-consistency"),
    ("SPEC_POSITIONAL_OUT_OF_RANGE", "partition-spec-consistency"),
    ("SPEC_POSITIONAL_DOUBLE_NEG", "partition-spec-consistency"),
    ("DONATE_MISSING", "donation-missing"),
])
def test_a_rule_without_a_torch_counterpart_is_listed_with_its_reason(
        tmp_path, fixture, rule):
    """The reference's fixture for the rule trips it there; the port
    registers no such rule and lists it, with the reason, instead."""
    assert rule in rules_of(_reference_lint(tmp_path,
                                            getattr(ref_fx, fixture)))
    assert rule not in rules()
    assert NOT_PORTED[rule].strip()


# -- trace: the bodies bound through a parameter, and the scalar guard --------

VMAP_GRIDS = """
import functools
import numpy as np
import torch

def body(n, w0):
    if isinstance(w0, torch.Tensor):
        k = torch.floor(w0 / 10)
    else:
        k = int(np.floor(w0 / 10))      # eager scalar calls only
    return torch.arange(n) + k

def _vmap_grids(body, w0s):
    return torch.func.vmap(lambda w: body(w))(torch.tensor(w0s))

def batch(n, w0s):
    fn = functools.partial(body, n)
    return _vmap_grids(fn, w0s)
"""


def test_a_body_bound_through_a_partial_is_traced(tmp_path):
    assert not lint_src(tmp_path, VMAP_GRIDS).findings
    unguarded = VMAP_GRIDS.replace(
        "    if isinstance(w0, torch.Tensor):\n"
        "        k = torch.floor(w0 / 10)\n    else:\n    ", "")
    res = lint_src(tmp_path, unguarded)
    assert rules_of(res) == ["trace-tracer-leak"]
    assert "int()" in res.findings[0].message
    # the same leak in a body nothing binds to the transform is not traced
    untraced = unguarded.replace("return _vmap_grids(fn, w0s)",
                                 "return fn(w0s[0])")
    assert not lint_src(tmp_path, untraced).findings


def test_a_write_into_a_partial_bound_tensor_is_a_captured_mutation(
        tmp_path):
    src = """
import functools
import torch

def f(buf, x):
    buf[0] = x.sum()
    return x

def run(xs, buf):
    return torch.func.vmap(functools.partial(f, buf))(xs)
"""
    assert rules_of(lint_src(tmp_path, src)) == ["trace-mutate-capture"]
    fixed = src.replace("    buf[0] = x.sum()",
                        "    out = buf.clone()\n    out[0] = x.sum()")
    assert not lint_src(tmp_path, fixed).findings


def test_the_ports_vmap_site_resolves_its_four_bodies(port_df):
    flow, _ = port_df
    (site,) = flow.sites
    bodies = {flow.cg.funcs[k].qualname for k in site.body_keys}
    assert {"_eval_counter_slide", "_eval_counter_fast", "_eval_counter_t",
            "_eval_core"} <= bodies
    # vmap batches the two grid offsets, past the partial's arguments
    for q in ("_eval_counter_slide", "_eval_counter_fast",
              "_eval_counter_t", "_eval_core"):
        assert flow.batched[f"filodb_tpu_torch.query.tilestore:{q}"] \
            == {"w0s", "w0e"}, q


# -- SPMD: rank-invariance through agreement and None-ness ---------------------

AGREED = """
import torch
import torch.distributed as dist

def _agree(t):
    buf = t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return buf

def run(t, n_local):
    agreed = _agree(torch.tensor([n_local])).tolist()
    if agreed[0] > 0:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t
"""

NONE_BY_QUERY = """
import torch.distributed as dist
from filodb_tpu_torch.lint.ranks import rank_invariant

def _partials(x, agg):
    val = None
    if agg == "sum":
        val = x * 2
    return x, val

def _all_reduce(t, op):
    dist.all_reduce(t, op=op)
    return t

@rank_invariant("agg", reason="every rank runs the same query")
def run(x, agg):
    vals = []
    for part in x:
        c, v = _partials(part, agg)
        vals.append(v)
    if vals[0] is not None:
        _all_reduce(vals[0], dist.ReduceOp.MAX)
    return vals
"""


def test_the_result_of_a_collective_is_rank_invariant(tmp_path):
    assert not lint_src(tmp_path, AGREED).findings
    res = lint_src(tmp_path, AGREED.replace("if agreed[0] > 0",
                                            "if n_local > 0"))
    assert rules_of(res) == ["spmd-collective-balance"]


def test_none_ness_is_proven_through_a_helpers_returns(tmp_path):
    assert not lint_src(tmp_path, NONE_BY_QUERY).findings
    # the helper chooses None on its data: not rank-invariant
    res = lint_src(tmp_path, NONE_BY_QUERY.replace('if agg == "sum":',
                                                   "if x.sum() > 0:"))
    assert rules_of(res) == ["spmd-collective-balance"]
    # without the declaration agg is a rank's own value
    res = lint_src(tmp_path, NONE_BY_QUERY.replace(
        '@rank_invariant("agg", reason="every rank runs the same query")\n',
        ""))
    assert rules_of(res) == ["spmd-collective-balance"]


def test_a_wrapper_forwards_its_op_to_its_call_sites(tmp_path):
    assert not lint_src(tmp_path, NONE_BY_QUERY).findings
    res = lint_src(tmp_path, NONE_BY_QUERY.replace("dist.ReduceOp.MAX",
                                                   "dist.ReduceOp.SUM"))
    assert rules_of(res) == ["reduction-order-determinism"]
    assert res.findings[0].line == NONE_BY_QUERY.splitlines().index(
        "        _all_reduce(vals[0], dist.ReduceOp.MAX)") + 1


def test_the_ports_collectives_and_in_place_append(port_df):
    flow, _ = port_df
    mod = "filodb_tpu_torch.parallel.distributed"
    calls = [s for s in flow.collective_sites
             if s.via == f"{mod}:_all_reduce"]
    assert len(calls) == 3
    assert {s.key for s in calls} == {f"{mod}:window_aggregate_distributed"}
    assert flow.rank_invariant[f"{mod}:window_aggregate_distributed"] \
        >= {"func", "agg", "num_groups", "params"}
    folds = {s.name for s in flow.collective_sites if s.kind == "fold"}
    assert {"psum", "pmin", "pmax", "all_gather"} <= folds
    appends = [c for c in flow.inplace_calls
               if c.writer.endswith("shardstore:_append_step")
               and c.relpath == "filodb_tpu_torch/parallel/shardstore.py"]
    assert len(appends) == 1
    assert flow.inplace_writers[appends[0].writer] == {"tsr", "v", "cv"}


def test_the_append_without_its_invalidation_is_flagged(tmp_path):
    """shardstore.append_slots clears the per-snapshot placements after
    writing the resident channels in place; the same file without that
    line is flagged."""
    src = open(os.path.join(REPO, "filodb_tpu_torch", "parallel",
                            "shardstore.py")).read()
    line = "        self._aligned.clear()   # row-major placements are " \
           "per-snapshot\n"
    assert src.count(line) == 1
    assert "donation-safety" not in rules_of(
        lint_src(tmp_path, src, "shardstore.py"))
    res = lint_src(tmp_path, src.replace(line, ""), "shardstore.py")
    assert [f.rule for f in res.findings] == ["donation-safety"]
    assert "self._aligned" in res.findings[0].message


def test_numerics_families_flow_through_json_github_changed(tmp_path):
    """The numerics families ride the reporting rails: --json carries the
    rule ids, --github renders annotation lines, and report_only
    (--changed-only) drops findings anchored elsewhere."""
    from filodb_tpu_torch.lint.ci_annotations import github_annotations
    res = lint_src(tmp_path, TORCH_TWINS["NARROW_VIOLATION"])
    payload = res.to_json()
    assert payload["exit_code"] == 1
    assert [f["rule"] for f in payload["findings"]] \
        == ["precision-narrowing"]
    lines = github_annotations(payload)
    assert len(lines) == 1 and "graftlint precision-narrowing" in lines[0]
    assert lines[0].startswith("::error ")
    p = tmp_path / "fixture.py"
    other = run_lint([str(p)], baseline=frozenset(), check_contracts=False,
                     report_only=frozenset(["somewhere/else.py"]))
    assert not other.findings


# -- the torch dtype inference, form by form ------------------------------------

DTYPE_FIXTURE = """
import numpy as np
import torch

F32 = torch.float32


def site(x, dev):
    v = torch.zeros(4, dtype=torch.float64, device=dev)
    t = torch.arange(4, dtype=torch.int64, device=dev)
    y = torch.zeros(4, dtype=torch.float32, device=dev)
    idx = torch.arange(4, device=dev)
    h = np.asarray(x, dtype=np.float64)
    return {expr}
"""


@pytest.mark.parametrize("expr", [
    "v.to(torch.float32)", "v.to(dtype=torch.float32)",
    "v.to(dev, torch.float32)", "v.to(F32)", "v.float()", "v.half()",
    "v.type(torch.float32)", "(v * 2.0 + 1).float()", "t.int()",
    "t.to(torch.int32)", "(t >> 31).to(torch.int32)",
    "torch.where(t > 0, v, v).float()", "h.astype(np.float32)",
    "np.float32(h)", "t.float()",
])
def test_each_narrowing_form_is_seen(tmp_path, expr):
    src = DTYPE_FIXTURE.format(expr=expr)
    assert rules_of(lint_src(tmp_path, src)) == ["precision-narrowing"]


@pytest.mark.parametrize("expr", [
    "v.to(torch.float64)", "v.double()", "t.long()", "y.float()",
    "t.to(dev)", "(t / 2).to(torch.float32)", "(t * 0.5).float()",
    "x.to(torch.float32)", "v.to(dev)",
])
def test_what_is_not_provably_a_narrowing_is_quiet(tmp_path, expr):
    """Widening, same-width and device moves, an integer tensor's true
    division or product with a Python float (torch's default float
    dtype) and a parameter of unknown dtype stay quiet."""
    src = DTYPE_FIXTURE.format(expr=expr)
    assert "precision-narrowing" not in rules_of(lint_src(tmp_path, src))


@pytest.mark.parametrize("expr", [
    "torch.sum(y)", "y.sum()", "torch.nansum(y)", "torch.cumsum(y, 0)",
    "y.cumsum(0)", "y @ y", "torch.matmul(y, y)", "torch.mm(y, y)",
    "torch.bmm(y, y)", 'torch.einsum("i,i->", y, y)',
    "y.index_add_(0, idx, y)", "y.scatter_add_(0, idx, y)",
])
def test_each_f32_accumulation_needs_a_bound(tmp_path, expr):
    src = DTYPE_FIXTURE.format(expr=expr)
    assert rules_of(lint_src(tmp_path, src)) == ["accumulation-bound"]


@pytest.mark.parametrize("expr", [
    "torch.sum(y, dtype=torch.float64)", "y.sum(dtype=torch.float64)",
    "v.sum()", "v @ v", "t.cumsum(0)", "torch.sum(x)",
])
def test_an_f64_or_unknown_accumulation_is_quiet(tmp_path, expr):
    src = DTYPE_FIXTURE.format(expr=expr)
    assert "accumulation-bound" not in rules_of(lint_src(tmp_path, src))
