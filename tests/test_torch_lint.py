"""The port passes both static analysers.

``python -m filodb_tpu.lint filodb_tpu_torch`` (the JAX package's
analyser) reports no finding under ``filodb_tpu_torch/``: the port
declares its invariants with its own decorators
(``filodb_tpu_torch/lint/``: ``@single_writer``, ``@cache_registry``,
``@publishes``/``@event_source``, ``@guarded_by``, ``@capacity``,
``@kernel_contract``, ``@hot_path``) and reasoned ``# graftlint:
disable=`` pragmas, which that analyser matches by their leaf names. That
run also lints the reference tree, whose own finding (the
``ulp-certification`` of ``grouped-pair-psum`` in
``filodb_tpu/parallel/shardstore.py``, a known fault of the JAX package)
is not the port's and is left out here.

``python -m filodb_tpu_torch.lint filodb_tpu_torch`` (the port's own
analyser, whose rules see torch device tensors and the CUDA kernel
libraries) reports no finding either, and its families are shown to have
looked: the residency analysis priced the escapes of the port's claimed
stores, and the kernel family found both CUDA launch sites under their
contracts."""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_lints_clean():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "filodb_tpu.lint", "filodb_tpu_torch",
         "--json"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    report = json.loads(proc.stdout)
    assert report["files"] > 0
    ours = [f for f in report["findings"]
            if f["path"].startswith("filodb_tpu_torch/")]
    assert not ours, "\n".join(
        f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
        for f in ours)
    # the port's pragmas are counted as suppressions, each with a reason
    assert report["suppressed"] >= 5


def test_port_lints_clean_under_its_own_analyser():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "filodb_tpu_torch.lint", "filodb_tpu_torch",
         "--json"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    elapsed = time.monotonic() - t0
    report = json.loads(proc.stdout)
    assert report["files"] > 100
    assert not report["findings"], "\n".join(
        f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
        for f in report["findings"])
    assert proc.returncode == 0 and report["exit_code"] == 0
    seen = report["seen"]
    # the residency family priced the escapes of the claimed stores
    # (AlignedTiles' three tensors, the tile cache, the sharded channels,
    # and more), and pragmas, each with a reason, cover the rest
    assert seen["residency_priced_sites"] >= 4, seen
    assert seen["residency_escape_sites"] >= seen["residency_priced_sites"]
    # both CUDA launch sites, each under its contract
    assert seen["kernel_launch_sites"] == 2, seen
    assert seen["kernel_launch_sites_under_contract"] == 2, seen
    assert seen["cuda_contracts"] == 2, seen
    assert report["suppressed"] >= 10
    assert sorted(report["not_ported"]) == ["rules_numerics", "rules_spmd",
                                            "rules_trace"]
    assert elapsed < 120, elapsed
