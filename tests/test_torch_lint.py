"""The port passes the JAX package's static analyser: ``python -m
filodb_tpu.lint filodb_tpu_torch`` reports no finding under
``filodb_tpu_torch/``.

The port declares its invariants with its own copies of the reference's
decorators (``filodb_tpu_torch/lint/``: ``@single_writer``,
``@cache_registry``, ``@publishes``/``@event_source``, ``@guarded_by``,
``@capacity``, ``@kernel_contract``) and reasoned ``# graftlint:
disable=`` pragmas; the analyser matches decorators by their leaf name, so
it reads the port's declarations as it reads the reference's. The run also
lints the reference tree, whose own finding (the ``ulp-certification`` of
``grouped-pair-psum`` in ``filodb_tpu/parallel/shardstore.py``, a known
fault of the JAX package) is not the port's and is left out here."""

import json
import os
import subprocess
import sys

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
