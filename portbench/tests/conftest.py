"""Tests of the benchmark itself, on the CPU: the reference, the
generators, the traffic, the readers, the roofline counts, the check and
its control, and a whole run at a tiny size against the CPU build of the
port. Tests marked `chip` need a CUDA card and skip without one:

  python -m pytest portbench/tests -q             # here
  python -m pytest portbench/tests -q -m chip     # on the card
"""

import json
import os
import shutil
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

PKG = os.path.join(CHECKOUT, "portbench")
BENCH_JSON = os.path.join(CHECKOUT, "BENCHMARK.json")

# the tiny sizes every CPU run of a cell uses
TINY = {"tsbs-devops-cpu": {"hosts": 8}}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's folder with every configuration cut to a
    size a CPU run holds in seconds."""
    root = tmp_path / "portbench"
    shutil.copytree(PKG, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name, over in TINY.items():
        p = root / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg.update(over)
        if "hosts" in over:
            cfg["label_domains"]["hostname"]["count"] = over["hosts"]
        p.write_text(json.dumps(cfg))
    return str(root)


@pytest.fixture
def tiny_bench(tiny_root):
    from portbench.harness import spec
    return spec.Bench(BENCH_JSON, root=tiny_root)
