"""On the card: one short run of each cell through the benchmark's own
command, which must come out correct and name the card. Skips without a
CUDA card; the benchmark's own runs do not run it."""

import json
import os
import subprocess
import sys

import pytest

from conftest import CHECKOUT

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("cell", ["tsbs-cpu.query-mix"])
def test_a_short_run_on_the_card_is_correct(cell, cuda):
    proc = subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), "--workload",
         cell, "--seed", "2147483999", "--seconds", "5", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
