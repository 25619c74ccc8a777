"""The control of each cell's check, at a size a test run holds: the
reference computed in float32 and put in the program's place must come out
not correct under the cell's limit, on three seeds. (On the card, at the
cells' own sizes: `python3 -m portbench.harness.control`; PERF.md gives
those readings.)"""

import pytest

from portbench.harness import control

CELLS = ("tsbs-cpu.query-mix",)


@pytest.mark.parametrize("seed", [21, 2**31 + 3, 977])
@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_fails_the_limit(cell, seed, tiny_bench):
    got = control.readings(tiny_bench, cell, seed)
    limit = tiny_bench.limits(cell)["gap"]["limit"]
    assert got["gap"] > limit, got
