"""The window evaluators' roofline count: samples covered once, on the
configuration's lattice and inside its data, and calls described by the
query's shape, not by the rows and steps the program pads them to."""

import numpy as np
import pytest

from conftest import BENCH_JSON
from portbench.harness import spec

DT = 10_000
CFG = {"start_ms": 0, "interval_ms": DT, "flushed_samples": 4_000}


def rl():
    return spec.Bench(BENCH_JSON).roofline("window_eval")


def test_covered_samples_count_each_sample_once():
    m = rl()
    # disjoint 1 h windows, both ends inclusive: 361 samples each
    assert m.covered_samples([(0, 3_600_000, 3_600_000 + 10_000, 3)],
                             CFG) == 3 * 361
    # windows that touch share their end sample
    assert m.covered_samples([(0, 3_600_000, 3_600_000, 3)],
                             CFG) == 3 * 360 + 1
    # overlapping 5 m windows at a 1 m step: the span once
    assert m.covered_samples([(0, 300_000, 60_000, 10)],
                             CFG) == (9 * 60_000 + 300_000) // DT + 1
    # two grids over the same span count it once
    g = (0, 300_000, 60_000, 10)
    assert m.covered_samples([g, g], CFG) == m.covered_samples([g], CFG)


def test_covered_samples_keep_to_the_lattice_and_the_data():
    m = rl()
    # a window whose edges fall between samples: 6 samples, not 7
    assert m.covered_samples([(1_000, 61_000, 60_000, 1)], CFG) == 6
    # windows past the data's last sample count only what is there
    last = (CFG["flushed_samples"] - 1) * DT
    assert m.covered_samples([(last - 60_000, last, 60_000, 5)], CFG) == 7
    assert m.covered_samples([(last + DT, last + 2 * DT, DT, 3)], CFG) == 0


def test_a_call_sums_its_parts():
    m = rl()
    call = {"parts": [(2, [(0, 300_000, 300_000, 2)]),
                      (1, [(0, 600_000, 600_000, 1)])]}
    nbytes, ops = m.call_bytes_ops(call, CFG)
    n = 2 * (2 * 30 + 1) + 61     # the touching windows share a sample
    assert nbytes == n * 12 + (2 * 2 + 1) * 8 and ops == 2 * n


def _packed(rows, n=64):
    from filodb_tpu_torch.query import backend as be
    ts = np.full((rows, n), be._TS_PAD, dtype=np.int64)
    ts[:, :n - 4] = np.arange(n - 4) * DT
    vals = np.random.default_rng(rows).uniform(0, 100, (rows, n))
    lens = np.full(rows, n - 4, dtype=np.int32)
    return ts, vals, lens


def test_a_padded_gather_reads_the_bytes_of_its_query():
    """The program pads 5 series to 8 rows and 9 steps to 16 in a call of
    its own, and stacks them unpadded in a batch: the call reads the same
    bytes either way, those of 5 series and 9 steps."""
    from filodb_tpu_torch.query import backend as be
    m = rl()
    back = be.TorchBackend(device="cpu", batcher=None)
    grid = (0, 60_000, 60_000, 9)
    orig = vars(be.TorchBackend)["_packed_single"]
    probes = m.probes()
    for p in probes:
        p.install()
    try:
        back._packed_single("max_over_time", *_packed(5), 0, 60_000,
                            60_000, 9, 0.0, 8)
        members = [be._PackedMember(*_packed(5), 0, 60_000, 60_000, 9, 8),
                   be._PackedMember(*_packed(3), 0, 60_000, 60_000, 9, 8)]
        back._packed_run_inner("max_over_time", 16, 0.0, members)
    finally:
        for p in probes:
            p.uninstall()
    calls = [c for p in probes for c in p.calls]
    assert [c["parts"] for c in calls] == [[(5, [grid])],
                                           [(5, [grid]), (3, [grid])]]
    single = m.call_bytes_ops(calls[0], CFG)
    assert single == m.call_bytes_ops({"parts": [(5, [grid])]}, CFG)
    batch = m.call_bytes_ops(calls[1], CFG)
    assert batch[0] == single[0] * 8 // 5
    assert vars(be.TorchBackend)["_packed_single"] is orig


@pytest.mark.parametrize("func", ["avg_over_time", "count_over_time"])
def test_calls_off_the_gather_are_not_counted_there(func):
    from filodb_tpu_torch.query import backend as be
    m = rl()
    back = be.TorchBackend(device="cpu", batcher=None)
    probes = m.probes()
    for p in probes:
        p.install()
    try:
        back._packed_single(func, *_packed(5), 0, 60_000, 60_000, 9, 0.0, 0)
    finally:
        for p in probes:
            p.uninstall()
    assert [c for p in probes for c in p.calls] == []
