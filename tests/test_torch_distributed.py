"""The port's two-process aggregate
(``filodb_tpu_torch/parallel/distributed.py``) on the CPU (the
counterpart of ``tests/test_distributed.py``): two OS processes join one
``torch.distributed`` group over gloo (``tcp://127.0.0.1``), each holds
only its own two shard groups on a mesh of two CPU partitions, and their
partial aggregates meet through ``all_reduce``. Both processes' answers
must equal the single-process 4-partition mesh's within 1e-12 relative,
counts exactly, for sum, avg, count, min and max of rate and of
max_over_time (the gather family). Each process has its own timeout of
120 s; a failed rendezvous is tried again on a new port. A ``file://``
rendezvous, which needs no port, gives the same answers."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from filodb_tpu_torch.parallel.mesh import MeshExecutor, make_mesh
from filodb_tpu_torch.query.model import RangeParams, RawSeries

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = RangeParams(300_000, 60_000, 1_200_000)
WINDOW = 300_000
AGGS = ("sum", "avg", "count", "min", "max")
FUNCS = ("rate", "max_over_time")
PROC_TIMEOUT_S = 120
RENDEZVOUS_ATTEMPTS = 3


def world():
    """4 shard groups of seeded counters (8 jobs, rows of unequal
    length), their global group ids: the same in every process."""
    rng = np.random.default_rng(21)
    by_shard, gids = [], []
    for g in range(4):
        row, ids = [], []
        for i in range(5 + g):
            n = 100 + 7 * i
            ts = 10_000 + np.arange(n, dtype=np.int64) * 10_000 \
                + rng.integers(-500, 500, n)
            ts.sort()
            row.append(RawSeries({"job": f"j{(g + i) % 8}", "i": f"{g}-{i}"},
                                 ts, np.cumsum(rng.uniform(0, 5, n)),
                                 is_counter=True))
            ids.append((g + i) % 8)
        by_shard.append(row)
        gids.append(ids)
    return by_shard, gids


RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[4])
from tests.test_torch_distributed import (AGGS, FUNCS, PARAMS, WINDOW,
                                          world)
from filodb_tpu_torch.parallel.distributed import (
    init_process, window_aggregate_distributed)
from filodb_tpu_torch.parallel.mesh import MeshExecutor, make_mesh
rank, addr, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
backend = init_process(addr, 2, rank, "cpu")
assert backend == "gloo", backend
by_shard, gids = world()
mine = slice(2 * rank, 2 * rank + 2)
ex = MeshExecutor(make_mesh(2, 1, [torch.device("cpu")] * 2))
res = {}
for func in FUNCS:
    for agg in AGGS:
        res[f"{func}/{agg}"] = window_aggregate_distributed(
            ex, by_shard[mine], gids[mine], PARAMS, func, agg, WINDOW, 8)
np.savez(out, **res)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp, attempt: int, addr=None):
    """Both ranks at ``addr`` (default a fresh port), each bounded by
    PROC_TIMEOUT_S; a rank that fails ends the other at once. -> (exit
    codes, outputs)."""
    addr = addr or f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    logs = [tmp / f"rank{r}-{attempt}.log" for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_SCRIPT, str(r), addr,
                 str(tmp / f"rank{r}.npz"), REPO], cwd=REPO, env=env,
                stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + PROC_TIMEOUT_S
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs], [f.read_text() for f in logs]


@pytest.fixture(scope="module")
def two_process_results(tmp_path_factory):
    """Both ranks' answers. The rendezvous port is picked free, then
    bound by rank 0 a moment later: another process of a busy test run
    may take it in between, so a failed attempt is made again on a new
    port (RENDEZVOUS_ATTEMPTS in all)."""
    tmp = tmp_path_factory.mktemp("dist")
    tried = []
    for attempt in range(RENDEZVOUS_ATTEMPTS):
        codes, logs = _run_ranks(tmp, attempt)
        if codes == [0, 0]:
            return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
        tried.append((codes, [log[-2000:] for log in logs]))
    raise AssertionError(f"the two ranks failed {RENDEZVOUS_ATTEMPTS} "
                         f"times: {tried}")


@pytest.fixture(scope="module")
def single_process():
    by_shard, gids = world()
    ex = MeshExecutor(make_mesh(4, 1, [torch.device("cpu")] * 4))
    return {f"{f}/{a}": ex.window_aggregate(by_shard, PARAMS, f, WINDOW, a,
                                            gids, 8)
            for f in FUNCS for a in AGGS}


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("agg", AGGS)
def test_two_process_aggregate_equals_the_single_process_mesh(
        two_process_results, single_process, func, agg):
    want = single_process[f"{func}/{agg}"]
    assert want.shape == (8, PARAMS.num_steps)
    assert np.isfinite(want).any()
    for r, res in enumerate(two_process_results):
        got = res[f"{func}/{agg}"]
        assert got.shape == want.shape, r
        if agg == "count":
            assert np.array_equal(got, want, equal_nan=True), r
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                       equal_nan=True, err_msg=f"rank {r}")


def test_file_rendezvous_gives_the_same_answers(tmp_path, single_process):
    """The rendezvous through a shared file, which needs no free port:
    one attempt, the same answers as the single-process mesh."""
    addr = f"file://{tmp_path / 'rendezvous'}"
    codes, logs = _run_ranks(tmp_path, 0, addr)
    assert codes == [0, 0], [log[-2000:] for log in logs]
    for r in range(2):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert set(got) == set(single_process)
        for key, want in single_process.items():
            np.testing.assert_allclose(got[key], want, rtol=1e-12, atol=0,
                                       equal_nan=True,
                                       err_msg=f"rank {r} {key}")


def test_backend_choice():
    from filodb_tpu_torch.parallel.distributed import backend_for
    assert backend_for("cpu", 2) == "gloo"
    # ranks sharing one card (more ranks than cards) take gloo
    assert backend_for("cuda", 64) == "gloo"


def test_a_process_passes_its_own_shard_groups_only():
    """The local shard groups must fill the local mesh's shard axis."""
    from filodb_tpu_torch.parallel.distributed import \
        window_aggregate_distributed
    by_shard, gids = world()
    ex = MeshExecutor(make_mesh(2, 1, [torch.device("cpu")] * 2))
    with pytest.raises(ValueError):
        window_aggregate_distributed(ex, by_shard[:3], gids[:3], PARAMS,
                                     "rate", "sum", WINDOW, 8)
