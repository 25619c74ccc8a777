#!/usr/bin/env python3
"""Profile the engine's cold queries on one CUDA card, stage by stage.

    python3 profile_cold_query.py [--series N] [--top K]

Builds chip_smoke's engine shard (N counter series and N gauges x 2,880
samples, default chip_smoke.S_ENGINE) and runs, cold, its first grouped
rate and `avg_over_time(queue_depth[5m])` through QueryEngine +
TorchBackend on the card. For each query it prints chip_smoke's host
split (select + decode, row alignment, tile assembly, group-sum) and the
K functions of most own time under cProfile. It first prints the
installed numpy and torch and the time of np.unique, np.diff and a
round-and-cast on one 2,910-sample sorted int64 row (the alignment's
per-row work), since host numpy versions differ between machines."""

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))


def micro(x: np.ndarray, reps: int = 2000) -> dict:
    fns = {"unique": lambda: np.unique(x), "diff": lambda: np.diff(x),
           "round": lambda: np.round(x / 10_000.0).astype(np.int64)}
    out = {}
    for name, fn in fns.items():
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name + "_us"] = (time.perf_counter() - t) / reps * 1e6
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                                parse_query_range)
    from filodb_tpu_torch.query import kernels as kn
    from filodb_tpu_torch.query.backend import TorchBackend
    from filodb_tpu_torch.query.engine import QueryEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--series", type=int, default=cs.S_ENGINE)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_cold_query: no CUDA device", file=sys.stderr)
        return 1
    row = np.sort(np.random.default_rng(0).integers(0, 10**9, 2_910))
    print(json.dumps({"numpy": np.__version__, "torch": torch.__version__,
                      "cpus": os.cpu_count(), **micro(row)}), flush=True)
    kn.build_kernels()
    t = time.perf_counter()
    shard, _ = cs.build_engine_shard(np.random.default_rng(42), args.series)
    print(f"shard of {args.series} series built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    be = TorchBackend()
    engine = QueryEngine([shard], backend=be)
    q0, start, end = cs.engine_queries()[0]
    try:
        for q in (q0, "avg_over_time(queue_depth[5m])"):
            plan = parse_query_range(q, TimeStepParams(start,
                                                       cs.STEP // 1000, end))
            timer = cs.HostSplit()
            prof = cProfile.Profile()
            t = time.perf_counter()
            prof.enable()
            try:
                engine.execute(plan)
            finally:
                prof.disable()
                timer.restore()
            secs = time.perf_counter() - t
            print(q, json.dumps(timer.split(secs)), flush=True)
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats("tottime") \
                .print_stats(args.top)
            print(buf.getvalue(), flush=True)
    finally:
        be.batcher.executor.stop(10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
