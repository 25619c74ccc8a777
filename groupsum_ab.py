#!/usr/bin/env python3
"""Time this checkout's group-sum CUDA kernel against another checkout's on
the same inputs, on one CUDA card.

    python3 groupsum_ab.py --other DIR [--seed N] [--rounds R]

DIR holds another version of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory); its
`filodb_tpu_torch/query/kernels.py` is loaded on its own and builds its
kernel into DIR/build/kernels. Both kernels get the same tensors at the two
shapes chip_smoke.py times: phase 3 (65,536 series, T = 470, every boundary
family read) and the engine phase's first query (8,192 series, T = 469).
Each is first held against this checkout's plain version and run twice
(reruns must be bit-identical), then timed in turns other, this, this,
other, R rounds, each turn both ways chip_smoke.py times a kernel: CUDA
events over back-to-back calls (`ms`) and CUDA-graph replay (`device_ms`,
without the host's cost of a call). Prints the card, each kernel's ptxas
lines, one line per timing and, last, one JSON object with every time.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))


def load_kernels(root: str, name: str):
    path = os.path.join(root, "filodb_tpu_torch", "query", "kernels.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase3_args(cs, gen, dev):
    from filodb_tpu_torch.query import tilestore as tst

    ts, vals = cs.gen_counters(cs.S_FULL, cs.N_FULL, gen, dev)
    tiles = tst.AlignedTiles([{}] * cs.S_FULL, cs.BASE, cs.DT,
                             torch.ones((cs.S_FULL, cs.N_FULL),
                                        dtype=torch.bool, device=dev),
                             ts, vals)
    del ts, vals
    steps = cs.BASE + 400_000 + np.arange(cs.T_FULL, dtype=np.int64) \
        * cs.STEP
    plan = tst.groupsum_plan(tiles, "rate", steps, cs.WINDOW)
    oh = torch.zeros((cs.S_FULL, cs.G), dtype=torch.float32, device=dev)
    oh[torch.arange(cs.S_FULL, device=dev),
       torch.arange(cs.S_FULL, device=dev) % cs.G] = 1.0
    return ("rate", plan["st"], plan["dspan"], plan["hi_mode"],
            plan["lo_mode"], tiles.t_perm_fixed_tiled("cv", plan["st"]),
            tiles.t_fixed_base("cv"), oh, plan["kl0"], plan["w0e_rel"],
            cs.WINDOW, cs.STEP, cs.T_FULL)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("groupsum_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from filodb_tpu_torch.query import kernels as kn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card {smi}", flush=True)
    bw, f32_rate = cs.card_rates(torch.cuda.get_device_name(0))
    versions = {"other": load_kernels(os.path.abspath(args.other),
                                      "other_kernels"), "this": kn}
    for tag, mod in versions.items():
        mod.build_kernels()
        for line in mod.BUILD_LOG["counter_groupsum"].splitlines():
            if "registers" in line or "smem" in line:
                print(f"ptxas {tag}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    out = {"card": smi}
    for shape, make in (("phase3", phase3_args), ("engine",
                                                  cs.engine_shape_args)):
        a = make(cs, gen, dev) if shape == "phase3" else make(gen, dev)
        want = kn.counter_groupsum_reference(*a)
        for tag, mod in versions.items():
            got = mod.counter_groupsum(*a)
            again = mod.counter_groupsum(*a)
            torch.cuda.synchronize()
            cs.check_groupsum(got, want, f"{tag} at {shape}")
            assert all(torch.equal(x, y) for x, y in zip(got, again)), \
                f"{tag} at {shape}: rerun not bit-identical"
        nbytes, bound, by = cs.groupsum_bound(a, bw, f32_rate)
        times = {f"{t}_{k}": [] for t in versions for k in ("ms",
                                                             "device_ms")}
        for _ in range(args.rounds):
            for tag in ("other", "this", "this", "other"):
                mod = versions[tag]

                def call():
                    return mod.counter_groupsum(*a)
                times[f"{tag}_ms"].append(cs.time_ms(call, reps=50, warm=5))
                times[f"{tag}_device_ms"].append(cs.graph_ms(call))
        for key, ts in times.items():
            print(f"{shape} {key}: {[round(t, 5) for t in ts]} bound "
                  f"{bound:.5f} ms ({nbytes / 1e9:.4f} GB, {by}); best "
                  f"{100 * bound / min(ts):.1f} % of the bound", flush=True)
        out[shape] = {"n_s": a[5].shape[0], "T": a[-1], "bound_ms": bound,
                      "bytes": nbytes, **times}
        del a, want
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
