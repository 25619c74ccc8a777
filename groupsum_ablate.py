#!/usr/bin/env python3
"""Where the group-sum CUDA kernel's time goes, on one CUDA card.

    python3 groupsum_ablate.py [--seed N]

Builds variants of filodb_tpu_torch/csrc/counter_groupsum.cu, each with a
part of the work taken out, and times each with CUDA-graph replay at the
two shapes chip_smoke.py times (phase 3: 65,536 series, T = 470; the engine
phase: 8,192 series, T = 469):

  full          the kernel as it is (held against the plain version);
  no_product    the group product skipped: streaming and the epilogue;
  no_epilogue   the epilogue skipped (each rate is a raw timestamp):
                streaming and the group product;
  streaming     both skipped: the bulk-copy ring alone;
  compute       every part, but the rows are copied only for the first
                ring round and the stages are then reused as they are:
                the consumer warps' work without the device-memory wait.

The variants' outputs are wrong by construction and are not checked. A
variant is made by replacing a line of the source; the script stops if a
line it looks for is gone. Prints the card, one line per variant and shape
and, last, one JSON object with every time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

_PRODUCT = ("      group_product(abuf, wsh, pb",
            "      if (p.T < 0) group_product(abuf, wsh, pb")
_EPILOGUE = ("""loc = element<FUNC, EXACT>(r[u], p, t0 + bt + tt + u, b0, c1, c2,
                                     &okf);""",
             "{ loc = __int_as_float(r[u].c.ts); okf = 1.0f; }")
_COPIES = ("""        mbar_expect_tx(&full[s], p.fams * kRowBytes);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < p.fams) {""", """        const bool copy = i < p.stages;
        if (copy)
          mbar_expect_tx(&full[s], p.fams * kRowBytes);
        else
          mbar_arrive(&full[s]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (copy && q < p.fams) {""")
VARIANTS = {"full": (), "no_product": (_PRODUCT,),
            "no_epilogue": (_EPILOGUE,), "streaming": (_PRODUCT, _EPILOGUE),
            "compute": (_COPIES,)}


def build_variants(kn) -> dict:
    with open(os.path.join(REPO, "filodb_tpu_torch", "csrc",
                           "counter_groupsum.cu")) as f:
        src = f.read()
    out_dir = os.path.join(REPO, "build", "ablate")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: source line not found: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kn._nvcc(), *kn.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = kn._bind("counter_groupsum", ctypes.CDLL(
            os.path.join(out_dir, f"lib{name}.so")))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("groupsum_ablate: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import groupsum_ab as ab
    from filodb_tpu_torch.query import kernels as kn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card {smi}", flush=True)
    kn.build_kernels()
    libs = build_variants(kn)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    out = {"card": smi}
    for shape in ("phase3", "engine"):
        a = (ab.phase3_args(cs, gen, dev) if shape == "phase3"
             else cs.engine_shape_args(gen, dev))
        kn._libs["counter_groupsum"] = libs["full"]
        cs.check_groupsum(kn.counter_groupsum(*a),
                          kn.counter_groupsum_reference(*a), "full")
        times = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                kn._libs["counter_groupsum"] = lib
                times[name].append(cs.graph_ms(
                    lambda: kn.counter_groupsum(*a)))
        for name, ts in times.items():
            print(f"{shape} {name}: device ms {[round(t, 5) for t in ts]}",
                  flush=True)
        out[shape] = times
        del a
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
