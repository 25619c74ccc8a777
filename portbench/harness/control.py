"""The control of a cell's check: the reference computed in float32, the
precision below the float64 its configuration states, put in the program's
place, and held against the float64 reference by the same comparison
(check.gap) on the cell's own data and queries. A limit that this reading
does not exceed would pass a float32 program; the benchmark's runs do not
run it.

  python3 -m portbench.harness.control --workload <cell> --seeds 1,2,3

prints one JSON line per seed: the widest gap over the answers a run would
check (`checked_per_query` requests of each template, drawn from the
seed), and each template's widest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from portbench.harness import check, spec
from portbench.harness.traffic import Mix
from portbench.reference import promql


def readings(bench: spec.Bench, cell: str, seed: int) -> dict:
    wl = bench.workload(cell)
    cfg = bench.config(wl["config"])
    mix = Mix(bench.traffic(wl["traffic"]), cfg,
              bench.traffic_module(wl["traffic"]))
    data = bench.datagen(cfg["name"]).generate(cfg, seed)
    series = promql.Series(data["labels"], data["ts"], data["vals"])
    rng = np.random.default_rng([seed, 3])
    by_template: dict = {}
    for seq in mix.plan(seed):
        for req in seq[:64]:
            by_template.setdefault(req["template"], []).append(req)
    out = {}
    for name in sorted(by_template):
        reqs = by_template[name]
        pick = rng.choice(len(reqs), min(len(reqs), mix.checked_per_query),
                          replace=False)
        out[name] = max(check.control_gap(reqs[i], series) for i in pick)
    return {"seed": seed, "gap": max(out.values()), "by_template": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = spec.Bench(os.path.join(spec.CHECKOUT, "BENCHMARK.json"))
    for s in args.seeds.split(","):
        print(json.dumps(readings(bench, args.workload, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
