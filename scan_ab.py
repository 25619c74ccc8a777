#!/usr/bin/env python3
"""Time the packed path's row scans in this checkout against another
checkout's, on the same inputs, on one CUDA card.

    python3 scan_ab.py --other DIR [--seed N] [--rounds R]

DIR holds another version of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory); its
`filodb_tpu_torch/query/backend.py` is loaded on its own, beside this
checkout's other modules. The inputs are chip_smoke.py phase 5's: the 1,024
irregular counter series of the engine phase (about 2,880 samples each,
clipped to the grid's span and packed to N = 4,096) on its 469-step grid.
Three functions are timed: `_extract_rate("rate", ...)` (the counter
correction's scan, then the `window_extract` kernel), `_window_endpoint(
"sum_over_time", ...)` (prefix sums, T bucketed to 512), and the row scan
alone on the packed values. Each pair is first held against each other
(rtol 1e-9), then timed between CUDA events in turns other, this, this,
other, R rounds. Prints the card, one line per timing and, last, one JSON
object with every time.
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


def load_backend(root: str, name: str):
    path = os.path.join(root, "filodb_tpu_torch", "query", "backend.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def irregular_tiles(cs, rng, dev):
    """chip_smoke's irregular series, clipped and packed as the backend's
    packed path packs them for phase 5's grid -> (ts, vals, lens on the
    card, w0s, w0e, step, nsteps)."""
    from filodb_tpu_torch.query import backend as bk
    from filodb_tpu_torch.query.engine import clip_series
    from filodb_tpu_torch.query.model import RawSeries

    series = []
    for _ in range(cs.ENGINE_IRREGULAR):
        t = np.unique(cs.BASE + np.arange(cs.N_FULL) * cs.DT
                      + rng.integers(-6_000, 6_000, cs.N_FULL))
        series.append(RawSeries({}, t, np.cumsum(rng.uniform(0, 3, t.size)),
                                is_counter=True))
    start, fe, _ = cs.engine_grid()
    steps = np.arange(start * 1000, fe * 1000 + 1, cs.STEP, dtype=np.int64)
    w0e = int(steps[0])
    w0s = w0e - cs.WINDOW
    series = clip_series(series, w0s, int(steps[-1]))
    ts, vals, lens = bk.pack_series(series)
    return (torch.as_tensor(ts, device=dev), torch.as_tensor(vals, device=dev),
            torch.as_tensor(lens, device=dev), w0s, w0e, cs.STEP, steps.size)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from filodb_tpu_torch.query import backend as bk
    from filodb_tpu_torch.query import kernels as kn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card {smi}", flush=True)
    kn.build_kernels()
    versions = {"other": load_backend(os.path.abspath(args.other),
                                      "other_backend"), "this": bk}
    dev = torch.device("cuda")
    ts, vals, lens, w0s, w0e, step, nsteps = irregular_tiles(
        cs, np.random.default_rng(args.seed), dev)
    t_bucket = bk._next_pow2(nsteps, 8)

    def scan(mod):
        if hasattr(mod, "_row_cumsum"):
            return mod._row_cumsum(vals)
        return torch.cumsum(vals, dim=1)
    calls = {
        "extract_rate": lambda mod: mod._extract_rate(
            "rate", ts, vals, lens, w0s, w0e, step, nsteps),
        "window_endpoint_sum": lambda mod: mod._window_endpoint(
            "sum_over_time", ts, vals, lens, w0s, w0e, step, t_bucket),
        "row_scan": scan,
    }
    out = {"card": smi, "S": ts.shape[0], "N": ts.shape[1], "T": nsteps,
           "T_bucket": t_bucket}
    for name, call in calls.items():
        a, b = call(versions["other"]), call(versions["this"])
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        ok = ~torch.isnan(a)
        diff = (a[ok] - b[ok]).abs()
        assert bool((diff <= 1e-9 * b[ok].abs() + 1e-9).all()), name
        times = {"other_ms": [], "this_ms": []}
        for _ in range(args.rounds):
            for tag in ("other", "this", "this", "other"):
                mod = versions[tag]
                times[f"{tag}_ms"].append(
                    cs.time_ms(lambda: call(mod), reps=20, warm=3))
        for key, t in times.items():
            print(f"{name} {key}: {t}", flush=True)
        out[name] = {"max_abs_diff": float(diff.max()), **times}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
