"""Finding a cell's parts by name. A cell of BENCHMARK.json names its
configuration and its traffic mix; everything else lives in files named
after them under the benchmark's folder:

  configs/<config>.json        the deployment (sizes, server keys, guarantees)
  datagen/<config>.py          generate(cfg, seed) -> the data
  traffic/<mix>.json           the mix (read by harness/traffic.py)
  traffic/<mix>.py             optional: the mix's own end rules and draws
  limits/<cell>.json           the limits that decide `correct`
  metrics/<metric>.py          read(ctx) -> value or None, per-layer metric
  roofline/<function>.py       the bytes and operations of one device function
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PKG_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str) -> ModuleType:
    """A module from its file, whatever characters its name holds."""
    name = "portbench_" + os.path.relpath(path, PKG_DIR).replace(
        os.sep, "_").replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """BENCHMARK.json and the folder that holds the cells' files."""

    def __init__(self, bench_json: str, root: str = PKG_DIR):
        self.doc = _json(bench_json)
        self.root = root

    def path(self, *parts: str) -> str:
        p = os.path.join(self.root, *parts)
        if not os.path.exists(p):
            raise FileNotFoundError(f"the benchmark has no {p}")
        return p

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(self.path("configs", name + ".json"))

    def datagen(self, name: str) -> ModuleType:
        return load_module(self.path("datagen", name + ".py"))

    def traffic(self, name: str) -> dict:
        return _json(self.path("traffic", name + ".json"))

    def traffic_module(self, name: str):
        """traffic/<mix>.py, or None where the mix has none."""
        p = os.path.join(self.root, "traffic", name + ".py")
        return load_module(p) if os.path.exists(p) else None

    def limits(self, cell: str) -> dict:
        return _json(self.path("limits", cell + ".json"))

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.path("metrics", name + ".py"))

    def roofline(self, function: str) -> ModuleType:
        return load_module(self.path("roofline", function + ".py"))

    def metrics_of(self, cell: str, trace: bool) -> list:
        """The cell's metrics for a run: end-to-end without tracing,
        per-layer with it; a metric with `workloads` only in those."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.doc[key]
                if cell in m.get("workloads", [cell])]
