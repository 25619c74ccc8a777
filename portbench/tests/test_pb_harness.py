"""The harness as a whole: files found by name, the import guard, and
whole runs at a tiny size on the CPU build of the port, clean and with the
timed path broken underneath."""

import ast
import json
import os
import time

import numpy as np
import pytest

from conftest import BENCH_JSON, PKG
from portbench.harness import bench, guard, spec

CELLS = ("tsbs-cpu.query-mix",)


def test_a_new_configuration_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "bench"
    for d in ("configs", "datagen", "traffic", "metrics", "limits",
              "roofline"):
        (root / d).mkdir(parents=True)
    (root / "configs" / "cfg-x.json").write_text('{"name": "cfg-x"}')
    (root / "datagen" / "cfg-x.py").write_text(
        "def generate(cfg, seed):\n    return {'seed': seed}\n")
    (root / "traffic" / "mix-y.json").write_text('{"name": "mix-y"}')
    (root / "traffic" / "mix-y.py").write_text(
        "END_RULES = {'late': lambda cfg: 7}\n")
    (root / "metrics" / "layer.z_ms.py").write_text(
        "def read(ctx):\n    return ctx['v'] * 2\n")
    (root / "roofline" / "fn.py").write_text(
        "from portbench.harness.devtrace import Probe\n"
        "def bytes_ops():\n    return 1, 2\n"
        "def probes():\n"
        "    return [Probe('json:dumps', lambda *a: {'n': 1})]\n")
    (root / "limits" / "cfg-x.mix-y.json").write_text('{"gap": {"limit": 0}}')
    doc = {"workloads": [{"name": "cfg-x.mix-y", "config": "cfg-x",
                          "traffic": "mix-y", "chips": 1}],
           "end_to_end": [{"name": "qps"}],
           "per_layer": [{"name": "layer.z_ms", "workloads": ["cfg-x.mix-y"]},
                         {"name": "roofline.fn"},
                         {"name": "other", "workloads": ["elsewhere"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    b = spec.Bench(str(tmp_path / "BENCHMARK.json"), root=str(root))
    wl = b.workload("cfg-x.mix-y")
    assert b.config(wl["config"]) == {"name": "cfg-x"}
    assert b.datagen("cfg-x").generate({}, 5) == {"seed": 5}
    assert b.traffic(wl["traffic"]) == {"name": "mix-y"}
    assert b.traffic_module(wl["traffic"]).END_RULES["late"]({}) == 7
    assert b.traffic_module("mix-without-module") is None
    assert b.limits("cfg-x.mix-y") == {"gap": {"limit": 0}}
    assert b.metric_reader("layer.z_ms").read({"v": 4}) == 8
    assert b.roofline("fn").bytes_ops() == (1, 2)
    traced = b.metrics_of("cfg-x.mix-y", True)
    assert [m["name"] for m in traced] == ["layer.z_ms", "roofline.fn"]
    probes = bench._probes(b, traced)
    assert list(probes) == ["fn"] and probes["fn"][0].attr == "dumps"
    assert [m["name"] for m in b.metrics_of("cfg-x.mix-y", False)] == ["qps"]
    with pytest.raises(FileNotFoundError):
        b.config("cfg-absent")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    found = []
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                found += [(f, m) for m in _imports(os.path.join(d, f))
                          if guard.forbidden([m])]
    assert found == []


def test_the_guard_compares_top_level_names_whole():
    assert guard.forbidden(["filodb_tpu_torch.query.engine", "jax.numpy",
                            "filodb_tpu.query", "jaxlib", "flaxen",
                            "flax", "numpy"]) == \
        ["filodb_tpu.query", "flax", "jax.numpy", "jaxlib"]


def run_tiny(tiny_bench, cell, trace, seed=2**31 + 77, seconds=2.0):
    return bench.run(tiny_bench, cell, seed, seconds, trace,
                     time.monotonic(), device="cpu", require_cuda=False,
                     log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_clean_run_is_correct_and_prints_the_contracts_keys(cell,
                                                              tiny_bench):
    r = run_tiny(tiny_bench, cell, False)
    line = json.loads(bench.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    with open(BENCH_JSON) as f:
        e2e = [m for m in json.load(f)["end_to_end"]
               if cell in m.get("workloads", [cell])]
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    for m in e2e:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_a_traced_run_reads_the_per_layer_metrics(tiny_bench):
    cell = "tsbs-cpu.query-mix"
    line = json.loads(bench.dumps(run_tiny(tiny_bench, cell, True)))
    assert line["correct"] is True
    want = {m["name"] for m in tiny_bench.metrics_of(cell, True)}
    # the CPU has no device trace: the readers of the card stay silent
    assert {"select_ms", "encode_ms", "tile_cache_hit_share",
            "resultcache_hit_share"} <= set(line["metrics"]) <= want
    assert "roofline.window_eval" not in line["metrics"]


def _halve_selection(monkeypatch):
    from filodb_tpu_torch.query import engine
    orig = engine.select_raw_series

    def half(*args, **kwargs):
        out = orig(*args, **kwargs)
        return out[::2] if len(out) > 1 else out
    monkeypatch.setattr(engine, "select_raw_series", half)


def _alter_one_value(monkeypatch):
    from filodb_tpu_torch.http import prom_json
    orig = prom_json.matrix_bytes

    def altered(res, *args, **kwargs):
        vals = np.asarray(res.values)
        ok = np.nonzero(np.isfinite(vals))
        if ok[0].size:
            vals[ok[0][0], ok[1][0]] *= 1.0 + 1e-4
        return orig(res, *args, **kwargs)
    monkeypatch.setattr(prom_json, "matrix_bytes", altered)


@pytest.mark.parametrize("fault", [_halve_selection, _alter_one_value],
                         ids=["half-the-series-left-out",
                              "an-answer-altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny_bench,
                                            monkeypatch):
    fault(monkeypatch)
    line = json.loads(bench.dumps(run_tiny(tiny_bench, cell, False)))
    assert line["correct"] is False
    assert line["checks"]["gap"]["value"] > line["checks"]["gap"]["limit"]
