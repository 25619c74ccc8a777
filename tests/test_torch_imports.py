"""The port stands alone: it imports neither ``jax`` nor anything of
``filodb_tpu``, and its entry points default to the CUDA device."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "filodb_tpu_torch")


def _modules():
    out = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


SERVING_MODULES = (
    "filodb_tpu_torch.query.qos", "filodb_tpu_torch.query.batcher",
    "filodb_tpu_torch.query.backend",
    # the server entry and what it needs
    "filodb_tpu_torch.parallel", "filodb_tpu_torch.parallel.shardmapper",
    "filodb_tpu_torch.parallel.resilience",
    "filodb_tpu_torch.core.cardinality", "filodb_tpu_torch.core.spread",
    "filodb_tpu_torch.obs", "filodb_tpu_torch.obs.metrics",
    "filodb_tpu_torch.obs.trace", "filodb_tpu_torch.obs.slowlog",
    "filodb_tpu_torch.obs.events", "filodb_tpu_torch.promql.semant",
    "filodb_tpu_torch.query.plancache", "filodb_tpu_torch.query.resultcache",
    "filodb_tpu_torch.query.planner", "filodb_tpu_torch.http.prom_json",
    "filodb_tpu_torch.ingest.health", "filodb_tpu_torch.http.server",
    "filodb_tpu_torch.gateway.producer",
    "filodb_tpu_torch.standalone.server",
    # the write path and durability
    "filodb_tpu_torch.testing", "filodb_tpu_torch.testing.chaos",
    "filodb_tpu_torch.store", "filodb_tpu_torch.store.integrity",
    "filodb_tpu_torch.store.columnstore", "filodb_tpu_torch.ingest",
    "filodb_tpu_torch.ingest.stream", "filodb_tpu_torch.ingest.driver",
    "filodb_tpu_torch.gateway.influx", "filodb_tpu_torch.gateway.server",
    "filodb_tpu_torch.http.remote_read", "filodb_tpu_torch.core.metering",
    "filodb_tpu_torch.obs.process", "filodb_tpu_torch.fsck",
)


@pytest.mark.parametrize("mod", SERVING_MODULES)
def test_the_walk_covers_the_serving_modules(mod):
    assert mod in _modules()


def test_the_parallel_package_imports_no_mesh_module():
    code = (
        "import sys\n"
        "import filodb_tpu_torch.parallel\n"
        "bad = [m for m in sys.modules if m.startswith("
        "'filodb_tpu_torch.parallel.') and m.rsplit('.', 1)[1] not in "
        "('shardmapper', 'resilience')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'filodb_tpu' or m.startswith('filodb_tpu.')]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


def test_no_module_names_jax_or_the_jax_package():
    offenders = []
    for mod in _modules():
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *mod.split("."), "__init__.py")
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "filodb_tpu"):
                    offenders.append(f"{mod}: {n}")
    assert offenders == []


def test_the_offline_tools_load_no_torch():
    """fsck and the stream codec walk durable files on any host: their
    import chain stays free of torch (and of jax)."""
    code = (
        "import sys\n"
        "import filodb_tpu_torch.fsck, filodb_tpu_torch.ingest\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'filodb_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_backend_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    from filodb_tpu_torch.query.backend import TorchBackend
    from filodb_tpu_torch.query.tilestore import AlignedTiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TorchBackend()
    with pytest.raises(RuntimeError):
        TorchBackend(device="cuda")
    with pytest.raises(RuntimeError):
        AlignedTiles([{}], 0, 10, [[True]], [[0.0]], [[1.0]])
    assert TorchBackend(device="cpu").device.type == "cpu"
