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
    # gRPC and the multi-node cluster
    "filodb_tpu_torch.grpcsvc", "filodb_tpu_torch.grpcsvc.wire",
    "filodb_tpu_torch.grpcsvc.server", "filodb_tpu_torch.grpcsvc.client",
    "filodb_tpu_torch.query.planwire", "filodb_tpu_torch.query.planparser",
    "filodb_tpu_torch.parallel.cluster",
    "filodb_tpu_torch.parallel.membership",
    "filodb_tpu_torch.parallel.discovery",
    # recording rules, alerting and self-monitoring
    "filodb_tpu_torch.obs.writeback", "filodb_tpu_torch.obs.selfmon",
    "filodb_tpu_torch.rules", "filodb_tpu_torch.rules.loader",
    "filodb_tpu_torch.rules.notify", "filodb_tpu_torch.rules.engine",
    "filodb_tpu_torch.rules.__main__",
    # the supervisor, its control-plane bus, and the CLI
    "filodb_tpu_torch.standalone", "filodb_tpu_torch.standalone.bus",
    "filodb_tpu_torch.standalone.supervisor", "filodb_tpu_torch.cli",
    # downsampling, the raw/downsample tiering's store, the ops jobs and
    # the declaration decorators
    "filodb_tpu_torch.downsample", "filodb_tpu_torch.downsample.kernels",
    "filodb_tpu_torch.downsample.job", "filodb_tpu_torch.downsample.flush",
    "filodb_tpu_torch.downsample.store", "filodb_tpu_torch.jobs",
    "filodb_tpu_torch.jobs.index_migration",
    "filodb_tpu_torch.jobs.chunk_copier", "filodb_tpu_torch.jobs.cardbuster",
    "filodb_tpu_torch.lint", "filodb_tpu_torch.lint.threads",
    "filodb_tpu_torch.lint.locks", "filodb_tpu_torch.lint.caches",
    "filodb_tpu_torch.lint.hotpath", "filodb_tpu_torch.lint.contracts",
    "filodb_tpu_torch.lint.capacity",
    # the certification rail: the query generator, the reference
    # evaluator, the precision claims, their harnesses and the soak
    "filodb_tpu_torch.promql.gen", "filodb_tpu_torch.promql.refeval",
    "filodb_tpu_torch.lint.numerics", "filodb_tpu_torch.lint.ulpcert",
    "filodb_tpu_torch.testing.soak",
    # the port's analyser and its capacity rail
    "filodb_tpu_torch.lint.__main__", "filodb_tpu_torch.lint.astwalk",
    "filodb_tpu_torch.lint.callgraph", "filodb_tpu_torch.lint.dataflow",
    "filodb_tpu_torch.lint.ci_annotations",
    "filodb_tpu_torch.lint.lockorder", "filodb_tpu_torch.lint.memcert",
    "filodb_tpu_torch.lint.rules_cache",
    "filodb_tpu_torch.lint.rules_capacity",
    "filodb_tpu_torch.lint.rules_concurrency",
    "filodb_tpu_torch.lint.rules_hot", "filodb_tpu_torch.lint.rules_kernel",
    "filodb_tpu_torch.lint.rules_lock", "filodb_tpu_torch.lint.rules_promql",
    "filodb_tpu_torch.lint.rules_span",
    # the mesh and distributed execution
    "filodb_tpu_torch.parallel.mesh", "filodb_tpu_torch.parallel.shardstore",
    "filodb_tpu_torch.parallel.distributed",
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


def test_importing_the_cluster_plane_loads_no_grpc():
    """grpcio is imported only where a gRPC channel or server is built:
    a node without it imports every module and refuses only a config
    that asks for the gRPC plane."""
    code = (
        "import sys\n"
        "import filodb_tpu_torch.grpcsvc, filodb_tpu_torch.http.server\n"
        "import filodb_tpu_torch.standalone.server\n"
        "import filodb_tpu_torch.parallel.cluster\n"
        "import filodb_tpu_torch.parallel.membership\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'grpc']\n"
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


def test_the_supervisor_and_the_cli_load_no_torch_or_numpy():
    """The supervisor process is a process manager and a text-format
    aggregator: it (and the CLI) import neither torch nor numpy."""
    code = (
        "import sys\n"
        "import filodb_tpu_torch.standalone.supervisor\n"
        "import filodb_tpu_torch.standalone.bus, filodb_tpu_torch.cli\n"
        "from filodb_tpu_torch.standalone import Supervisor\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'filodb_tpu')]\n"
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


def test_downsampler_job_defaults_to_cuda_and_refuses_without_it(
        monkeypatch, tmp_path):
    from filodb_tpu_torch.downsample import DownsamplerJob
    from filodb_tpu_torch.store import FlatFileColumnStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = FlatFileColumnStore(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        DownsamplerJob(cs)
    assert DownsamplerJob(cs, device="cpu").device.type == "cpu"


def test_the_lint_decorators_load_nothing():
    """The declaration decorators stay pure Python: importing them loads
    neither torch nor numpy (the offline tools import the memstore's
    index through them)."""
    code = (
        "import sys\n"
        "import filodb_tpu_torch.lint.threads, filodb_tpu_torch.lint.locks\n"
        "import filodb_tpu_torch.lint.caches, filodb_tpu_torch.lint.hotpath\n"
        "import filodb_tpu_torch.lint.contracts\n"
        "import filodb_tpu_torch.lint.capacity\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'filodb_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
