"""The sampling profiler (``filodb_tpu_torch/obs/profiler.py``), the
``@thread_root`` inventory and the routes that read them
(``/debug/profile``, ``/debug/threads``), held against the JAX package's
(the profiler tests of ``tests/test_profiling_tail.py`` and the inventory
tests of ``tests/test_concurrency_followups.py``).

The port declares every thread root and its class's ``@guarded_by``
summary at the reference's sites, so both packages' registries name the
same roots with the same guards once the same modules are imported."""

import importlib
import json
import threading
import urllib.parse
import urllib.request

import pytest
import torch

from filodb_tpu.lint import threads as j_threads
from filodb_tpu.standalone.server import FiloServer as JServer
from filodb_tpu_torch.lint import threads as p_threads
from filodb_tpu_torch.obs.profiler import UNATTRIBUTED, SamplingProfiler
from filodb_tpu_torch.standalone import server as psrv

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

T0 = 1_600_000_000
QUERY = 'rate({_metric_=~"heap_usage|http_requests_total"}[5m])'

# the modules that declare thread roots, by their path under either
# package (the JAX package's query/tpu.py is the port's query/backend.py)
ROOT_MODULES = [
    "core.metering", "gateway.server", "grpcsvc.server", "http.server",
    "ingest.driver", "obs.profiler", "obs.selfmon", "obs.trace",
    "parallel.cluster", "parallel.membership", "query.batcher",
    "rules.engine", "rules.notify", "standalone.bus",
    "standalone.server", "standalone.supervisor"]


def _import_roots():
    for m in ROOT_MODULES:
        importlib.import_module("filodb_tpu_torch." + m)
        importlib.import_module("filodb_tpu." + m)
    importlib.import_module("filodb_tpu_torch.query.backend")
    importlib.import_module("filodb_tpu.query.tpu")


def _static_roots(mod, pkg: str):
    """(display name, qualname) -> guard summary of every root the package
    ``pkg`` declares on a module-level function or a method (closures
    register only when their thread is started, and test modules of
    either package may register roots of their own: both depend on what
    else ran in this process)."""
    return {(info["name"], qual): mod._guard_summary(info["module"], qual)
            for qual, info in mod.THREAD_ROOTS.items()
            if "<locals>" not in qual
            and info["module"].split(".")[0] == pkg}


def test_thread_inventory_names_the_reference_roots_and_guards():
    _import_roots()
    p = _static_roots(p_threads, "filodb_tpu_torch")
    j = _static_roots(j_threads, "filodb_tpu")
    assert set(p) == set(j)
    assert p == j                # the same @guarded_by summaries
    # and the roots the reference's own test expects
    names = {n for n, _ in p}
    assert {"failure-detector", "tenant-metering", "device-executor",
            "ingest-shard", "adopt-shard", "handback",
            "http-handler", "profiler-sampler", "trace-exporter",
            "selfmon-loop", "rules-scheduler", "bus-client",
            "worker-supervisor", "main-idle"} <= names


def test_thread_root_registry_and_inventory():
    from filodb_tpu_torch.lint.threads import THREAD_ROOTS, thread_inventory
    import filodb_tpu_torch.parallel.cluster  # noqa: F401
    assert "FailureDetector._run" in THREAD_ROOTS
    inv = thread_inventory()
    by_name = {e["name"]: e for e in inv}
    e = by_name["failure-detector"]
    assert e["root"] == \
        "filodb_tpu_torch.parallel.cluster.FailureDetector._run"
    assert isinstance(e["guards"], dict)
    assert isinstance(e["live_threads"], list)
    assert by_name["rules-scheduler"]["guards"]["_alerts"] == "_lock"


def test_sampler_and_exporter_are_registered_thread_roots():
    from filodb_tpu_torch.lint.threads import THREAD_ROOTS
    names = {info["name"] for info in THREAD_ROOTS.values()}
    assert "profiler-sampler" in names
    assert "trace-exporter" in names


def test_profiler_tick_attributes_registered_roots():
    """A direct tick() with a thread parked inside a @thread_root function
    attributes that stack by FRAME match (the thread's OS name is a stdlib
    default, so the name fallback cannot be the one matching)."""
    prof = SamplingProfiler(hz=50.0)
    release = threading.Event()

    from filodb_tpu_torch.obs.selfmon import SelfMonitor
    mon = SelfMonitor.__new__(SelfMonitor)
    mon.interval_s = 60.0
    mon._stop = release

    def park():
        # sits inside SelfMonitor._run (@thread_root "selfmon-loop")
        # waiting on the event: the sampled stack walks through it
        mon._run()

    t = threading.Thread(target=park)    # default "Thread-N" name
    t.start()
    try:
        for _ in range(3):
            prof.tick()
        folded, selfs = prof.tables()
        assert any(k.startswith("selfmon-loop;") for k in folded)
        assert any(root == "selfmon-loop" for root, _ in selfs)
        snap = prof.snapshot()
        assert snap["samples"] > 0 and snap["attributed"] > 0
        # folded text is flamegraph-shaped: "stack count" lines
        for ln in prof.folded_text().splitlines():
            stack, n = ln.rsplit(" ", 1)
            assert ";" in stack and int(n) >= 1
    finally:
        release.set()
        t.join(timeout=5)


def test_profiler_bounded_stacks_overflow_bucket():
    prof = SamplingProfiler(hz=10.0, max_stacks=64)
    with prof._lock:
        for i in range(64):
            prof._folded[f"r;m.f{i}"] = 1
    # a NEW distinct stack past the cap folds into the overflow bucket
    release = threading.Event()
    t = threading.Thread(target=release.wait)
    t.start()
    try:
        prof.tick()
    finally:
        release.set()
        t.join(timeout=5)
    folded, _ = prof.tables()
    assert len([k for k in folded if ";" + "(overflow)" in k
                or k.endswith("(overflow)")]) >= 1
    assert prof.snapshot()["dropped_stacks"] >= 1


def _get_raw(port, path, **params):
    qs = urllib.parse.urlencode(params, doseq=True)
    url = f"http://127.0.0.1:{port}{path}" + (f"?{qs}" if qs else "")
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.headers.get("Content-Type", ""), r.read()


def _get(port, path, **params):
    return json.loads(_get_raw(port, path, **params)[1])


def _query(port):
    return _get(port, "/promql/timeseries/api/v1/query_range", query=QUERY,
                start=T0 + 300, end=T0 + 500, step=60)


@pytest.fixture
def prof_server():
    srv = psrv.FiloServer({"num-shards": 2, "port": 0, "device": "cpu",
                           "gc-freeze": False, "grpc-port": None,
                           "profiler-enabled": True,
                           "profiler-hz": 97.0}).start()
    try:
        srv.seed_dev_data(n_samples=60, n_instances=3,
                          start_ms=T0 * 1000)
        yield srv
    finally:
        srv.stop()


def test_debug_profile_window_and_folded(prof_server):
    srv = prof_server
    assert srv.http.profiler is not None and srv.http.profiler.running
    for _ in range(2):
        _query(srv.port)
    body = _get(srv.port, "/debug/profile", seconds=0.4)
    assert body["status"] == "success"
    rep = body["data"]
    assert rep["samples"] > 0
    assert rep["window_s"] == 0.4
    assert rep["top_self"] and all(
        set(e) == {"root", "func", "samples", "self_seconds"}
        for e in rep["top_self"])
    # the handler thread itself is parked in the window: attributed to
    # the http-handler root by frame walk, not thread name
    assert "http-handler" in rep["roots"]
    known = sum(n for r, n in rep["roots"].items() if r != UNATTRIBUTED)
    assert known > 0
    ctype, text = _get_raw(srv.port, "/debug/profile", seconds=0.2,
                           format="folded")
    assert ctype.startswith("text/plain")
    lines = text.decode().splitlines()
    assert lines and all(ln.rsplit(" ", 1)[1].isdigit() for ln in lines)
    # the sampler exports its self-time gauge and tick histogram
    _, mtext = _get_raw(srv.port, "/metrics")
    mtext = mtext.decode()
    assert "filodb_profile_self_seconds_total" in mtext
    assert "filodb_profiler_tick_seconds_count" in mtext
    assert "filodb_profiler_running 1" in mtext


def test_profiler_stops_with_the_server():
    srv = psrv.FiloServer({"num-shards": 2, "port": 0, "device": "cpu",
                           "gc-freeze": False, "grpc-port": None,
                           "profiler-enabled": True}).start()
    prof = srv.http.profiler
    assert prof.running and prof.hz == 29.0 and prof.top_n == 20
    srv.stop()
    assert not prof.running


def test_debug_threads_endpoint_matches_the_jax_server():
    """Both servers list the roots they registered, with the handler that
    serves the request among the live ones; with gRPC on, both register
    grpc's serving thread by call."""
    port = psrv.FiloServer({"num-shards": 2, "port": 0, "device": "cpu",
                            "gc-freeze": False}).start()
    jax_srv = JServer({"num-shards": 2, "port": 0,
                       "gc-freeze": False}).start()
    try:
        bodies = [_get(s.port, "/debug/threads") for s in (port, jax_srv)]
    finally:
        port.stop()
        jax_srv.stop()
    for body in bodies:
        assert body["status"] == "success"
        roots = {e["name"]: e for e in body["data"]}
        assert {"http-handler", "tenant-metering", "grpc-serve",
                "device-executor"} <= set(roots)
        assert any(e["live_threads"] for e in body["data"]
                   if e["name"] == "http-handler")
    (pb, jb) = bodies
    static = {e["name"] for e in jb["data"]
              if "<locals>" not in e["root"]
              and e["root"].startswith("filodb_tpu.")}
    assert static <= {e["name"] for e in pb["data"]}
