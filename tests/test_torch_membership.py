"""Elastic membership of the port (``filodb_tpu_torch.parallel.membership``)
after tests/test_membership.py, on the CPU: planned drain, rejoin deferral
and hand-back, the stale-routing bounce on the pushdown and leaf planes,
and gossiped watermarks; then the ``/metrics`` families of a node with
peers against the JAX package's.

Each scenario runs on in-process port nodes sharing one data-dir, as the
reference's tests run theirs; where the reference's own test pins a
behaviour (the bounce envelope, the answer before and after a drain), the
same request goes to a JAX cluster of the same shape and the answers are
compared (per-series rate on aligned tiles: 8 f32 ulps, as in
tests/test_torch_server.py).
"""

import json
import socket
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from filodb_tpu.standalone.server import FiloServer as JServer
from filodb_tpu_torch.query.model import StaleRoutingError
from filodb_tpu_torch.standalone.server import FiloServer
from filodb_tpu_torch.testing import chaos

torch.set_num_threads(1)

T0 = 1_600_000_000
N_SAMPLES = 60
N_INSTANCES = 4


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(port, path, **params):
    qs = urllib.parse.urlencode(params, doseq=True)
    url = f"http://127.0.0.1:{port}{path}"
    if qs:
        url += "?" + qs
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _query(port, **extra):
    """Unpruned cross-node range query touching every shard."""
    return _get(port, "/promql/timeseries/api/v1/query_range",
                query='rate({_metric_=~'
                      '"heap_usage|http_requests_total"}[5m])',
                start=T0 + 300, end=T0 + (N_SAMPLES - 1) * 10, step=60,
                **extra)


def _result_data(body):
    rows = [(tuple(sorted(r["metric"].items())), r.get("values"))
            for r in body["data"]["result"]]
    return sorted(rows)


def _shard_owners(port):
    _, body = _get(port, "/api/v1/cluster/timeseries/status")
    return {s["shard"]: (s["status"], s["address"]) for s in body["data"]}


def _poll(fn, timeout=60.0, interval=0.05):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            ok, last = fn()
            if ok:
                return last
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(interval)
    raise TimeoutError(f"poll timed out; last={last!r}")


def _mk_cluster(tmp_path, n_nodes=2, num_shards=4, fd_interval=0.1,
                grace=0.5, cls=FiloServer, **extra):
    ports = [_free_port() for _ in range(n_nodes)]
    peers = {f"node{i}": f"http://127.0.0.1:{p}"
             for i, p in enumerate(ports)}
    base = {
        "num-shards": num_shards, "num-nodes": n_nodes, "peers": peers,
        "data-dir": str(tmp_path / ("data" if cls is FiloServer
                                    else "jax-data")),
        "query-sample-limit": 0, "query-series-limit": 0,
        "failure-detect-interval-s": fd_interval,
        "failure-detect-threshold": 2,
        "shard-reassign-grace-s": grace,
        "handoff-timeout-s": 20.0, "gc-freeze": False,
        **({"device": "cpu"} if cls is FiloServer else {}),
        **extra,
    }
    cfgs = [{**base, "node-ordinal": i, "port": ports[i]}
            for i in range(n_nodes)]
    servers = []
    try:
        for cfg in cfgs:
            srv = cls(dict(cfg)).start()
            servers.append(srv)
            srv.seed_dev_data(n_samples=N_SAMPLES, n_instances=N_INSTANCES,
                              start_ms=T0 * 1000)
    except BaseException:
        _stop(servers)
        raise
    return servers, cfgs, ports


def _stop(servers):
    for srv in servers:
        if srv is not None:
            srv.stop()


def _f32_ulps(a, b):
    mag = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.abs(a - b) / np.spacing(mag).astype(np.float64)


def _assert_rates_match(got, want):
    """Same series and timestamps; rates within 8 f32 ulps."""
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, gv), (_, wv) in zip(got, want):
        g, w = np.asarray(gv, np.float64), np.asarray(wv, np.float64)
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        assert (_f32_ulps(g[:, 1], w[:, 1]) <= 8).all()


def test_drain_hands_every_shard_off_and_results_stay_identical(tmp_path):
    servers, _, _ = _mk_cluster(tmp_path)
    a, b = servers
    try:
        code, full = _query(a.port)
        assert code == 200 and "partial" not in full
        golden = _result_data(full)
        node1_shards = sorted(sh for sh, (_, n) in
                              _shard_owners(a.port).items()
                              if n == "node1")
        assert node1_shards == [2, 3]

        code, out = _post(b.port, "/admin/drain")
        assert code == 200 and out["status"] == "success"
        assert {h["shard"] for h in out["data"]["handed_off"]} == \
            set(node1_shards)
        assert out["data"]["failed"] == []
        st_b = _shard_owners(b.port)
        assert all(n != "node1" for _, n in st_b.values()), st_b
        assert all(s == "active" for s, _ in st_b.values()), st_b
        for port in (a.port, b.port):
            code, body = _query(port)
            assert code == 200 and "partial" not in body
            assert _result_data(body) == golden
        _poll(lambda: (all(n == "node0" for _, n in
                           _shard_owners(a.port).values()), None))
        assert b.store.shards(b.ref) == []
        for srv in (a, b):
            assert srv.mapper.topology_epoch > 0
        _, mtx = _get_text(b.port, "/metrics")
        assert any(line.startswith("filodb_shard_handoff_completed_total")
                   and int(float(line.split()[-1])) >= 2
                   for line in mtx.splitlines())
        assert 'filodb_shard_adoptions_total{kind="planned"} 2' in \
            _get_text(a.port, "/metrics")[1]
    finally:
        _stop(servers)
    # the JAX cluster of the same shape answers the same series
    jservers, _, _ = _mk_cluster(tmp_path, cls=JServer)
    try:
        code, jfull = _query(jservers[0].port)
        assert code == 200
        _assert_rates_match(golden, _result_data(jfull))
    finally:
        _stop(jservers)


def _get_text(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.read().decode()


@pytest.mark.parametrize("cls", [FiloServer, JServer], ids=["port", "jax"])
def test_drain_without_peers_fails_cleanly(tmp_path, cls):
    extra = {"device": "cpu"} if cls is FiloServer else {}
    srv = cls({"num-shards": 2, "port": 0, "gc-freeze": False,
               "data-dir": str(tmp_path / "d"), **extra}).start()
    try:
        code, body = _post(srv.port, "/admin/drain")
        assert code == 400
        assert body["error"] == "drain: no alive peer to hand shards to"
    finally:
        srv.stop()


def test_rejoin_defers_claimed_shards_and_receives_them_back(tmp_path):
    servers, cfgs, _ = _mk_cluster(tmp_path)
    a, b = servers
    try:
        code, full = _query(a.port)
        golden = _result_data(full)
        node1_shards = [2, 3]
        _post(b.port, "/admin/drain")
        b.stop()
        servers[1] = None
        _poll(lambda: (a.detector.is_down("node1"), None))
        _poll(lambda: (a.detector._reassigned.get("node1", False), None),
              timeout=30)
        b2 = FiloServer(dict(cfgs[1])).start()
        servers[1] = b2
        # start-up deferral: node0 still serves node1's shards, so the
        # restarted node must NOT have created them
        served = {s.shard_num for s in b2.store.shards(b2.ref)}
        assert set(b2.deferred_shards) | (served & set(node1_shards)) \
            == set(node1_shards)

        def _handed_back():
            st = _shard_owners(a.port)
            return all(st[sh] == ("active", "node1")
                       for sh in node1_shards), st
        _poll(_handed_back, timeout=60)
        for port in (a.port, b2.port):
            code, body = _query(port)
            assert code == 200 and "partial" not in body
            assert _result_data(body) == golden
        assert a.membership.metrics_snapshot()["handoffs_completed"] >= 2
    finally:
        _stop(servers)


def test_stale_routing_bounce_is_never_returned_and_retries(tmp_path):
    """A shard moves between the plan-cache fill and the query; the
    entry node's routing still names the old owner, which bounces
    stale_routing; the entry node rewires from the bounce's owner hint
    and re-materializes. The client sees only the correct result."""
    servers, _, _ = _mk_cluster(tmp_path, n_nodes=3, fd_interval=300.0,
                                grace=None)
    a, b, c = servers
    try:
        code, full = _query(a.port)
        assert code == 200
        golden = _result_data(full)
        assert sorted(sh for sh, (_, n) in _shard_owners(a.port).items()
                      if n == "node1") == [2, 3]
        inj = chaos.ChaosInjector()
        inj.fail("handoff.transfer",
                 match=lambda ctx: ctx.get("node") == "node0")
        with inj:
            code, out = _post(b.port, "/admin/drain")
            assert code == 200 and out["data"]["failed"] == [], out
        by_new_owner = {h["shard"]: h["to"]
                        for h in out["data"]["handed_off"]}
        assert sorted(by_new_owner.values()) == ["node0", "node2"]
        stale_shard = next(sh for sh, n in by_new_owner.items()
                           if n == "node2")
        assert _shard_owners(a.port)[stale_shard][1] == "node1"
        before = a.http.stale_routing_retries
        code, body = _query(a.port)
        assert code == 200 and "partial" not in body
        assert _result_data(body) == golden
        assert a.http.stale_routing_retries > before
        assert b.http.stale_routing_bounces >= 1
        assert _shard_owners(a.port)[stale_shard][1] == "node2"
        assert "stale-routing" in \
            a.http.plan_cache.snapshot()["invalidations_by_reason"]
    finally:
        _stop(servers)


def test_stale_routing_error_round_trips_through_strings():
    e = StaleRoutingError(owners={3: "node2", 1: "node0"}, epoch=17,
                          node="node1", detail="shards [3] moved")
    back = StaleRoutingError.parse(f"remote node node1: {e}")
    assert back is not None
    assert back.owners == {3: "node2", 1: "node0"}
    assert back.epoch == 17 and back.node == "node1"
    assert StaleRoutingError.parse("plain error") is None


def test_leaf_endpoint_bounces_unserved_shards_as_the_reference(tmp_path):
    """POST /api/v1/raw naming a shard this node does not serve answers
    a stale_routing envelope (owners + epoch), never a silent subset;
    the pushdown plane's expect_shards bounces alike."""
    out = []
    for cls in (FiloServer, JServer):
        servers, _, _ = _mk_cluster(tmp_path, fd_interval=300.0,
                                    grace=None, cls=cls, **{
                                        "grpc-port": None})
        a = servers[0]
        try:
            body = {"filters": [["_metric_", "eq", "heap_usage"]],
                    "start_ms": 0, "end_ms": 1 << 60, "column": None,
                    "shards": [2]}
            code, leaf = _post(a.port, "/api/v1/raw/timeseries", body)
            assert code == 200
            code, push = _get(a.port, "/promql/timeseries/api/v1/"
                              "query_range", query="heap_usage",
                              start=T0 + 300, end=T0 + 590, step=60,
                              dispatch="local", expect_shards="1,2")
            assert code == 200
            out.append((leaf, push, a.http.stale_routing_bounces))
        finally:
            _stop(servers)
    (leaf, push, n), (jleaf, jpush, jn) = out
    assert leaf == jleaf and push == jpush and n == jn == 2
    assert leaf["status"] == "error"
    assert leaf["errorType"] == "stale_routing"
    assert leaf["owners"] == {"2": "node1"} and "topo_epoch" in leaf
    assert push["owners"] == {"2": "node1"}


def test_gossiped_watermarks_ride_health_and_stamp_remote_groups(
        tmp_path):
    servers, _, _ = _mk_cluster(tmp_path, fd_interval=0.1, grace=None)
    a, b = servers
    try:
        _, health = _get(b.port, "/__health")
        for key in ("watermarks", "backfill_epochs", "topo_epoch",
                    "grpc_port", "down_peers", "draining"):
            assert key in health, key
        _poll(lambda: ("node1" in a.http.peer_watermarks,
                       dict(a.http.peer_watermarks)))
        planner = a.http.make_planner("timeseries")
        remote = [s for s in planner._resolve_shards(None)
                  if hasattr(s, "fetch_raw")]
        assert [type(g).__name__ for g in remote] == ["GrpcShardGroup"]
        for grp in remote:
            assert grp.ingest_watermark_ms is not None
            assert hasattr(grp, "ingest_backfill_epoch")
    finally:
        _stop(servers)


def _families(port):
    _, body = _get_text(port, "/metrics")
    return {ln.split()[2] for ln in body.splitlines()
            if ln.startswith("# TYPE ")}


# families of the reference with no counterpart in the port -> why: none
# since the port accounts its dispatch keys (the exec-cache families) and
# profiles them (obs/devprof.py)
ABSENT_FAMILIES: set = set()
# families of the port the reference lacks -> why: the count of gRPC
# downgrades to the HTTP plane (ROADMAP C.15)
EXTRA_FAMILIES = {"filodb_grpc_plane_fallbacks_total"}


def test_metric_families_with_peers_match_the_jax_servers(tmp_path):
    """The families the HTTP servers build themselves (those of their
    ``_METRIC_HELP``); the process-wide registries' families depend on
    what else ran in the process, and tests/test_torch_server.py compares
    them at the defaults."""
    from filodb_tpu.http.server import FiloHttpServer as JHttp
    from filodb_tpu_torch.http.server import FiloHttpServer as PHttp
    server_fams = set(JHttp._METRIC_HELP) | set(PHttp._METRIC_HELP)
    fams = []
    for cls in (FiloServer, JServer):
        servers, _, _ = _mk_cluster(tmp_path, fd_interval=0.1, grace=None,
                                    cls=cls)
        try:
            _poll(lambda: (all(s.http.grpc_peers for s in servers), None))
            fams.append(_families(servers[0].port) & server_fams)
        finally:
            _stop(servers)
    pf, jf = fams
    assert pf == (jf - ABSENT_FAMILIES) | EXTRA_FAMILIES
    for fam in ("filodb_grpc_rpcs_served_total",
                "filodb_shard_handoff_started_total",
                "filodb_stale_routing_bounces_total",
                "filodb_peer_fanout_workers",
                "filodb_detector_thread_wedged"):
        assert fam in pf, fam
