"""The port's admin and PromQL CLI (``python -m filodb_tpu_torch.cli``)
against the JAX package's (``filodb_tpu.cli``): one case per command that
tests/test_cli.py covers. The server commands run against the port's
server on the CPU and the JAX server, both seeded with the same dev data;
the offline commands run both CLIs on the same inputs. Outputs must be
equal, but for the range query's values, which hold the per-series rate
tolerance of tests/test_torch_server.py (8 f32 ulps).
"""

import contextlib
import io
import json

import numpy as np
import pytest

from filodb_tpu import cli as j_cli
from filodb_tpu.standalone.server import FiloServer as JServer
from filodb_tpu_torch import cli as p_cli
from filodb_tpu_torch.standalone import server as psrv

T0 = 1_600_000_000


@pytest.fixture(scope="module")
def hosts():
    port = psrv.FiloServer({"num-shards": 2, "port": 0, "device": "cpu",
                            "gc-freeze": False, "grpc-port": None}).start()
    jax_srv = JServer({"num-shards": 2, "port": 0, "grpc-port": None,
                       "gc-freeze": False}).start()
    for srv in (port, jax_srv):
        srv.seed_dev_data(n_samples=30, n_instances=2, start_ms=T0 * 1000)
    yield (f"http://127.0.0.1:{port.port}",
           f"http://127.0.0.1:{jax_srv.port}")
    port.stop()
    jax_srv.stop()


def _run(cli, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(list(argv)) == 0
    return json.loads(buf.getvalue())


def _both(hosts, *argv):
    """(port CLI on the port's server, JAX CLI on the JAX server)."""
    return (_run(p_cli, "--host", hosts[0], *argv),
            _run(j_cli, "--host", hosts[1], *argv))


def test_status(hosts):
    got, want = _both(hosts, "status")
    assert {s["shard"] for s in got["data"]} == {0, 1}
    assert got == want


def test_labels_and_values(hosts):
    got, want = _both(hosts, "labels")
    assert "_ws_" in got["data"] and got == want
    got, want = _both(hosts, "labelvalues", "_ws_")
    assert got["data"] == ["demo"] and got == want


def test_query_range(hosts):
    got, want = _both(hosts, "query-range", "rate(http_requests_total[5m])",
                      "--start", str(T0 + 100), "--end", str(T0 + 290),
                      "--step", "60")
    assert got["status"] == want["status"] == "success"
    pr, jr = got["data"]["result"], want["data"]["result"]
    assert pr and [e["metric"] for e in pr] == [e["metric"] for e in jr]
    for pe, je in zip(pr, jr):
        pv, jv = (np.asarray(e["values"], np.float64) for e in (pe, je))
        np.testing.assert_array_equal(pv[:, 0], jv[:, 0])
        mag = np.maximum(np.abs(pv[:, 1]), np.abs(jv[:, 1]))
        ulps = np.abs(pv[:, 1] - jv[:, 1]) / np.spacing(
            mag.astype(np.float32)).astype(np.float64)
        assert (ulps <= 8).all(), (pe["metric"], ulps)


def test_tscard_and_topk(hosts):
    got, want = _both(hosts, "tscard", "--prefix", "demo")
    assert got["data"][0]["tsCount"] > 0 and got == want
    got, want = _both(hosts, "topkcard", "--prefix", "demo", "-k", "1")
    assert len(got) == 1 and got == want


def test_find_query_shards():
    argv = ("find-query-shards", "demo,App-0", "heap_usage", "--spread",
            "1", "--num-shards", "4")
    got = _run(p_cli, *argv)
    assert len(got["shards"]) == 2 and got == _run(j_cli, *argv)


def test_validate_schemas():
    got = _run(p_cli, "validate-schemas")
    assert got["ok"] and "prom-counter" in got["schemas"]
    assert got == _run(j_cli, "validate-schemas")


def test_decode_vector_roundtrip():
    from filodb_tpu_torch.memory import vectors as bv
    vals = np.arange(10, dtype=np.float64) * 1.5
    blob = "hex:" + bv.encode_doubles(vals).hex()
    got = _run(p_cli, "decode-vector", blob)
    np.testing.assert_allclose(got["values"], vals)
    assert got == _run(j_cli, "decode-vector", blob)


def test_decode_chunk_info(tmp_path):
    from filodb_tpu_torch.core.memstore import TimeSeriesShard
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
    from filodb_tpu_torch.store import FlatFileColumnStore
    cs = FlatFileColumnStore(str(tmp_path))
    shard = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0,
                            column_store=cs)
    b = RecordBuilder(DEFAULT_SCHEMAS)
    for t in range(20):
        b.add_sample("gauge", {"_metric_": "m", "_ws_": "w", "_ns_": "n"},
                     1000 + t * 10, float(t))
    for c in b.containers():
        shard.ingest(c)
    shard.flush_all(offset=1)
    got = _run(p_cli, "decode-chunk-info", str(tmp_path))
    assert got and got[0]["numRows"] == 20
    # the JAX package's CLI reads the port's column store alike
    assert got == _run(j_cli, "decode-chunk-info", str(tmp_path))
