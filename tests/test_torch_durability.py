"""The port's column store, ODP paging, eviction, fsck and integrity
switch against the JAX package's.

Both packages flush the same samples into their own
``FlatFileColumnStore``s, and the files must be byte-identical; each
package then bootstraps from the other's data-dir and pages every series
back in. The same damaged directory gets the same ``fsck`` report from
both, and the quarantine knob trips both drivers at the same count. A
bootstrapped or evicted shard must answer every query exactly as before:
the data is the same bytes, so the tolerance is equality throughout.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from filodb_tpu import fsck as j_fsck
from filodb_tpu.core.memstore import TimeSeriesShard as JShard
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetRef as JRef
from filodb_tpu.ingest import LogIngestionStream as JStream
from filodb_tpu.ingest.driver import IngestionDriver as JDriver
from filodb_tpu.store import FlatFileColumnStore as JStore
from filodb_tpu_torch import fsck as p_fsck
from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.core.memstore import TimeSeriesShard as PShard
from filodb_tpu_torch.core.record import RecordBuilder as PBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS as P_SCHEMAS
from filodb_tpu_torch.core.schemas import DatasetRef as PRef
from filodb_tpu_torch.ingest import LogIngestionStream as PStream
from filodb_tpu_torch.ingest.driver import IngestionDriver as PDriver
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.query.backend import TorchBackend
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.store import FlatFileColumnStore as PStore
from filodb_tpu_torch.store import integrity as p_integrity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_600_000_000_000
N = 120

PKG = {
    "port": (PShard, PStore, PBuilder, P_SCHEMAS, PRef, PStream, PDriver),
    "jax": (JShard, JStore, JBuilder, J_SCHEMAS, JRef, JStream, JDriver),
}


def _rows(seed=11, S=6):
    """(schema, labels, ts ms, values): jittered counters with a reset,
    counters of irregular cadence and gauges."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(S):
        ts = T0 + np.arange(N) * 10_000 + rng.integers(-2000, 2000, N)
        v = 1e6 + np.cumsum(rng.uniform(0, 5, N))
        if i == 1:
            v[N // 2:] -= v[N // 2 - 1]
        out.append(("prom-counter",
                    {"_metric_": "req_total", "_ws_": "demo",
                     "_ns_": "App-0", "job": f"j{i % 2}",
                     "instance": f"i{i}"}, ts, v))
    for i in range(S // 2):
        ts = np.unique(T0 + np.arange(N) * 10_000
                       + rng.integers(-6000, 6000, N))
        out.append(("prom-counter",
                    {"_metric_": "irr_total", "_ws_": "demo",
                     "_ns_": "App-0", "instance": f"k{i}"},
                    ts, np.cumsum(rng.uniform(0, 3, ts.size))))
    for i in range(S // 2):
        ts = T0 + np.arange(N) * 10_000
        out.append(("gauge",
                    {"_metric_": "depth", "_ws_": "demo", "_ns_": "App-0",
                     "instance": f"g{i}"},
                    ts, (100 + np.cumsum(rng.integers(-3, 4, N)))
                    .astype(np.float64)))
    return out


def _ingest(pkg, shard, rows, lo, hi, offset):
    """Samples [lo, hi) of each row through the package's own builder."""
    b = PKG[pkg][2](PKG[pkg][3])
    for schema, labels, ts, vals in rows:
        for t, v in zip(ts[lo:hi], vals[lo:hi]):
            b.add_sample(schema, labels, int(t), float(v))
    for c in b.containers():
        shard.ingest(c, offset)


def _flushed_shard(pkg, root, rows, store=True):
    Shard, Store, _, schemas, Ref = PKG[pkg][:5]
    cs = Store(str(root)) if store else None
    shard = Shard(Ref("timeseries"), schemas, 0, num_groups=2,
                  max_chunk_rows=16, column_store=cs)
    _ingest(pkg, shard, rows, 0, N // 2, 3)
    shard.flush_group(0, offset=3)
    _ingest(pkg, shard, rows, N // 2, N, 7)
    shard.flush_all(offset=7)
    return shard


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_column_store_files_are_byte_identical(tmp_path):
    rows = _rows()
    for pkg in PKG:
        _flushed_shard(pkg, tmp_path / pkg, rows).column_store.close()
    p, j = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(p) == sorted(j)
    assert {"timeseries/shard=0/chunks.log",
            "timeseries/shard=0/partkeys.log"} <= set(p)
    for name in p:
        assert p[name] == j[name], name


def _samples(shard):
    """{labels: (ts, values)} of every partition, paging shells in."""
    out = {}
    for pid, part in sorted(shard.partitions.items()):
        if part.odp_pending:
            shard._ensure_loaded(part)
        ts, vals, _ = part.read_full(1)
        out[tuple(sorted(part.part_key.label_map.items()))] = (
            np.asarray(ts).tolist(), np.asarray(vals).tolist())
    return out


def _truth(rows):
    return {tuple(sorted(lab.items())): (
        np.asarray(ts, np.int64).tolist(), np.asarray(v).tolist())
        for _, lab, ts, v in rows}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_data_dir(tmp_path, writer):
    rows = _rows()
    _flushed_shard(writer, tmp_path / "data", rows).column_store.close()
    got = {}
    for pkg in PKG:
        Shard, Store, _, schemas, Ref = PKG[pkg][:5]
        shard = Shard(Ref("timeseries"), schemas, 0, num_groups=2,
                      max_chunk_rows=16,
                      column_store=Store(str(tmp_path / "data")))
        assert shard.bootstrap_from_store() == len(rows)
        assert all(p.odp_pending for p in shard.partitions.values())
        got[pkg] = (dict(shard.checkpoints), shard.recovery_watermark(),
                    _samples(shard))
    assert got["port"] == got["jax"]
    assert got["port"][0] == {0: 7, 1: 7}
    assert got["port"][2] == _truth(rows)


@pytest.mark.parametrize("metric", ["req_total", "irr_total", "depth"])
def test_bootstrap_then_page_in_gives_back_every_sample(tmp_path, metric):
    rows = _rows(seed=3)
    _flushed_shard("port", tmp_path, rows).column_store.close()
    shard = PShard(PRef("timeseries"), P_SCHEMAS, 0, num_groups=2,
                   max_chunk_rows=16, column_store=PStore(str(tmp_path)))
    shard.bootstrap_from_store()
    parts = shard.lookup_partitions(
        [ColumnFilter("_metric_", "eq", metric)], T0, T0 + N * 10_000)
    want = {k: v for k, v in _truth(rows).items()
            if dict(k)["_metric_"] == metric}
    assert len(parts) == len(want) > 0
    assert shard.stats.partitions_paged_in == len(want)
    got = {}
    for part in parts:
        ts, vals, _ = part.read_full(1)
        got[tuple(sorted(part.part_key.label_map.items()))] = (
            np.asarray(ts).tolist(), np.asarray(vals).tolist())
    assert got == want


QUERIES = ["sum by (job) (rate(req_total[5m]))", "rate(irr_total[5m])",
           "max_over_time(depth[5m])"]


def _answer(shard, query, backend):
    plan = parse_query_range(query, TimeStepParams(
        T0 // 1000 + 400, 60, T0 // 1000 + N * 10 - 30))
    res = QueryEngine([shard], backend=backend).execute(plan)
    return [(tuple(sorted(k.items())), np.asarray(v).tobytes())
            for k, v in zip(res.keys, res.values)]


def _evict_keys(pkg, root, rows, store):
    shard = _flushed_shard(pkg, root, rows, store=store)
    before = shard.resident_samples()
    evicted = shard.ensure_headroom(before // 2)
    shells = sorted(p.part_key.to_bytes() for p in shard.partitions.values()
                    if p.odp_pending)
    return shard, evicted, shells, sorted(shard._by_part_key)


@pytest.mark.parametrize("store", [True, False],
                         ids=["odp-shells", "memory-only"])
def test_eviction_matches_the_jax_package(tmp_path, store):
    rows = _rows()
    _, pe, ps, pk = _evict_keys("port", tmp_path / "p", rows, store)
    _, je, js, jk = _evict_keys("jax", tmp_path / "j", rows, store)
    assert (pe, ps, pk) == (je, js, jk)
    assert pe > 0
    assert len(ps) == (pe if store else 0)


@pytest.mark.parametrize("query", QUERIES)
def test_eviction_to_odp_shells_keeps_every_answer(tmp_path, query):
    """One backend throughout, so the answer after the page-in goes
    through the tile cache the first answer filled, and a fresh backend's
    answer too."""
    rows = _rows()
    shard = _flushed_shard("port", tmp_path, rows)
    backend = TorchBackend(device="cpu")
    before = _answer(shard, query, backend)
    assert shard.ensure_headroom(shard.resident_samples() // 4) > 0
    assert any(p.odp_pending for p in shard.partitions.values())
    assert _answer(shard, query, backend) == before
    assert shard.stats.partitions_paged_in > 0
    assert _answer(shard, query, TorchBackend(device="cpu")) == before


def _flip(path, pos, mask=0x01):
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ mask]))


def _write_wal(path, n=5):
    s = PStream(path, P_SCHEMAS, group_commit_s=0.0)
    for i in range(n):
        b = PBuilder(P_SCHEMAS)
        b.add_sample("gauge", {"_metric_": "m", "_ws_": "demo",
                               "_ns_": "App-0", "instance": f"i{i}"},
                     T0 + i * 1000, float(i))
        for c in b.containers():
            s.append(c)
    recs = list(s._records)
    s.close()
    return recs


def _damaged_dir(root):
    """A bit-flipped WAL frame, a torn WAL tail, a clean WAL, and a
    flushed column-store shard with a flipped chunk frame and a flipped
    checkpoint, all written by the port."""
    os.makedirs(root / "stream" / "shard=0")
    os.makedirs(root / "stream" / "shard=1")
    os.makedirs(root / "stream" / "shard=2")
    recs = _write_wal(str(root / "stream" / "shard=0" / "stream.log"))
    _flip(str(root / "stream" / "shard=0" / "stream.log"),
          recs[2].payload_off + recs[2].payload_len // 2)
    _write_wal(str(root / "stream" / "shard=1" / "stream.log"))
    with open(root / "stream" / "shard=1" / "stream.log", "ab") as f:
        f.write(p_integrity.encode_frame(b"y" * 64)[:17])
    _write_wal(str(root / "stream" / "shard=2" / "stream.log"))
    shard = _flushed_shard("port", root / "data", _rows())
    shard.column_store.close()
    d = shard.column_store._shard_dir("timeseries", 0)
    chunks = os.path.join(d, "chunks.log")
    with open(chunks, "rb") as f:
        res = p_integrity.scan_buffer(f.read(), probe=lambda b, o: 0)
    victim = res.records[1]
    _flip(chunks, victim.payload_off + victim.payload_len // 2)
    ckpt = shard.column_store._ckpt_path("timeseries", 0)
    _flip(ckpt, os.path.getsize(ckpt) // 2)


@pytest.mark.parametrize("repair", [False, True], ids=["check", "repair"])
def test_fsck_reports_alike(tmp_path, repair):
    _damaged_dir(tmp_path / "src")
    reports = {}
    for pkg, mod in (("port", p_fsck), ("jax", j_fsck)):
        root = tmp_path / pkg
        shutil.copytree(tmp_path / "src", root)
        rep = mod.check_dir(str(root), repair=repair)
        reports[pkg] = json.loads(json.dumps(rep).replace(str(root),
                                                          "<root>"))
        if repair:
            again = mod.check_dir(str(root))
            assert again["summary"]["files_with_findings"] == 0
    assert reports["port"] == reports["jax"]
    assert reports["port"]["summary"]["files_with_findings"] == 4


def test_fsck_command_lines_print_the_same_json(tmp_path):
    _damaged_dir(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = {}
    for mod in ("filodb_tpu_torch.fsck", "filodb_tpu.fsck"):
        proc = subprocess.run(
            [sys.executable, "-m", mod, str(tmp_path), "--json"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        out[mod] = (proc.returncode, json.loads(proc.stdout))
    assert out["filodb_tpu_torch.fsck"] == out["filodb_tpu.fsck"]
    assert out["filodb_tpu.fsck"][0] == 1


def _trip(pkg, root, src, knob):
    """Drive a shard from a copy of ``src`` (two damaged records) with
    the quarantine knob at ``knob``; then append one more batch. Returns
    (read-only, quarantined, rows ingested)."""
    Shard, _, Builder, schemas, Ref, Stream, Driver = PKG[pkg]
    os.makedirs(root)
    path = str(root / "stream.log")
    shutil.copy(src, path)
    stream = Stream(path, schemas, group_commit_s=0.0)
    shard = Shard(Ref("timeseries"), schemas, 0, num_groups=2,
                  max_chunk_rows=64)
    drv = Driver(shard, stream, poll_interval_s=0.005,
                 max_quarantined_records=knob).start()
    try:
        deadline = time.monotonic() + 30
        while drv.recovered_to < 0 or drv.next_offset < drv.recovered_to:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        b = Builder(schemas)
        b.add_sample("gauge", {"_metric_": "m", "_ws_": "demo",
                               "_ns_": "App-0", "instance": "new"},
                     T0 + 10**6, 1.0)
        for c in b.containers():
            stream.append(c)
        deadline = time.monotonic() + 2
        while shard.stats.rows_ingested < 4 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        drv.stop(flush=False)
        stream.close()
    return (shard.integrity_read_only, shard.integrity_quarantined_records,
            shard.stats.rows_ingested)


@pytest.mark.parametrize("knob", [0, 1, 2])
def test_integrity_read_only_trips_at_the_same_count(tmp_path, knob):
    src = str(tmp_path / "src.log")
    recs = _write_wal(src, n=5)
    for victim in (recs[1], recs[3]):
        _flip(src, victim.payload_off + 3)
    got = {pkg: _trip(pkg, tmp_path / pkg, src, knob) for pkg in PKG}
    assert got["port"] == got["jax"]
    read_only, quarantined, rows = got["port"]
    assert quarantined == 2
    assert read_only == (knob < 2)
    # recovery applies every survivor; the new batch lands only when the
    # knob tolerates the loss
    assert rows == (3 if read_only else 4)
