"""The port's ingest edge and durable streams against the JAX package's.

The same Influx lines go through both parsers and both gateways' routing;
the same samples go through both packages' record builders into both
``LogIngestionStream``s; the same damaged logs are opened by both; and
both ``IngestionDriver``s recover the same shard from the same checkpoint.
Everything here is host code with no float arithmetic of its own, so the
tolerance is equality: equal records, byte-identical stream frames, equal
quarantine counts and sidecar bytes, equal replayed offsets.
"""

import os
import shutil
import time

import numpy as np
import pytest

from filodb_tpu.core.memstore import TimeSeriesShard as JShard
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetRef as JRef
from filodb_tpu.gateway import influx as j_influx
from filodb_tpu.gateway.server import GatewayServer as JGateway
from filodb_tpu.ingest import stream as j_stream
from filodb_tpu.ingest.driver import IngestionDriver as JDriver
from filodb_tpu.memory.histogram import CustomBuckets as JBuckets
from filodb_tpu.parallel.shardmapper import ShardMapper as JMapper
from filodb_tpu.store import FlatFileColumnStore as JStore
from filodb_tpu.store import integrity as j_integrity
from filodb_tpu_torch.core.memstore import TimeSeriesShard as PShard
from filodb_tpu_torch.core.record import RecordBuilder as PBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS as P_SCHEMAS
from filodb_tpu_torch.core.schemas import DatasetRef as PRef
from filodb_tpu_torch.gateway import influx as p_influx
from filodb_tpu_torch.gateway.server import GatewayServer as PGateway
from filodb_tpu_torch.ingest import stream as p_stream
from filodb_tpu_torch.ingest.driver import IngestionDriver as PDriver
from filodb_tpu_torch.memory.histogram import CustomBuckets as PBuckets
from filodb_tpu_torch.parallel.shardmapper import ShardMapper as PMapper
from filodb_tpu_torch.store import FlatFileColumnStore as PStore
from filodb_tpu_torch.store import integrity as p_integrity

T0_NS = 1_600_000_000_000_000_000
NOW_MS = 1_600_000_123_456

LINES = [
    "heap_usage,host=a,dc=us gauge=12.5 %d" % T0_NS,
    r"my\ metric,tag\,x=a\ b,t2=c\=d value=3i %d" % (T0_NS + 1),
    "http_requests_total,job=j0,instance=i0 counter=1e9 %d"
    % (T0_NS + 10**9),
    "lat,job=j0 sum=12.5,count=10,0.1=1,0.5=4,1=7,+Inf=10 %d"
    % (T0_NS + 2 * 10**9),
    "cpu,host=a user=1.5,sys=2.5 %d" % (T0_NS + 3 * 10**9),
    "m,_ws_=w1,_ns_=n1,host=b value=-0.25 %d" % (T0_NS + 4 * 10**9),
    'm,host=c value=2,msg="hi" %d' % (T0_NS + 5 * 10**9),
    "no_timestamp,host=d gauge=7",
    "tiny,host=e value=4.9e-324 %d" % (T0_NS + 6 * 10**9 + 999_999),
]

BAD_LINES = [
    "no_fields_here",
    "m,host=a value=abc 1",
    "m,host value=1 1",
    'm value="only a string" 1',
    "m value=1 2 3",
    # the parser splits on spaces before it reads quotes (reference
    # behaviour, kept)
    'm,host=c value=2,msg="hi there" 1',
    "",
]


def _records(influx, line):
    rec = influx.parse_line(line, now_ms=NOW_MS)
    out = []
    for schema, labels, ts, values in influx.input_records(rec):
        vals = []
        for v in values:
            if isinstance(v, tuple):
                scheme, counts = v
                vals.append((repr(scheme), np.asarray(counts).tolist()))
            else:
                vals.append(repr(float(v)))
        out.append((schema, sorted(labels.items()), ts, vals))
    return (rec.measurement, sorted(rec.tags.items()),
            sorted(rec.fields.items()), rec.timestamp_ms), out


@pytest.mark.parametrize("line", LINES, ids=range(len(LINES)))
def test_influx_lines_give_the_same_records(line):
    assert _records(p_influx, line) == _records(j_influx, line)


@pytest.mark.parametrize("line", BAD_LINES, ids=range(len(BAD_LINES)))
def test_bad_influx_lines_fail_alike(line):
    with pytest.raises(ValueError) as pe:
        p_influx.parse_line(line, now_ms=NOW_MS)
    with pytest.raises(ValueError) as je:
        j_influx.parse_line(line, now_ms=NOW_MS)
    assert type(pe.value).__name__ == type(je.value).__name__
    assert str(pe.value) == str(je.value)


def _gateway_frames(gw_cls, stream_mod, schemas, body):
    """Route a POST body's lines (comments and blanks skipped, as the
    HTTP ingest edge does) through a gateway into memory streams; return
    (accepted, rejected, {shard: [frame bytes]})."""
    streams = {s: stream_mod.MemoryIngestionStream() for s in range(4)}
    gw = gw_cls(streams, schemas, num_shards=4).start()
    try:
        builders = {}
        accepted = rejected = 0
        for raw in body.splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if gw._route_line(line, builders):
                accepted += 1
            else:
                rejected += 1
        gw._publish(builders)
        frames = {s: [stream_mod.encode_container(sd.container)
                      for sd in st.read(0, 1000)]
                  for s, st in streams.items()}
        return accepted, rejected, frames, gw.lines_ingested, \
            gw.lines_rejected
    finally:
        gw.stop()


def test_gateways_route_a_body_to_the_same_shards_and_frames():
    body = "\n".join(["# a comment", ""] + LINES[:7] + BAD_LINES[:3]
                     + ["  # indented comment"] + LINES[8:])
    p = _gateway_frames(PGateway, p_stream, P_SCHEMAS, body)
    j = _gateway_frames(JGateway, j_stream, J_SCHEMAS, body)
    assert p == j
    assert p[0] == len(LINES) - 1 and p[1] == 3
    assert sum(len(f) for f in p[2].values()) > 0


def _fill(builder_cls, schemas, i, n=6):
    """One batch of containers: counter, gauge and histogram samples."""
    b = builder_cls(schemas)
    buckets = (PBuckets if builder_cls is PBuilder else JBuckets)(
        (0.1, 1.0, float("inf")))
    t0 = 1_600_000_000_000 + i * 60_000
    for r in range(n):
        b.add_sample("prom-histogram",
                     {"_metric_": "lat", "_ws_": "demo", "_ns_": "App-0",
                      "job": f"j{i % 2}"},
                     t0 + r * 10_000, 0.5 * r, float(3 * r),
                     (buckets, np.array([r, 2 * r, 3 * r], np.float64)))
        b.add_sample("prom-counter",
                     {"_metric_": "req_total", "_ws_": "demo",
                      "_ns_": "App-0", "instance": f"i{i % 3}"},
                     t0 + r * 10_000, float(i * 100 + r) + 0.1)
        b.add_sample("gauge",
                     {"_metric_": "heap", "_ws_": "demo", "_ns_": "App-0",
                      "host": f"h{i % 2}"},
                     t0 + r * 10_000, -float(r) / 3.0)
    return b.containers()


def _write_log(stream_mod, builder_cls, schemas, path, batches=5):
    s = stream_mod.LogIngestionStream(path, schemas, group_commit_s=0.0)
    for i in range(batches):
        for c in _fill(builder_cls, schemas, i):
            s.append(c)
    recs = list(s._records)
    s.close()
    return recs


def test_stream_frames_are_byte_identical(tmp_path):
    pp, jp = str(tmp_path / "p.log"), str(tmp_path / "j.log")
    precs = _write_log(p_stream, PBuilder, P_SCHEMAS, pp)
    jrecs = _write_log(j_stream, JBuilder, J_SCHEMAS, jp)
    assert len(precs) == len(jrecs) > 5
    with open(pp, "rb") as f1, open(jp, "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_stream(tmp_path, writer):
    path = str(tmp_path / "stream.log")
    if writer == "port":
        _write_log(p_stream, PBuilder, P_SCHEMAS, path)
    else:
        _write_log(j_stream, JBuilder, J_SCHEMAS, path)
    ps = p_stream.LogIngestionStream(path, P_SCHEMAS)
    js = j_stream.LogIngestionStream(path, J_SCHEMAS)
    try:
        assert ps.end_offset() == js.end_offset() > 0
        got_p = [(sd.offset, p_stream.encode_container(sd.container))
                 for sd in ps.read(0, 1000)]
        got_j = [(sd.offset, j_stream.encode_container(sd.container))
                 for sd in js.read(0, 1000)]
        assert got_p == got_j
        assert [o for o, _ in got_p] == list(range(len(got_p)))
    finally:
        ps.close()
        js.close()


def _flip(path, pos, mask=0x01):
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ mask]))


def _sidecars(path, integrity):
    qdir = integrity.quarantine_dir(path)
    out = {}
    for name in sorted(os.listdir(qdir)):
        if name.endswith(".bad"):
            with open(os.path.join(qdir, name), "rb") as f:
                out[name] = f.read()
    return out


DAMAGE = ["bitflip", "torn-tail", "bitflip-and-torn-tail"]


@pytest.mark.parametrize("damage", DAMAGE)
def test_damaged_streams_are_quarantined_alike(tmp_path, damage):
    src = str(tmp_path / "src.log")
    recs = _write_log(p_stream, PBuilder, P_SCHEMAS, src)
    if "bitflip" in damage:
        victim = recs[2]
        _flip(src, victim.payload_off + victim.payload_len // 2)
    if "torn" in damage:
        with open(src, "ab") as f:
            f.write(p_integrity.encode_frame(b"x" * 64)[:20])
    out = {}
    for name, mod, integ, schemas in (
            ("port", p_stream, p_integrity, P_SCHEMAS),
            ("jax", j_stream, j_integrity, J_SCHEMAS)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "stream.log")
        shutil.copy(src, path)
        s = mod.LogIngestionStream(path, schemas)
        got = [(sd.offset, mod.encode_container(sd.container))
               for sd in s.read(0, 1000)]
        out[name] = (got, s.quarantined_records(), s.quarantined_bytes(),
                     s.tail_state(), _sidecars(path, integ)
                     if "bitflip" in damage else {})
        s.close()
    assert out["port"] == out["jax"]
    got, quarantined, _, tail, _ = out["port"]
    assert quarantined == (1 if "bitflip" in damage else 0)
    assert len(got) == len(recs) - quarantined
    assert tail == ("torn" if "torn" in damage else "clean")


def _recover(pkg, tmp_path, src_stream):
    """Run one package's driver over the stream with a flush every 4
    records (stopping without a final flush, as a crash would), then
    recover a fresh shard from the column store; return the first run's
    checkpoints and the recovery's (offset, part keys) ingests, status
    events and end offsets."""
    if pkg == "port":
        Shard, Store, Stream, Driver, Mapper, Ref, schemas = (
            PShard, PStore, p_stream.LogIngestionStream, PDriver, PMapper,
            PRef, P_SCHEMAS)
    else:
        Shard, Store, Stream, Driver, Mapper, Ref, schemas = (
            JShard, JStore, j_stream.LogIngestionStream, JDriver, JMapper,
            JRef, J_SCHEMAS)
    root = tmp_path / pkg
    root.mkdir()
    path = str(root / "stream.log")
    shutil.copy(src_stream, path)
    ref = Ref("timeseries")

    def shard_and_driver(log):
        store = Store(str(root / "data"))
        shard = Shard(ref, schemas, 0, num_groups=2, max_chunk_rows=8,
                      column_store=store)
        shard.bootstrap_from_store()
        orig = shard.ingest

        def ingest(container, offset=-1):
            log.append((offset, sorted({pk.to_bytes()
                                        for pk in container.part_keys})))
            return orig(container, offset)
        shard.ingest = ingest
        stream = Stream(path, schemas)
        events = []
        drv = Driver(shard, stream, mapper=Mapper(1),
                     flush_every_records=4, flush_interval_s=3600.0,
                     poll_interval_s=0.005,
                     on_event=lambda *e: events.append(
                         (e[0], e[1].value, e[2])))
        return shard, stream, drv, events

    def run(drv, stream):
        drv.start()
        deadline = time.monotonic() + 30
        while drv.next_offset < stream.end_offset() \
                or drv.recovered_to < 0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        drv.stop(flush=False)
        stream.close()

    first_log = []
    shard, stream, drv, _ = shard_and_driver(first_log)
    run(drv, stream)
    checkpoints = dict(shard.checkpoints)
    log = []
    shard, stream, drv, events = shard_and_driver(log)
    watermark = shard.recovery_watermark()
    run(drv, stream)
    series = {}
    for pk, part in sorted(shard._by_part_key.items()):
        p = shard.partitions[part]
        shard._ensure_loaded(p)
        ts, vals, _ = p.read_full(1)
        series[pk] = (np.asarray(ts).tolist(), np.asarray(vals).tolist())
    return {"checkpoints": checkpoints, "watermark": watermark,
            "replayed": log, "events": events,
            "recovered_to": drv.recovered_to, "next": drv.next_offset,
            "series": series}


def test_driver_recovery_replays_the_same_offsets_as_the_jax_driver(
        tmp_path):
    src = str(tmp_path / "src.log")
    n = len(_write_log(p_stream, PBuilder, P_SCHEMAS, src, batches=7))
    p = _recover("port", tmp_path, src)
    j = _recover("jax", tmp_path, src)
    assert p == j
    # the first run flushed on its record cadence and left checkpoints;
    # recovery replayed from the lower one to the end of the log
    assert p["watermark"] >= 0
    assert [o for o, _ in p["replayed"]] == list(
        range(p["watermark"] + 1, n))
    assert p["recovered_to"] == p["next"] == n
    assert p["events"][-1][1] == "active"
    # every sample of the log is in the recovered shard: 7 batches of 6
    # histogram, counter and gauge rows
    assert sum(len(ts) for ts, _ in p["series"].values()) == 7 * 6 * 3
