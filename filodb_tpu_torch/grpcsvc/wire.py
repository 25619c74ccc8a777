"""Protobuf wire codecs for the gRPC query service (the counterpart of
``filodb_tpu.grpcsvc.wire``: every encoder gives the same bytes, so a
port node and a JAX node read each other's frames).

This fills the role of the reference's grpc/src/main/protobuf
(query_service.proto Request/Response, range_vector.proto
SerializedRangeVector) but defines its OWN message schema — the field
layout below is not interoperable with the reference service; only the
protobuf encoding primitives (the same varint / length-delimited field
encoding protoc emits, reused from the remote-read implementation) are
shared. Sample columns ride NibblePack (memory/format/NibblePack.scala
semantics — delta-packed sorted timestamps, XOR-packed doubles),
typically 2-6x smaller than the base64-JSON control-plane wire they
replace.

Messages (field numbers):
  Filter        {1: label, 2: op, 3: value}
  RawRequest    {1: dataset, 2: Filter*, 3: start_ms, 4: end_ms,
                 5: column, 6: shards packed, 7: span_snap,
                 8: deadline_ms (caller's remaining budget; 0 = none),
                 9: trace ctx "trace_id-parent_span-1" (absent = untraced),
                 10: tenant (QoS budget inheritance; absent = default),
                 11: priority class (absent = interactive)}
  SnapKey       {1: node, 2: ds, 3: shard, 4: part, 5: num_chunks,
                 6: col, 7: start_ms, 8: end_ms}
  Srv           {1: label entry {1:k,2:v}*, 2: n, 3: ts nibble,
                 4: vals nibble, 5: is_counter, 6: nb, 7: les f64le,
                 8: drops nibble, 9: chunk_len+1, 10: SnapKey}
  RawResponse   {1: Srv*, 2: error,
                 3: trace spans (JSON list; present only when traced)}
  ExecRequest   {1: dataset, 2: query, 3: start_ms, 4: step_ms,
                 5: end_ms, 6: local_only, 7: hist_wire,
                 9: deadline_ms (caller's remaining budget; 0 = none),
                 10: trace ctx "trace_id-parent_span-1",
                 11: no_cache (results-cache bypass propagation),
                 12: expect_shards packed (stale-routing guard on
                 local_only pushdown hops),
                 13: tenant (QoS budget inheritance; absent = default),
                 14: priority class (absent = interactive)}
  ExecSeries    {1: label entry*, 2: values nibble (grid-aligned,
                 NaN where absent), 3: hist nibble flat, 4: nb}
  ExecResponse  {1: ExecSeries*, 2: error, 3: steps nibble,
                 4: series_scanned, 5: samples_scanned,
                 6: les f64le, 7: scalar flag, 8: partial flag,
                 9: warning string*,
                 10: trace spans (JSON list; present only when traced)}

The trace fields carry the Dapper-style propagated context (obs/trace):
the caller forwards its trace id + parent span id; the peer records its
spans under that parent and ships them back, so the entry node's
recorder holds ONE stitched trace across the gRPC plane. Span payloads
ride as JSON — they exist only on sampled traces, so wire compactness
is irrelevant next to the NibblePack sample columns.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.http.remote_read import (_fields, _ld,
                                               _read_uvarint, _signed,
                                               _uvarint, _vi)
from filodb_tpu_torch.memory import nibblepack as np_codec
from filodb_tpu_torch.query.model import RawSeries


def _pack_i64(vals: np.ndarray) -> bytes:
    """NibblePack a sorted/monotone-friendly int64 column (delta)."""
    out = bytearray()
    np_codec.pack_delta([int(v) for v in np.asarray(vals, np.int64)], out)
    return bytes(out)


def _unpack_i64(buf: bytes, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int64)
    vals, _ = np_codec.unpack_delta(buf, 0, n)
    return np.asarray(vals, np.int64)


def _pack_f64(vals: np.ndarray) -> bytes:
    out = bytearray()
    np_codec.pack_doubles(np.asarray(vals, np.float64).ravel(), out)
    return bytes(out)


def _unpack_f64(buf: bytes, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.float64)
    vals, _ = np_codec.unpack_double_xor(buf, 0, n)
    return np.asarray(vals, np.float64)


def _labels_enc(labels: Dict[str, str]) -> bytes:
    out = bytearray()
    for k, v in labels.items():
        entry = _ld(1, k.encode()) + _ld(2, v.encode())
        out += _ld(1, entry)
    return bytes(out)


def _entry_dec(buf: bytes) -> Tuple[str, str]:
    k = v = ""
    for f, _, val in _fields(buf):
        if f == 1:
            k = val.decode()
        elif f == 2:
            v = val.decode()
    return k, v


# -- RawRequest --------------------------------------------------------------

def encode_raw_request(dataset: str, filters, start_ms: int, end_ms: int,
                       column: Optional[str],
                       shards: Optional[Sequence[int]],
                       span_snap: bool = True,
                       deadline_ms: int = 0,
                       trace_ctx: str = "",
                       tenant: str = "",
                       priority: int = 0) -> bytes:
    out = bytearray(_ld(1, dataset.encode()))
    for f in filters:
        out += _ld(2, _ld(1, f.label.encode()) + _ld(2, f.op.encode())
                   + _ld(3, f.value.encode()))
    out += _vi(3, int(start_ms)) + _vi(4, int(end_ms))
    if column:
        out += _ld(5, column.encode())
    if shards is not None:
        out += _ld(6, b"".join(_uvarint(int(s)) for s in shards))
    out += _vi(7, 1 if span_snap else 0)
    if deadline_ms > 0:
        out += _vi(8, int(deadline_ms))
    if trace_ctx:
        out += _ld(9, trace_ctx.encode())
    if tenant:
        out += _ld(10, tenant.encode())
    if priority:
        out += _vi(11, int(priority))
    return bytes(out)


def decode_raw_request(buf: bytes) -> Dict:
    from filodb_tpu_torch.core.index import ColumnFilter
    req = {"dataset": "", "filters": [], "start_ms": 0, "end_ms": 0,
           "column": None, "shards": None, "span_snap": True,
           "deadline_ms": 0, "trace": "", "tenant": "", "priority": 0}
    for f, _, v in _fields(buf):
        if f == 1:
            req["dataset"] = v.decode()
        elif f == 2:
            lbl = op = val = ""
            for ff, _, vv in _fields(v):
                if ff == 1:
                    lbl = vv.decode()
                elif ff == 2:
                    op = vv.decode()
                elif ff == 3:
                    val = vv.decode()
            req["filters"].append(ColumnFilter(lbl, op, val))
        elif f == 3:
            req["start_ms"] = _signed(v)
        elif f == 4:
            req["end_ms"] = _signed(v)
        elif f == 5:
            req["column"] = v.decode()
        elif f == 6:
            shards, pos = [], 0
            while pos < len(v):
                s, pos = _read_uvarint(v, pos)
                shards.append(s)
            req["shards"] = shards
        elif f == 7:
            req["span_snap"] = bool(v)
        elif f == 8:
            req["deadline_ms"] = _signed(v)
        elif f == 9:
            req["trace"] = v.decode()
        elif f == 10:
            req["tenant"] = v.decode()
        elif f == 11:
            req["priority"] = _signed(v)
    return req


# -- SerializedRangeVector ---------------------------------------------------

def _snap_enc(snap: Tuple) -> bytes:
    node, ds, shard, part, nchunks, col, start, end = snap
    return (_ld(1, str(node).encode()) + _ld(2, str(ds).encode())
            + _vi(3, int(shard)) + _vi(4, int(part)) + _vi(5, int(nchunks))
            + _vi(6, int(col)) + _vi(7, int(start)) + _vi(8, int(end)))


def _snap_dec(buf: bytes) -> Tuple:
    vals = ["", "", 0, 0, 0, 0, 0, 0]
    for f, _, v in _fields(buf):
        if f in (1, 2):
            vals[f - 1] = v.decode()
        elif 3 <= f <= 8:
            vals[f - 1] = _signed(v)
    return tuple(vals)


def encode_series(s: RawSeries) -> bytes:
    out = bytearray(_labels_enc(dict(s.labels)))
    n = int(s.ts.size)
    out += _vi(2, n)
    if n:
        out += _ld(3, _pack_i64(s.ts))
        out += _ld(4, _pack_f64(s.values))
    out += _vi(5, 1 if s.is_counter else 0)
    if s.values.ndim == 2:
        out += _vi(6, int(s.values.shape[1]))
    if s.bucket_les is not None:
        out += _ld(7, np.asarray(s.bucket_les, "<f8").tobytes())
    if s.hist_drop_rows is not None:
        d = np.asarray(s.hist_drop_rows, np.int64)
        out += _ld(8, _uvarint(d.size) + _pack_i64(d))
    if s.chunk_len >= 0:
        out += _vi(9, int(s.chunk_len) + 1)
    if s.snapshot_key is not None:
        out += _ld(10, _snap_enc(s.snapshot_key))
    return bytes(out)


def decode_series(buf: bytes) -> RawSeries:
    labels: Dict[str, str] = {}
    n = 0
    ts_b = vals_b = b""
    is_counter = False
    nb = 0
    les = None
    drops_b = None
    chunk_len = -1
    snap = None
    for f, _, v in _fields(buf):
        if f == 1:
            k, val = _entry_dec(v)
            labels[k] = val
        elif f == 2:
            n = v
        elif f == 3:
            ts_b = v
        elif f == 4:
            vals_b = v
        elif f == 5:
            is_counter = bool(v)
        elif f == 6:
            nb = v
        elif f == 7:
            les = np.frombuffer(v, "<f8")
        elif f == 8:
            drops_b = v
        elif f == 9:
            chunk_len = v - 1
        elif f == 10:
            snap = _snap_dec(v)
    ts = _unpack_i64(ts_b, n)
    total = n * nb if nb else n
    vals = _unpack_f64(vals_b, total)
    if nb:
        vals = vals.reshape(n, nb)
    drops = None
    if drops_b is not None:
        nd, pos = _read_uvarint(drops_b, 0)
        drops = _unpack_i64(drops_b[pos:], nd)
    return RawSeries(labels=labels, ts=ts, values=vals,
                     is_counter=is_counter, bucket_les=les,
                     hist_drop_rows=drops, snapshot_key=snap,
                     chunk_len=chunk_len)


def encode_raw_response(series: Sequence[RawSeries],
                        error: str = "",
                        trace_spans: bytes = b"") -> bytes:
    out = bytearray()
    for s in series:
        out += _ld(1, encode_series(s))
    if error:
        out += _ld(2, error.encode())
    if trace_spans:
        out += _ld(3, trace_spans)
    return bytes(out)


def decode_raw_response(buf: bytes):
    """-> (series, error, trace_spans_bytes)."""
    series: List[RawSeries] = []
    error = ""
    trace_spans = b""
    for f, _, v in _fields(buf):
        if f == 1:
            series.append(decode_series(v))
        elif f == 2:
            error = v.decode()
        elif f == 3:
            trace_spans = v
    return series, error, trace_spans


# -- Exec (whole-query pushdown / federation) --------------------------------

def encode_exec_request(dataset: str, query: str, start_ms: int,
                        step_ms: int, end_ms: int,
                        local_only: bool = True,
                        plan_wire: bytes = b"",
                        deadline_ms: int = 0,
                        trace_ctx: str = "",
                        no_cache: bool = False,
                        expect_shards=None,
                        tenant: str = "",
                        priority: int = 0) -> bytes:
    """Field 8 carries a STRUCTURAL LogicalPlan tree (query.planwire) —
    the reference's exec_plan.proto capability; the printed query text
    stays alongside for debuggability and older peers. Field 9 carries
    the caller's remaining deadline budget in ms (server-side deadline
    propagation; 0/absent = none). Field 10 carries the propagated
    trace context (absent = untraced). Field 11 propagates the caller's
    results-cache bypass (&cache=false) so the peer skips its cache.
    Field 12 (packed uvarints) names the shards the caller expects the
    peer to serve on a local_only hop — the peer bounces stale_routing
    instead of silently evaluating over a subset after a handoff."""
    out = (_ld(1, dataset.encode()) + _ld(2, query.encode())
           + _vi(3, int(start_ms)) + _vi(4, int(step_ms))
           + _vi(5, int(end_ms)) + _vi(6, 1 if local_only else 0))
    if plan_wire:
        out += _ld(8, plan_wire)
    if deadline_ms > 0:
        out += _vi(9, int(deadline_ms))
    if trace_ctx:
        out += _ld(10, trace_ctx.encode())
    if no_cache:
        out += _vi(11, 1)
    if expect_shards:
        out += _ld(12, b"".join(_uvarint(int(s))
                                for s in expect_shards))
    if tenant:
        out += _ld(13, tenant.encode())
    if priority:
        out += _vi(14, int(priority))
    return out


def decode_exec_request(buf: bytes) -> Dict:
    req = {"dataset": "", "query": "", "start_ms": 0, "step_ms": 0,
           "end_ms": 0, "local_only": True, "plan_wire": b"",
           "deadline_ms": 0, "trace": "", "no_cache": False,
           "expect_shards": None, "tenant": "", "priority": 0}
    for f, _, v in _fields(buf):
        if f == 1:
            req["dataset"] = v.decode()
        elif f == 2:
            req["query"] = v.decode()
        elif f == 3:
            req["start_ms"] = _signed(v)
        elif f == 4:
            req["step_ms"] = _signed(v)
        elif f == 5:
            req["end_ms"] = _signed(v)
        elif f == 6:
            req["local_only"] = bool(v)
        elif f == 8:
            req["plan_wire"] = v
        elif f == 9:
            req["deadline_ms"] = _signed(v)
        elif f == 10:
            req["trace"] = v.decode()
        elif f == 11:
            req["no_cache"] = bool(v)
        elif f == 12:
            shards, pos = [], 0
            while pos < len(v):
                s, pos = _read_uvarint(v, pos)
                shards.append(s)
            req["expect_shards"] = shards
        elif f == 13:
            req["tenant"] = v.decode()
        elif f == 14:
            req["priority"] = _signed(v)
    return req


def encode_exec_response(grid, stats=None, error: str = "",
                         trace_spans: bytes = b"") -> bytes:
    """GridResult -> ExecResponse (grid-aligned nibble-packed rows)."""
    out = bytearray()
    if error:
        out += _ld(2, error.encode())
        if trace_spans:
            out += _ld(10, trace_spans)
        return bytes(out)
    steps = np.asarray(grid.steps, np.int64)
    out += _ld(3, _uvarint(steps.size) + _pack_i64(steps))
    nb = 0
    if grid.hist_values is not None and grid.bucket_les is not None:
        nb = int(grid.bucket_les.size)
        out += _ld(6, np.asarray(grid.bucket_les, "<f8").tobytes())
    for i, key in enumerate(grid.keys):
        msg = bytearray(_labels_enc(dict(key)))
        msg += _ld(2, _pack_f64(grid.values[i]))
        if nb and grid.hist_values is not None \
                and grid.hist_values[i] is not None:
            msg += _ld(3, _pack_f64(grid.hist_values[i].ravel()))
            msg += _vi(4, nb)
        out += _ld(1, bytes(msg))
    if stats is not None:
        out += _vi(4, int(getattr(stats, "series_scanned", 0)))
        out += _vi(5, int(getattr(stats, "samples_scanned", 0)))
    # degraded-mode provenance (the HTTP plane's "partial"/"warnings"
    # envelope): union of grid- and stats-level markers so a pushdown
    # peer's degradation survives the binary hop
    partial = bool(getattr(grid, "partial", False)) \
        or bool(getattr(stats, "partial", False))
    warnings = list(getattr(grid, "warnings", ()) or ())
    for w in getattr(stats, "warnings", ()) or ():
        if w not in warnings:
            warnings.append(w)
    if partial:
        out += _vi(8, 1)
    for w in warnings:
        out += _ld(9, str(w).encode())
    if trace_spans:
        out += _ld(10, trace_spans)
    return bytes(out)


def decode_exec_response(buf: bytes):
    """-> (steps i64, keys, values [S,T], hist [S,T,nb]|None, les|None,
    stats dict, error). The peer's trace spans (if any) ride
    ``stats["trace_spans"]`` as raw JSON bytes."""
    steps = np.zeros(0, np.int64)
    rows = []
    les = None
    stats = {"seriesScanned": 0, "samplesScanned": 0,
             "partial": False, "warnings": [], "trace_spans": b""}
    error = ""
    for f, _, v in _fields(buf):
        if f == 3:
            steps = v          # count-prefixed; decoded below
        elif f == 1:
            rows.append(v)
        elif f == 2:
            error = v.decode()
        elif f == 4:
            stats["seriesScanned"] = v
        elif f == 5:
            stats["samplesScanned"] = v
        elif f == 6:
            les = np.frombuffer(v, "<f8")
        elif f == 8:
            stats["partial"] = bool(v)
        elif f == 9:
            stats["warnings"].append(v.decode())
        elif f == 10:
            stats["trace_spans"] = v
    if error:
        return None, [], None, None, None, stats, error
    # nibble streams decode in 8-word groups, so counts ride explicitly
    n, pos = _read_uvarint(steps, 0)
    steps_arr = _unpack_i64(steps[pos:], n) if n else np.zeros(0, np.int64)
    keys, values, hists = [], [], []
    any_hist = False
    for row in rows:
        labels: Dict[str, str] = {}
        vals_b = b""
        hist_b = None
        nb = 0
        for f, _, v in _fields(row):
            if f == 1:
                k, val = _entry_dec(v)
                labels[k] = val
            elif f == 2:
                vals_b = v
            elif f == 3:
                hist_b = v
            elif f == 4:
                nb = v
        keys.append(labels)
        values.append(_unpack_f64(vals_b, n))
        if hist_b is not None and nb:
            any_hist = True
            hists.append(_unpack_f64(hist_b, n * nb).reshape(n, nb))
        else:
            hists.append(None)
    vals = np.vstack(values) if values else np.zeros((0, n))
    hv = None
    if any_hist:
        nb = les.size
        hv = np.stack([h if h is not None
                       else np.full((n, nb), np.nan) for h in hists])
    return steps_arr, keys, vals, hv, les, stats, error
