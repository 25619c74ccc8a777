"""Prometheus HTTP API JSON response shapes.

(Reference: query/PromQueryResponse.scala + PromCirceSupport — the
`{"status": "success", "data": {"resultType": ..., "result": [...]}}`
envelope; NaN serialization follows the reference's remote-read behavior
of stringified values, and absent samples are omitted from matrices like
Prometheus does.)"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List

import numpy as np

from filodb_tpu_torch.query.model import GridResult, ScalarResult


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


# shortest-roundtrip float texts memoized across requests: metric
# streams repeat values heavily (constant rates, integer gauges), and a
# dict hit is ~10x cheaper than repr. Bounded by reset; no lock — a
# lost race just recomputes the same string (CPython dict ops are
# atomic; values are pure functions of the key).
_FMT_MEMO: Dict[float, str] = {}
_FMT_MEMO_MAX = 65536


def _fmt_row(steps_s: np.ndarray, row: np.ndarray, ok: np.ndarray
             ) -> List[List]:
    """Vectorized [ts, "value"] pairs for one matrix row (the serving
    fast path's JSON encode: per-element math.isnan/isinf checks in
    Python dominated the encode cost). ``tolist()`` converts in C; the
    per-element ``repr`` of a Python float is the same shortest-roundtrip
    text ``_fmt`` produces; rows with infinities (rare) fall back to
    ``_fmt`` for the +Inf/-Inf spellings."""
    vals = row[ok]
    ts = steps_s[ok].tolist()
    if np.isinf(vals).any():
        return [[t, _fmt(v)] for t, v in zip(ts, vals.tolist())]
    memo = _FMT_MEMO
    if len(memo) > _FMT_MEMO_MAX:
        memo.clear()
    out = []
    for t, v in zip(ts, vals.tolist()):
        s = memo.get(v)
        if s is None:
            memo[v] = s = repr(v)
        out.append([t, s])
    return out


def success(data: Any) -> Dict:
    return {"status": "success", "data": data}


def error(message: str, error_type: str = "bad_data",
          status: str = "error") -> Dict:
    return {"status": status, "errorType": error_type, "error": message}


class PreEncoded:
    """Response payload already serialized to JSON bytes (the serving
    fast path skips the dict -> json.dumps walk for bulk matrix data);
    the HTTP edge sends ``body`` verbatim with ``ctype``."""

    __slots__ = ("body", "ctype")

    def __init__(self, body: bytes,
                 ctype: str = "application/json"):
        self.body = body
        self.ctype = ctype


# timestamps repeat across queries (step grids) and values repeat across
# steps (constant rates, integer gauges): memoized fragments make the
# bulk encode mostly dict lookups. Unlocked by design — racing writers
# recompute identical strings (CPython dict ops are atomic).
_TS_MEMO: Dict[float, str] = {}


def _ts_frag(t: float) -> str:
    s = _TS_MEMO.get(t)
    if s is None:
        if len(_TS_MEMO) > _FMT_MEMO_MAX:
            _TS_MEMO.clear()
        _TS_MEMO[t] = s = repr(t)
    return s


def matrix_bytes(grid: GridResult, stats_json: Dict,
                 warnings=None, partial: bool = False,
                 rows_memo=None) -> PreEncoded:
    """Serving fast path: a range-query matrix response encoded straight
    to JSON bytes. Byte-identical to ``json.dumps(matrix(grid)
    [+stats/degraded], separators=(",", ":"))`` — pinned by
    tests/test_http_e2e-style golden comparisons in test_plancache.

    Only the plain scalar-matrix shape takes this path (histogram wire
    and scalar results keep the dict path).

    ``rows_memo`` is a results-cache handle (``.get() -> str|None``,
    ``.put(text)``) present only on a FULL hit: the rendered result-row
    text is a pure function of the (immutable) cached extent and the
    range, so repeat hits splice the memoized rows and re-encode only
    the per-request stats tail; stored text is charged against the
    cache's byte budget. Racing writers store identical strings."""
    joined = None
    if rows_memo is not None:
        joined = rows_memo.get()
    if joined is None:
        rows: List[tuple] = []
        steps_s = grid.steps / 1000.0
        memo = _FMT_MEMO
        if len(memo) > _FMT_MEMO_MAX:
            memo.clear()
        for i, key in enumerate(grid.keys):
            row = grid.values[i]
            ok = ~np.isnan(row)
            if not ok.any():
                continue
            vals = row[ok]
            ts = steps_s[ok].tolist()
            metric = json.dumps(_metric(key), sort_keys=True,
                                separators=(",", ":"))
            if np.isinf(vals).any():
                frags = [f'[{_ts_frag(t)},"{_fmt(v)}"]'
                         for t, v in zip(ts, vals.tolist())]
            else:
                frags = []
                for t, v in zip(ts, vals.tolist()):
                    s = memo.get(v)
                    if s is None:
                        memo[v] = s = repr(v)
                    frags.append(f'[{_ts_frag(t)},"{s}"]')
            rows.append((metric, '{"metric":%s,"values":[%s]}'
                         % (metric, ",".join(frags))))
        # deterministic series order (sorted by the encoded metric):
        # responses are a pure function of the data, not of scan /
        # ingest / peer-merge order — the property that makes
        # single-worker and N-worker serving byte-identical
        rows.sort(key=lambda kv: kv[0])
        joined = ",".join(txt for _, txt in rows)
        if rows_memo is not None:
            rows_memo.put(joined)
    tail = ',"stats":' + json.dumps(stats_json, separators=(",", ":"))
    if warnings:
        tail += ',"warnings":' + json.dumps(sorted(set(warnings)),
                                            separators=(",", ":"))
    if partial:
        tail += ',"partial":true'
    body = ('{"status":"success","data":{"resultType":"matrix",'
            '"result":[' + joined + "]}" + tail + "}")
    return PreEncoded(body.encode())


def matrix(grid: GridResult, hist_wire: bool = False) -> Dict:
    """Range-query result as resultType=matrix; NaN steps are omitted
    (Prometheus staleness: absent sample, not NaN).

    ``hist_wire`` (internal cluster dispatch only) attaches native
    histogram rows as base64 [T, NB] blocks so a forwarded query keeps
    bucket data that the plain text format cannot carry."""
    result: List[Dict] = []
    steps_s = grid.steps / 1000.0
    for i, key in enumerate(grid.keys):
        row = grid.values[i]
        ok = ~np.isnan(row)
        entry = None
        if ok.any():
            values = _fmt_row(steps_s, row, ok)
            entry = {"metric": _metric(key), "values": values}
        if hist_wire and grid.is_hist():
            import base64
            hv = np.ascontiguousarray(grid.hist_values[i],
                                      dtype=np.float64)
            entry = entry or {"metric": _metric(key), "values": []}
            entry["hist"] = {
                "les": [float(x) for x in np.asarray(grid.bucket_les)],
                "values": base64.b64encode(hv.tobytes()).decode(),
            }
        if entry is not None:
            result.append(entry)
    result.sort(key=_entry_order)       # deterministic series order
    return success({"resultType": "matrix", "result": result})


def vector(grid: GridResult) -> Dict:
    """Instant-query result (single step) as resultType=vector."""
    result: List[Dict] = []
    t = float(grid.steps[-1]) / 1000.0 if grid.steps.size else 0.0
    for i, key in enumerate(grid.keys):
        v = grid.values[i, -1] if grid.values.size else np.nan
        if np.isnan(v):
            continue
        result.append({"metric": _metric(key), "value": [t, _fmt(v)]})
    result.sort(key=_entry_order)       # deterministic series order
    return success({"resultType": "vector", "result": result})


def scalar(res: ScalarResult, instant: bool) -> Dict:
    if instant:
        t = float(res.steps[-1]) / 1000.0
        return success({"resultType": "scalar",
                        "result": [t, _fmt(res.values[-1])]})
    values = [[float(t) / 1000.0, _fmt(v)]
              for t, v in zip(res.steps, res.values)]
    return success({"resultType": "matrix",
                    "result": [{"metric": {}, "values": values}]})


def attach_degraded(out: Dict, res, stats=None) -> Dict:
    """Surface degraded-mode markers on a response envelope: union of
    grid- and stats-level warnings in ``warnings`` plus a top-level
    ``"partial": true`` when any shard group was dropped (the
    Thanos/M3 partial-response shape)."""
    warnings = list(getattr(stats, "warnings", ()) or ())
    partial = bool(getattr(stats, "partial", False))
    if isinstance(res, GridResult):
        warnings.extend(res.warnings)
        partial = partial or res.partial
    if warnings:
        out["warnings"] = sorted(set(warnings))
    if partial:
        out["partial"] = True
    return out


def _entry_order(entry: Dict) -> str:
    """Sort key for result entries: the canonically-encoded metric.
    Both encode paths (dict tree and pre-encoded bytes) order series by
    it, so a response is a pure function of its data — single-worker
    and N-worker topologies answer byte-identically even though their
    scan/peer-merge orders differ."""
    return json.dumps(entry["metric"], sort_keys=True,
                      separators=(",", ":"))


def _metric(key: Dict[str, str]) -> Dict[str, str]:
    # sorted OUTPUT label order: the JSON text of a metric (and
    # therefore the _entry_order sort key and the matrix_bytes
    # fragments) is stable regardless of the label-map construction
    # order upstream, and insertion-order json.dumps matches
    # sort_keys=True exactly
    return dict(sorted(("__name__" if k == "_metric_" else k, v)
                       for k, v in key.items()))
