"""Admin + PromQL CLI of the port (the counterpart of ``filodb_tpu.cli``;
cli/src/main/scala/filodb.cli/CliMain.scala:159-266).

Commands mirror the reference's surface, talking to a running server over
its HTTP API (the reference talks Akka to a cluster; the control plane
here is HTTP), plus local offline debug commands for the binary formats:

  status          shard status of a dataset          (CliMain `status`)
  labels          label names                        (`labels`)
  labelvalues     values of one label                (`labelvalues`)
  timeseries-metadata  series key sets for a filter  (`timeseriesMetadata`)
  query           PromQL instant query               (`timeseries query`)
  query-range     PromQL range query
  tscard          cardinality records by prefix      (`tscard`)
  topkcard        heaviest children of a prefix      (`topkcardlocal`)
  find-query-shards    shards a shard key maps to    (`findqueryshards`)
  validate-schemas     check the built-in schema set (`validateSchemas`)
  decode-vector        hex/b64 BinaryVector -> values (`decodeVector`)
  decode-chunk-info    chunk metadata of a log file  (`decodeChunkInfo`)

The server may be a standalone node or a supervisor's public port.

Usage: python -m filodb_tpu_torch.cli <command> [--host URL] [args...]
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import urllib.parse
import urllib.request


def _get(host: str, path: str, **params):
    qs = urllib.parse.urlencode(
        {k: v for k, v in params.items() if v is not None}, doseq=True)
    url = host.rstrip("/") + path + (f"?{qs}" if qs else "")
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _print_json(obj) -> None:
    print(json.dumps(obj, indent=2, sort_keys=True))


def cmd_status(a):
    _print_json(_get(a.host, f"/api/v1/cluster/{a.dataset}/status"))


def cmd_labels(a):
    _print_json(_get(a.host, f"/promql/{a.dataset}/api/v1/labels",
                     **{"match[]": a.match} if a.match else {}))


def cmd_labelvalues(a):
    _print_json(_get(
        a.host, f"/promql/{a.dataset}/api/v1/label/{a.label}/values",
        **{"match[]": a.match} if a.match else {}))


def cmd_series(a):
    _print_json(_get(a.host, f"/promql/{a.dataset}/api/v1/series",
                     **{"match[]": a.match}))


def cmd_query(a):
    _print_json(_get(a.host, f"/promql/{a.dataset}/api/v1/query",
                     query=a.promql, time=a.time))


def cmd_query_range(a):
    _print_json(_get(a.host, f"/promql/{a.dataset}/api/v1/query_range",
                     query=a.promql, start=a.start, end=a.end,
                     step=a.step))


def cmd_tscard(a):
    _print_json(_get(a.host, f"/api/v1/cardinality/{a.dataset}",
                     prefix=a.prefix, depth=a.depth))


def cmd_topkcard(a):
    body = _get(a.host, f"/api/v1/cardinality/{a.dataset}",
                prefix=a.prefix,
                depth=len([p for p in (a.prefix or "").split(",")
                           if p]) + 1)
    recs = sorted(body.get("data", []), key=lambda r: -r["tsCount"])
    _print_json(recs[: a.k])


def cmd_find_query_shards(a):
    from filodb_tpu_torch.core.record import query_shards, shard_key_hash
    values = [v for v in a.shard_key_values.split(",") if v]
    skh = shard_key_hash(values, a.metric)
    shards = query_shards(skh, a.spread, a.num_shards)
    print(json.dumps({"shardKeyHash": skh, "shards": shards}))


def cmd_validate_schemas(a):
    """(Schemas.__post_init__ rejects hash clashes at load; this surfaces
    the registered set + ids like the reference's validateSchemas.)"""
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    out = {s.name: s.schema_id
           for s in DEFAULT_SCHEMAS.schemas.values()}
    print(json.dumps({"schemas": out, "ok": True}, sort_keys=True))


def _read_blob(arg: str) -> bytes:
    if arg.startswith("hex:"):
        return bytes.fromhex(arg[4:])
    if arg.startswith("b64:"):
        return base64.b64decode(arg[4:])
    with open(arg, "rb") as f:
        return f.read()


def cmd_decode_vector(a):
    from filodb_tpu_torch.memory import histogram as bh
    from filodb_tpu_torch.memory import vectors as bv
    buf = _read_blob(a.blob)
    if buf[:1] in (bytes([bh.K_HIST_2D]), bytes([bh.K_HIST_SECT])):
        scheme, counter, rows, drops = bh.decode_histograms_full(buf)
        print(json.dumps({
            "kind": "histogram", "counter": counter,
            "les": [float(x) for x in scheme.les()],
            "numRows": int(rows.shape[0]),
            "dropRows": None if drops is None else drops.tolist(),
            "rows": rows.tolist()[: a.limit]}))
        return
    vals = bv.decode(buf)
    print(json.dumps({"kind": "vector", "numValues": int(vals.size),
                      "values": vals.tolist()[: a.limit]}))


def cmd_decode_chunk_info(a):
    """Chunk metadata from a FlatFileColumnStore chunks.log."""
    from filodb_tpu_torch.store.columnstore import FlatFileColumnStore
    cs = FlatFileColumnStore(a.data_dir)
    out = []
    for e in cs.scan_part_keys(a.dataset, a.shard):
        for c in cs.read_chunks(a.dataset, a.shard, e.part_key):
            out.append({
                "chunkId": c.chunk_id, "numRows": c.num_rows,
                "startTime": c.start_ts, "endTime": c.end_ts,
                "vectorBytes": [len(v) for v in c.vectors]})
            if len(out) >= a.limit:
                break
        if len(out) >= a.limit:
            break
    _print_json(out)


def main(argv=None) -> int:
    # --host/--dataset are accepted both before AND after the subcommand
    # (the docstring shows the latter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--host", default="http://127.0.0.1:8080")
    common.add_argument("--dataset", default="timeseries")
    # the subparser copy must NOT re-apply defaults, or an unset
    # post-command --host would clobber a pre-command one
    sub_common = argparse.ArgumentParser(add_help=False)
    sub_common.add_argument("--host", default=argparse.SUPPRESS)
    sub_common.add_argument("--dataset", default=argparse.SUPPRESS)
    p = argparse.ArgumentParser(prog="filodb-torch-cli", description=__doc__,
                                parents=[common])
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name):
        return sub.add_parser(name, parents=[sub_common])

    add("status").set_defaults(fn=cmd_status)
    sp = add("labels")
    sp.add_argument("--match", action="append")
    sp.set_defaults(fn=cmd_labels)
    sp = add("labelvalues")
    sp.add_argument("label")
    sp.add_argument("--match", action="append")
    sp.set_defaults(fn=cmd_labelvalues)
    sp = add("timeseries-metadata")
    sp.add_argument("match", nargs="+")
    sp.set_defaults(fn=cmd_series)
    sp = add("query")
    sp.add_argument("promql")
    sp.add_argument("--time", type=int)
    sp.set_defaults(fn=cmd_query)
    sp = add("query-range")
    sp.add_argument("promql")
    sp.add_argument("--start", type=int, required=True)
    sp.add_argument("--end", type=int, required=True)
    sp.add_argument("--step", type=int, default=60)
    sp.set_defaults(fn=cmd_query_range)
    sp = add("tscard")
    sp.add_argument("--prefix", default="")
    sp.add_argument("--depth", type=int)
    sp.set_defaults(fn=cmd_tscard)
    sp = add("topkcard")
    sp.add_argument("--prefix", default="")
    sp.add_argument("-k", type=int, default=10)
    sp.set_defaults(fn=cmd_topkcard)
    sp = add("find-query-shards")
    sp.add_argument("shard_key_values",
                    help="comma-separated non-metric shard key values")
    sp.add_argument("metric")
    sp.add_argument("--spread", type=int, default=1)
    sp.add_argument("--num-shards", type=int, default=4)
    sp.set_defaults(fn=cmd_find_query_shards)
    add("validate-schemas").set_defaults(
        fn=cmd_validate_schemas)
    sp = add("decode-vector")
    sp.add_argument("blob", help="file path, hex:<hex>, or b64:<base64>")
    sp.add_argument("--limit", type=int, default=50)
    sp.set_defaults(fn=cmd_decode_vector)
    sp = add("decode-chunk-info")
    sp.add_argument("data_dir")
    sp.add_argument("--shard", type=int, default=0)
    sp.add_argument("--limit", type=int, default=20)
    sp.set_defaults(fn=cmd_decode_chunk_info)

    a = p.parse_args(argv)
    a.fn(a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
