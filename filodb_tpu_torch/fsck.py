"""Offline durable-file checker/repairer for the storage-integrity rail.

    python -m filodb_tpu_torch.fsck <data-dir> [--json] [--repair] [--quiet]

Walks every durable file under ``<data-dir>`` — WAL segments
(``stream.log``), chunk logs (``chunks.log``), partkey logs
(``partkeys.log``) and checkpoint documents (``checkpoints.json``) —
verifies every frame with the same scanner the online readers use
(store/integrity.py), and prints a per-file report: record counts split
by format (framed vs legacy unframed), corrupt regions with offsets and
reasons, and the tail state.

``--repair`` makes the findings go away the same way the online path
would, but eagerly and including the cases the online path must leave
pending:

  * torn tails are truncated (the bytes are first copied to the
    ``quarantine/`` sidecar — repair never destroys the only copy);
  * corrupt tails (bad bytes with no resync point) are quarantined and
    truncated;
  * corrupt regions MID-log are quarantined and the log is compacted —
    surviving records are rewritten byte-identical (format preserved),
    so replay and ODP indexing walk a clean file;
  * an unverifiable checkpoint is quarantined and removed (replay
    restarts from offset 0, which is safe: chunk/partkey appends
    upsert and re-ingest is idempotent).

Exit status: 0 when every file is clean (or was fully repaired),
1 when findings remain (no ``--repair``), 2 on usage errors.

The import chain is deliberately torch-free so the tool starts fast on
any host with the package installed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from filodb_tpu_torch.ingest.stream import legacy_wal_probe
from filodb_tpu_torch.store import integrity
from filodb_tpu_torch.store.columnstore import (legacy_chunk_probe,
                                          legacy_pk_probe)

# durable file basenames -> (file_kind, legacy probe); checkpoints are
# JSON documents handled separately
_LOG_KINDS = {
    "stream.log": ("wal", legacy_wal_probe),
    "chunks.log": ("chunklog", legacy_chunk_probe),
    "partkeys.log": ("partkeys", legacy_pk_probe),
}
_CKPT_NAME = "checkpoints.json"


def _find_durable_files(root: str) -> List[str]:
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        # never descend into sidecars: quarantined bytes are corrupt
        # by definition and not part of the durable set
        dirnames[:] = [d for d in dirnames if d != "quarantine"]
        for name in sorted(filenames):
            if name in _LOG_KINDS or name == _CKPT_NAME:
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def _check_log(path: str, kind: str, probe) -> Dict:
    with open(path, "rb") as f:
        buf = f.read()
    res = integrity.scan_buffer(buf, probe=probe)
    framed = sum(1 for r in res.records if r.framed)
    report = {
        "path": path, "kind": kind, "size": len(buf),
        "records": {"framed": framed,
                    "legacy": len(res.records) - framed},
        "corrupt_regions": [
            {"offset": c.offset, "length": c.length, "reason": c.reason}
            for c in res.corrupt],
        "tail": {"state": res.tail_state, "offset": res.tail_off,
                 "reason": res.tail_reason},
        "clean": not res.corrupt and res.tail_state == "clean",
    }
    report["_scan"] = res          # for repair; stripped before output
    report["_buf"] = buf
    return report


def _check_checkpoint(path: str) -> Dict:
    with open(path, "rb") as f:
        raw = f.read()
    report = {"path": path, "kind": "checkpoint", "size": len(raw),
              "records": {"framed": 0, "legacy": 0},
              "corrupt_regions": [], "tail": {"state": "clean",
                                              "offset": len(raw),
                                              "reason": ""},
              "clean": True}
    try:
        _, framed = integrity.decode_checkpoint(raw)
        report["records"]["framed" if framed else "legacy"] = 1
    except integrity.FrameError as e:
        report["clean"] = False
        report["corrupt_regions"].append(
            {"offset": 0, "length": len(raw), "reason": e.reason})
    report["_buf"] = raw
    return report


def _repair_log(report: Dict) -> List[str]:
    """Quarantine bad ranges and leave the file containing exactly the
    verified records. Returns human-readable action lines."""
    path, kind = report["path"], report["kind"]
    res = report["_scan"]
    buf = report["_buf"]
    actions: List[str] = []
    for c in res.corrupt:
        integrity.quarantine(path, kind, c.offset,
                             buf[c.offset:c.offset + c.length], c.reason,
                             action="fsck-quarantined")
        actions.append(f"quarantined {c.length} bytes @ {c.offset}: "
                       f"{c.reason}")
    if res.tail_state != "clean":
        tail = buf[res.tail_off:]
        if tail:
            integrity.quarantine(path, kind, res.tail_off, tail,
                                 res.tail_reason or res.tail_state,
                                 action="fsck-truncated")
        actions.append(f"truncated {res.tail_state} tail "
                       f"({len(tail)} bytes @ {res.tail_off})")
    if res.corrupt:
        # compact: rewrite surviving records byte-identical (format
        # preserved) so readers walk a contiguous clean file
        tmp = path + ".fsck-tmp"
        with open(tmp, "wb") as f:
            for r in res.records:
                f.write(buf[r.offset:r.offset + r.length])
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        actions.append(f"compacted: kept {len(res.records)} records")
    elif res.tail_state != "clean":
        os.truncate(path, res.consumed)
    return actions


def _repair_checkpoint(report: Dict) -> List[str]:
    path = report["path"]
    raw = report["_buf"]
    reason = report["corrupt_regions"][0]["reason"]
    integrity.quarantine(path, "checkpoint", 0, raw, reason,
                         action="fsck-removed")
    os.unlink(path)
    return ["quarantined + removed unverifiable checkpoint "
            "(replay restarts from offset 0)"]


def check_dir(root: str, repair: bool = False) -> Dict:
    """Programmatic entry point: scan (and optionally repair) every
    durable file under ``root``; returns the full report dict."""
    files: List[Dict] = []
    for path in _find_durable_files(root):
        base = os.path.basename(path)
        if base == _CKPT_NAME:
            rep = _check_checkpoint(path)
            if not rep["clean"] and repair:
                rep["repair_actions"] = _repair_checkpoint(rep)
                rep["repaired"] = True
        else:
            kind, probe = _LOG_KINDS[base]
            rep = _check_log(path, kind, probe)
            if not rep["clean"] and repair:
                rep["repair_actions"] = _repair_log(rep)
                rep["repaired"] = True
        rep.pop("_scan", None)
        rep.pop("_buf", None)
        files.append(rep)
    dirty = [f for f in files if not f["clean"]]
    return {
        "root": os.path.abspath(root),
        "files": files,
        "summary": {
            "files_checked": len(files),
            "files_clean": len(files) - len(dirty),
            "files_with_findings": len(dirty),
            "corrupt_regions": sum(len(f["corrupt_regions"])
                                   for f in files),
            "torn_tails": sum(1 for f in files
                              if f["tail"]["state"] == "torn"),
            "repaired": repair,
        },
    }


def _human(report: Dict, out) -> None:
    s = report["summary"]
    for f in report["files"]:
        recs = f["records"]
        status = "clean" if f["clean"] else (
            "REPAIRED" if f.get("repaired") else "CORRUPT")
        fmt = []
        if recs["framed"]:
            fmt.append(f"{recs['framed']} framed")
        if recs["legacy"]:
            fmt.append(f"{recs['legacy']} legacy")
        print(f"{status:8s} {f['kind']:10s} {f['path']} "
              f"({f['size']} bytes, {', '.join(fmt) or 'no records'})",
              file=out)
        for c in f["corrupt_regions"]:
            print(f"         corrupt @ {c['offset']} "
                  f"({c['length']} bytes): {c['reason']}", file=out)
        if f["tail"]["state"] != "clean":
            print(f"         {f['tail']['state']} tail @ "
                  f"{f['tail']['offset']}: {f['tail']['reason']}",
                  file=out)
        for a in f.get("repair_actions", ()):
            print(f"         repair: {a}", file=out)
    print(f"{s['files_checked']} files checked: {s['files_clean']} "
          f"clean, {s['files_with_findings']} with findings "
          f"({s['corrupt_regions']} corrupt regions, "
          f"{s['torn_tails']} torn tails)", file=out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m filodb_tpu_torch.fsck",
        description="Verify (and optionally repair) FiloDB durable "
                    "files: WAL, chunk log, partkey log, checkpoints.")
    ap.add_argument("data_dir", help="root directory to walk "
                    "(a --data-dir, --stream-dir, or any parent)")
    ap.add_argument("--repair", action="store_true",
                    help="quarantine bad frames, truncate torn tails, "
                         "compact damaged logs, remove unverifiable "
                         "checkpoints")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the full report as one JSON object")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human report (exit status only)")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.data_dir):
        print(f"fsck: not a directory: {args.data_dir}",
              file=sys.stderr)
        return 2
    report = check_dir(args.data_dir, repair=args.repair)
    if args.as_json:
        print(json.dumps(report, indent=2))
    elif not args.quiet:
        _human(report, sys.stdout)
    if report["summary"]["files_with_findings"] and not args.repair:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
