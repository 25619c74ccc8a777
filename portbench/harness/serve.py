"""The system under test: the port's FiloServer, in memory, on this
process's device, loaded with a configuration's generated data through the
port's own loader (routed to its shards as the ingest edge routes rows)."""

from __future__ import annotations

import re
from typing import Dict, Optional

from portbench.harness.client import KeepAlive


def program_labels(labels: Dict[str, str]) -> Dict[str, str]:
    """Prometheus labels -> the port's (the metric name is `_metric_`)."""
    return {("_metric_" if k == "__name__" else k): v
            for k, v in labels.items()}


def start(cfg: dict, trace: bool, device: Optional[str]):
    from filodb_tpu_torch.standalone.server import FiloServer

    conf = {**cfg["server"], "port": 0}
    if device is not None:
        conf["device"] = device
    if trace:
        # every query of the window retained, none sampled out
        conf.update({"trace-enabled": True, "trace-sample-rate": 1.0,
                     "trace-max-traces": 1_000_000})
    return FiloServer(conf).start()


def load(srv, cfg: dict, data: dict) -> int:
    """Every flushed sample into chunks, then the unflushed tail."""
    from filodb_tpu_torch import state

    labels = [program_labels(lab) for lab in data["labels"]]
    ts, vals, n = data["ts"], data["vals"], data["flushed"]
    kw = dict(num_shards=srv.config["num-shards"],
              spread=srv.config["default-spread"])
    rows = state.load_into_store(
        srv.store, srv.ref, [(lab, ts[i, :n], vals[i, :n])
                             for i, lab in enumerate(labels)],
        cfg["schema"], True, **kw)
    if ts.shape[1] > n:
        rows += state.load_into_store(
            srv.store, srv.ref, [(lab, ts[i, n:], vals[i, n:])
                                 for i, lab in enumerate(labels)],
            cfg["schema"], False, **kw)
    return rows


def query(port: int, path: str, req: dict, timeout_s: float = 600.0):
    """One range query over a fresh connection -> (status, body)."""
    import urllib.parse
    conn = KeepAlive(port, timeout_s)
    try:
        return conn.get(path + "?" + urllib.parse.urlencode(
            {k: req[k] for k in ("query", "start", "end", "step")}))
    finally:
        conn.close()


_SAMPLE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})?\s+(\S+)")


def counters(port: int) -> Dict[str, float]:
    """/metrics as {family: sum over its label sets}."""
    conn = KeepAlive(port, 60.0)
    try:
        status, body = conn.get("/metrics")
    finally:
        conn.close()
    if status != 200:
        raise RuntimeError(f"/metrics answered {status}")
    out: Dict[str, float] = {}
    for ln in body.decode().splitlines():
        m = _SAMPLE.match(ln)
        if m and not ln.startswith("#"):
            try:
                out[m.group(1)] = out.get(m.group(1), 0.0) + float(
                    m.group(3))
            except ValueError:
                continue
    return out
