"""Structural LogicalPlan tree serialization for the Exec data plane (the
counterpart of ``filodb_tpu.query.planwire``; its bytes are identical).

The reference ships whole ExecPlan trees over gRPC as protobuf messages
(grpc/src/main/protobuf/exec_plan.proto,
coordinator/.../ProtoConverters.scala) so remote dispatch never depends
on a printable query text. This is the same capability for this
framework's LogicalPlan dataclasses: a type-tagged structural codec —
every frozen-dataclass plan node, ColumnFilter, tuple and primitive
round-trips; no PromQL printer in the loop. Pushdown/federation prefer
this wire and fall back to the printed-PromQL form only for peers that
predate it.

Wire form: JSON-compatible nested dicts ({"__p__": type_tag, ...fields})
carried inside the gRPC ExecRequest / HTTP exec body.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.query import logical as lp

# every plan node type, by stable tag (class name)
_PLAN_TYPES = {
    name: obj for name, obj in vars(lp).items()
    if dataclasses.is_dataclass(obj)
}
_PLAN_TYPES["ColumnFilter"] = ColumnFilter


def _enc(v: Any):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        tag = type(v).__name__
        if tag not in _PLAN_TYPES:
            raise ValueError(f"unserializable plan node {tag}")
        out = {"__p__": tag}
        for f in dataclasses.fields(v):
            out[f.name] = _enc(getattr(v, f.name))
        return out
    if isinstance(v, (list, tuple)):
        return {"__t__": [_enc(x) for x in v]}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise ValueError(f"unserializable plan value {type(v).__name__}")


def _dec(v: Any):
    if isinstance(v, dict) and "__p__" in v:
        cls = _PLAN_TYPES.get(v["__p__"])
        if cls is None:
            raise ValueError(f"unknown plan node {v['__p__']}")
        kwargs = {k: _dec(x) for k, x in v.items() if k != "__p__"}
        return cls(**kwargs)
    if isinstance(v, dict) and "__t__" in v:
        return tuple(_dec(x) for x in v["__t__"])
    return v


def plan_to_wire(plan) -> bytes:
    """LogicalPlan tree -> canonical JSON bytes."""
    return json.dumps(_enc(plan), separators=(",", ":"),
                      sort_keys=True).encode()


def plan_from_wire(buf: bytes):
    """Inverse of plan_to_wire."""
    return _dec(json.loads(buf))
