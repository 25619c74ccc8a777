"""Cardinality control: per-(workspace, namespace, metric) series counting
with quota enforcement at series creation.

Re-design of the reference's ratelimit subsystem
(core/memstore/ratelimit/CardinalityTracker.scala:38 — a prefix-tree of
counts with per-node quotas; RocksDbCardinalityStore.scala:70 backs it with
RocksDB for crash-safe, memory-bounded storage; CardinalityManager.scala:14
periodically rebuilds from the Lucene index; quota config
filodb-defaults.conf:277-318). Here the tree is in-process dicts — counts
are re-derived from persisted partkeys on bootstrap, which is the
reference's own recovery story, so durable storage adds nothing at this
scale.

Prefix levels mirror the reference: () → (ws,) → (ws, ns) →
(ws, ns, metric). A new series increments all four levels; a quota breach
at ANY level rejects the series (QuotaReachedException →
QuotaExceededProtocol: the shard drops the series and counts it). Counts
rebuild naturally on restart: bootstrap re-registers every recovered
series through the same admission path (the reference instead rebuilds
from Lucene periodically, CardinalityManager.scala:14).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from filodb_tpu_torch.lint.locks import single_writer


SHARD_KEY_LABELS = ("_ws_", "_ns_", "_metric_")
MAX_DEPTH = len(SHARD_KEY_LABELS)


class QuotaReachedException(Exception):
    def __init__(self, prefix: Tuple[str, ...], quota: int):
        super().__init__(f"cardinality quota {quota} reached at "
                         f"prefix {prefix}")
        self.prefix = prefix
        self.quota = quota


@dataclass
class CardinalityRecord:
    """(ratelimit/CardinalityRecord — one node of the tree.)"""
    prefix: Tuple[str, ...]
    ts_count: int = 0           # series under this prefix
    active_ts_count: int = 0    # actively ingesting series
    children_count: int = 0     # direct children
    quota: int = 0              # 0 = unlimited

    def to_json(self) -> Dict:
        return {"prefix": list(self.prefix), "tsCount": self.ts_count,
                "activeTsCount": self.active_ts_count,
                "childrenCount": self.children_count,
                "childrenQuota": self.quota}


@single_writer("prefix-tree nodes belong to one shard's tracker "
               "(see CardinalityTracker)")
@dataclass
class _Node:
    ts_count: int = 0
    active: int = 0
    quota: int = 0
    children: Dict[str, "_Node"] = field(default_factory=dict)


@single_writer("one tracker per shard: quota setup runs before the "
               "shard serves, counts mutate only on the shard's owning "
               "thread; metering reads are racy-by-design snapshots")
class CardinalityTracker:
    """Prefix tree of series counts with quota enforcement
    (CardinalityTracker.scala:38)."""

    def __init__(self, default_quotas: Sequence[int] = (0, 0, 0, 0)):
        # default quota per depth (0..3); 0 = unlimited
        self.default_quotas = tuple(default_quotas) + (0,) * (
            MAX_DEPTH + 1 - len(default_quotas))
        self.root = _Node(quota=self.default_quotas[0])

    # -- quota config (QuotaSource) ---------------------------------------
    def set_quota(self, prefix: Sequence[str], quota: int) -> None:
        node = self.root
        for depth, p in enumerate(prefix):
            node = node.children.setdefault(
                p, _Node(quota=self.default_quotas[
                    min(depth + 1, MAX_DEPTH)]))
        node.quota = quota

    @staticmethod
    def prefix_of(labels: Mapping[str, str]) -> Tuple[str, ...]:
        return tuple(labels.get(l, "") for l in SHARD_KEY_LABELS)

    # -- counting (modifyCount) -------------------------------------------
    def modify_count(self, prefix: Sequence[str], delta: int,
                     active_delta: int = 0) -> None:
        """Walk the prefix path adjusting counts; on a positive delta,
        raise QuotaReachedException if any level would exceed its quota —
        in that case NOTHING is modified and no tree nodes are created
        (a rejected high-cardinality flood must not grow the tree)."""
        # pass 1: existing nodes only — quota checks before any mutation
        existing: List[_Node] = [self.root]
        node = self.root
        missing_from = None
        for depth, p in enumerate(prefix[:MAX_DEPTH]):
            child = node.children.get(p) if node is not None else None
            if child is None:
                if missing_from is None:
                    missing_from = depth
                node = None
                continue
            existing.append(child)
            node = child
        if delta > 0:
            for n in existing:
                if n.quota and n.ts_count + delta > n.quota:
                    raise QuotaReachedException(tuple(prefix), n.quota)
            if missing_from is not None:
                # nodes to be created get depth defaults; reject if the
                # default itself cannot admit the delta
                for depth in range(missing_from, min(len(prefix),
                                                     MAX_DEPTH)):
                    dq = self.default_quotas[depth + 1]
                    if dq and delta > dq:
                        raise QuotaReachedException(tuple(prefix), dq)
        # pass 2: create + mutate
        path: List[_Node] = [self.root]
        node = self.root
        for depth, p in enumerate(prefix[:MAX_DEPTH]):
            child = node.children.get(p)
            if child is None:
                child = _Node(quota=self.default_quotas[depth + 1])
                node.children[p] = child
            path.append(child)
            node = child
        for n in path:
            n.ts_count += delta
            n.active += active_delta
            if n.ts_count < 0:
                n.ts_count = 0
            if n.active < 0:
                n.active = 0

    # -- scans (TsCardinalities / topkCardLocal) --------------------------
    def _node_at(self, prefix: Sequence[str]) -> Optional[_Node]:
        node = self.root
        for p in prefix:
            node = node.children.get(p)
            if node is None:
                return None
        return node

    def series_count(self, prefix: Sequence[str]) -> Optional[int]:
        """Series count under ``prefix`` (O(depth) — the QoS cost
        estimator's cardinality input), or None when the prefix has
        never been seen. An empty prefix answers the shard total."""
        node = self._node_at(prefix)
        if node is None:
            return None
        return node.ts_count

    def scan(self, prefix: Sequence[str], depth: int
             ) -> List[CardinalityRecord]:
        """Records at ``depth`` under ``prefix`` (TsCardinalities plan:
        shard_key_prefix + num_groups)."""
        base = self._node_at(prefix)
        if base is None:
            return []
        out: List[CardinalityRecord] = []

        def rec(node: _Node, path: Tuple[str, ...]):
            if len(path) == depth:
                out.append(CardinalityRecord(
                    path, node.ts_count, node.active,
                    len(node.children), node.quota))
                return
            for name, child in node.children.items():
                rec(child, path + (name,))

        rec(base, tuple(prefix))
        return out

    def top_k(self, prefix: Sequence[str], k: int
              ) -> List[CardinalityRecord]:
        """Heaviest direct children of a prefix (CLI topkcardlocal)."""
        node = self._node_at(prefix)
        if node is None:
            return []
        items = sorted(node.children.items(),
                       key=lambda kv: -kv[1].ts_count)[:k]
        return [CardinalityRecord(tuple(prefix) + (name,), c.ts_count,
                                  c.active, len(c.children), c.quota)
                for name, c in items]


def merge_records(per_shard: Sequence[Sequence[CardinalityRecord]]
                  ) -> List[CardinalityRecord]:
    """Sum same-prefix records across shards (TsCardReduceExec)."""
    acc: Dict[Tuple[str, ...], CardinalityRecord] = {}
    for records in per_shard:
        for r in records:
            got = acc.get(r.prefix)
            if got is None:
                acc[r.prefix] = CardinalityRecord(
                    r.prefix, r.ts_count, r.active_ts_count,
                    r.children_count, r.quota)
            else:
                got.ts_count += r.ts_count
                got.active_ts_count += r.active_ts_count
                # children are NAME sets, not disjoint across shards: the
                # max is a lower bound on distinct children (scan one
                # level deeper for exact names)
                got.children_count = max(got.children_count,
                                         r.children_count)
    return sorted(acc.values(), key=lambda r: -r.ts_count)
