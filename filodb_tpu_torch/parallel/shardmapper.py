"""Shard → node/device mapping with the reference's shard state FSM.

Mirrors coordinator/ShardMapper.scala:26 (shard→ActorRef array, updateFromEvent
:204, ingestionShard :122, queryShards :93) and ShardStatus.scala's state
machine (Unassigned/Assigned/Active/Recovery/Down/Error/Stopped) — but a
"node" here is a host/device slot in the mesh, not an Akka actor.

The hash math itself (xxh32 shard-key hash, combineHash, spread bit split)
lives in filodb_tpu_torch.core.record (ingestion_shard / query_shards) and is
bit-compatible with RecordBuilder.scala:638-683 so sharding interoperates
with reference deployments.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from filodb_tpu_torch.core.record import ingestion_shard, query_shards


class ShardStatus(enum.Enum):
    """Shard lifecycle states (ShardStatus.scala)."""
    UNASSIGNED = "unassigned"
    ASSIGNED = "assigned"           # node picked, ingestion not started
    ACTIVE = "active"               # ingesting + queryable
    RECOVERY = "recovery"           # replaying from checkpoint (has progress)
    ERROR = "error"
    DOWN = "down"
    STOPPED = "stopped"

    @property
    def queryable(self) -> bool:
        return self in (ShardStatus.ACTIVE, ShardStatus.RECOVERY)


@dataclass
class ShardState:
    status: ShardStatus = ShardStatus.UNASSIGNED
    node: Optional[str] = None      # node/coordinator identifier
    progress_pct: int = 0           # recovery progress (ShardStatus.scala)


@dataclass
class ShardEvent:
    """Published on state transitions (ShardStatus.scala sealed trait)."""
    shard: int
    status: ShardStatus
    node: Optional[str] = None
    progress_pct: int = 0


class ShardMapper:
    """numShards-entry shard→node table + status FSM (ShardMapper.scala:26)."""

    def __init__(self, num_shards: int):
        if num_shards <= 0 or (num_shards & (num_shards - 1)) != 0:
            raise ValueError("num_shards must be a power of 2")
        self.num_shards = num_shards
        self._states: List[ShardState] = [ShardState()
                                          for _ in range(num_shards)]
        self._subscribers: List = []
        # monotone topology epoch: bumped on every OWNERSHIP change
        # (shard -> node edge rewired), not on status-only transitions.
        # Carried in the health body and peer responses so stale-routing
        # detection and the plan/results caches key off one counter
        # (ShardMapper.scala versioning analogue).
        self._epoch = 0
        # serializes FSM transitions: update() is called concurrently
        # from the failure-detector poll thread, per-shard ingestion
        # driver threads, membership handoff workers, and HTTP admin
        # threads — an unlocked `_epoch += 1` loses bumps under that
        # interleaving, and a lost bump means two different topologies
        # share an epoch (the plan/results caches would keep serving
        # extents across an ownership rewire).
        self._lock = threading.Lock()

    @property
    def topology_epoch(self) -> int:
        with self._lock:
            return self._epoch

    # -- hash-based routing (ShardMapper.scala:93-150) ---------------------
    def ingestion_shard(self, shard_key_hash: int, part_hash: int,
                        spread: int) -> int:
        return ingestion_shard(shard_key_hash, part_hash, spread,
                               self.num_shards)

    def query_shards(self, shard_key_hash: int, spread: int) -> List[int]:
        return query_shards(shard_key_hash, spread, self.num_shards)

    # -- assignment / FSM (updateFromEvent :204) ---------------------------
    def subscribe(self, callback) -> None:
        self._subscribers.append(callback)

    def _publish(self, ev: ShardEvent) -> None:
        for cb in self._subscribers:
            cb(ev)

    # the ONE topology-epoch mutation publisher: every ownership rewire
    # funnels through here (membership handoff, crash reassignment, bus
    # convergence, admin transfer); it reaches every registered cache's
    # topology hook through the subscription chain.
    def update(self, shard: int, status: ShardStatus,
               node: Optional[str] = None, progress_pct: int = 0) -> None:
        # the transition (multi-field ShardState write + epoch bump) is
        # atomic under _lock; _publish runs OUTSIDE it — subscribers
        # take their own locks (plan/results-cache invalidation) and
        # must not nest under the mapper's
        with self._lock:
            st = self._states[shard]
            prev_node = st.node
            st.status = status
            if node is not None:
                st.node = node
            if status in (ShardStatus.UNASSIGNED, ShardStatus.STOPPED):
                st.node = None
            if st.node != prev_node:
                self._epoch += 1        # ownership edge rewired
            st.progress_pct = progress_pct
            ev = ShardEvent(shard, status, st.node, progress_pct)
        self._publish(ev)

    def assign(self, shard: int, node: str) -> None:
        self.update(shard, ShardStatus.ASSIGNED, node)

    def activate(self, shard: int) -> None:
        self.update(shard, ShardStatus.ACTIVE)

    def status(self, shard: int) -> ShardStatus:
        return self._states[shard].status

    def node_of(self, shard: int) -> Optional[str]:
        return self._states[shard].node

    def shards_for_node(self, node: str) -> List[int]:
        return [i for i, s in enumerate(self._states) if s.node == node]

    def active_shards(self, shards: Optional[Sequence[int]] = None
                      ) -> List[int]:
        it = shards if shards is not None else range(self.num_shards)
        return [s for s in it if self._states[s].status.queryable]

    def all_queryable(self) -> bool:
        return all(s.status.queryable for s in self._states)

    def unassigned_shards(self) -> List[int]:
        return [i for i, s in enumerate(self._states)
                if s.status is ShardStatus.UNASSIGNED]


def assign_shards_evenly(mapper: ShardMapper, nodes: Sequence[str]) -> None:
    """DefaultShardAssignmentStrategy (ShardAssignmentStrategy.scala:188):
    spread shards as evenly as possible across nodes."""
    if not nodes:
        return
    per = -(-mapper.num_shards // len(nodes))
    for i in range(mapper.num_shards):
        mapper.assign(i, nodes[min(i // per, len(nodes) - 1)])


def shards_for_ordinal(ordinal: int, num_nodes: int, num_shards: int
                       ) -> List[int]:
    """Deterministic k8s-statefulset-ordinal → shards mapping
    (v2 FiloDbClusterDiscovery.scala:50 / K8sStatefulSetShardAssignmentStrategy
    ShardAssignmentStrategy.scala:53)."""
    if not (0 <= ordinal < num_nodes):
        raise ValueError("ordinal out of range")
    per = -(-num_shards // num_nodes)
    lo = ordinal * per
    return list(range(lo, min(lo + per, num_shards)))
