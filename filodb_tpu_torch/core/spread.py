"""Spread provider: per-shard-key fan-out overrides.

(core/SpreadProvider.scala + filodb-defaults.conf:319 — a system
default-spread plus per-application overrides keyed by shard-key values;
doc/sharding.md "Spread": hot shard keys get a larger spread so one
tenant's series fan across 2^spread shards.)

The SAME provider instance must drive both the ingest edge (gateway
shard routing) and the query planner (shard pruning) — a mismatch
silently prunes to the wrong shards. `FiloServer` builds one from config
and hands it to both, which replaces the previous "these two ints MUST
match" comment-level contract.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence


class SpreadProvider:
    """default spread + overrides keyed by comma-joined non-metric
    shard-key values (e.g. "demo,App-0")."""

    def __init__(self, default_spread: int = 1,
                 overrides: Optional[Mapping[str, int]] = None):
        self.default_spread = int(default_spread)
        self.overrides: Dict[str, int] = {
            k: int(v) for k, v in (overrides or {}).items()}

    @staticmethod
    def _key(shard_key_values: Sequence[str]) -> str:
        return ",".join(shard_key_values)

    def spread_for(self, shard_key_values: Sequence[str]) -> int:
        return self.overrides.get(self._key(shard_key_values),
                                  self.default_spread)

    def spread_for_labels(self, labels: Mapping[str, str],
                          shard_key_columns: Sequence[str]) -> int:
        return self.spread_for([labels.get(c, "")
                                for c in shard_key_columns])
