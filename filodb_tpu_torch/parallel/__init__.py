"""Cluster-plane pieces of the port that a single node needs: the shard
map (:mod:`~filodb_tpu_torch.parallel.shardmapper`) and the deadline,
retry and breaker primitives (:mod:`~filodb_tpu_torch.parallel.resilience`).

The device mesh, sharded tile store and multi-node membership are not
ported; this package deliberately imports no mesh module.
"""

from filodb_tpu_torch.parallel.resilience import (  # noqa: F401
    BreakerOpenError, BreakerRegistry, Deadline, DeadlineExceeded,
    PeerResilience, RetryPolicy)
from filodb_tpu_torch.parallel.shardmapper import (  # noqa: F401
    ShardMapper, ShardStatus)
