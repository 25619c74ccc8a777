"""Cluster-plane pieces of the port: the shard map
(:mod:`~filodb_tpu_torch.parallel.shardmapper`) and the deadline, retry
and breaker primitives (:mod:`~filodb_tpu_torch.parallel.resilience`),
imported here; the device mesh (:mod:`~filodb_tpu_torch.parallel.mesh`),
the sharded tile store (:mod:`~filodb_tpu_torch.parallel.shardstore`) and
the multi-process aggregate (:mod:`~filodb_tpu_torch.parallel.distributed`)
load only when used: importing this package imports no mesh module
(``MeshExecutor`` and ``pack_sharded`` resolve lazily through the module
``__getattr__``).
"""

from filodb_tpu_torch.parallel.resilience import (  # noqa: F401
    BreakerOpenError, BreakerRegistry, Deadline, DeadlineExceeded,
    PeerResilience, RetryPolicy)
from filodb_tpu_torch.parallel.shardmapper import (  # noqa: F401
    ShardMapper, ShardStatus)

_LAZY = {"MeshExecutor": "filodb_tpu_torch.parallel.mesh",
         "pack_sharded": "filodb_tpu_torch.parallel.mesh"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
