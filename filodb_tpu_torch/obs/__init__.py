"""Observability: tracing, Prometheus metrics, the slow-query log and the
in-flight registry (the counterpart of ``filodb_tpu.obs``).

  * :mod:`filodb_tpu_torch.obs.trace` — the span API, off by default;
  * :mod:`filodb_tpu_torch.obs.metrics` — the registry behind ``/metrics``
    (counters, gauges, fixed-bucket histograms);
  * :mod:`filodb_tpu_torch.obs.slowlog` — the slow-query log and the
    in-flight registry behind ``/debug/slow_queries`` and
    ``/debug/queries``;
  * :mod:`filodb_tpu_torch.obs.events` — the operational event journal
    behind ``/debug/events``.

Device profiling (``obs/devprof.py``, ``&explain=analyze``), the process
collector, the sampling profiler and self-monitoring are not ported yet.
"""

from filodb_tpu_torch.obs.metrics import (  # noqa: F401
    GLOBAL_REGISTRY, Histogram, MetricsRegistry)
from filodb_tpu_torch.obs.slowlog import (  # noqa: F401
    InflightRegistry, SlowQueryLog)
from filodb_tpu_torch.obs.trace import (  # noqa: F401
    Span, Trace, Tracer, span, trace_active)

# the reserved self-monitoring dataset (obs/selfmon.py in the JAX package);
# the HTTP layer keeps it node-local even before self-monitoring is ported
SELFMON_DATASET = "__selfmon__"
