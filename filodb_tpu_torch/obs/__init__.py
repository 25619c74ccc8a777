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

  * :mod:`filodb_tpu_torch.obs.selfmon` — self-monitoring: the loop that
    ingests the metrics registry into ``__selfmon__`` through
    :mod:`filodb_tpu_torch.obs.writeback` (the write-back rail it shares
    with the rules engine).

  * :mod:`filodb_tpu_torch.obs.devprof` — device dispatch profiling: per
    dispatch key build/recompile counters, analytic FLOPs and bytes, and
    the ``&explain=analyze`` payload;
  * :mod:`filodb_tpu_torch.obs.profiler` — the wall-clock sampling
    profiler behind ``/debug/profile``, attributing stacks to the
    ``@thread_root`` registry.
"""

from filodb_tpu_torch.obs.metrics import (  # noqa: F401
    GLOBAL_REGISTRY, Histogram, MetricsRegistry)
from filodb_tpu_torch.obs.profiler import SamplingProfiler  # noqa: F401
from filodb_tpu_torch.obs.slowlog import (  # noqa: F401
    InflightRegistry, SlowQueryLog)
from filodb_tpu_torch.obs.trace import (  # noqa: F401
    Span, Trace, Tracer, span, trace_active)

# the reserved self-monitoring dataset (obs/selfmon.py holds the same
# name; this copy keeps the HTTP layer's import light)
SELFMON_DATASET = "__selfmon__"
