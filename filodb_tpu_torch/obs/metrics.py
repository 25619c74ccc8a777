"""Fixed-bucket Prometheus histograms + the exposition builder.

The Kamon-histogram surface the reference gets for free: stage
latencies (query total, batcher queue wait, device execute, flush,
ingest append, fsync) are observed into fixed cumulative buckets and
exposed as well-formed ``_bucket``/``_sum``/``_count`` families with
``# HELP``/``# TYPE`` lines, so p50/p95/p99 come out of any Prometheus
scrape instead of being recomputed client-side in bench scripts.

Also home of :class:`ExpositionBuilder`, the family-grouped text-format
writer the ``/metrics`` endpoint uses for EVERY family (gauges and
counters included): one ``# HELP``/``# TYPE`` block per family,
consistent label-value escaping, and a guaranteed absence of duplicate
series.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


# latency buckets in seconds: sub-ms serving path up to multi-second
# degraded tails (the Prometheus http duration defaults, extended down)
LATENCY_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# fsync/append: flash-to-spinning-rust-to-stalled-container spread
FSYNC_BUCKETS_S = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0)
# batch occupancy: powers of two up to the batcher's max_batch scale
OCCUPANCY_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0)
# step counts (results-cache cached-steps-served): dashboards range from
# a handful of steps to multi-day grids
STEPS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0, 2048.0)


def _fmt_float(v: float) -> str:
    """Prometheus sample-value text: integral floats print bare."""
    if v == math.inf:
        return "+Inf"
    if v == int(v):
        return str(int(v))
    return repr(float(v))


# an exemplar older than this is replaced by ANY fresh observation —
# "the slowest RECENT fill", not the all-time max
EXEMPLAR_MAX_AGE_S = 60.0


class Histogram:
    """One cumulative fixed-bucket histogram (thread-safe observe).

    ``observe(value, trace_id=...)`` optionally attaches an OpenMetrics
    exemplar to the bucket the value lands in: the (trace_id, value,
    unix ts) triple of the slowest recent fill, so a latency bucket
    links straight to the retained trace that filled it. Exemplars cost
    nothing until the first trace_id-bearing observe and never surface
    in the exposition unless explicitly requested
    (``/metrics?exemplars=1``)."""

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be sorted/unique: {buckets}")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # +Inf tail
        self._sum = 0.0
        self._count = 0
        # per-bucket (trace_id, value, unix_ts); allocated lazily on
        # the first exemplar-bearing observe
        self._exemplars: Optional[List[Optional[Tuple[str, float,
                                                      float]]]] = None

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if trace_id is None:
                return
            if self._exemplars is None:
                self._exemplars = [None] * (len(self.buckets) + 1)
            cur = self._exemplars[i]
            now = time.time()
            if cur is None or value >= cur[1] \
                    or now - cur[2] > EXEMPLAR_MAX_AGE_S:
                self._exemplars[i] = (str(trace_id), float(value), now)

    def exemplars(self) -> List[Optional[Tuple[str, float, float]]]:
        """Per-bucket exemplar snapshot (index-aligned with
        ``snapshot()['counts']``); all-None when never attached."""
        with self._lock:
            if self._exemplars is None:
                return [None] * (len(self.buckets) + 1)
            return list(self._exemplars)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counts = list(self._counts)
            return {"buckets": self.buckets, "counts": counts,
                    "sum": self._sum, "count": self._count}

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (what a PromQL
        histogram_quantile would compute); NaN when empty."""
        snap = self.snapshot()
        total = snap["count"]
        if total == 0:
            return math.nan
        rank = q * total
        cum = 0
        lo = 0.0
        for i, c in enumerate(snap["counts"]):
            prev = cum
            cum += c
            if cum >= rank:
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1])
                if i >= len(self.buckets):
                    return float(self.buckets[-1])
                frac = (rank - prev) / c if c else 0.0
                return lo + (hi - lo) * frac
            lo = self.buckets[i] if i < len(self.buckets) else lo
        return float(self.buckets[-1])


class CounterFamily:
    """Labeled monotone counter family living in the registry (the
    counter analogue of :class:`Histogram`): ``inc()`` from any thread,
    ``series()`` snapshots for the exposition walk."""

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        # sorted (key, value) label tuple -> running total
        self._series: Dict[Tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def series(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            items = list(self._series.items())
        return [(dict(k), v) for k, v in items]


class GaugeFamily:
    """Labeled gauge family living in the registry (``set()`` replaces
    the labeled series' value)."""

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[Tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            self._series[key] = float(value)

    def series(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            items = list(self._series.items())
        return [(dict(k), v) for k, v in items]


class MetricsRegistry:
    """Name-keyed metric-family registry. One process-global instance
    (:data:`GLOBAL_REGISTRY`) serves the deep layers (batcher, ingest
    stream, device dispatch) that have no natural path to the server
    object; the /metrics endpoint exposes it.

    Besides histograms it holds labeled counter/gauge families and
    *collectors* — callables invoked at exposition-build time that
    sample external state (the process collector reads /proc; the
    device profiler walks its executable table). The registry is the
    walkable surface the self-monitoring pipeline snapshots in-process
    (obs/selfmon.py), so anything registered here is automatically a
    PromQL-queryable series once ``--self-monitor`` is on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: Dict[str, Histogram] = {}
        self._counters: Dict[str, CounterFamily] = {}
        self._gauges: Dict[str, GaugeFamily] = {}
        self._collectors: List = []

    def histogram(self, name: str, help: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_S
                  ) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = Histogram(name, help, buckets)
                self._hists[name] = h
            return h

    def get(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def histograms(self) -> List[Histogram]:
        with self._lock:
            return list(self._hists.values())

    def counter(self, name: str, help: str) -> CounterFamily:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = CounterFamily(name, help)
                self._counters[name] = c
            return c

    def gauge(self, name: str, help: str) -> GaugeFamily:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = GaugeFamily(name, help)
                self._gauges[name] = g
            return g

    def register_collector(self, fn) -> None:
        """Register ``fn(builder: ExpositionBuilder)`` to be called at
        every exposition build (idempotent by function identity)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        """Drop a collector registered by ``register_collector``. A loop
        that stops calls this: the registry is process-global, and a bound
        method left in it keeps its object, and all that object reaches
        (a stopped server's backend and its device tiles), alive."""
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect_into(self, builder: "ExpositionBuilder",
                     exemplars: bool = False) -> None:
        """Walk the whole registry into ``builder``: counter + gauge
        families, registered collectors, then the histograms (sorted by
        name, matching the /metrics layout). ``exemplars=True``
        (the content-negotiated ``/metrics?exemplars=1``) attaches each
        histogram bucket's OpenMetrics exemplar."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            collectors = list(self._collectors)
            hists = list(self._hists.values())
        for c in sorted(counters, key=lambda c: c.name):
            for labels, v in c.series():
                builder.sample(c.name, labels, _fmt_float(v),
                               mtype="counter", help=c.help)
        for g in sorted(gauges, key=lambda g: g.name):
            for labels, v in g.series():
                builder.sample(g.name, labels, _fmt_float(v),
                               mtype="gauge", help=g.help)
        for fn in collectors:
            try:
                fn(builder)
            except Exception:   # noqa: BLE001 — a collector must never
                pass            # fail the scrape
        for h in sorted(hists, key=lambda h: h.name):
            builder.histogram(h, exemplars=exemplars)

    def reset(self) -> None:
        """Test hook: drop all registered families. Collectors are
        WIRING, not state — they survive a reset (the device profiler
        and process collector register once per process)."""
        with self._lock:
            self._hists.clear()
            self._counters.clear()
            self._gauges.clear()


GLOBAL_REGISTRY = MetricsRegistry()


def observe(name: str, help: str, value: float,
            buckets: Sequence[float] = LATENCY_BUCKETS_S,
            trace_id: Optional[str] = None) -> None:
    """One-line observe into the global registry; ``trace_id`` attaches
    an exemplar (the metric→trace link) to the landing bucket."""
    GLOBAL_REGISTRY.histogram(name, help, buckets).observe(
        value, trace_id=trace_id)


class timed:
    """``with metrics.timed("filodb_x_seconds", "help"):`` — observes
    the elapsed wall seconds into the global registry on exit."""

    __slots__ = ("_name", "_help", "_buckets", "_t0")

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        self._name = name
        self._help = help
        self._buckets = buckets

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        observe(self._name, self._help,
                time.perf_counter() - self._t0, self._buckets)
        return False


# -- exposition --------------------------------------------------------------

def escape_label(v: object) -> str:
    """Prometheus text-format label-value escaping: backslash, quote,
    newline (the one escaping rule, applied to EVERY label value)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def format_exemplar(ex: Optional[Tuple[str, float, float]]
                    ) -> Optional[str]:
    """OpenMetrics exemplar suffix text for a (trace_id, value, ts)
    triple — the part after ``# `` on a sample line::

        {trace_id="8ff60ae4"} 0.053 1700000000.123

    None passes through (no exemplar on this bucket)."""
    if ex is None:
        return None
    trace_id, value, ts = ex
    return (f'{{trace_id="{escape_label(trace_id)}"}} '
            f"{_fmt_float(value)} {round(float(ts), 3)}")


class ExpositionBuilder:
    """Family-grouped Prometheus text-format writer.

    Samples accumulate per family; ``render()`` emits one
    ``# HELP``/``# TYPE`` block per family followed by its samples,
    with duplicate series (same name + label set) dropped
    deterministically (first writer wins) so the exposition always
    parses."""

    def __init__(self):
        # family -> (type, help, [(name, labels_tuple, value_str,
        #                          exemplar_suffix_or_None)])
        self._families: "Dict[str, Tuple[str, str, List]]" = {}
        self._order: List[str] = []

    def declare(self, name: str, mtype: str, help: str) -> None:
        if name not in self._families:
            self._families[name] = (mtype, help, [])
            self._order.append(name)

    def sample(self, name: str, labels: Dict[str, object], value,
               mtype: str = "gauge", help: str = "",
               family: Optional[str] = None,
               exemplar: Optional[str] = None) -> None:
        """Add one sample. ``family`` overrides the HELP/TYPE grouping
        key for histogram children (``x_bucket`` groups under ``x``).
        ``exemplar`` is a pre-rendered OpenMetrics exemplar suffix (the
        text after ``# `` — e.g. ``{trace_id="ab12"} 0.053 1700.2``)
        appended verbatim at render time; it is never part of the
        series identity."""
        fam = family or name
        if fam not in self._families:
            self.declare(fam, mtype,
                         help or f"FiloDB metric {fam}")
        self._families[fam][2].append(
            (name, tuple(sorted((str(k), str(v))
                                for k, v in labels.items())), value,
             exemplar))

    def histogram(self, h: Histogram,
                  labels: Optional[Dict[str, object]] = None,
                  exemplars: bool = False) -> None:
        labels = labels or {}
        snap = h.snapshot()
        ex = h.exemplars() if exemplars \
            else [None] * (len(snap["buckets"]) + 1)
        self.declare(h.name, "histogram", h.help)
        cum = 0
        for i, (b, c) in enumerate(zip(snap["buckets"],
                                       snap["counts"])):
            cum += c
            self.sample(h.name + "_bucket",
                        {**labels, "le": _fmt_float(b)}, cum,
                        family=h.name,
                        exemplar=format_exemplar(ex[i]))
        cum += snap["counts"][-1]
        self.sample(h.name + "_bucket", {**labels, "le": "+Inf"}, cum,
                    family=h.name, exemplar=format_exemplar(ex[-1]))
        self.sample(h.name + "_sum", labels, snap["sum"],
                    family=h.name)
        self.sample(h.name + "_count", labels, snap["count"],
                    family=h.name)

    def families(self):
        """Structured walk of the accumulated exposition — the in-process
        alternative to rendering text and parsing it back (what the
        self-monitoring pipeline does every tick). Yields
        ``(family, mtype, help, samples)`` where each sample is
        ``(sample_name, labels_tuple, value)``; ``labels_tuple`` is the
        sorted ``((key, value), ...)`` form and duplicate series are
        dropped exactly like :meth:`render` drops them (first writer
        wins), so the walk and the text agree sample-for-sample."""
        seen: set = set()
        for fam in self._order:
            mtype, help, samples = self._families[fam]
            if not samples:
                continue
            out = []
            for name, labels, value, _ex in samples:
                key = (name, labels)
                if key in seen:
                    continue
                seen.add(key)
                out.append((name, labels, value))
            yield fam, mtype, help, out

    def render(self) -> str:
        lines: List[str] = []
        seen: set = set()
        for fam in self._order:
            mtype, help, samples = self._families[fam]
            if not samples:
                continue
            lines.append(f"# HELP {fam} {escape_help(help)}")
            lines.append(f"# TYPE {fam} {mtype}")
            for name, labels, value, ex in samples:
                key = (name, labels)
                if key in seen:
                    continue        # no duplicate series, ever
                seen.add(key)
                if labels:
                    lbl = ",".join(f'{k}="{escape_label(v)}"'
                                   for k, v in labels)
                    line = f"{name}{{{lbl}}} {value}"
                else:
                    line = f"{name} {value}"
                if ex:
                    line += f" # {ex}"
                lines.append(line)
        return "\n".join(lines) + "\n"


# -- multi-worker aggregation ------------------------------------------------

_LABELS_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"') \
        .replace("\\\\", "\\")


def parse_exposition(text: str,
                     help_sink: Optional[Dict[str, str]] = None,
                     exemplar_sink: Optional[Dict[Tuple, str]] = None
                     ) -> "List[Tuple[str, str, str, Dict[str, str], str]]":
    """Parse Prometheus text format into
    ``(family, mtype, sample_name, labels, value)`` rows (family = the
    HELP/TYPE grouping name, so ``x_bucket`` rows carry family ``x``).
    ``help_sink`` (optional) collects each family's HELP text.
    ``exemplar_sink`` (optional) collects OpenMetrics exemplar suffixes
    keyed by ``(sample_name, sorted labels tuple)``; without a sink
    exemplars are stripped, so every consumer (validators, selfmon,
    aggregation) sees plain samples. Tolerant of unknown lines
    (skipped), so a worker running newer code than its supervisor still
    aggregates."""
    out = []
    mtypes: Dict[str, str] = {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# HELP "):
            if help_sink is not None:
                parts = ln.split(" ", 3)
                if len(parts) == 4:
                    help_sink.setdefault(parts[2], parts[3])
            continue
        if ln.startswith("# TYPE "):
            parts = ln.split()
            if len(parts) >= 4:
                mtypes[parts[2]] = parts[3]
            continue
        if ln.startswith("#"):
            continue
        # OpenMetrics exemplar suffix: `series value # {labels} v ts`.
        # Right-most ``" # {"`` anchors the split, so label values
        # containing a bare " # " stay intact (the suffix itself never
        # contains the anchor).
        exemplar = None
        if " # {" in ln:
            ln, _, rest = ln.rpartition(" # {")
            exemplar = "{" + rest
        name_part, _, value = ln.rpartition(" ")
        if not name_part:
            continue
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            labels = {k: _unescape_label(v)
                      for k, v in _LABELS_RE.findall(
                          rest.rsplit("}", 1)[0])}
        else:
            name, labels = name_part, {}
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and mtypes.get(base) == "histogram":
                fam = base
                break
        if exemplar is not None and exemplar_sink is not None:
            exemplar_sink[(name, tuple(sorted(labels.items())))] = \
                exemplar
        out.append((fam, mtypes.get(fam, ""), name, labels, value))
    return out


def merge_expositions(by_worker: "Dict[str, str]",
                      help_table: Optional[Dict[str, str]] = None) -> str:
    """The supervisor's ``/metrics`` aggregation: each worker's
    exposition re-emitted with a ``worker`` label injected into every
    sample, one HELP/TYPE block per family across all workers. Workers
    stay individually scrapeable on their private ports; this is the
    one-target view (per-worker batcher occupancy, qps, cache hit
    ratios side by side)."""
    b = ExpositionBuilder()
    helps: Dict[str, str] = dict(help_table or {})
    exemplars: Dict[str, Dict[Tuple, str]] = {w: {} for w in by_worker}
    parsed = {w: parse_exposition(by_worker[w], help_sink=helps,
                                  exemplar_sink=exemplars[w])
              for w in by_worker}
    for worker in sorted(parsed, key=str):
        for fam, mtype, name, labels, value in parsed[worker]:
            if not mtype:
                mtype = "counter" if fam.endswith("_total") else "gauge"
            # a sample that ALREADY carries a worker label keeps it:
            # self-monitoring stamps internal series with their origin
            # worker, and re-merging a merged exposition must be a
            # no-op (merge idempotence — supervisor-of-supervisor
            # chains and re-scraped aggregates stay stable)
            lbl = dict(labels)
            lbl.setdefault("worker", str(worker))
            # a worker's exemplar suffix rides its sample through the
            # merge unmangled (keyed on the PRE-injection identity, so
            # re-merging keyed on the already-labeled series also hits)
            ex = exemplars[worker].get(
                (name, tuple(sorted(labels.items()))))
            b.sample(name, lbl, value, mtype=mtype,
                     help=helps.get(fam, f"FiloDB metric {fam}"),
                     family=fam, exemplar=ex)
    return b.render()


def validate_histogram_families(text: str) -> List[str]:
    """Registry-wide histogram self-consistency validator over a full
    text exposition. For every family declared ``histogram`` (per label
    set, ``le`` excluded) it checks:

      * bucket counts are cumulative (non-decreasing in ``le`` order),
      * the ``+Inf`` bucket equals ``_count``,
      * ``_sum`` and ``_count`` are both emitted.

    Returns a list of human-readable violations (empty = clean). Run
    as a tier-1 test over the live exposition AND by the supervisor
    merge tests — a histogram that fails any of these breaks
    ``histogram_quantile`` silently downstream."""
    out: List[str] = []
    # (family, labels-minus-le) -> {"buckets": [(le, v)], "count": v,
    #                               "sum": present}
    groups: Dict[Tuple, Dict] = {}
    for fam, mtype, name, labels, value in parse_exposition(text):
        if mtype != "histogram":
            continue
        base_labels = tuple(sorted((k, v) for k, v in labels.items()
                                   if k != "le"))
        g = groups.setdefault((fam, base_labels),
                              {"buckets": [], "count": None,
                               "sum": False})
        try:
            v = float(str(value).replace("+Inf", "inf"))
        except ValueError:
            out.append(f"{fam}{dict(base_labels)}: unparseable value "
                       f"{value!r} on {name}")
            continue
        if name == fam + "_bucket":
            try:
                le = float(str(labels.get("le", "")).replace(
                    "+Inf", "inf"))
            except ValueError:
                out.append(f"{fam}{dict(base_labels)}: bad le "
                           f"{labels.get('le')!r}")
                continue
            g["buckets"].append((le, v))
        elif name == fam + "_count":
            g["count"] = v
        elif name == fam + "_sum":
            g["sum"] = True
    for (fam, base_labels), g in sorted(groups.items(), key=str):
        where = f"{fam}{dict(base_labels)}"
        buckets = sorted(g["buckets"])
        if not buckets:
            out.append(f"{where}: histogram family with no _bucket "
                       f"samples")
            continue
        vals = [v for _le, v in buckets]
        if vals != sorted(vals):
            out.append(f"{where}: bucket counts are not cumulative")
        if buckets[-1][0] != math.inf:
            out.append(f"{where}: no +Inf bucket")
        if g["count"] is None:
            out.append(f"{where}: _count not emitted")
        elif buckets[-1][0] == math.inf and buckets[-1][1] != g["count"]:
            out.append(f"{where}: +Inf bucket {buckets[-1][1]} != "
                       f"_count {g['count']}")
        if not g["sum"]:
            out.append(f"{where}: _sum not emitted")
    return out
