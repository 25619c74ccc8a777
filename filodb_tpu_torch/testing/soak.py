"""Generated differential soak of the port's engine (test support).

Seeded well-typed queries (:mod:`filodb_tpu_torch.promql.gen`) run
through the port's ``QueryEngine`` with a ``TorchBackend``, so they reach
the device routes (aligned tiles, the fused group-sum kernel, the packed
path and its boundary-extract kernel), and through the pure-Python
reference evaluator (:mod:`filodb_tpu_torch.promql.refeval`). Each answer
is held to the reference with the tolerance of the routes it took:

  * an answer from f64 routes only: the reference soak's ``_close``,
    1e-6 absolute + 1e-6 relative;
  * an answer that took an f32 hybrid route: that route's ``@precision``
    budget (:mod:`filodb_tpu_torch.lint.numerics`, ``ROUTE_CLAIMS``) in
    f32 ulps of the magnitude of the f32-route terms the answer is built
    from, plus the fixed-point split's floor. That magnitude
    (``Reference.scale``) is refeval's answer with every rate-family
    window taken as its absolute value and every subtraction as an
    addition, less the same answer with those windows taken as 0: the
    sum of the terms' magnitudes, through the query's sums, differences
    and scalings, with the f64 operands (gauges, constants, scalars)
    cancelled out. Where that is not finite, the answer's own magnitude.
    Never looser than the claim.

Where the extrapolation branch of a window is a knife edge (its start or
end gap within 1 ms of 1.1 times the average sample interval), the
kernel decides it on integer ms and the reference on floats, and either
side is right. A cell outside its tolerance may match the reference
evaluated with every such branch flipped (``Reference.knife``); it is
counted, and its series is named in the result and in any failure
message.

Two worlds over the reference soak's metric and label universe:

  * :func:`reference_world`, built as the reference soak builds its
    shard (12 counters with 5 % scrape gaps and one reset, gauges, a
    classic histogram), all flushed;
  * :func:`regular_world`: 10 s cadence with +/-2 s integer-ms jitter, no
    gaps, one reset, flushed into chunks (the aligned tiles and the fused
    group-sum), with an unflushed write-buffer tail inside the query
    range for ``http_requests_total`` and ``cpu_usage`` (their last steps
    take the packed path).

The mesh routes (``mesh_backend``): the same soak through a backend
whose tiles are resident across 4 shard partitions (``mesh-tiles`` keys,
the fast evaluator's budget) and a planner holding a ``MeshExecutor``
over them (the scatter-gather ``mesh`` keys, f64).

Used by ``tests/test_torch_promql_differential.py`` on the CPU and by
``chip_smoke.py`` phase 13 on the card.
"""

from __future__ import annotations

import functools
import math
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.lint import numerics as nmod
from filodb_tpu_torch.obs import devprof
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.promql import refeval
from filodb_tpu_torch.promql.gen import QueryGen
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.promql.refeval import RefSeries, ref_eval
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.query.model import GridResult, ScalarResult
from filodb_tpu_torch.query.planner import QueryPlanner
from filodb_tpu_torch.query.resultcache import ResultCache

T0 = 1_600_000_000
START, STEP, END = T0 + 900, 60, T0 + 2100

SOAK_SEED = 0xD1FF
SOAK_N = 200            # acceptance floor: >= 200 generated queries

# (schema, labels, ts ms, values, flushed)
Row = Tuple[str, Dict[str, str], List[int], List[float], bool]

_JOBS_INSTS = [(j, i) for j in ("api", "web") for i in ("i0", "i1", "i2")]
_LES = ("0.1", "0.5", "1", "2.5", "+Inf")


def reference_world() -> Tuple[List[Row], List[RefSeries]]:
    """The reference soak's world (tests/test_promql_differential.py
    ``_build``), sample for sample: irregular counters with gaps and one
    mid-stream reset, a classic-bucket histogram, noisy gauges."""
    rng = random.Random(7)
    rows: List[Row] = []
    for metric in ("http_requests_total", "errors_total"):
        for job, inst in _JOBS_INSTS:
            labels = {"_metric_": metric, "_ws_": "demo",
                      "_ns_": "App-0", "job": job, "instance": inst}
            v = 0.0
            ts, vals = [], []
            for k in range(240):
                t = T0 + k * 10
                if rng.random() < 0.05:
                    continue                    # scrape gap
                v += rng.random() * 5
                if metric == "errors_total" and inst == "i1" and k == 150:
                    v = rng.random()            # counter reset
                ts.append(t * 1000)
                vals.append(v)
            rows.append(("prom-counter", labels, ts, vals, True))
    for job in ("api", "web"):
        for inst in ("i0", "i1"):
            cum = [0.0] * len(_LES)
            series = {le: ([], []) for le in _LES}
            for k in range(240):
                t = T0 + k * 10
                if rng.random() < 0.05:
                    continue                    # whole-scrape gap
                incs = [rng.random() * 3 for _ in _LES]
                run = 0.0
                for bi, le in enumerate(_LES):
                    run += incs[bi]             # cumulative across le
                    cum[bi] += run
                    series[le][0].append(t * 1000)
                    series[le][1].append(cum[bi])
            for le in _LES:
                labels = {"_metric_": "http_request_duration_seconds_bucket",
                          "_ws_": "demo", "_ns_": "App-0", "job": job,
                          "instance": inst, "le": le}
                ts, vals = series[le]
                rows.append(("prom-counter", labels, list(ts), list(vals),
                             True))
    for metric in ("cpu_usage", "queue_depth"):
        for job in (("api", "web") if metric == "cpu_usage" else ("api",)):
            for inst in ("i0", "i1", "i2"):
                labels = {"_metric_": metric, "_ws_": "demo",
                          "_ns_": "App-0", "job": job, "instance": inst}
                ts, vals = [], []
                for k in range(240):
                    t = T0 + k * 10
                    if rng.random() < 0.05:
                        continue
                    v = 50 * math.sin(k / 17.0) + rng.random() * 10 - 5
                    ts.append(t * 1000)
                    vals.append(v)
                rows.append(("gauge", labels, ts, vals, True))
    return rows, _ref_series(rows)


# the regular world's write-buffer tail: samples at or after this time
# stay unflushed for these metrics (inside the query range, so their
# last steps take the packed path); the others are flushed whole
TAIL_FROM_MS = (T0 + 2000) * 1000
TAIL_METRICS = ("http_requests_total", "cpu_usage")


def regular_world() -> Tuple[List[Row], List[RefSeries]]:
    """The same metric and label universe on a regular 10 s cadence with
    +/-2 s integer-ms scrape jitter and no gaps, so the series share one
    cadence grid (aligned tiles; dense, so the slide evaluator and the
    fused group-sum qualify). ``errors_total{instance="i1",job="api"}``
    resets mid-stream."""
    rng = np.random.default_rng(0x5EED)
    K = 240
    rows: List[Row] = []

    def stamps():
        return [int(x) for x in (T0 + np.arange(K) * 10) * 1000
                + rng.integers(-2000, 2001, K)]

    for metric in ("http_requests_total", "errors_total"):
        for job, inst in _JOBS_INSTS:
            labels = {"_metric_": metric, "_ws_": "demo",
                      "_ns_": "App-0", "job": job, "instance": inst}
            v = np.cumsum(rng.uniform(0, 5, K))
            if metric == "errors_total" and (job, inst) == ("api", "i1"):
                v[150:] -= v[149] - rng.uniform(0, 1)   # counter reset
            rows.append(("prom-counter", labels, stamps(),
                         [float(x) for x in v], True))
    for job in ("api", "web"):
        for inst in ("i0", "i1"):
            ts = stamps()
            incs = rng.uniform(0, 3, (K, len(_LES)))
            cum = np.cumsum(np.cumsum(incs, axis=1), axis=0)
            for bi, le in enumerate(_LES):
                labels = {"_metric_": "http_request_duration_seconds_bucket",
                          "_ws_": "demo", "_ns_": "App-0", "job": job,
                          "instance": inst, "le": le}
                rows.append(("prom-counter", labels, list(ts),
                             [float(x) for x in cum[:, bi]], True))
    for metric in ("cpu_usage", "queue_depth"):
        for job in (("api", "web") if metric == "cpu_usage" else ("api",)):
            for inst in ("i0", "i1", "i2"):
                labels = {"_metric_": metric, "_ws_": "demo",
                          "_ns_": "App-0", "job": job, "instance": inst}
                k = np.arange(K)
                v = 50 * np.sin(k / 17.0) + rng.uniform(-5, 5, K)
                rows.append(("gauge", labels, stamps(),
                             [float(x) for x in v], True))
    out: List[Row] = []
    for schema, labels, ts, vals, _ in rows:
        if labels["_metric_"] not in TAIL_METRICS:
            out.append((schema, labels, ts, vals, True))
            continue
        cut = int(np.searchsorted(np.asarray(ts), TAIL_FROM_MS))
        out.append((schema, labels, ts[:cut], vals[:cut], True))
        out.append((schema, labels, ts[cut:], vals[cut:], False))
    return out, _ref_series(out)


def _ref_series(rows: Sequence[Row]) -> List[RefSeries]:
    by: Dict[Tuple, RefSeries] = {}
    for _schema, labels, ts, vals, _ in rows:
        key = tuple(sorted(labels.items()))
        if key in by:
            by[key].ts.extend(ts)
            by[key].values.extend(vals)
        else:
            by[key] = RefSeries(dict(labels), list(ts), list(vals))
    return list(by.values())


def build_shard(rows: Sequence[Row]) -> TimeSeriesShard:
    """One shard holding ``rows``: the flushed rows ingested and flushed
    into chunks, then the unflushed ones left in the write buffers."""
    shard = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0)
    for flushed in (True, False):
        b = RecordBuilder(DEFAULT_SCHEMAS)
        for schema, labels, ts, vals, fl in rows:
            if fl == flushed:
                for t, v in zip(ts, vals):
                    b.add_sample(schema, labels, int(t), float(v))
        for c in b.containers():
            shard.ingest(c)
        if flushed:
            shard.flush_all()
    return shard


# ---------------------------------------------------------------------------
# routes and their tolerances
# ---------------------------------------------------------------------------

# (dispatch site, key kind) of an f32 hybrid route -> the claims bounding
# its answers; every other route computes in f64
ROUTE_CLAIMS: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("tilestore", "fast"): ("counter-fast-hybrid",),
    ("tilestore-batch", "fast"): ("counter-fast-hybrid",),
    ("tilestore", "slide"): ("counter-slide-hybrid",),
    ("tilestore-batch", "slide"): ("counter-slide-hybrid",),
    ("tilestore", "groupsum"): ("groupsum-recombine-f32",
                                "counter-epilogue-f32"),
    # the resident sharded tiles run the fast evaluator per partition;
    # their grouped sums add its f32 values in f64
    ("mesh-tiles", "mesh-fast"): ("counter-fast-hybrid",),
    ("mesh-tiles", "mesh-fast-b"): ("counter-fast-hybrid",),
    ("mesh-tiles", "mesh-grouped-pair"): ("counter-fast-hybrid",),
    ("mesh-tiles", "mesh-grouped"): ("counter-fast-hybrid",),
}

MESH_PARTITIONS = 4


def mesh_backend(device="cpu"):
    """A ``TorchBackend`` serving from tiles resident across
    ``MESH_PARTITIONS`` shard partitions of ``device`` (``mesh_eval``),
    and a ``MeshExecutor`` over the same partitions for the planner's
    scatter-gather: (backend, executor)."""
    import torch

    from filodb_tpu_torch.parallel.mesh import MeshExecutor, make_mesh
    from filodb_tpu_torch.parallel.shardstore import ShardedTileEvaluator
    from filodb_tpu_torch.query.backend import TorchBackend
    mesh = make_mesh(MESH_PARTITIONS, 1,
                     [torch.device(device)] * MESH_PARTITIONS)
    return (TorchBackend(device=device,
                         mesh_eval=ShardedTileEvaluator(mesh)),
            MeshExecutor(mesh))


def route_of(site: str, kind: str) -> str:
    """A dispatch's route name: the site and the kind of its key
    (``tilestore/slide``, ``tilestore/groupsum``, ``packed/pallas``,
    ``tilestore/avg_over_time``, ...)."""
    return f"{site}/{kind}"


def dispatched(run: Callable):
    """``run()`` under a trace of its own: its result and the (site, key
    kind) of every device dispatch it made, read from the executable
    events each dispatch records (``tilestore.note_exec``)."""
    tr = obs_trace.Trace()
    with obs_trace.activate(tr):
        out = run()
    assert not tr.truncated, "the trace dropped spans: routes unread"
    return out, [(sp.tags["site"], sp.tags["key"].split("/", 1)[0])
                 for sp in tr.spans if sp.name == devprof.EXEC_EVENT]


def route_budget(dispatches: Sequence[Tuple[str, str]]) -> float:
    """f32 ulps an answer built from these dispatches may be off: the
    sum of the budgets of the claims its f32 routes hold (0 = f64 only).
    The group-sum composes the recombine's and the epilogue's."""
    claims: Set[str] = set()
    for site, kind in dispatches:
        claims.update(ROUTE_CLAIMS.get((site, kind), ()))
    return float(sum(nmod.precision_claim(c).rel_ulps for c in claims))


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def canon(res) -> Dict[Tuple, List[float]]:
    if isinstance(res, ScalarResult):
        return {(): list(res.values)}
    assert isinstance(res, GridResult), type(res)
    out = {}
    for i, k in enumerate(res.keys):
        key = tuple(sorted(k.items()))
        assert key not in out, f"duplicate engine key {key}"
        out[key] = list(res.values[i])
    return out


def f32_ulps(a: float, b: float, scale: float, floor: float) -> float:
    """|a - b| less ``floor``, in f32 ulps of ``scale``."""
    sp = max(float(np.spacing(np.float32(abs(scale)))),
             float(np.finfo(np.float32).tiny))
    return float(max(abs(a - b) - floor, 0.0) / sp)


def close(a: float, b: float, ulps: float = 0.0, floor: float = 0.0,
          scale: Optional[float] = None) -> bool:
    """The reference soak's tolerance (1e-6 abs + 1e-6 rel), or, for an
    answer of f32 routes (``ulps`` > 0), ``ulps`` f32 ulps of ``scale``
    (default: the reference answer ``b``) plus ``floor``."""
    if math.isnan(a) and math.isnan(b):
        return True
    if math.isinf(a) or math.isinf(b):
        return a == b
    if math.isnan(a) or math.isnan(b):
        return False
    if ulps > 0:
        return f32_ulps(a, b, b if scale is None else scale, floor) <= ulps
    return abs(a - b) <= 1e-6 + 1e-6 * max(abs(a), abs(b))


KNIFE_S = 1e-3          # a gap within 1 ms of its threshold

# the operators with every subtraction an addition
_SUMS = dict(refeval._ARITH, **{"-": refeval._ARITH["+"]})


def _abs_window(*args) -> float:
    return abs(refeval._extrapolated(*args))


def _zero_window(*args) -> float:
    r = refeval._extrapolated(*args)
    return 0.0 if math.isfinite(r) else r


class Reference:
    """refeval's answer to one query (``plain``) and the variants a
    comparison may need, each evaluated on first use: ``knife``, with
    every knife-edge branch flipped, and ``scale``, the magnitude of the
    f32-route terms in each cell."""

    def __init__(self, q: str, ref: Sequence[RefSeries]):
        self.q, self.ref = q, ref
        self.plain = self._eval()

    def _eval(self, **hooks) -> Dict[Tuple, List[float]]:
        return ref_eval(self.q, self.ref, START, STEP, END, **hooks)

    @functools.cached_property
    def knife(self) -> Dict[Tuple, List[float]]:
        return self._eval(extrapolate=functools.partial(
            refeval._extrapolated, knife_s=KNIFE_S))

    @functools.cached_property
    def scale(self) -> Dict[Tuple, List[float]]:
        """Per cell, the sum of the magnitudes of the rate-family windows
        in it (the values the f32 routes compute): refeval with each
        window's absolute value and every subtraction an addition, less
        refeval with each window 0 and the same additions, so that the
        f64 operands cancel out. NaN where either is not finite."""
        mag = self._eval(extrapolate=_abs_window, arith=_SUMS)
        m0 = self._eval(extrapolate=_zero_window, arith=_SUMS)
        return {k: [abs(x - y) if math.isfinite(x) and math.isfinite(y)
                    else math.nan for x, y in zip(mag[k], m0[k])]
                for k in mag if k in m0}


@dataclass
class SoakResult:
    """What one soak over one world saw."""
    queries: int = 0
    cells: int = 0
    routes: Dict[str, int] = field(default_factory=dict)   # queries/route
    f32_queries: int = 0
    worst_ulps: float = 0.0     # worst f32-route error, ulps of its scale
    worst_query: str = ""
    knife_edges: List[str] = field(default_factory=list)
    failures: List[str] = field(default_factory=list)
    seconds: float = 0.0


def compare(tag: str, got: Dict, rf: Reference, budget: float,
            floor: float, res: SoakResult) -> None:
    """Hold one canonical answer to the reference; record what failed.
    ``budget`` > 0 (an answer of f32 routes): each cell within that many
    f32 ulps of the magnitude of its f32-route terms (``rf.scale``; the
    answer's own where that is not finite) plus ``floor``."""
    q, plain = rf.q, rf.plain
    if set(got) != set(plain):
        res.failures.append(
            f"{tag}: series keysets differ for {q!r}: engine only "
            f"{sorted(set(got) - set(plain))[:3]}, reference only "
            f"{sorted(set(plain) - set(got))[:3]}")
        return
    scales = rf.scale if budget > 0 else {}
    for k in got:
        for j, (a, b) in enumerate(zip(got[k], plain[k])):
            res.cells += 1
            scale = abs(b)
            if k in scales and math.isfinite(scales[k][j]):
                scale = scales[k][j]
            if budget > 0 and math.isfinite(a) and math.isfinite(b) \
                    and scale > 0:
                u = f32_ulps(a, b, scale, floor)
                if u > res.worst_ulps:
                    res.worst_ulps, res.worst_query = u, q
            if close(a, b, budget, floor, scale):
                continue
            kn = rf.knife
            if k in kn and close(a, kn[k][j], budget, floor, scale):
                res.knife_edges.append(f"{q} {dict(k)} step {j}")
                continue
            res.failures.append(
                f"{tag}: {q!r} diverges at series {dict(k)} step {j}: "
                f"engine={a!r} reference={b!r}"
                + (f" (budget {budget:g} f32 ulps of {scale!r})"
                   if budget else "")
                + (f"; knife edges so far: {res.knife_edges[:5]}"
                   if res.knife_edges else ""))
            return


def world_floor(ref: Sequence[RefSeries]) -> float:
    """The fixed-point split's quantization floor for this world: the
    widest series span times 2**-59 (fixed-point-split)."""
    span = max((max(s.values) - min(s.values)) for s in ref if s.values)
    return float(span) * 2.0 ** -59


def run_soak(shard, ref: Sequence[RefSeries], backend,
             tag: str = "soak", mesh_executor=None) -> SoakResult:
    """``SOAK_N`` generated queries (``QueryGen(SOAK_SEED)``) through
    ``QueryEngine([shard], backend)`` against ``ref_eval``, the cache
    off. With ``mesh_executor`` each query is planned and run by a
    ``QueryPlanner`` holding it (so the mesh lowerings take their
    shapes: ``MeshTileExec`` and the scatter-gather
    ``MeshAggregateExec``)."""
    res = SoakResult()
    floor = world_floor(ref)
    t0 = time.perf_counter()
    g = QueryGen(seed=SOAK_SEED)
    for i in range(SOAK_N):
        q = g.query()
        plan = parse_query_range(q, TimeStepParams(START, STEP, END))
        if mesh_executor is None:
            got, seen = dispatched(
                lambda: QueryEngine([shard], backend=backend).execute(plan))
        else:
            planner = QueryPlanner([shard], backend=backend,
                                   mesh_executor=mesh_executor)
            got, seen = dispatched(
                lambda: planner.materialize(plan).execute())
        _account(res, seen)
        compare(f"{tag}[{i}]", canon(got), Reference(q, ref),
                route_budget(seen), floor, res)
    res.queries = SOAK_N
    res.seconds = time.perf_counter() - t0
    return res


def _account(res: SoakResult, seen) -> None:
    for r in sorted({route_of(s, k) for s, k in seen}):
        res.routes[r] = res.routes.get(r, 0) + 1
    if route_budget(seen) > 0:
        res.f32_queries += 1


def through_cache(shard, backend, cache: ResultCache, q: str):
    """One range evaluation through the results-cache split path (the
    HTTP edge's plan -> begin -> materialize -> finish pipeline): the
    canonical answer and its dispatches."""
    planner = QueryPlanner([shard], backend=backend)
    plan = parse_query_range(q, TimeStepParams(START, STEP, END))

    def run():
        ses = cache.begin(planner, "timeseries", q, plan, START * 1000,
                          STEP * 1000, END * 1000)
        exs = [planner.materialize(p) for p in ses.plans]
        return canon(ses.finish(planner, [ex.execute() for ex in exs]))
    return dispatched(run)


def run_cache_soak(shard, ref: Sequence[RefSeries], backend,
                   tag: str = "cache") -> Tuple[SoakResult, ResultCache]:
    """The same queries through the results cache, cold then warm (a
    re-issue served from the cached extent): both held to ``ref_eval``."""
    res = SoakResult()
    floor = world_floor(ref)
    cache = ResultCache(max_bytes=32 << 20)
    t0 = time.perf_counter()
    g = QueryGen(seed=SOAK_SEED)
    for i in range(SOAK_N):
        q = g.query()
        rf = Reference(q, ref)
        cold, seen = through_cache(shard, backend, cache, q)
        _account(res, seen)
        warm, seen_warm = through_cache(shard, backend, cache, q)
        budget = route_budget(seen + seen_warm)
        for phase, got in (("cold", cold), ("warm", warm)):
            compare(f"{tag}-{phase}[{i}]", got, rf, budget, floor, res)
    res.queries = SOAK_N
    res.seconds = time.perf_counter() - t0
    return res, cache
