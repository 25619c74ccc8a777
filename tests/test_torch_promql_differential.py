"""The generated differential soak through the port's device routes.

200 seeded well-typed queries (``QueryGen(seed=0xD1FF)``, the reference
soak's) run through the port's ``QueryEngine`` with
``TorchBackend(device="cpu")`` over two worlds
(``filodb_tpu_torch/testing/soak.py``): the reference soak's world
(gaps, one reset, a classic histogram; aligned tiles with gaps and the
packed path) and a regular world (10 s +/-2 s integer-ms jitter, no
gaps, one reset; dense tiles, the slide evaluator and the fused group-sum
kernel, and an unflushed tail on the packed path with the boundary-extract
kernel). Each answer is held to the pure-Python ``ref_eval``, with the
cache off and through the results cache, cold and warm. The regular
world's soak runs once more through the mesh routes (tiles resident
across 4 CPU partitions, a planner with the scatter-gather executor).

Tolerances (``soak.close``): answers of f64 routes within 1e-6 absolute +
1e-6 relative (the reference soak's); answers that took an f32 route
within that route's ``@precision`` budget in f32 ulps of the magnitude
of the f32-route terms in the answer (``soak.Reference.scale``: through
sums, differences and scalings, the sum of the rate-family windows'
magnitudes, the f64 operands cancelled out; the answer's own magnitude
where that is not finite), plus the fixed-point split's floor:
``tilestore/fast`` 16 (counter-fast-hybrid), ``tilestore/slide`` 16
(counter-slide-hybrid), ``tilestore/groupsum`` 4 + 4
(groupsum-recombine-f32 and counter-epilogue-f32, the kernel's
recombine and its f32 epilogue). Knife edges of the extrapolation
branch (a gap within 1 ms of its threshold) may match the reference
with that branch flipped; they are counted and named.

At the bottom, the reference soak's pinned regressions
(``tests/test_promql_differential.py``) through the port's device routes.
"""

import math

import numpy as np
import pytest
import torch

from filodb_tpu_torch.promql.gen import QueryGen
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.promql.refeval import RefEvalError, ref_eval
from filodb_tpu_torch.query.backend import TorchBackend
from filodb_tpu_torch.query.engine import QueryEngine
from filodb_tpu_torch.testing import soak

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

WORLDS = {"reference": soak.reference_world, "regular": soak.regular_world}
COUNTERS = ("tile_builds", "aligned_evals", "fused_aggs",
            "packed_dispatches")


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for name, make in WORLDS.items():
        rows, ref = make()
        out[name] = (soak.build_shard(rows), ref)
    return out


@pytest.fixture(scope="module")
def soaks(worlds):
    """Each world's soak with the cache off, on a backend of its own."""
    out = {}
    for name, (shard, ref) in worlds.items():
        be = TorchBackend(device="cpu")
        res = soak.run_soak(shard, ref, be, tag=f"soak-{name}")
        out[name] = (res, {c: getattr(be, c) for c in COUNTERS})
    return out


def _report(name, res):
    share = {r: f"{n / res.queries:.1%}" for r, n in sorted(
        res.routes.items())}
    print(f"\n{name}: {res.queries} queries, {res.cells} cells, "
          f"{res.f32_queries} on f32 routes (worst {res.worst_ulps:.3g} "
          f"f32 ulps: {res.worst_query}), knife edges "
          f"{len(res.knife_edges)} {res.knife_edges[:5]}, "
          f"{res.seconds:.1f} s; share of queries per route: {share}")


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_soak_matches_refeval(soaks, name):
    res, _ = soaks[name]
    _report(name, res)
    assert res.queries == soak.SOAK_N
    assert not res.failures, "\n".join(res.failures[:10])


def test_the_soak_reached_every_route(soaks):
    """Tiles, aligned evaluations, fused group-sums and packed dispatches
    all took part, counted by the backends over both worlds."""
    totals = {c: sum(cnt[c] for _res, cnt in soaks.values())
              for c in COUNTERS}
    print("\nbackend counters over the soak:", totals,
          {n: cnt for n, (_r, cnt) in soaks.items()})
    assert all(v > 0 for v in totals.values()), totals
    routes = set()
    for res, _ in soaks.values():
        routes |= set(res.routes)
    for r in ("tilestore/fast", "tilestore/slide", "tilestore/groupsum",
              "packed/pallas", "packed/gather", "packed/endpoint"):
        assert r in routes, (r, sorted(routes))


@pytest.fixture(scope="module")
def mesh_soak(worlds):
    """The regular world's soak through the mesh routes: a backend whose
    tiles are resident across 4 CPU partitions and a planner holding a
    MeshExecutor over them (``soak.mesh_backend``)."""
    shard, ref = worlds["regular"]
    be, ex = soak.mesh_backend("cpu")
    res = soak.run_soak(shard, ref, be, tag="soak-mesh", mesh_executor=ex)
    return res, be


def test_soak_through_the_mesh_routes(mesh_soak):
    """Every answer within its routes' budgets of ref_eval; the resident
    sharded evaluators (per series, batched, grouped) and the
    scatter-gather (aggregates, topk) all took part."""
    res, be = mesh_soak
    _report("mesh", res)
    assert res.queries == soak.SOAK_N
    assert not res.failures, "\n".join(res.failures[:10])
    for r in ("mesh-tiles/mesh-fast", "mesh-tiles/mesh-aligned",
              "mesh-tiles/mesh-grouped-pair", "mesh/agg", "mesh/topk"):
        assert r in res.routes, (r, sorted(res.routes))
    assert be.mesh_dispatches > 0 and be.mesh_eval.ndev == 4
    assert soak.route_budget([("mesh-tiles", "mesh-fast")]) == 16.0
    assert soak.route_budget([("mesh", "agg")]) == 0.0


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_soak_through_the_results_cache(worlds, name):
    """The same queries through the results cache, cold then warm (served
    from the cached extent): both held to the reference."""
    shard, ref = worlds[name]
    res, cache = soak.run_cache_soak(shard, ref, TorchBackend(device="cpu"),
                                     tag=f"cache-{name}")
    _report(f"{name} (results cache)", res)
    assert not res.failures, "\n".join(res.failures[:10])
    assert cache.hits > 0 and cache.cached_steps_served > 0, (
        "the warm pass never hit the results cache", cache.hits)


def test_the_tolerances_have_teeth(worlds):
    """An f32-route answer 17 f32 ulps off fails the 16-ulp budget; an
    f64-route answer off by 2e-6 relative fails the reference's
    tolerance; both pass unperturbed."""
    shard, ref = worlds["regular"]
    q = 'rate(http_requests_total{job="api"}[5m])'
    plan = parse_query_range(q, TimeStepParams(soak.START, soak.STEP,
                                               soak.END))
    got, seen = soak.dispatched(lambda: soak.canon(QueryEngine(
        [shard], backend=TorchBackend(device="cpu")).execute(plan)))
    budget = soak.route_budget(seen)
    assert budget == 16.0, seen
    ref_q = soak.Reference(q, ref)
    rf = ref_q.plain
    k = sorted(rf)[0]
    b = next(v for v in rf[k] if math.isfinite(v))
    assert soak.close(b, b, budget)
    sp = float(np.spacing(np.float32(abs(b))))
    assert not soak.close(b + 17 * sp, b, budget)
    assert soak.close(b + 15 * sp, b, budget)
    assert not soak.close(b * (1 + 2e-6) + 1e-6, b)
    res = soak.SoakResult()
    bad = {key: [v + 17 * float(np.spacing(np.float32(abs(v))))
                 for v in vals] for key, vals in rf.items()}
    soak.compare("teeth", bad, ref_q, budget, 0.0, res)
    assert res.failures
    res = soak.SoakResult()
    soak.compare("teeth", got, ref_q, budget, 0.0, res)
    assert not res.failures, res.failures


def test_the_f32_scale_counts_only_the_f32_terms(worlds):
    """A rate less a large constant or a gauge is held to 16 f32 ulps of
    the rate, not of the constant: an error of 17 ulps of the rate fails,
    though it is far under one ulp of the constant; a difference of two
    rates is held to the sum of their magnitudes."""
    _shard, ref = worlds["regular"]
    sel = '{job="api",instance="i0"}'
    rate = soak.Reference(f"rate(http_requests_total{sel}[5m])", ref).plain
    for q in (f"rate(http_requests_total{sel}[5m]) - 1e5",
              f"rate(http_requests_total{sel}[5m]) - on (job, instance) "
              f"(cpu_usage{sel} * 1e3)"):
        rq = soak.Reference(q, ref)
        (k,) = rq.plain
        (rk,) = rate
        for j, s in enumerate(rq.scale[k]):
            if math.isfinite(rate[rk][j]):
                assert s == pytest.approx(abs(rate[rk][j]), rel=1e-6), q
        bad = {k: [v + 17 * float(np.spacing(np.float32(abs(r))))
                   for v, r in zip(rq.plain[k], rate[rk])]}
        res = soak.SoakResult()
        soak.compare("scale", bad, rq, 16.0, 0.0, res)
        assert res.failures, q
        res = soak.SoakResult()
        soak.compare("scale", rq.plain, rq, 16.0, 0.0, res)
        assert not res.failures, res.failures
    q = ('rate(http_requests_total{job="api",instance="i0"}[5m]) - on '
         '(job, instance) rate(http_requests_total{job="api",'
         'instance="i0"}[2m])')
    rq = soak.Reference(q, ref)
    five = soak.Reference(
        'rate(http_requests_total{job="api",instance="i0"}[5m])', ref)
    two = soak.Reference(
        'rate(http_requests_total{job="api",instance="i0"}[2m])', ref)
    (k,) = rq.plain
    for j, s in enumerate(rq.scale[k]):
        a, b = (next(iter(r.plain.values()))[j] for r in (five, two))
        if math.isfinite(a) and math.isfinite(b):
            assert s == pytest.approx(abs(a) + abs(b), rel=1e-12)


def test_knife_edge_flip_is_refeval_elsewhere():
    """The flipped reference differs from refeval's only where a gap sits
    within 1 ms of its threshold, and there takes the other branch."""
    from filodb_tpu_torch.promql import refeval
    sts = [1_000, 11_000, 21_000, 31_000]       # avg 10 s, threshold 11 s
    svs = [1.0, 2.0, 3.5, 4.0]
    far = refeval._extrapolated(-4_000, 36_000, sts, svs, True, True,
                                knife_s=soak.KNIFE_S)
    assert far == refeval._extrapolated(-4_000, 36_000, sts, svs, True,
                                        True)
    # the end gap is exactly 11 s, the threshold 1.1 * 10 s: refeval
    # extrapolates the half interval (11 < 11 is false), the group-sum
    # kernel's integer rule (10 * 3 * 11000 <= 11 * 30000) the whole gap,
    # and so does the flip
    near = refeval._extrapolated(1_000, 42_000, sts, svs, False, False,
                                 knife_s=soak.KNIFE_S)
    assert refeval._extrapolated(1_000, 42_000, sts, svs, False, False) \
        == pytest.approx(3.0 * (30 + 5) / 30)
    assert near == pytest.approx(3.0 * (30 + 11) / 30)


# ---------------------------------------------------------------------------
# the reference soak's pinned regressions, through the port's device routes
# ---------------------------------------------------------------------------

def _one(worlds, name, q):
    shard, ref = worlds[name]
    plan = parse_query_range(q, TimeStepParams(soak.START, soak.STEP,
                                               soak.END))
    eng, seen = soak.dispatched(lambda: soak.canon(QueryEngine(
        [shard], backend=TorchBackend(device="cpu")).execute(plan)))
    res = soak.SoakResult()
    soak.compare("pinned", eng, soak.Reference(q, ref),
                 soak.route_budget(seen), soak.world_floor(ref), res)
    assert not res.failures, res.failures
    return eng


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_differential_refeval_rejects_out_of_scope(worlds, name):
    _shard, ref = worlds[name]
    with pytest.raises(RefEvalError):
        ref_eval("quantile(0.9, cpu_usage)", ref, soak.START, soak.STEP,
                 soak.END)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_pinned_scalar_lhs_comparison_filter(worlds, name):
    """A filtering comparison with the scalar on the LEFT keeps the
    vector's sample values."""
    eng = _one(worlds, name, '0.25 <= queue_depth{job="api",instance="i0"}')
    (vals,) = eng.values()
    finite = [v for v in vals if not math.isnan(v)]
    assert finite, "filter retained nothing — fixture drifted"
    assert all(v >= 0.25 and v != 0.25 for v in finite)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_pinned_nested_subquery_rebase(worlds, name):
    _one(worlds, name,
         'avg_over_time(last_over_time('
         'http_requests_total{job="web",instance="i0"}[10m:])[6m:30s])')


def test_pinned_rebase_subquery_node_directly():
    from filodb_tpu_torch.query import logical as lp
    from filodb_tpu_torch.query.engine import lp_replace_range
    raw = lp.RawSeriesPlan((), 0, 1000)
    sub = lp.SubqueryWithWindowing(
        lp.PeriodicSeries(raw, 0, 60_000, 1_000_000), "avg_over_time",
        600_000, 60_000, 0, 60_000, 1_000_000)
    moved = lp_replace_range(sub, 500_000, 30_000, 2_000_000)
    assert (moved.start_ms, moved.step_ms, moved.end_ms) == \
        (500_000, 30_000, 2_000_000)
    assert moved.window_ms == 600_000 and moved.function == \
        "avg_over_time"


def test_soak_stream_covers_new_shapes():
    qs = QueryGen(seed=soak.SOAK_SEED).queries(soak.SOAK_N)
    assert any("histogram_quantile" in q for q in qs)
    assert any("topk(" in q or "bottomk(" in q for q in qs)
    assert any("group_left" in q or "group_right" in q for q in qs)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_pinned_histogram_quantile_bucket_join(worlds, name):
    eng = _one(worlds, name, 'histogram_quantile(0.9, '
               'rate(http_request_duration_seconds_bucket[5m]))')
    assert eng, "no histogram groups came back"
    assert all("le" not in dict(k) for k in eng)
    finite = [v for row in eng.values() for v in row
              if not math.isnan(v)]
    assert finite and all(0 <= v <= 2.5 for v in finite)
    _one(worlds, name, 'histogram_quantile(0.5, sum by (le,job) '
         '(rate(http_request_duration_seconds_bucket[2m])))')


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_pinned_grouped_join(worlds, name):
    eng = _one(worlds, name, '(rate(errors_total[5m]) / on (job) '
               'group_left sum by (job) (rate(http_requests_total[5m])))')
    assert all("instance" in dict(k) for k in eng)
    _one(worlds, name, '(sum by (instance) (rate(errors_total[5m])) * '
         'on (instance) group_right rate(http_requests_total[5m]))')


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_pinned_topk(worlds, name):
    eng = _one(worlds, name, 'topk(2, rate(http_requests_total[5m]))')
    rows = list(eng.values())
    for t in range(len(rows[0])):
        live = sum(1 for r in rows if not math.isnan(r[t]))
        assert live <= 2
    _one(worlds, name, 'bottomk(1, avg_over_time(cpu_usage[5m]))')
