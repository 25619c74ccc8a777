"""The static cost bound against the QoS runtime estimator on the port's
server (the reference's ``tests/test_promql_cost_bound.py``, held on
``filodb_tpu_torch``): for every plan shape, ``static_cost_bound(plan,
shards).total >= estimate_plan_cost(plan, shards).total``, over the QoS
golden shapes and the port's generated queries."""

import json
import urllib.request

import pytest

from filodb_tpu_torch.promql.gen import QueryGen
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range
from filodb_tpu_torch.promql.semant import static_cost_bound
from filodb_tpu_torch.query import qos
from filodb_tpu_torch.standalone.server import FiloServer

T0 = 1_600_000_000


@pytest.fixture(scope="module")
def server():
    srv = FiloServer({"num-shards": 2, "grpc-port": None, "port": 0,
                      "results-cache-mb": 0, "device": "cpu",
                      "gc-freeze": False, "batch-enabled": False}).start()
    srv.seed_dev_data(n_samples=120, n_instances=4,
                      start_ms=T0 * 1000)
    try:
        yield srv
    finally:
        srv.stop()


# the QoS golden-ordering bench shapes plus heavier trees: joins,
# subqueries, instant functions
_SHAPES = [
    ('heap_usage{instance="instance-0"}', T0 + 400, T0 + 500, 20),
    ('heap_usage{instance="instance-0"}', T0 + 300, T0 + 1190, 10),
    ('rate(http_requests_total[5m])', T0 + 300, T0 + 1190, 10),
    ('sum(rate({_metric_=~"heap_usage|http_requests_total"}[10m])) '
     'by (instance)', T0 + 300, T0 + 1190, 5),
    ('sum by (instance) (rate(http_requests_total[5m])) / '
     'sum by (instance) (rate(http_requests_total[10m]))',
     T0 + 300, T0 + 1190, 10),
    ('clamp_min(avg_over_time(heap_usage[2m]), 0) + 1',
     T0 + 300, T0 + 900, 15),
    ('max_over_time(sum(rate(http_requests_total[1m]))[10m:1m])',
     T0 + 600, T0 + 1190, 30),
    ('heap_usage', T0 + 400, T0 + 400, 0),      # instant query
]


def _check(plan, shards):
    bound = static_cost_bound(plan, shards)
    est = qos.estimate_plan_cost(plan, shards)
    assert bound.total >= est.total, (
        f"static bound {bound.total} < runtime estimate {est.total} "
        f"— QoS could under-charge this plan shape: {plan}")
    return bound, est


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: s[0][:40])
def test_bound_dominates_estimate_on_golden_shapes(server, shape):
    query, start, end, step = shape
    planner = server.http.make_planner("timeseries")
    plan = parse_query_range(query, TimeStepParams(start, step, end))
    bound, est = _check(plan, planner.shards)
    # the bound is a ceiling, not a fantasy: within a constant factor of
    # the estimate on these healthy shapes
    assert bound.total <= 1000 * max(est.total, 1.0), (query, bound)


@pytest.mark.parametrize("seed", [0xB0, 0xD1FF])
def test_bound_dominates_on_generated_queries(server, seed):
    """Property sweep: 60 generated well-typed queries, every one
    bound >= estimate."""
    planner = server.http.make_planner("timeseries")
    g = QueryGen(seed=seed)
    for _ in range(60):
        q = g.query()
        plan = parse_query_range(
            q, TimeStepParams(T0 + 300, 15, T0 + 900))
        _check(plan, planner.shards)


def test_bound_is_monotone_in_breadth_and_span(server):
    planner = server.http.make_planner("timeseries")

    def bound(q, start=T0 + 300, step=10, end=T0 + 600):
        plan = parse_query_range(q, TimeStepParams(start, step, end))
        return static_cost_bound(plan, planner.shards).total

    one = bound('heap_usage{instance="instance-0"}')
    metric = bound('heap_usage')
    assert one <= metric
    short = bound('rate(http_requests_total[1m])')
    wide = bound('rate(http_requests_total[10m])')
    assert short < wide
    near = bound('heap_usage', end=T0 + 400)
    far = bound('heap_usage', end=T0 + 1100)
    assert near < far


def test_planner_facade_and_json_shape(server):
    planner = server.http.make_planner("timeseries")
    plan = parse_query_range('sum(rate(http_requests_total[5m]))',
                             TimeStepParams(T0 + 300, 10, T0 + 600))
    bound = planner.static_cost_bound(plan)
    j = bound.to_json()
    assert j["total"] >= planner.estimate_cost(plan).total
    assert j["seriesUpperBound"] >= 1
    assert j["stepsUpperBound"] == 31
    assert j["leaves"] and "seriesUpperBound" in j["leaves"][0]


def test_explain_analyze_carries_static_bound(server):
    """&explain=analyze records the static bound next to the QoS cost
    (the admission headroom surface)."""
    url = (f"http://127.0.0.1:{server.port}/promql/timeseries/api/v1/"
           f"query_range?query=sum(rate(http_requests_total[5m]))"
           f"&start={T0 + 300}&end={T0 + 600}&step=10"
           f"&explain=analyze")
    with urllib.request.urlopen(url, timeout=30) as r:
        payload = json.loads(r.read())
    stages = payload["analyze"]["stages"]
    assert stages["staticCostBound"]["total"] > 0
    assert stages["staticCostBound"]["seriesUpperBound"] >= 1
