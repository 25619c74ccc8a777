"""The port's query generator (``filodb_tpu_torch/promql/gen.py``) against
the JAX package's: the same ``(seed, metrics)`` yields the same query list,
string for string; and the reference's own generator tests
(``tests/test_promql_gen.py``) held on the port's copy, its ``semant``
and its parser."""

import re

import pytest

from filodb_tpu.promql import gen as j_gen
from filodb_tpu_torch.promql import semant
from filodb_tpu_torch.promql.gen import (DEFAULT_HISTOGRAM, DEFAULT_METRICS,
                                         MetricSpec, QueryGen)
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query_range


@pytest.mark.parametrize("seed", [0, 1, 7, 0xB0, 0xBEEF, 0xD1FF,
                                  0xD1FF + 1])
def test_same_queries_as_the_reference_per_seed(seed):
    assert QueryGen(seed=seed).queries(200) == \
        j_gen.QueryGen(seed=seed).queries(200)


def test_same_queries_over_a_custom_universe():
    spec = (("my_total", "counter", (("dc", ("a", "b")),)),
            ("my_gauge", "gauge", (("dc", ("a", "b")), ("rack", ("r1",)))))
    ours = QueryGen(seed=3, metrics=[MetricSpec(*m) for m in spec])
    theirs = j_gen.QueryGen(seed=3,
                            metrics=[j_gen.MetricSpec(*m) for m in spec])
    assert ours.queries(100) == theirs.queries(100)


def test_the_default_universe_is_the_reference_s():
    assert [(m.name, m.kind, m.labels) for m in DEFAULT_METRICS] == \
        [(m.name, m.kind, m.labels) for m in j_gen.DEFAULT_METRICS]
    h, jh = DEFAULT_HISTOGRAM, j_gen.DEFAULT_HISTOGRAM
    assert (h.name, h.kind, h.labels) == (jh.name, jh.kind, jh.labels)


# the reference's generator tests, on the port's copy


def test_deterministic_per_seed():
    a = QueryGen(seed=7).queries(30)
    b = QueryGen(seed=7).queries(30)
    assert a == b
    c = QueryGen(seed=8).queries(30)
    assert a != c


def test_every_query_is_well_typed_and_plannable():
    g = QueryGen(seed=123)
    schemas = semant.MetricSchemas(
        {m.name: m.kind for m in DEFAULT_METRICS})
    params = TimeStepParams(1_600_000_000, 30, 1_600_000_600)
    for q in g.queries(100):
        diags = semant.errors(semant.lint_query(q, schemas))
        assert not diags, (q, [d.rule for d in diags])
        parse_query_range(q, params)    # must not raise


def test_surface_breadth():
    """One seed's first 150 queries must cover range functions,
    aggregation, binary ops, subqueries and instant functions."""
    qs = QueryGen(seed=0xBEEF).queries(150)
    text = "\n".join(qs)
    assert "rate(" in text
    assert re.search(r"\b(sum|avg|min|max|count) ", text) or \
        re.search(r"\b(sum|avg|min|max|count)\(", text)
    assert "[4m:" in text or "[6m:" in text or "[10m:" in text  # subquery
    assert re.search(r"\bbool\b", text)
    assert re.search(r"\boffset\b", text)
    assert re.search(r"\b(and|or|unless)\b", text)
    assert re.search(r"\bclamp", text)
    fns = set(re.findall(r"([a-z_0-9]+)\(", text))
    assert len(fns) >= 12, sorted(fns)


def test_counter_metrics_feed_counter_functions_only():
    """Schema discipline by construction: rate/increase/irate never
    see a gauge metric, delta/deriv never see a counter."""
    qs = QueryGen(seed=5).queries(120)
    counters = {m.name for m in DEFAULT_METRICS if m.kind == "counter"}
    counters.add(DEFAULT_HISTOGRAM.name)      # buckets are counters
    gauges = {m.name for m in DEFAULT_METRICS if m.kind == "gauge"}
    for q in qs:
        for m in re.finditer(
                r"\b(rate|increase|irate|resets)\(([a-z_0-9]+)", q):
            assert m.group(2) in counters, q
        for m in re.finditer(r"\b(delta|idelta|deriv)\(([a-z_0-9]+)",
                             q):
            assert m.group(2) in gauges, q


def test_custom_metric_universe():
    spec = (MetricSpec("my_total", "counter",
                       (("dc", ("a", "b")),)),)
    g = QueryGen(seed=1, metrics=spec)
    qs = g.queries(20)
    assert all("my_total" in q or "dc" in q or
               not re.search(r"[a-z_]+\{", q) for q in qs)
    for q in qs:
        assert "http_requests_total" not in q


def test_generator_self_check_fails_loudly():
    """With validation on, a drifted generator raises instead of
    emitting invalid queries (sanity: validate=False still yields)."""
    g = QueryGen(seed=2, validate=False)
    assert len(g.queries(5)) == 5
