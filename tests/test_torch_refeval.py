"""The port's pure-Python reference evaluator
(``filodb_tpu_torch/promql/refeval.py``) against the JAX package's: on the
same series and query, ``ref_eval`` gives the same answer bit for bit, and
the same ``RefEvalError`` outside its scope."""

import struct

import pytest

from filodb_tpu.promql import refeval as j_refeval
from filodb_tpu_torch.promql import refeval
from filodb_tpu_torch.promql.gen import QueryGen
from filodb_tpu_torch.testing import soak

WORLDS = {"reference": soak.reference_world, "regular": soak.regular_world}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request):
    _rows, ref = WORLDS[request.param]()
    j_ref = [j_refeval.RefSeries(dict(s.labels), list(s.ts),
                                 list(s.values)) for s in ref]
    return ref, j_ref


def _bits(answer):
    """The answer as {key: exact bit patterns} (NaN payloads included)."""
    return {k: [struct.pack("<d", v) for v in vals]
            for k, vals in answer.items()}


def test_same_answers_bit_for_bit_over_generated_queries(world):
    ref, j_ref = world
    g = QueryGen(seed=soak.SOAK_SEED)
    for i in range(soak.SOAK_N):
        q = g.query()
        ours = refeval.ref_eval(q, ref, soak.START, soak.STEP, soak.END)
        theirs = j_refeval.ref_eval(q, j_ref, soak.START, soak.STEP,
                                    soak.END)
        assert list(ours) == list(theirs), (i, q)
        assert _bits(ours) == _bits(theirs), (i, q)


@pytest.mark.parametrize("q", [
    "quantile(0.9, cpu_usage)",                      # aggregation
    "sort(cpu_usage)",                               # instant function
    "holt_winters(cpu_usage[5m], 0.5, 0.5)",         # range function
    'label_replace(cpu_usage, "a", "$1", "job", "(.*)")',
    "http_requests_total[5m]",                       # bare range vector
    "cpu_usage + on (job) cpu_usage",                # many-to-many
])
def test_same_errors_outside_the_scope(world, q):
    ref, j_ref = world
    with pytest.raises(j_refeval.RefEvalError) as theirs:
        j_refeval.ref_eval(q, j_ref, soak.START, soak.STEP, soak.END)
    with pytest.raises(refeval.RefEvalError) as ours:
        refeval.ref_eval(q, ref, soak.START, soak.STEP, soak.END)
    assert str(ours.value) == str(theirs.value)


def test_same_range_function_per_window():
    """``eval_range_fn``, the window loop the precision harnesses hold the
    exact evaluator to, on a counter with a reset and a knife-edge gap."""
    ts = [0, 10_000, 20_000, 31_000, 40_000, 50_000, 61_000]
    vs = [5.0, 7.0, 9.5, 1.0, 4.0, 4.0, 8.5]
    for func in ("rate", "increase", "delta", "irate", "idelta", "resets",
                 "changes", "deriv", "avg_over_time", "stddev_over_time",
                 "last_over_time", "count_over_time"):
        for ws, we in ((0, 60_000), (5_000, 61_000), (-11_000, 30_000)):
            a = refeval.eval_range_fn(func, ts, vs, ws, we)
            b = j_refeval.eval_range_fn(func, ts, vs, ws, we)
            assert struct.pack("<d", a) == struct.pack("<d", b), \
                (func, ws, we)
