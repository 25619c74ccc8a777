"""The plain reference against hand-worked Prometheus cases."""

import numpy as np
import pytest

from portbench.reference import promql


def one(name, ts_s, vals, **labels):
    return {"__name__": name, **labels}, np.asarray(ts_s) * 1000, vals


def series(*rows):
    n = max(len(r[1]) for r in rows)
    assert all(len(r[1]) == n for r in rows)
    return promql.Series([r[0] for r in rows],
                         np.array([r[1] for r in rows], np.int64),
                         np.array([r[2] for r in rows], np.float64))


def only(answer):
    assert len(answer) == 1
    return next(iter(answer.values()))


def test_rate_corrects_a_reset_and_extrapolates_to_the_window():
    # 10, 20, 30, then a reset to 5, 15: corrected 10, 20, 30, 35, 45;
    # window [-5 s, 45 s]: 35 over 40 s of samples, extended 5 s at each
    # end (both under 1.1 gaps): 35 * 50 / 40
    s = series(one("c", [0, 10, 20, 30, 40], [10, 20, 30, 5, 15]))
    assert only(s.evaluate("increase(c[50s])", 45, 45, 1))[0] == \
        pytest.approx(43.75, rel=1e-15)
    assert only(s.evaluate("rate(c[50s])", 45, 45, 1))[0] == \
        pytest.approx(0.875, rel=1e-15)


def test_rate_extrapolates_no_further_than_the_counter_zero():
    # first sample 1 at 20 s, 20 more by 40 s: zero lies 1 s before the
    # first sample, nearer than the window start (20 s before)
    s = series(one("c", [20, 30, 40], [1, 11, 21]))
    assert only(s.evaluate("rate(c[40s])", 40, 40, 1))[0] == \
        pytest.approx(21 / 40, rel=1e-15)


def test_rate_extends_half_a_gap_past_a_far_window_edge():
    # the window starts 30 s before the first sample (> 1.1 gaps): half a
    # gap (5 s) instead
    s = series(one("c", [30, 40, 50], [100, 110, 120]))
    assert only(s.evaluate("increase(c[50s])", 50, 50, 1))[0] == \
        pytest.approx(25.0, rel=1e-15)


def test_rate_needs_two_samples():
    s = series(one("c", [0, 100, 200], [1, 2, 3]))
    assert s.evaluate("rate(c[50s])", 100, 100, 1) == {}


def test_window_functions_take_both_ends_of_the_window():
    s = series(one("g", [0, 10, 20, 30], [1, 2, 3, 4]))
    avg = only(s.evaluate("avg_over_time(g[20s])", 20, 30, 10))
    mx = only(s.evaluate("max_over_time(g[20s])", 20, 30, 10))
    # [0, 20] holds 1, 2, 3; [10, 30] holds 2, 3, 4
    np.testing.assert_array_equal(avg, [2.0, 3.0])
    np.testing.assert_array_equal(mx, [3.0, 4.0])
    np.testing.assert_array_equal(
        only(s.evaluate("max_over_time(g[10s])", 20, 30, 10)), [3.0, 4.0])
    np.testing.assert_array_equal(
        only(s.evaluate("min_over_time(g[10s])", 20, 30, 10)), [2.0, 3.0])


def test_an_empty_window_has_no_value():
    s = series(one("g", [0, 10, 50, 60], [1, 2, 3, 4]))
    got = only(s.evaluate("avg_over_time(g[5s])", 10, 50, 20))
    assert got[0] == 2.0 and np.isnan(got[1]) and got[2] == 3.0


def test_grouping_over_the_series_present_at_each_step():
    s = series(one("g", [0, 10], [1, 5], job="a", i="0"),
               one("g", [0, 10], [3, 7], job="a", i="1"),
               one("g", [0, 10], [10, 20], job="b", i="2"))
    for agg, a, b in (("sum", 12.0, 20.0), ("avg", 6.0, 20.0),
                      ("count", 2.0, 1.0), ("max", 7.0, 20.0),
                      ("min", 5.0, 20.0)):
        got = s.evaluate(f"{agg} by (job) (max_over_time(g[5s]))", 10, 10, 1)
        assert set(got) == {(("job", "a"),), (("job", "b"),)}
        assert got[(("job", "a"),)][0] == a
        assert got[(("job", "b"),)][0] == b


def test_selectors_anchor_regexes_and_drop_the_metric_name():
    s = series(one("cpu_usage_user", [0], [1.0], host="h1"),
               one("cpu_usage_user", [0], [2.0], host="h10"),
               one("cpu_usage_system", [0], [3.0], host="h1"))
    got = s.evaluate('max by (host) (max_over_time({__name__=~"cpu_usage_.+",'
                     ' host=~"h1"}[1s]))', 0, 0, 1)
    assert {k: v[0] for k, v in got.items()} == {(("host", "h1"),): 3.0}
    got = s.evaluate('max_over_time(cpu_usage_user{host!="h1"}[1s])', 0, 0,
                     1)
    assert list(got) == [(("host", "h10"),)]


def test_grouping_by_the_metric_name_makes_one_group():
    """A range function drops __name__, so TSBS's `by (__name__)` puts
    every selected series, whatever its metric, in one group."""
    s = series(one("cpu_usage_user", [0], [1.0], host="h1"),
               one("cpu_usage_idle", [0], [5.0], host="h2"),
               one("cpu_usage_user", [0], [2.0], host="h2"))
    got = s.evaluate("max(max_over_time({__name__=~'cpu_(usage_user|"
                     "usage_idle)', host=~'h1|h2'}[1s])) by (__name__)",
                     0, 0, 1)
    assert {k: v[0] for k, v in got.items()} == {(): 5.0}
    got = s.evaluate("avg(avg_over_time(cpu_usage_user{}[1s])) by "
                     "(__name__, host)", 0, 0, 1)
    assert {k: v[0] for k, v in got.items()} == {(("host", "h1"),): 1.0,
                                                 (("host", "h2"),): 2.0}


def test_the_by_clause_may_follow_the_operand():
    for a, b in (("sum by (job) (rate(c[5m]))", "sum(rate(c[5m])) by (job)"),
                 ('max_over_time(g{h="x"}[1m])',
                  "max_over_time(g{h='x'}[1m])")):
        pa, pb = promql.parse(a), promql.parse(b)
        assert (pa.agg, pa.by, pa.func, pa.window_ms, pa.matchers) == \
            (pb.agg, pb.by, pb.func, pb.window_ms, pb.matchers)


def test_forms_outside_the_reference_are_refused():
    for q in ("topk(3, rate(c[5m]))", "rate(c)", "quantile_over_time(0.5,"
              " g[5m])", "stddev by (job) (rate(c[5m]))"):
        with pytest.raises(ValueError):
            promql.parse(q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_window_search_matches_searchsorted(seed):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 10_000, (7, 50)), axis=1)
    ts += np.arange(50)         # strictly increasing rows
    rows = np.array([0, 3, 6, 2])
    t = np.sort(rng.integers(-500, 11_000, 40))
    for right in (False, True):
        want = np.array([np.searchsorted(ts[r], t, side="right" if right
                                         else "left") for r in rows])
        np.testing.assert_array_equal(
            promql._search(ts, rows, t, right), want)


def test_float32_is_the_control_precision():
    rng = np.random.default_rng(3)
    ts = (np.arange(400) * 10_000)[None, :].repeat(4, 0)
    vals = np.cumsum(rng.uniform(0, 5, (4, 400)), axis=1) + 1e4
    s = promql.Series([{"__name__": "c", "i": str(i)} for i in range(4)],
                      ts, vals)
    hi = s.evaluate("rate(c[5m])", 600, 3900, 60)
    lo = s.evaluate("rate(c[5m])", 600, 3900, 60, np.float32)
    assert all(v.dtype == np.float32 for v in lo.values())
    gap = max(float(np.max(np.abs(lo[k] - hi[k]) / np.abs(hi[k])))
              for k in hi)
    assert 1e-9 < gap < 1e-2
