"""The one generator's draws: exact mixes, ends inside the data, labels
drawn from the configuration's domains, repeatable from the seed, and a
mix's own rules and draws taken from its module."""

import re
import types
from collections import Counter

import numpy as np
import pytest

from portbench.harness.traffic import Mix, time_bounds

# every mix with its configuration
PAIRS = (("tsbs-devops-cpu", "tsbs-mix"),)


def mix_of(bench, pair, module=None):
    cfg = bench.config(pair[0])
    return Mix(bench.traffic(pair[1]), cfg, module), cfg


@pytest.mark.parametrize("pair", PAIRS, ids=[p[1] for p in PAIRS])
def test_every_block_holds_the_weights_exactly(pair, tiny_bench):
    mix, _ = mix_of(tiny_bench, pair)
    block = sum(t.weight for t in mix.templates)
    seq = mix.sequence(99, 0)
    assert len(seq) == mix.per_client
    for i in range(0, len(seq) - block + 1, block):
        got = Counter(r["template"] for r in seq[i:i + block])
        assert got == {t.name: t.weight for t in mix.templates}


@pytest.mark.parametrize("pair", PAIRS, ids=[p[1] for p in PAIRS])
def test_ends_fall_on_whole_seconds_inside_the_flushed_data(pair,
                                                            tiny_bench):
    mix, cfg = mix_of(tiny_bench, pair)
    b = time_bounds(cfg)
    spans = {t.name: t for t in mix.templates}
    for req in mix.plan(5)[0][:300]:
        t = spans[req["template"]]
        assert req["end"] - req["start"] == t.range_s
        assert req["step"] == t.step_s
        assert (req["start"] - t.lookback_s) * 1000 >= b["first"]
        assert req["end"] * 1000 <= b["flushed_end"]


def test_the_tsbs_templates_keep_the_generators_ranges_and_steps(
        tiny_bench):
    mix, _ = mix_of(tiny_bench, PAIRS[0])
    got = {t.name: ((t.range_s // t.step_s) + 1, t.step_s, t.lookback_s)
           for t in mix.templates}
    assert got == {"double-groupby-1": (13, 3600, 3600),
                   "cpu-max-all-8": (9, 3600, 3600),
                   "single-groupby-1-1-12": (721, 60, 60)}


def test_host_sets_are_distinct_hosts_of_the_domain(tiny_bench):
    mix, cfg = mix_of(tiny_bench, PAIRS[0])
    hosts = cfg["label_domains"]["hostname"]["count"]
    seen = Counter()
    for req in mix.plan(3)[1]:
        m = re.search(r"hostname=(~?)'([^']+)'", req["query"])
        if m:
            picked = m.group(2).split("|")
            seen[len(picked)] += 1
            assert len(set(picked)) == len(picked) == (8 if m.group(1)
                                                      else 1)
            assert all(0 <= int(h[5:]) < hosts for h in picked)
        assert "{host}" not in req["query"] and "{hosts}" not in req["query"]
    assert set(seen) == {1, 8}


def test_plans_repeat_from_the_seed_and_clients_differ(tiny_bench):
    mix, _ = mix_of(tiny_bench, PAIRS[0])
    a, b = mix.plan(2**31 + 11), mix.plan(2**31 + 11)
    assert a == b
    assert a[0] != a[1]
    assert mix.plan(12) != a
    assert mix.warm(12) != mix.plan(12)[0][:3]
    assert [r["template"] for r in mix.warm(12)] == \
        [t.name for t in mix.templates]


def test_a_mix_module_brings_its_end_rules_and_draws(tiny_bench):
    spec = tiny_bench.traffic("tsbs-mix")
    cfg = tiny_bench.config("tsbs-devops-cpu")
    first_end = time_bounds(cfg)["first"] // 1000 + 3600 + 43200 + 1
    spec = {**spec, "queries": [{**q, "end_within": "early"}
                                for q in spec["queries"]]}
    with pytest.raises(ValueError, match="end_within"):
        Mix(spec, cfg)
    mod = types.SimpleNamespace(END_RULES={"early": lambda c: first_end
                                           * 1000})
    mix = Mix(spec, cfg, mod)
    ends = {r["end"] for s in mix.plan(4) for r in s}
    assert max(ends) <= first_end
    # an open loop: the module's own sequence gives each request its `at`
    open_spec = {**spec, "loop": "open"}
    with pytest.raises(ValueError, match="open loop"):
        Mix(open_spec, cfg, mod)
    mod.sequence = lambda m, seed, c: [
        {**m.templates[0].draw(np.random.default_rng([seed, c, i])),
         "at": 0.5 * i} for i in range(4)]
    mix = Mix(open_spec, cfg, mod)
    assert [r["at"] for r in mix.sequence(1, 0)] == [0.0, 0.5, 1.0, 1.5]
    mod.sequence = lambda m, seed, c: [m.templates[0].draw(
        np.random.default_rng(seed))]
    with pytest.raises(ValueError, match="lacks its `at`"):
        Mix(open_spec, cfg, mod).sequence(1, 0)
