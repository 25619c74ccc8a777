"""Each configuration's generator repeats exactly from its seed."""

import json

import numpy as np
import pytest

from conftest import TINY


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_seed_gives_the_same_data_and_another_seed_other_data(name,
                                                                tiny_bench):
    cfg = tiny_bench.config(name)
    gen = tiny_bench.datagen(name)
    a, b = gen.generate(cfg, 2**31 + 5), gen.generate(cfg, 2**31 + 5)
    c = gen.generate(cfg, 7)
    assert a["labels"] == b["labels"]
    np.testing.assert_array_equal(a["ts"], b["ts"])
    np.testing.assert_array_equal(a["vals"], b["vals"])
    assert not np.array_equal(a["vals"], c["vals"])


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_data_has_the_configured_shape(name, tiny_bench):
    cfg = tiny_bench.config(name)
    d = tiny_bench.datagen(name).generate(cfg, 11)
    n = cfg["flushed_samples"] + cfg.get("tail_samples", 0)
    assert d["ts"].shape == d["vals"].shape == (len(d["labels"]), n)
    assert d["flushed"] == cfg["flushed_samples"]
    assert (np.diff(d["ts"], axis=1) > 0).all()
    jit = cfg.get("jitter_ms", 0)
    nominal = cfg["start_ms"] + np.arange(n) * cfg["interval_ms"]
    assert np.abs(d["ts"] - nominal).max() <= jit
    assert len({json.dumps(lab, sort_keys=True)
                for lab in d["labels"]}) == len(d["labels"])


def test_gauges_walk_inside_0_to_100(tiny_bench):
    cfg = tiny_bench.config("tsbs-devops-cpu")
    d = tiny_bench.datagen("tsbs-devops-cpu").generate(cfg, 3)
    assert d["vals"].min() >= 0.0 and d["vals"].max() <= 100.0
    assert len(d["labels"]) == cfg["hosts"] * len(cfg["metrics"])
    steps = np.abs(np.diff(d["vals"], axis=1))
    assert steps.max() < 8.0        # N(0, 1) steps, clamped
