"""The one generator of every traffic mix: it reads a mix's data file
(`traffic/<mix>.json`) and the configuration's time bounds and label
domains, and draws each client's sequence of range queries from the seed.

A mix names its loop, its clients, and its query templates. In a closed
loop each client sends its next request when the last answer is in; in an
open one each request carries `at`, the seconds into the window before
which it is not sent (harness/client.py). Each template has a weight, a
PromQL text whose `{param}` fields are filled with label values drawn from
the configuration's `label_domains`, a range and step, the lookback its
windows reach behind the first step, and where its end may fall:
`flushed` (the last step before the first unflushed sample), or a rule of
the mix's own. Ends fall on whole seconds, uniformly over what the data
allows. Set-up warms one query of each template.

Every client's sequence is made of blocks that hold each template exactly
`weight` times, in an order drawn from the seed, so every seed sends the
same mix of work and only its order, its ends and its labels differ.

A mix may bring `traffic/<mix>.py` beside its data file, with either of:

  END_RULES = {"<rule>": latest_end_ms(cfg)}   further `end_within` rules
  def sequence(mix, seed, client) -> [request]  a client's own draws
                                                (an open loop's arrivals)
"""

from __future__ import annotations

import numpy as np


def time_bounds(cfg: dict) -> dict:
    """Bounds in ms of the configuration's data: the first sample and the
    last instant before any unflushed sample."""
    start, dt = cfg["start_ms"], cfg["interval_ms"]
    jit = cfg.get("jitter_ms", 0)
    n, tail = cfg["flushed_samples"], cfg.get("tail_samples", 0)
    return {"first": start + jit,
            "flushed_end": start + n * dt - jit - 1 if tail
            else start + (n - 1) * dt}


def label_values(cfg: dict, label: str) -> list:
    dom = cfg["label_domains"][label]
    return [dom["format"].format(i) for i in range(dom["count"])]


class Template:
    def __init__(self, spec: dict, cfg: dict, end_rules: dict):
        self.name = spec["name"]
        self.weight = int(spec["weight"])
        self.promql = spec["promql"]
        self.range_s = int(spec["range_s"])
        self.step_s = int(spec["step_s"])
        self.lookback_s = int(spec["lookback_s"])
        if self.range_s % self.step_s:
            raise ValueError(f"{self.name}: range not a whole number of "
                             f"steps")
        b = time_bounds(cfg)
        rule = end_rules.get(spec["end_within"])
        if rule is None:
            raise ValueError(f"{self.name}: unknown end_within "
                             f"{spec['end_within']!r}")
        self.end_lo = -(-(b["first"] + 1000 * (self.lookback_s
                                                + self.range_s)) // 1000)
        self.end_hi = rule(cfg) // 1000
        if self.end_hi < self.end_lo:
            raise ValueError(f"{self.name}: the data is too short for it")
        self.params = {k: (label_values(cfg, p["label"]), int(p["count"]),
                           p["join"])
                       for k, p in spec.get("params", {}).items()}

    def draw(self, rng: np.random.Generator) -> dict:
        """One request."""
        end = int(rng.integers(self.end_lo, self.end_hi + 1))
        q = self.promql
        for key, (values, count, join) in self.params.items():
            pick = rng.choice(len(values), count, replace=False)
            q = q.replace("{" + key + "}",
                          join.join(values[i] for i in sorted(pick)))
        return {"template": self.name, "query": q, "start": end - self.range_s,
                "end": end, "step": self.step_s}


BUILTIN_END_RULES = {"flushed": lambda cfg: time_bounds(cfg)["flushed_end"]}


class Mix:
    def __init__(self, spec: dict, cfg: dict, module=None):
        self.loop = spec.get("loop")
        self._sequence = getattr(module, "sequence", None)
        if self.loop not in ("closed", "open"):
            raise ValueError(f"unknown loop {self.loop!r}")
        if self.loop == "open" and self._sequence is None:
            raise ValueError("an open loop needs the mix's own sequence() "
                             "to give each request its `at`")
        self.name = spec["name"]
        self.clients = int(spec["clients"])
        self.per_client = int(spec["requests_per_client"])
        self.path = spec["path"]
        self.checked_per_query = int(spec["checked_per_query"])
        rules = {**BUILTIN_END_RULES, **getattr(module, "END_RULES", {})}
        self.templates = [Template(t, cfg, rules) for t in spec["queries"]]

    def _block(self) -> list:
        return [t for t in self.templates for _ in range(t.weight)]

    def sequence(self, seed: int, client: int) -> list:
        if self._sequence is not None:
            seq = self._sequence(self, seed, client)
            if self.loop == "open" and any("at" not in r for r in seq):
                raise ValueError("an open loop's request lacks its `at`")
            return seq
        rng = np.random.default_rng([seed, 1, client])
        block = self._block()
        out = []
        while len(out) < self.per_client:
            for i in rng.permutation(len(block)):
                out.append(block[i].draw(rng))
        return out[:self.per_client]

    def plan(self, seed: int) -> list:
        return [self.sequence(seed, c) for c in range(self.clients)]

    def warm(self, seed: int) -> list:
        """The set-up's queries, drawn apart from the clients': one of each
        template."""
        rng = np.random.default_rng([seed, 2])
        return [t.draw(rng) for t in self.templates]
