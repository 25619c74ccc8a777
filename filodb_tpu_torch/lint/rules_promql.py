"""graftlint promql family: the promlint semantic analyzer wired into
the repo's static-analysis gate.

Two checks run inside every ``python -m filodb_tpu_torch.lint``
invocation (and therefore inside ``tests/test_torch_lint.py``):

* **Rule-file sweep** — every shipped rule file (``examples/*.yaml`` /
  ``.yml`` / ``.json``) loads through the rules loader with promlint
  semantic analysis (:mod:`filodb_tpu_torch.promql.semant`): type errors,
  schema misuse (``rate()`` on a declared gauge), label-dataflow
  breaks, and normalized duplicate detection. Findings keep their
  ``promql-*`` rule ids, so ``--json`` / ``--github`` emit them under
  the promql family prefix and CI annotates the YAML line.

* **Differential micro-soak** — a tiny seeded arm of the full
  correctness rail (tests/test_torch_promql_differential.py): generated
  well-typed queries, engine-vs-reference, any mismatch is a
  ``promql-differential-mismatch`` finding. Skipped under
  ``--changed-only`` (the fast pre-commit path; the full soak runs in
  tier-1).
"""

from __future__ import annotations

import glob
import math
import os
import re
from typing import List, Optional, Tuple

from filodb_tpu_torch.lint import ERROR, WARNING, Finding, register_rule
from filodb_tpu_torch.promql.semant import RULES as _SEMANT_RULES

for _rid, (_sev, _doc) in sorted(_SEMANT_RULES.items()):
    register_rule(_rid, "promql", _doc, severity=_sev)
register_rule(
    "promql-rule-file", "promql",
    "a shipped rule file fails loader/structural validation")
register_rule(
    "promql-rule-file-warning", "promql",
    "non-fatal promlint finding in a shipped rule file",
    severity=WARNING)
register_rule(
    "promql-differential-mismatch", "promql",
    "a generated well-typed query evaluates differently on the engine "
    "and the pure-Python reference evaluator")

_RULE_ID_RE = re.compile(r"\[(promql-[\w\-]+)\]")

SOAK_SEED = 0x50AC
SOAK_QUERIES = 12


def _line_of(text: str, needle: str) -> int:
    """1-based line of the first occurrence of ``needle`` (trimmed) in
    ``text``; 1 when not found."""
    needle = needle.strip()
    if needle:
        for i, line in enumerate(text.splitlines(), start=1):
            if needle in line:
                return i
    return 1


def _rule_file_findings(path: str, root: str
                        ) -> List[Tuple[Optional[str], Finding]]:
    from filodb_tpu_torch.rules.loader import check_rules_file_full
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError:
        text = ""
    out: List[Tuple[Optional[str], Finding]] = []
    errors, warnings = check_rules_file_full(path)
    for msg, fallback_rule, severity in (
            [(e, "promql-rule-file", ERROR) for e in errors]
            + [(w, "promql-rule-file-warning", WARNING) for w in warnings]):
        m = _RULE_ID_RE.search(msg)
        rule = m.group(1) if m and m.group(1) in _SEMANT_RULES \
            else fallback_rule
        sev = _SEMANT_RULES[rule][0] if rule in _SEMANT_RULES \
            else severity
        # promlint renders carry the expr on their second line — use it
        # to anchor the finding at the expression's line in the YAML
        lines = msg.splitlines()
        anchor = lines[1] if len(lines) > 1 else msg
        head = lines[0]
        out.append((rel, Finding(
            rule=rule, path=rel, line=_line_of(text, anchor),
            message=head, severity=sev, context=f"rulefile:{rel}")))
    return out


def _soak_findings(root: str) -> List[Tuple[Optional[str], Finding]]:
    """Seeded engine-vs-reference micro-soak over synthetic in-memory
    data; each mismatch is one finding. Deterministic (fixed seed) so
    the gate cannot flake."""
    import numpy as np

    from filodb_tpu_torch.core.memstore import TimeSeriesShard
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
    from filodb_tpu_torch.promql.gen import QueryGen
    from filodb_tpu_torch.promql.parser import (TimeStepParams,
                                          parse_query_range)
    from filodb_tpu_torch.promql.refeval import (RefEvalError, RefSeries,
                                           ref_eval)
    from filodb_tpu_torch.query.engine import QueryEngine
    from filodb_tpu_torch.query.model import GridResult, ScalarResult

    t0 = 1_600_000_000
    start, step, end = t0 + 600, 60, t0 + 1200
    shard = TimeSeriesShard(DatasetRef("timeseries"), DEFAULT_SCHEMAS, 0)
    b = RecordBuilder(DEFAULT_SCHEMAS)
    ref: List = []
    import random as _random
    rng = _random.Random(3)
    for metric, schema in (("http_requests_total", "prom-counter"),
                           ("errors_total", "prom-counter"),
                           ("cpu_usage", "gauge"),
                           ("queue_depth", "gauge")):
        for inst in ("i0", "i1"):
            labels = {"_metric_": metric, "_ws_": "demo",
                      "_ns_": "App-0", "job": "api", "instance": inst}
            v = 0.0
            ts, vals = [], []
            for k in range(140):
                t = t0 + k * 10
                if rng.random() < 0.04:
                    continue
                v = v + rng.random() * 3 if schema == "prom-counter" \
                    else 20 * math.sin(k / 11.0) + rng.random()
                b.add_sample(schema, labels, t * 1000, v)
                ts.append(t * 1000)
                vals.append(v)
            ref.append(RefSeries(dict(labels), ts, vals))
    # classic-bucket histogram world for the generator's
    # histogram_quantile shapes (v4 widening): complete cumulative
    # bucket sets per (job, instance), monotone across le
    les = ("0.1", "0.5", "1", "2.5", "+Inf")
    for job in ("api", "web"):
        for inst in ("i0", "i1"):
            cum = [0.0] * len(les)
            per_le = {le: ([], []) for le in les}
            for k in range(140):
                t = t0 + k * 10
                if rng.random() < 0.04:
                    continue
                run = 0.0
                for bi, le in enumerate(les):
                    run += rng.random() * 2
                    cum[bi] += run
                    per_le[le][0].append(t * 1000)
                    per_le[le][1].append(cum[bi])
            for le in les:
                labels = {
                    "_metric_": "http_request_duration_seconds_bucket",
                    "_ws_": "demo", "_ns_": "App-0", "job": job,
                    "instance": inst, "le": le}
                hts, hvals = per_le[le]
                for t, v in zip(hts, hvals):
                    b.add_sample("prom-counter", labels, t, v)
                ref.append(RefSeries(dict(labels), list(hts),
                                     list(hvals)))
    for c in b.containers():
        shard.ingest(c)
    shard.flush_all()

    def canon(res):
        if isinstance(res, ScalarResult):
            return {(): list(res.values)}
        assert isinstance(res, GridResult)
        return {tuple(sorted(k.items())): list(res.values[i])
                for i, k in enumerate(res.keys)}

    def close(a, b):
        if math.isnan(a) and math.isnan(b):
            return True
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= 1e-6 + 1e-6 * max(abs(a), abs(b))

    out: List[Tuple[Optional[str], Finding]] = []
    g = QueryGen(seed=SOAK_SEED)
    rel = "filodb_tpu_torch/lint/rules_promql.py"
    for i in range(SOAK_QUERIES):
        q = g.query()
        try:
            plan = parse_query_range(q, TimeStepParams(start, step, end))
            eng = canon(QueryEngine([shard]).execute(plan))
            rf = ref_eval(q, ref, start, step, end)
        except RefEvalError:
            continue            # generator widened past refeval scope
        except Exception as e:  # noqa: BLE001 — a gate must not crash
            out.append((rel, Finding(
                rule="promql-differential-mismatch", path=rel, line=1,
                message=f"soak[{i}] {q!r} crashed: {e}",
                context=f"soak:{SOAK_SEED}:{i}")))
            continue
        bad = None
        if set(eng) != set(rf):
            bad = "series keysets differ"
        else:
            for k in eng:
                if not all(close(a, b) for a, b in zip(eng[k], rf[k])):
                    bad = f"values differ at {k}"
                    break
        if bad:
            out.append((rel, Finding(
                rule="promql-differential-mismatch", path=rel, line=1,
                message=f"soak[{i}] {q!r}: engine vs reference: {bad}",
                context=f"soak:{SOAK_SEED}:{i}")))
    return out


def check_project(mods, root: str, skip_soak: bool = False
                  ) -> List[Tuple[Optional[str], Finding]]:
    out: List[Tuple[Optional[str], Finding]] = []
    ex_dir = os.path.join(root, "examples")
    for pat in ("*.yaml", "*.yml", "*.json"):
        for path in sorted(glob.glob(os.path.join(ex_dir, pat))):
            out.extend(_rule_file_findings(path, root))
    if not skip_soak:
        out.extend(_soak_findings(root))
    return out
