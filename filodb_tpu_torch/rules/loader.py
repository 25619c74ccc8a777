"""Rule-group loader: Prometheus-style rule files -> typed groups (the
counterpart of ``filodb_tpu.rules.loader``).

The file format is the Prometheus ruler's (``groups:`` with per-group
``interval`` and ``rules:`` carrying either ``record:`` or ``alert:``
entries), parsed from YAML when PyYAML is present (it is baked into the
serving image) or from JSON otherwise — the loader never *requires* the
YAML dependency, matching the repo's no-new-deps rule. Two extensions:

* ``dataset:`` (group) — the SOURCE dataset the group's expressions
  evaluate against (default: the node's main dataset; ``__selfmon__``
  turns a group into alerting-on-our-own-telemetry).
* ``schema: counter|gauge`` (recording rule) — the ingest schema of the
  recorded series. Default is the counter-suffix heuristic the selfmon
  rail uses (``*_total``/``_bucket``/``_count``/``_sum`` -> counter
  schema, so ``rate()`` over a recorded counter gets reset correction).

Validation is promtool-shaped: structural errors, PromQL syntax through
the NORMAL parser (the engine evaluates exactly what validated),
duplicate-rule detection (same type + name + static labels anywhere in
the file, plus parser-NORMALIZED expression comparison so whitespace/
label-order variants are caught), and promlint semantic analysis
(:mod:`filodb_tpu_torch.promql.semant`): type/schema errors — e.g. ``rate()``
on a metric another rule declares ``schema: gauge`` — and provably-
broken vector matching REJECT the file at load time; warning-severity
findings surface without failing. ``python -m filodb_tpu_torch.rules --check
<file>`` runs it from the command line; the shipped example file is
validated in the tier-1 gate.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from filodb_tpu_torch.promql import semant
from filodb_tpu_torch.promql.parser import (ParseError, TimeStepParams,
                                            normalize_query,
                                            parse_duration_ms,
                                            parse_query_range)

DEFAULT_GROUP_INTERVAL_S = 60.0

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class RuleLoadError(ValueError):
    """A rule file failed to load; ``errors`` carries every finding."""

    def __init__(self, errors: List[str]):
        super().__init__("; ".join(errors))
        self.errors = list(errors)


@dataclass(frozen=True)
class Rule:
    """One recording or alerting rule (immutable; runtime state lives
    in the engine)."""
    name: str                   # record metric name / alert name
    expr: str
    kind: str                   # "recording" | "alerting"
    labels: Tuple[Tuple[str, str], ...] = ()
    annotations: Tuple[Tuple[str, str], ...] = ()
    for_s: float = 0.0          # alerting: pending hold duration
    schema: Optional[str] = None  # recording: "counter" | "gauge"

    @property
    def is_alert(self) -> bool:
        return self.kind == "alerting"


@dataclass(frozen=True)
class RuleGroup:
    name: str
    interval_s: float
    rules: Tuple[Rule, ...]
    dataset: Optional[str] = None   # None = the node's main dataset
    limit: int = 0                  # max series a rule may produce


def _parse_duration_s(raw, where: str, errors: List[str],
                      default: float = 0.0) -> float:
    if raw is None:
        return default
    if isinstance(raw, (int, float)) and not isinstance(raw, bool):
        return float(raw)
    try:
        return parse_duration_ms(str(raw)) / 1000.0
    except (ValueError, TypeError):
        errors.append(f"{where}: bad duration {raw!r}")
        return default


def _str_map(raw, where: str, errors: List[str],
             check_names: bool = False) -> Tuple[Tuple[str, str], ...]:
    if raw is None:
        return ()
    if not isinstance(raw, dict):
        errors.append(f"{where}: expected a mapping, got {type(raw).__name__}")
        return ()
    out = []
    for k, v in raw.items():
        if check_names and not _LABEL_NAME_RE.match(str(k)):
            errors.append(f"{where}: bad label name {k!r}")
            continue
        out.append((str(k), str(v)))
    return tuple(sorted(out))


def _check_expr(expr: str, where: str, errors: List[str]) -> None:
    """PromQL syntax check through the normal parser — the exact code
    path the engine evaluates with (no second grammar to drift)."""
    try:
        parse_query_range(str(expr), TimeStepParams(0, 60, 600))
    except ParseError as e:
        errors.append(f"{where}: PromQL syntax error: {e}")
    except Exception as e:   # noqa: BLE001 — a validator must not crash
        errors.append(f"{where}: expression rejected: {e}")


def load_groups(obj, errors: Optional[List[str]] = None,
                warnings: Optional[List[str]] = None) -> List[RuleGroup]:
    """Parse the Python-object form (``{"groups": [...]}`` or a bare
    group list). With ``errors=None`` raises :class:`RuleLoadError` on
    any finding; otherwise appends findings and returns what parsed.
    ``warnings`` (optional) collects non-fatal promlint findings."""
    own_errors = errors if errors is not None else []
    own_warnings = warnings if warnings is not None else []
    groups: List[RuleGroup] = []
    if isinstance(obj, dict):
        raw_groups = obj.get("groups")
        unknown = set(obj) - {"groups"}
        if unknown:
            own_errors.append(
                f"top level: unknown keys {sorted(unknown)}")
    else:
        raw_groups = obj
    if not isinstance(raw_groups, list) or not raw_groups:
        own_errors.append("no rule groups found (want groups: [...])")
        raw_groups = []
    seen_groups: set = set()
    seen_rules: Dict[Tuple, str] = {}
    # (where, kind, name, expr) for the promlint/normalization post-pass
    pending: List[Tuple[str, str, str, str]] = []
    for gi, g in enumerate(raw_groups):
        gw = f"group[{gi}]"
        if not isinstance(g, dict):
            own_errors.append(f"{gw}: expected a mapping")
            continue
        name = str(g.get("name") or "")
        if not name:
            own_errors.append(f"{gw}: missing name")
            name = f"group{gi}"
        gw = f"group {name!r}"
        if name in seen_groups:
            own_errors.append(f"{gw}: duplicate group name")
        seen_groups.add(name)
        interval_s = _parse_duration_s(g.get("interval"), gw, own_errors,
                                       DEFAULT_GROUP_INTERVAL_S)
        if interval_s <= 0:
            own_errors.append(f"{gw}: interval must be positive")
            interval_s = DEFAULT_GROUP_INTERVAL_S
        unknown = set(g) - {"name", "interval", "rules", "dataset",
                            "limit"}
        if unknown:
            own_errors.append(f"{gw}: unknown keys {sorted(unknown)}")
        rules: List[Rule] = []
        for ri, r in enumerate(g.get("rules") or ()):
            rw = f"{gw} rule[{ri}]"
            if not isinstance(r, dict):
                own_errors.append(f"{rw}: expected a mapping")
                continue
            record = r.get("record")
            alert = r.get("alert")
            if bool(record) == bool(alert):
                own_errors.append(
                    f"{rw}: exactly one of record:/alert: required")
                continue
            kind = "recording" if record else "alerting"
            rname = str(record or alert)
            rw = f"{gw} {kind} rule {rname!r}"
            expr = r.get("expr")
            if not expr:
                own_errors.append(f"{rw}: missing expr")
                continue
            _check_expr(expr, rw, own_errors)
            pending.append((rw, kind, rname, str(expr)))
            labels = _str_map(r.get("labels"), rw, own_errors,
                              check_names=True)
            annotations = _str_map(r.get("annotations"), rw, own_errors)
            schema = r.get("schema")
            allowed = {"expr", "labels"}
            if kind == "recording":
                allowed |= {"record", "schema"}
                if not _METRIC_NAME_RE.match(rname):
                    own_errors.append(f"{rw}: invalid metric name")
                if r.get("for") is not None:
                    own_errors.append(f"{rw}: for: is alert-only")
                if r.get("annotations") is not None:
                    own_errors.append(f"{rw}: annotations are alert-only")
                if schema is not None and schema not in ("counter",
                                                         "gauge"):
                    own_errors.append(
                        f"{rw}: schema must be counter|gauge")
            else:
                allowed |= {"alert", "for", "annotations",
                            "keep_firing_for"}
                if schema is not None:
                    own_errors.append(f"{rw}: schema: is recording-only")
            unknown = set(r) - allowed
            if unknown:
                own_errors.append(f"{rw}: unknown keys {sorted(unknown)}")
            for_s = _parse_duration_s(r.get("for"), rw, own_errors)
            dup_key = (kind, rname, labels)
            if dup_key in seen_rules:
                own_errors.append(
                    f"{rw}: duplicate rule (same name + labels as one "
                    f"in {seen_rules[dup_key]})")
            else:
                seen_rules[dup_key] = f"group {name!r}"
            rules.append(Rule(
                name=rname, expr=str(expr), kind=kind, labels=labels,
                annotations=annotations, for_s=for_s,
                schema=str(schema) if schema else None))
        if not rules:
            own_errors.append(f"{gw}: no rules")
        ds = g.get("dataset")
        groups.append(RuleGroup(
            name=name, interval_s=interval_s, rules=tuple(rules),
            dataset=str(ds) if ds else None,
            limit=int(g.get("limit") or 0)))
    _semantic_pass(groups, pending, own_errors, own_warnings)
    if errors is None and own_errors:
        raise RuleLoadError(own_errors)
    return groups


def _semantic_pass(groups: List[RuleGroup],
                   pending: List[Tuple[str, str, str, str]],
                   errors: List[str], warnings: List[str]) -> None:
    """Post-parse pass over every rule expression: promlint semantic
    diagnostics (error severity rejects the file; warnings surface),
    and parser-NORMALIZED duplicate detection — whitespace/label-order
    expression variants compare equal, and two recording rules that
    evaluate the identical normalized expression warn (the second is a
    wasted standing evaluation)."""
    # schema resolution sees EVERY recording rule's schema: extension,
    # across groups, so forward references resolve
    schemas = semant.MetricSchemas.from_rule_groups(groups)
    norm_seen: Dict[str, Tuple[str, str]] = {}
    for where, kind, rname, expr in pending:
        for d in semant.lint_query(expr, schemas):
            msg = f"{where}: promlint: {d.render(expr)}"
            if d.severity == semant.ERROR and \
                    d.rule != "promql-syntax":
                # syntax errors were already reported by _check_expr
                errors.append(msg)
            elif d.severity == semant.WARNING:
                warnings.append(msg)
        if kind != "recording":
            continue
        try:
            norm = normalize_query(expr)
        except (ParseError, ValueError):
            continue
        prev = norm_seen.get(norm)
        if prev is not None and prev[1] != rname:
            warnings.append(
                f"{where}: semantically identical expression to "
                f"{prev[0]} (normalized: {norm}) — one standing "
                f"evaluation would serve both")
        elif prev is None:
            norm_seen[norm] = (where, rname)


def parse_rules_text(text: str, errors: Optional[List[str]] = None,
                     warnings: Optional[List[str]] = None
                     ) -> List[RuleGroup]:
    """Parse YAML (when PyYAML is importable) or JSON rule-file text."""
    own_errors = errors if errors is not None else []
    stripped = text.lstrip()
    obj = None
    if stripped.startswith(("{", "[")):
        try:
            obj = json.loads(text)
        except ValueError as e:
            own_errors.append(f"JSON parse error: {e}")
    else:
        try:
            import yaml
        except ImportError:
            own_errors.append(
                "PyYAML is not available in this environment; supply "
                "the rule file as JSON ({\"groups\": [...]})")
        else:
            try:
                obj = yaml.safe_load(text)
            except yaml.YAMLError as e:
                own_errors.append(f"YAML parse error: {e}")
    if obj is None:
        if errors is None and own_errors:
            raise RuleLoadError(own_errors)
        return []
    out = load_groups(obj, errors=own_errors, warnings=warnings)
    if errors is None and own_errors:
        raise RuleLoadError(own_errors)
    return out


def load_rules_file(path: str) -> List[RuleGroup]:
    with open(path) as f:
        return parse_rules_text(f.read())


def check_rules_file(path: str) -> List[str]:
    """promtool-style validation: returns human-readable findings
    (empty = clean). Never raises on content errors — unreadable files
    come back as a finding too."""
    return check_rules_file_full(path)[0]


def check_rules_file_full(path: str) -> Tuple[List[str], List[str]]:
    """(errors, warnings) — errors reject the file (exit 1 from
    ``--check``); warning-severity promlint findings surface without
    failing (promtool's check-rules warning behavior)."""
    errors: List[str] = []
    warnings: List[str] = []
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return [f"cannot read {path}: {e}"], warnings
    groups = parse_rules_text(text, errors=errors, warnings=warnings)
    if not errors and not groups:
        errors.append("no rule groups found")
    return errors, warnings
