"""GitHub-workflow annotations & SARIF reports from graftlint findings.

Turns a :class:`~filodb_tpu_torch.lint.LintResult` (or its ``--json``
serialization) into GitHub's workflow-command lines::

    ::error file=filodb_tpu_torch/query/backend.py,line=512,title=graftlint trace-side-effect::print() inside a traced function

printed on stdout so a CI step like

.. code-block:: yaml

    - run: python -m filodb_tpu_torch.lint --github

surfaces findings as inline PR annotations. New findings annotate as
``error``; baselined (grandfathered) findings annotate as ``warning``
so they stay visible without failing the run. Messages are sanitized
per the workflow-command escaping rules (%, CR, LF in the message;
additionally ``,`` and ``:`` in properties).
"""

from __future__ import annotations

from typing import Dict, List


def _esc_msg(s: str) -> str:
    return (str(s).replace("%", "%25").replace("\r", "%0D")
            .replace("\n", "%0A"))


def _esc_prop(s: str) -> str:
    return (_esc_msg(s).replace(":", "%3A").replace(",", "%2C"))


def _line(level: str, f: Dict) -> str:
    return (f"::{level} file={_esc_prop(f.get('path', ''))},"
            f"line={int(f.get('line', 1))},"
            f"title={_esc_prop('graftlint ' + f.get('rule', ''))}"
            f"::{_esc_msg(f.get('message', ''))}")


def github_annotations(result_json: Dict) -> List[str]:
    """Workflow-command lines for one lint run (``LintResult.to_json()``
    shape): errors for new findings, warnings for baselined ones."""
    out: List[str] = []
    for f in result_json.get("findings", []):
        level = "error" if f.get("severity", "error") == "error" \
            else "warning"
        out.append(_line(level, f))
    for f in result_json.get("baselined", []):
        out.append(_line("warning", f))
    return out


def _sarif_result(f: Dict, level: str) -> Dict:
    return {
        "ruleId": f.get("rule", ""),
        "level": level,
        "message": {"text": f.get("message", "")},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.get("path", ""),
                                     "uriBaseId": "%SRCROOT%"},
                "region": {"startLine": max(int(f.get("line", 1)), 1)},
            },
        }],
        "partialFingerprints": {
            "graftlint/key": f"{f.get('path', '')}::{f.get('rule', '')}"
                             f"::{f.get('context', '')}",
        },
    }


def sarif_report(result_json: Dict) -> Dict:
    """SARIF 2.1.0 log for one lint run (``LintResult.to_json()``
    shape) so findings land in code-scanning UIs. The tool driver
    carries the FULL rule catalog — every graftlint family (kernel,
    trace, lock, concurrency, spmd, cache, promql, numerics, span,
    hot-path, meta) — so the UI can group and filter by rule; new
    findings report at their registered severity, baselined
    (grandfathered) findings report as ``note`` so they stay visible
    without failing a gate."""
    from filodb_tpu_torch.lint import rules
    catalog = rules()
    driver_rules = [
        {
            "id": rid,
            "shortDescription": {"text": rule.doc},
            "properties": {"family": rule.family},
            "defaultConfiguration": {
                "level": "error" if rule.severity == "error"
                else "warning"},
        }
        for rid, rule in sorted(catalog.items())
    ]
    results: List[Dict] = []
    for f in result_json.get("findings", []):
        level = "error" if f.get("severity", "error") == "error" \
            else "warning"
        results.append(_sarif_result(f, level))
    for f in result_json.get("baselined", []):
        results.append(_sarif_result(f, "note"))
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri": "https://example.invalid/graftlint",
                "rules": driver_rules,
            }},
            "results": results,
        }],
    }
