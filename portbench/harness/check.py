"""The comparison that decides `correct`: the JSON answers that the timed
window's requests got over HTTP, held against the plain reference
(`reference/promql.py`) over the samples the benchmark generated.

Each answer must carry the reference's series (labels without __name__),
each with a value at exactly the steps where the reference has one. The
number compared is the widest gap over every such value:
|served - reference| / max(|reference|, 1), relative where a value is
1 or more and absolute below. An answer that is not a success, names
other series or other steps reads as an infinite gap.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional, Tuple

import numpy as np

from portbench.reference import promql


def served_grid(body: bytes, steps_ms: np.ndarray
                ) -> Tuple[Optional[Dict], str]:
    """A Prometheus matrix answer -> ({label pairs: [T] values, NaN where
    the answer has no sample}, "") or (None, what is wrong with it)."""
    try:
        doc = json.loads(body)
    except ValueError as e:
        return None, f"not JSON: {e}"
    if doc.get("status") != "success":
        return None, f"status {doc.get('status')!r}: {doc.get('error')!r}"
    data = doc.get("data") or {}
    if data.get("resultType") != "matrix":
        return None, f"resultType {data.get('resultType')!r}"
    pos = {int(t): i for i, t in enumerate(steps_ms)}
    out = {}
    for r in data.get("result", []):
        key = tuple(sorted((k, v) for k, v in r["metric"].items()
                           if k != "__name__"))
        if key in out:
            return None, f"series {dict(key)} answered twice"
        row = np.full(steps_ms.size, np.nan)
        for t, v in r["values"]:
            i = pos.get(int(round(float(t) * 1000)))
            if i is None:
                return None, f"a sample at {t}, off the step grid"
            row[i] = float(v)
        out[key] = row
    return out, ""


def gap(served: Dict, want: Dict) -> Tuple[float, str]:
    """(widest gap, where it lies or what disagrees) of a served answer
    against the reference's."""
    if set(served) != set(want):
        extra = len(set(served) - set(want))
        missing = len(set(want) - set(served))
        return math.inf, f"{extra} series not in the reference, {missing} missing"
    worst, where = 0.0, ""
    for key, ref in want.items():
        got = served[key]
        have_r, have_g = ~np.isnan(ref), ~np.isnan(got)
        if (have_r != have_g).any():
            return math.inf, (f"series {dict(key)}: values at "
                              f"{int((have_g & ~have_r).sum())} steps the "
                              f"reference leaves empty, none at "
                              f"{int((have_r & ~have_g).sum())} it fills")
        if have_r.any():
            r = ref.astype(np.float64)
            d = np.where(have_r, np.abs(got - r) / np.maximum(np.abs(r), 1.0),
                         0.0)
            i = int(np.argmax(d))
            if d[i] > worst:
                worst = float(d[i])
                where = (f"series {dict(key)} step {i}: served {got[i]!r}, "
                         f"reference {r[i]!r}")
    return worst, where


def _args(req: dict):
    return req["query"], req["start"], req["end"], req["step"]


def check_answer(req: dict, body: bytes, data: promql.Series
                 ) -> Tuple[float, str]:
    """The gap of one served answer to the request `req` (query, start,
    end, step in s) against the float64 reference."""
    steps = promql.steps_ms(req["start"], req["end"], req["step"])
    got, why = served_grid(body, steps)
    if got is None:
        return math.inf, why
    return gap(got, data.evaluate(*_args(req), np.float64))


def control_gap(req: dict, data: promql.Series, dtype=np.float32) -> float:
    """The gap of the reference computed in `dtype`, put in the program's
    place, against the float64 reference: the control's reading."""
    low = {k: v.astype(np.float64)
           for k, v in data.evaluate(*_args(req), dtype).items()}
    return gap(low, data.evaluate(*_args(req), np.float64))[0]
