"""Tag index: label filters -> partition ids.

Replaces the reference's per-shard Apache Lucene index
(core/src/main/scala/filodb.core/memstore/PartKeyLuceneIndex.scala:49,128;
abstract API PartKeyIndex.scala).  Same query surface — Equals / In / Regex /
NotEquals / NotRegex / Prefix filters, label-values facets, start/end-time
range lookups — implemented as in-memory inverted maps per shard.  High-
cardinality scaling (roaring bitmaps / C++ index) is a later optimization;
the API is the stable boundary.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set

import numpy as np

from filodb_tpu_torch.lint.locks import single_writer


# sentinel for "still ingesting" (PartKeyLuceneIndex endTime semantics)
END_TIME_INGESTING = (1 << 62)


@dataclass(frozen=True)
class ColumnFilter:
    """One label filter (core/query/Filter in the reference)."""
    label: str
    op: str          # eq | neq | in | nin | re | nre | prefix
    value: object    # str for eq/re/prefix, tuple for in

    # constructors
    @staticmethod
    def eq(label: str, value: str) -> "ColumnFilter":
        return ColumnFilter(label, "eq", value)

    @staticmethod
    def neq(label: str, value: str) -> "ColumnFilter":
        return ColumnFilter(label, "neq", value)

    @staticmethod
    def in_(label: str, values: Sequence[str]) -> "ColumnFilter":
        return ColumnFilter(label, "in", tuple(values))

    @staticmethod
    def regex(label: str, pattern: str) -> "ColumnFilter":
        return ColumnFilter(label, "re", pattern)

    @staticmethod
    def not_regex(label: str, pattern: str) -> "ColumnFilter":
        return ColumnFilter(label, "nre", pattern)

    @staticmethod
    def prefix(label: str, pfx: str) -> "ColumnFilter":
        return ColumnFilter(label, "prefix", pfx)


def _full_match(pattern: str, value: str) -> bool:
    return re.fullmatch(pattern, value) is not None


@single_writer("one index per shard, mutated only by the shard's "
               "owning thread (ingest driver / pre-driver bootstrap)")
class TagIndex:
    """Inverted index for one shard: label -> value -> set(part_id), plus
    per-part start/end times (the ``__startTime__``/``__endTime__`` doc values
    of PartKeyLuceneIndex.scala)."""

    def __init__(self):
        self._postings: Dict[str, Dict[str, Set[int]]] = {}
        self._labels: Dict[int, Mapping[str, str]] = {}
        self._start: Dict[int, int] = {}
        self._end: Dict[int, int] = {}
        self._all: Set[int] = set()

    # -- write path -------------------------------------------------------
    def add_part_key(self, part_id: int, labels: Mapping[str, str],
                     start_time: int,
                     end_time: int = END_TIME_INGESTING) -> None:
        self._labels[part_id] = labels
        self._start[part_id] = start_time
        self._end[part_id] = end_time
        self._all.add(part_id)
        for k, v in labels.items():
            self._postings.setdefault(k, {}).setdefault(v, set()).add(part_id)

    def update_end_time(self, part_id: int, end_time: int) -> None:
        if part_id in self._end:
            self._end[part_id] = end_time

    def start_time(self, part_id: int) -> Optional[int]:
        return self._start.get(part_id)

    def end_time(self, part_id: int) -> Optional[int]:
        return self._end.get(part_id)

    def remove_part_keys(self, part_ids: Iterable[int]) -> None:
        for pid in part_ids:
            labels = self._labels.pop(pid, None)
            if labels is None:
                continue
            self._all.discard(pid)
            self._start.pop(pid, None)
            self._end.pop(pid, None)
            for k, v in labels.items():
                vals = self._postings.get(k)
                if vals and v in vals:
                    vals[v].discard(pid)
                    if not vals[v]:
                        del vals[v]

    # -- read path --------------------------------------------------------
    def posting_upper_bound(self, filters: Sequence[ColumnFilter]
                            ) -> Optional[int]:
        """Cheap (O(#filters), no set intersection) upper bound on the
        series an equality-filter set can match: the smallest posting
        list among the eq filters. None when no eq filter names an
        indexed label — the caller falls back to its cardinality-tree
        estimate. This is the QoS cost estimator's tag-index input; it
        must stay cheap enough to run BEFORE admission."""
        best: Optional[int] = None
        for f in filters:
            if getattr(f, "op", "") != "eq":
                continue
            vals = self._postings.get(f.label)
            if vals is None:
                continue
            n = len(vals.get(f.value, ()))
            if best is None or n < best:
                best = n
        return best

    def _ids_for_filter(self, f: ColumnFilter) -> Set[int]:
        vals = self._postings.get(f.label, {})
        if f.op == "eq":
            return set(vals.get(f.value, ()))
        if f.op == "in":
            out: Set[int] = set()
            for v in f.value:
                out |= vals.get(v, set())
            return out
        if f.op == "re":
            # Prometheus fast-path: a plain-string regex is an equals match
            out = set()
            for v, ids in vals.items():
                if _full_match(f.value, v):
                    out |= ids
            return out
        if f.op == "prefix":
            out = set()
            for v, ids in vals.items():
                if v.startswith(f.value):
                    out |= ids
            return out
        if f.op == "neq":
            matched: Set[int] = set(vals.get(f.value, ()))
            return self._all - matched
        if f.op == "nre":
            matched = set()
            for v, ids in vals.items():
                if _full_match(f.value, v):
                    matched |= ids
            return self._all - matched
        raise ValueError(f"unknown filter op {f.op}")

    def part_ids_from_filters(self, filters: Sequence[ColumnFilter],
                              start_time: int, end_time: int) -> List[int]:
        """Series matching all filters whose [start,end] lifetime overlaps the
        query range (partIdsFromFilters, PartKeyLuceneIndex.scala:993ff)."""
        if filters:
            ids: Optional[Set[int]] = None
            for f in filters:
                got = self._ids_for_filter(f)
                ids = got if ids is None else (ids & got)
                if not ids:
                    return []
        else:
            ids = set(self._all)
        out = [
            pid for pid in ids
            if self._start[pid] <= end_time and self._end[pid] >= start_time
        ]
        out.sort()
        return out

    def label_values(self, label: str,
                     filters: Sequence[ColumnFilter] = (),
                     start_time: int = 0,
                     end_time: int = END_TIME_INGESTING) -> List[str]:
        """Distinct values of a label (labelValuesEfficient /
        LabelValues facet path)."""
        if not filters:
            return sorted(self._postings.get(label, {}).keys())
        pids = set(self.part_ids_from_filters(filters, start_time, end_time))
        out = {
            v for v, ids in self._postings.get(label, {}).items()
            if ids & pids
        }
        return sorted(out)

    def label_names(self, filters: Sequence[ColumnFilter] = (),
                    start_time: int = 0,
                    end_time: int = END_TIME_INGESTING) -> List[str]:
        if not filters:
            return sorted(self._postings.keys())
        pids = self.part_ids_from_filters(filters, start_time, end_time)
        names: Set[str] = set()
        for pid in pids:
            names |= set(self._labels[pid].keys())
        return sorted(names)

    def labels_for(self, part_id: int) -> Mapping[str, str]:
        return self._labels[part_id]

    @property
    def num_parts(self) -> int:
        return len(self._all)
