"""Lock-discipline annotations.

:func:`guarded_by` is a class decorator declaring that certain instance
fields may only be touched while a named lock attribute of the same
object is held:

    @guarded_by("_cache_lock", "_decode_cache", "_merge_cache")
    class TimeSeriesPartition: ...

Decorators stack for fields guarded by different locks. The decorator
is runtime-neutral (it only records ``cls.__guarded_by__``); the AST
checker in ``filodb_tpu.lint.rules_lock`` enforces, statically:

  * every read/write of a guarded ``self.<field>`` happens inside a
    ``with self.<lock>:`` block (``__init__`` and methods whose name
    ends in ``_locked`` — the caller-holds-the-lock convention — are
    exempt);
  * accesses through another object (``part._decode_cache``) require
    ``with part.<lock>:``; foreign-object checks apply to
    underscore-prefixed fields only (public counters may be read racily
    by design — suppress with a pragma where that is intentional);
  * no blocking call (sleep / socket / dial / fan-out) is made while
    any declared lock is held.

Module-level shared state uses a plain dict assignment the checker
reads the same way::

    __guarded_by__ = {"_channels": "_channels_lock"}
"""

from __future__ import annotations


def guarded_by(lock: str, *fields: str):
    """Declare ``fields`` guarded by instance attribute ``lock``."""
    def deco(cls):
        decls = dict(getattr(cls, "__guarded_by__", {}) or {})
        for f in fields:
            decls[f] = lock
        cls.__guarded_by__ = decls
        return cls
    return deco


def single_writer(reason: str):
    """Declare that instances of this class are mutated by at most ONE
    thread at a time *by design* — the per-shard single-writer
    invariant (a shard's index/partitions/stats are touched only by the
    thread that currently owns the shard: its ingestion driver, or the
    bootstrap that runs strictly before the driver starts; ownership
    transfer is a happens-before edge the membership protocol pins).

    graftlint's ``thread-unguarded-shared-state`` inference reasons per
    (class, attribute) and cannot see that two roots mutate *disjoint
    instances*; this declaration is the documented escape hatch — and,
    like a pragma, it REQUIRES a reason string. Runtime-neutral: only
    records ``cls.__single_writer__``."""
    def deco(cls):
        cls.__single_writer__ = reason
        return cls
    return deco
