"""Rank-invariance declarations for code that runs on every rank of a
``torch.distributed`` group.

A cross-process collective hangs the group when one rank skips it, so
``spmd-collective-balance`` (``rules_spmd``) flags a collective under
Python control flow whose test it cannot prove takes the same branch on
every rank. The proof starts from what the code declares here, the
counterpart of the reference's ``static_argnames``:

    @rank_invariant("func", "agg", "num_groups",
                    reason="every rank runs the same query")
    def window_aggregate_distributed(mesh_ex, local_series, ...): ...

The named parameters hold the same value on every rank. Everything else
a rank reads (its own data before agreement, its rank, the clock, the
environment, a random draw) is rank-dependent until a collective agrees
on it: the result of a collective is rank-invariant.

The decorator is runtime-neutral: it attaches ``__rank_invariant__``
and returns the function unchanged.
"""

from __future__ import annotations

from typing import Callable


def rank_invariant(*params: str, reason: str) -> Callable:
    """Declare the parameters of ``fn`` that every rank passes the same
    value; ``reason`` says why (which caller or protocol makes it so)."""
    if not reason or not reason.strip():
        raise ValueError("@rank_invariant requires a non-empty reason")

    def deco(fn):
        fn.__rank_invariant__ = frozenset(params)
        return fn
    return deco
