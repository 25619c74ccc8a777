"""Cache-inventory annotations (the port's copy of
``filodb_tpu/lint/caches.py``).

The cache-soundness bugs this design has had (a results-cache key
without its dispatch scope, a watermark that ignored shard coverage)
were *invalidation-completeness* misses: some world-mutation event existed
that the cache's key or invalidation hooks did not account for, and a
human had to notice at review time. These annotations mechanize that
review. A cache DECLARES the events that affect its keys; event
publishers and authoritative state readers are marked; and graftlint's
``cache-invalidation-completeness`` rule checks, over the project call
graph, that the wiring is complete:

  * :func:`cache_registry` — class decorator declaring one cache the
    class owns, with the events that can change the world its entries
    were computed against:

      - ``invalidated_by={event: hook_method}`` — **push** events: the
        rule requires every ``@publishes(event)`` function in the
        project to REACH ``hook_method`` through the call graph
        (including listener/subscriber indirection — see the
        registration-bridge inference in ``lint/dataflow.py``).
      - ``validated_by={event: hook_methods}`` — **pull** events,
        checked at lookup time rather than pushed: the rule requires
        each named hook to reach an ``@event_source(event)`` function
        (the authoritative read of that event's state), so the check
        cannot silently rot out of the lookup path.
      - ``keyed=(...)`` — key components that make the cache immune to
        an event class by construction (a chunk-count in the key needs
        no chunk invalidation hook). Documentation + inventory only.

    Decorators stack for classes owning several caches.

  * :func:`publishes` — marks a function as a mutation publisher of an
    event (the topology-epoch bump, the backfill-epoch bump, a schema
    invalidation broadcast). Every publisher of a push event must reach
    every registered cache's hook for it.

  * :func:`event_source` — marks the authoritative reader of a pull
    event's state (``shards_epoch``, ``shards_watermark``). Pull hooks
    must reach one.

Classes whose name or dict-attribute names say "cache" but carry no
registry are themselves a finding (``cache-unregistered``): an
unregistered cache is one nobody has thought about invalidation for.

Module-level caches (the tilestore executable tables) declare through a
plain assignment the checker reads the same way::

    __cache_registry__ = {
        "tilestore-executables": {"keyed": ("kernel", "shape-bucket")},
    }

All decorators are runtime-neutral: they only record attributes
(``cls.__cache_registry__``, ``fn.__publishes__``,
``fn.__event_source__``) and feed the runtime inventory behind the
README's cache table.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Union

# runtime inventory: cache name -> declaration (module, class, events)
CACHES: Dict[str, Dict[str, object]] = {}


def _norm_hooks(v: Union[str, Iterable[str], None]) -> tuple:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


def cache_registry(name: str,
                   invalidated_by: Optional[Dict[str, str]] = None,
                   validated_by: Optional[Dict[str, object]] = None,
                   keyed: Iterable[str] = ()):
    """Declare one cache owned by the decorated class (see module
    docstring). ``invalidated_by`` maps push events to the hook method
    called on them; ``validated_by`` maps pull events to the lookup
    method(s) that check them; ``keyed`` names key components."""
    def deco(cls):
        reg = dict(getattr(cls, "__cache_registry__", {}) or {})
        entry = {
            "invalidated_by": dict(invalidated_by or {}),
            "validated_by": {k: _norm_hooks(v)
                             for k, v in (validated_by or {}).items()},
            "keyed": tuple(keyed),
            "owner": cls.__name__,
            "module": cls.__module__,
        }
        reg[name] = entry
        cls.__cache_registry__ = reg
        CACHES[name] = entry
        return cls
    return deco


def publishes(event: str) -> Callable:
    """Mark a function as a mutation publisher of ``event``."""
    def deco(fn):
        evs = list(getattr(fn, "__publishes__", ()) or ())
        evs.append(event)
        fn.__publishes__ = tuple(evs)
        return fn
    return deco


def event_source(event: str) -> Callable:
    """Mark a function as the authoritative read of ``event``'s
    state (what pull-model validation hooks must consult)."""
    def deco(fn):
        evs = list(getattr(fn, "__event_source__", ()) or ())
        evs.append(event)
        fn.__event_source__ = tuple(evs)
        return fn
    return deco


def cache_inventory() -> Dict[str, Dict[str, object]]:
    """The runtime cache inventory (registered declarations seen by
    imported modules) — the README table's source of truth."""
    return dict(CACHES)
