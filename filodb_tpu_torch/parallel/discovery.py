"""Cluster seed discovery of the port (the counterpart of
``filodb_tpu.parallel.discovery``): how a node finds its peers at
startup.

The reference boots its Akka cluster through pluggable seed discovery
(akka-bootstrapper/src/main/scala/filodb/akkabootstrapper/
AkkaBootstrapper.scala:31 — whitelist, DNS-SRV, and Consul strategies
selected by config). Same surface here, producing the {node_id: url}
peer map the standalone server and FailureDetector consume:

  * ``explicit-list`` — the static map from config (ExplicitList mode).
  * ``dns-srv``       — resolve an SRV name to host:port targets
                        (SrvSeedDiscovery): ordinals follow the sorted
                        target list so every node derives the SAME ids.
  * ``consul``        — query a Consul catalog service endpoint
                        (ConsulSeedDiscovery) over its HTTP API.

Resolvers/fetchers are injectable (tests and air-gapped environments);
the defaults use dnspython when present and urllib for Consul.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# one SRV/consul target: (host, port)
Target = Tuple[str, int]


def _default_srv_resolver(name: str) -> List[Target]:
    try:
        import dns.resolver  # type: ignore
    except ImportError as e:        # pragma: no cover - env dependent
        raise RuntimeError(
            "dns-srv discovery needs the dnspython package or an "
            "injected resolver") from e
    out = []
    for r in dns.resolver.resolve(name, "SRV"):   # pragma: no cover
        out.append((str(r.target).rstrip("."), int(r.port)))
    return out


def _default_consul_fetcher(url: str) -> List[dict]:
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _peer_map(targets: Sequence[Target], scheme: str) -> Dict[str, str]:
    """Deterministic node ids: every node sorts the same target list, so
    ordinals agree cluster-wide without a coordinator (the property the
    reference gets from sorted seed addresses)."""
    ordered = sorted(set(targets))
    return {f"node{i}": f"{scheme}://{host}:{port}"
            for i, (host, port) in enumerate(ordered)}


def discover_peers(config: dict,
                   srv_resolver: Optional[Callable] = None,
                   consul_fetcher: Optional[Callable] = None
                   ) -> Dict[str, str]:
    """Resolve the peer map for a discovery config:

      {"mode": "explicit-list", "peers": {...}}
      {"mode": "dns-srv", "srv-name": "_filodb._tcp.ns.svc"}
      {"mode": "consul", "url": "http://consul:8500", "service": "filodb"}
    """
    mode = (config or {}).get("mode", "explicit-list")
    scheme = (config or {}).get("scheme", "http")
    if mode == "explicit-list":
        return dict((config or {}).get("peers") or {})
    if mode == "dns-srv":
        name = config["srv-name"]
        resolver = srv_resolver or _default_srv_resolver
        return _peer_map(resolver(name), scheme)
    if mode == "consul":
        base = config["url"].rstrip("/")
        service = config["service"]
        fetcher = consul_fetcher or _default_consul_fetcher
        rows = fetcher(f"{base}/v1/catalog/service/{service}")
        targets = [(row.get("ServiceAddress") or row.get("Address"),
                    int(row["ServicePort"])) for row in rows]
        return _peer_map(targets, scheme)
    raise ValueError(f"unknown discovery mode {mode!r}")
