"""Data of the `tsbs-devops-cpu` configuration, drawn from the seed: TSBS's
devops use case, cpu-only. Every host carries the devops host tags and
ten cpu_usage_* gauges, each a random walk of N(0, 1) steps clamped to
[0, 100] from a uniform start (TSBS devops/cpu.go), one sample every
interval_ms exactly."""

import numpy as np

_REGIONS = {
    "us-east-1": ("us-east-1a", "us-east-1b", "us-east-1c", "us-east-1e"),
    "us-west-1": ("us-west-1a", "us-west-1b"),
    "us-west-2": ("us-west-2a", "us-west-2b", "us-west-2c"),
    "eu-west-1": ("eu-west-1a", "eu-west-1b", "eu-west-1c"),
    "eu-central-1": ("eu-central-1a", "eu-central-1b"),
    "ap-southeast-1": ("ap-southeast-1a", "ap-southeast-1b"),
    "ap-southeast-2": ("ap-southeast-2a", "ap-southeast-2b"),
    "ap-northeast-1": ("ap-northeast-1a", "ap-northeast-1c"),
    "sa-east-1": ("sa-east-1a", "sa-east-1b", "sa-east-1c"),
}
_OS = ("Ubuntu16.10", "Ubuntu16.04LTS", "Ubuntu15.10")
_ARCH = ("x64", "x86")
_TEAM = ("SF", "NYC", "LON", "CHI")
_ENV = ("production", "staging", "test")


def host_tags(rng: np.random.Generator, hosts: int) -> list:
    regions = list(_REGIONS)
    out = []
    for h in range(hosts):
        region = regions[rng.integers(len(regions))]
        dcs = _REGIONS[region]
        out.append({
            "hostname": f"host_{h}", "region": region,
            "datacenter": dcs[rng.integers(len(dcs))],
            "rack": str(rng.integers(100)), "os": _OS[rng.integers(3)],
            "arch": _ARCH[rng.integers(2)], "team": _TEAM[rng.integers(4)],
            "service": str(rng.integers(20)),
            "service_version": str(rng.integers(2)),
            "service_environment": _ENV[rng.integers(3)]})
    return out


def generate(cfg: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    hosts, metrics, N = cfg["hosts"], cfg["metrics"], cfg["flushed_samples"]
    tags = host_tags(rng, hosts)
    S = hosts * len(metrics)
    vals = np.empty((S, N))
    x = rng.uniform(0.0, 100.0, S)
    steps = rng.normal(0.0, 1.0, (N, S))
    for j in range(N):
        if j:
            x = np.clip(x + steps[j], 0.0, 100.0)
        vals[:, j] = x
    ts = np.broadcast_to(cfg["start_ms"] + np.arange(N, dtype=np.int64)
                         * cfg["interval_ms"], (S, N)).copy()
    labels = [{"__name__": m, "_ws_": cfg["ws"], "_ns_": cfg["ns"], **tags[h]}
              for h in range(hosts) for m in metrics]
    return {"labels": labels, "ts": ts, "vals": vals, "flushed": N}
