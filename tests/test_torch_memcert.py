"""The port's capacity-certification rail (``filodb_tpu_torch.lint.memcert``),
case for case the reference's ``tests/test_memcert.py``: every ``@capacity``
claim of the port certifies against its declared bytes budget on the CPU
(the sharded one at 1, 2, 4 and 8 partitions), the measurement is a walk
over distinct tensor storages, lying claims (understated, slack, orphan)
are flagged, and the ledger projects the same resident series per card as
the JAX package's for the claims whose layout is the reference's."""

import gc
import math

import numpy as np
import pytest
import torch

from filodb_tpu_torch.lint import capacity as cmod
from filodb_tpu_torch.lint import memcert

# the port's claims whose layout (bytes per padded slot) is the reference's
REFERENCE_LAYOUT = {"shardstore-resident-channels": 20.0,
                    "tilestore-aligned-tiles": 17.0,
                    "device-tile-cache": 17.0,
                    "downsample-pack-buffers": 16.0}


@pytest.fixture(scope="module")
def results():
    return {r.name: r for r in memcert.certify_all("cpu")}


def test_every_tree_claim_is_certified(results):
    cmod.import_annotated_modules()
    assert cmod.CAPACITY, "annotations disappeared"
    for name in cmod.CAPACITY:
        assert name in results, f"claim {name!r} never certified"
        r = results[name]
        assert r.ok, (f"claim {name!r} failed certification: measured "
                      f"{r.measured} vs {r.claimed} ({r.detail})")


def test_expected_claim_inventory(results):
    """The port's resident inventory: the shardstore channels, the aligned
    tiles, the backend tile cache and the downsample staging block. The
    reference's fourth, tilestore-executable-constants, has nothing to
    price in eager PyTorch (test_the_dispatch_record_holds_no_device_bytes)."""
    assert set(cmod.CAPACITY) == set(REFERENCE_LAYOUT)
    assert "tilestore-executable-constants" not in cmod.CAPACITY
    for name, bps in REFERENCE_LAYOUT.items():
        assert cmod.CAPACITY[name].bytes_per_sample == bps


def test_the_claims_sit_at_the_reference_sites():
    c = cmod.capacity_claim("tilestore-aligned-tiles")
    assert (c.module, c.qualname) == ("filodb_tpu_torch.query.tilestore",
                                      "AlignedTiles")
    c = cmod.capacity_claim("device-tile-cache")
    assert (c.module, c.qualname) == ("filodb_tpu_torch.query.backend",
                                      "TorchBackend._insert_tile_entry")


def test_sharded_claim_ran_at_1_2_4_8_partitions(results):
    r = results["shardstore-resident-channels"]
    assert r.device_counts == (1, 2, 4, 8), r.device_counts


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_sharded_store_at_each_partition_count(ndev):
    st, ns, nr = memcert.HARNESSES["shardstore-resident-channels"](ndev,
                                                                  "cpu")
    assert st.n_shard == ndev and st.cap == 64 and nr == st.S_pad
    b, n_storages = memcert.storage_walk(st, "cpu")
    assert b == 20 * ns
    # three channels, one tensor per shard partition each
    assert n_storages == 3 * ndev


def test_measured_bytes_are_real_and_tight(results):
    for name, r in results.items():
        assert 0 < r.measured <= r.claimed <= \
            memcert.OVERCLAIM_RATIO * r.measured, (name, r)
        assert r.storages > 0 and r.alloc_delta is None     # CPU
    st = results["shardstore-resident-channels"]
    assert st.measured == st.claimed == 20 * st.n_samples
    for name in ("tilestore-aligned-tiles", "device-tile-cache"):
        r = results[name]
        assert r.measured == r.claimed == 17 * r.n_samples == 17 * 8 * 64
    ds = results["downsample-pack-buffers"]
    # 48 samples pad to 64 slots: the padding is priced
    assert ds.n_samples == 4 * 64 and ds.measured == 16 * ds.n_samples


def _with_claim(claim, harness=None):
    cmod.CAPACITY[claim.name] = claim
    if harness is not None:
        memcert.HARNESSES[claim.name] = harness


def _drop_claim(name, saved):
    cmod.CAPACITY.pop(name, None)
    memcert.HARNESSES.pop(name, None)
    memcert._MEMO.clear()
    memcert._MEMO.update(saved)


def test_mutated_twin_understated_claim_is_flagged():
    saved = dict(memcert._MEMO)
    claim = cmod.CapacityClaim(
        name="lying-claim", bytes_per_sample=1.0,
        reason="deliberately understates the store",
        module="filodb_tpu_torch.query.tilestore", qualname="lying")
    # the "store" holds 4096 device bytes but the claim covers 64 x 1 B
    _with_claim(claim, lambda device: (4096, 64, 1))
    try:
        res = {r.name: r for r in memcert.certify_all("cpu", force=True)}
        r = res["lying-claim"]
        assert not r.ok and r.measured > r.claimed
        assert any(f.rule == "capacity-certification"
                   and "lying-claim" in f.message
                   for _rel, f in memcert.check_certifications())
    finally:
        _drop_claim("lying-claim", saved)


def test_mutated_twin_slack_claim_is_flagged():
    saved = dict(memcert._MEMO)
    claim = cmod.CapacityClaim(
        name="slack-claim", bytes_per_sample=1000.0,
        reason="pads 1000x over reality",
        module="filodb_tpu_torch.query.tilestore", qualname="slack")
    _with_claim(claim, lambda device: (64, 64, 1))
    try:
        res = {r.name: r for r in memcert.certify_all("cpu", force=True)}
        r = res["slack-claim"]
        assert not r.ok and r.claimed > \
            memcert.OVERCLAIM_RATIO * r.measured
    finally:
        _drop_claim("slack-claim", saved)


def test_mutated_twin_tiles_claimed_below_their_layout_is_flagged():
    """A twin of the aligned-tiles claim at 16 B per slot (the validity
    byte forgotten) fails against the real store."""
    saved = dict(memcert._MEMO)
    claim = cmod.CapacityClaim(
        name="tiles-without-valid", bytes_per_sample=16.0,
        reason="forgets the validity bool",
        module="filodb_tpu_torch.query.tilestore", qualname="twin")
    _with_claim(claim, memcert.HARNESSES["tilestore-aligned-tiles"])
    try:
        r = memcert.certify("tiles-without-valid", "cpu")
        assert not r.ok and r.measured == 17 * r.n_samples
    finally:
        _drop_claim("tiles-without-valid", saved)


def test_claim_without_harness_is_flagged():
    saved = dict(memcert._MEMO)
    claim = cmod.CapacityClaim(
        name="orphan-claim", bytes_per_sample=8.0, reason="no harness",
        module="filodb_tpu_torch.query.tilestore", qualname="orphan")
    _with_claim(claim)
    try:
        res = {r.name: r for r in memcert.certify_all("cpu", force=True)}
        r = res["orphan-claim"]
        assert not r.ok and "no certification harness" in r.detail
        assert not math.isfinite(r.measured)
    finally:
        _drop_claim("orphan-claim", saved)


def test_a_crashing_harness_fails_the_claim():
    saved = dict(memcert._MEMO)
    claim = cmod.CapacityClaim(
        name="crash-claim", bytes_per_sample=8.0, reason="raises",
        module="filodb_tpu_torch.query.tilestore", qualname="crash")

    def boom(device):
        raise RuntimeError("no card")
    _with_claim(claim, boom)
    try:
        r = memcert.certify("crash-claim", "cpu")
        assert not r.ok and "harness crashed" in r.detail
    finally:
        _drop_claim("crash-claim", saved)


def test_storage_walk_dedups_views_and_counts_whole_storages():
    """A view and its base count once; a narrow view keeps its whole
    storage resident and counts it whole; numpy arrays and tensors on
    another device do not count."""
    base = torch.zeros((64, 8), dtype=torch.float64)

    class Box:
        pass

    b = Box()
    b.base = base
    b.view = base[:, :2]
    b.t = base.T
    b.host = np.zeros((1024,))
    b.nest = {"again": [base, (base.view(-1),)]}
    assert memcert.storage_walk(b, "cpu") == (base.nbytes, 1)
    narrow = Box()
    narrow.row = base[3]
    assert memcert.storage_walk(narrow, "cpu") == (64 * 8 * 8, 1)
    assert memcert.storage_walk(b, "cuda") == (0, 0)
    assert memcert.storage_walk(b.host, None) == (0, 0)
    two = Box()
    two.a, two.b = torch.zeros(16), torch.zeros(16)
    assert memcert.storage_walk(two, "cpu") == (128, 2)
    # closures and slots are walked too
    held = torch.ones(32, dtype=torch.int32)
    assert memcert.device_bytes(lambda: held, "cpu") == 128


def test_capacity_ledger_rows(results):
    rows = {row["family"]: row
            for row in memcert.capacity_ledger(hbm_bytes=16 << 30)}
    assert set(rows) == set(cmod.CAPACITY)
    st = rows["shardstore-resident-channels"]
    assert st["certified"] and st["sharded"]
    assert st["measured_bytes"] == results[
        "shardstore-resident-channels"].measured
    assert st["projected_series_per_device"] == (16 << 30) // (20 * 2880)
    assert st["device_counts"] == [1, 2, 4, 8]
    assert st["measured_bytes_per_sample"] == 20.0
    # on the CPU the default card size is the port's (an H100's 80 GB)
    dflt = {row["family"]: row for row in memcert.capacity_ledger()}
    assert dflt["tilestore-aligned-tiles"]["hbm_bytes"] == 80 << 30


def test_ledger_projects_the_reference_series_per_card():
    """For every claim whose layout is the reference's, the port's ledger
    at 16 GiB projects the same resident series as the JAX package's
    ``memcert.capacity_ledger()``."""
    from filodb_tpu.lint import memcert as ref_memcert
    ref = {row["family"]: row for row in ref_memcert.capacity_ledger()}
    ours = {row["family"]: row
            for row in memcert.capacity_ledger(hbm_bytes=16 << 30)}
    for name in REFERENCE_LAYOUT:
        assert ref[name]["certified"] and ours[name]["certified"]
        assert ours[name]["projected_series_per_device"] == \
            ref[name]["projected_series_per_chip_16gb"], name
        assert ours[name]["claimed_bytes_per_sample"] == \
            ref[name]["claimed_bytes_per_sample"]


def test_certification_rides_the_lint_gate():
    from filodb_tpu_torch.lint import rules
    cat = rules()
    assert cat["capacity-certification"].severity == "error"
    assert cat["capacity-certification"].family == "capacity"


def test_capacity_families_registered_at_error():
    from filodb_tpu_torch.lint import rules
    cat = rules()
    for rid in ("hbm-residency-budget", "device-buffer-leak",
                "oversized-transfer", "smem-frontier-budget",
                "capacity-certification"):
        assert cat[rid].severity == "error"
        assert cat[rid].family == "capacity"


def test_claim_lookup_and_projection():
    c = cmod.capacity_claim("shardstore-resident-channels")
    assert c.sharded and c.bytes_per_sample == 20.0
    assert c.claimed_total(1024, 16) == pytest.approx(
        20.0 * 1024 + c.bytes_per_series * 16 + c.overhead_bytes)
    assert c.projected_series_per_chip(2880) == \
        int((cmod.HBM_BYTES_PER_CHIP - c.overhead_bytes)
            // (20.0 * 2880 + c.bytes_per_series))


def test_duplicate_claim_name_rejected():
    with pytest.raises(ValueError):
        @cmod.capacity("shardstore-resident-channels",
                       bytes_per_sample=1.0,
                       reason="collides with the shardstore claim")
        def other():
            pass


def test_empty_reason_rejected():
    with pytest.raises(ValueError):
        cmod.capacity("x", bytes_per_sample=1.0, reason="  ")


def test_residency_gauge_collector():
    from filodb_tpu_torch.obs import metrics as obs_metrics
    cmod.ensure_residency_collector()
    cmod.record_resident("memcert-test-family", "3", 0xBEEF, 12345)
    try:
        snap = cmod.residency_snapshot()
        assert snap["memcert-test-family"]["3"] == 12345
        b = obs_metrics.ExpositionBuilder()
        obs_metrics.GLOBAL_REGISTRY.collect_into(b)
        assert ('filodb_device_memory_bytes{family="memcert-test-'
                'family",shard="3"} 12345') in b.render()
    finally:
        cmod.drop_resident("memcert-test-family", "3", 0xBEEF)
    assert "memcert-test-family" not in cmod.residency_snapshot()


def test_shardstore_records_residency():
    from filodb_tpu_torch.parallel.shardstore import ShardedTiles
    st = ShardedTiles(memcert._partition_mesh(1, "cpu"),
                      memcert._seed_tiles("cpu"))
    fam = "shardstore-resident-channels"
    assert cmod.residency_snapshot().get(fam, {}).get("1", 0) \
        >= st.cap * st.S_pad * 20
    del st
    gc.collect()
    assert cmod.residency_snapshot().get(fam, {}).get("1", 0) == 0


def test_the_dispatch_record_holds_no_device_bytes():
    """The reference's tilestore-executable-constants prices the device
    constants its jitted closures keep alive. Eager PyTorch keeps no
    executable: after aligned and packed dispatches the port's dispatch
    record (``tilestore._EXEC_KEYS``, the hit/miss counts) and the device
    profiler's entries hold keys, shapes and counts, and 0 device bytes,
    so the port declares no such claim (ROADMAP C.25)."""
    from filodb_tpu_torch.obs import devprof
    from filodb_tpu_torch.query import tilestore as tst
    tiles = memcert._seed_tiles("cpu", S=8, N=64)
    base = int(tiles.base_ms)
    steps = base + 600_000 + np.arange(4, dtype=np.int64) * 60_000
    out = tst.evaluate_counters_t(tiles, "rate", steps, 300_000, 0)
    got = tst.evaluate_aligned(tiles, "sum_over_time", steps, 300_000, 0)
    assert out.numel() and got.numel()
    assert tst.executable_cache_stats()["entries"] > 0
    record = (tst._EXEC_KEYS, tst._JIT_STATS, devprof.GLOBAL_PROFILER)
    assert memcert.storage_walk(record, "cpu") == (0, 0)
    assert memcert.storage_walk(record, None) == (0, 0)
