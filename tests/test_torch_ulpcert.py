"""The port's precision rail (``filodb_tpu_torch/lint/numerics.py`` and
``filodb_tpu_torch/lint/ulpcert.py``) on the CPU: each of the eight
``@precision`` claims is declared at the port's counterpart site with the
reference's name, bits and budget, and certified against its f64
reference by its harness, which runs the port's plain versions here (the
group-sum kernel's plain version included); a widened error is reported
as a miss. The two ``@order_insensitive`` claims of the mesh are
certified across 1, 2, 4 and 8 partitions of the CPU. On the card
chip_smoke phase 13 runs the same harnesses with ``device="cuda"``, and
phase 14 the mesh's three claims."""

import math

import numpy as np
import pytest

from filodb_tpu.lint import numerics as j_nmod
from filodb_tpu.lint import ulpcert as j_ulpcert
from filodb_tpu_torch.lint import numerics as nmod
from filodb_tpu_torch.lint import ulpcert

CLAIMS = {
    # name -> the port's site (module, qualname)
    "fixed-point-split": ("filodb_tpu_torch.query.tilestore",
                          "AlignedTiles._fixed_channels"),
    "counter-exact-slot-index": ("filodb_tpu_torch.query.tilestore",
                                 "_eval_counter_t"),
    "counter-fast-hybrid": ("filodb_tpu_torch.query.tilestore",
                            "_eval_counter_fast"),
    "counter-slide-hybrid": ("filodb_tpu_torch.query.tilestore",
                             "_eval_counter_slide"),
    "counter-epilogue-f32": ("filodb_tpu_torch.query.tilestore",
                             "_f32_epilogue"),
    "extrapolated-rate-f64": ("filodb_tpu_torch.query.backend",
                              "_extrapolated_rate"),
    "groupsum-recombine-f32": ("filodb_tpu_torch.query.kernels",
                               "counter_groupsum"),
    "append-carry-exact": ("filodb_tpu_torch.parallel.shardstore",
                           "_append_step"),
}
# order claims -> the port's site
ORDER_CLAIMS = {
    "grouped-reduce-psum": ("filodb_tpu_torch.parallel.mesh",
                            "_grouped_reduce"),
    "grouped-pair-psum": ("filodb_tpu_torch.parallel.shardstore",
                          "_grouped_pair"),
}


@pytest.fixture(scope="module")
def results():
    return {r.name: r for r in ulpcert.certify_all("cpu")}


def test_the_inventory_is_the_seven_claims():
    """The seven claims of the single-device sites, and since the mesh
    (ROADMAP A.11) its precision claim and its two order claims."""
    inv = nmod.claim_inventory()
    assert set(inv["precision"]) == set(CLAIMS)
    assert len(CLAIMS) == 8
    assert set(inv["order"]) == set(ORDER_CLAIMS)


@pytest.mark.parametrize("name", sorted(ORDER_CLAIMS))
def test_order_claim_certified_across_partition_counts(results, name):
    claim = nmod.order_claim(name)
    assert (claim.module, claim.qualname) == ORDER_CLAIMS[name]
    assert claim.tolerance == j_nmod.order_claim(name).tolerance
    r = results[name]
    assert r.kind == "order" and r.device == "cpu"
    assert r.ok, f"{name}: {r.measured} vs {r.claimed} ({r.detail})"
    assert "(1, 2, 4, 8)" in r.detail


def test_the_reference_misses_its_grouped_pair_claim_where_the_port_holds():
    """The JAX package's own harness of grouped-pair-psum deviates across
    its virtual device counts (ROADMAP C.13, 0.875 relative); the port's,
    on the same counter world, stays within 1e-12."""
    j_nmod.import_annotated_modules()
    j = j_ulpcert._measure_order(j_nmod.order_claim("grouped-pair-psum"),
                                 j_ulpcert.HARNESSES["grouped-pair-psum"][1],
                                 (1, 2, 4, 8))
    p = ulpcert.certify_order("grouped-pair-psum", "cpu")
    assert not j.ok and j.measured > 0.1, j.detail
    assert p.ok and p.measured <= 1e-12, p.detail


def test_a_widened_order_deviation_is_a_miss():
    def drifting(ndev, device):
        return (np.array([1.0 + 1e-9 * ndev]),)

    r = ulpcert._measure_order(nmod.order_claim("grouped-reduce-psum"),
                               drifting, (1, 2, 4, 8), "cpu")
    assert not r.ok and r.measured > 1e-12


@pytest.mark.parametrize("name", sorted(CLAIMS))
def test_claim_declared_at_the_port_site_with_the_reference_budget(name):
    claim = nmod.precision_claim(name)
    assert (claim.module, claim.qualname) == CLAIMS[name]
    ref = j_nmod.precision_claim(name)
    assert (claim.bits, claim.rel_ulps, claim.accum_terms,
            claim.compensated) == (ref.bits, ref.rel_ulps, ref.accum_terms,
                                   ref.compensated)
    assert claim.reason.strip()


@pytest.mark.parametrize("name", sorted(CLAIMS))
def test_claim_certified_on_the_cpu(results, name):
    r = results[name]
    assert r.ok, f"{name}: measured {r.measured} vs {r.claimed} ({r.detail})"
    assert r.device == "cpu"
    assert r.measured <= r.claimed


def test_measured_values_leave_headroom(results):
    """Not a function against itself: rounding shows where the site
    rounds, under the claim."""
    for name in ("counter-fast-hybrid", "counter-slide-hybrid",
                 "counter-epilogue-f32", "fixed-point-split",
                 "groupsum-recombine-f32"):
        assert 0 < results[name].measured <= results[name].claimed, name


@pytest.fixture(scope="module")
def reference_harnesses():
    """The JAX package's own harnesses, run on the same seeded worlds."""
    j_nmod.import_annotated_modules()
    return {name: j_ulpcert.HARNESSES[name][1]() for name in CLAIMS}


def test_the_same_measurements_as_the_reference_harnesses(
        results, reference_harnesses):
    """Each claim's harness in both packages: the same f64 reference on
    the same inputs, and the same worst error measured against it (the
    port's plain versions round as the reference's sites do)."""
    for name in sorted(CLAIMS):
        j_prod, j_ref, j_floor = reference_harnesses[name]
        prod, ref, floor = ulpcert.HARNESSES[name]("cpu")
        shape = np.shape(ref)
        np.testing.assert_array_equal(
            np.asarray(ref, np.float64),
            np.asarray(j_ref, np.float64).reshape(shape), err_msg=name)
        j = j_ulpcert._measure_precision(
            j_nmod.precision_claim(name),
            np.asarray(j_prod).reshape(np.shape(prod)),
            np.asarray(j_ref).reshape(shape),
            np.broadcast_to(np.asarray(j_floor), np.shape(floor))
            if np.ndim(floor) else j_floor)
        assert j.ok, (name, j.detail)
        assert results[name].measured == pytest.approx(
            j.measured, rel=1e-9, abs=0.0), \
            (name, results[name].detail, j.detail)


def test_a_widened_error_is_a_miss():
    """The teeth: the group-sum harness fed an f32-rounded reference (the
    f64 delta the claim is held to, rounded through f32 first and then
    nudged by 8 f32 ulps) must fail its 4-ulp claim."""
    harness = ulpcert.HARNESSES["groupsum-recombine-f32"]

    def widened(device):
        prod, ref, floor = harness(device)
        r32 = ref.astype(np.float32)
        return prod, (r32 + 8 * np.spacing(np.abs(r32))).astype(
            np.float64), floor

    saved = ulpcert.HARNESSES["groupsum-recombine-f32"]
    ulpcert.HARNESSES["groupsum-recombine-f32"] = widened
    try:
        r = ulpcert.certify("groupsum-recombine-f32", "cpu")
    finally:
        ulpcert.HARNESSES["groupsum-recombine-f32"] = saved
    assert not r.ok and r.measured > r.claimed


def test_an_exact_claim_is_certified_bitwise():
    claim = nmod.PrecisionClaim(name="exact-probe", bits=31,
                                reason="probe", rel_ulps=0)
    ref = np.arange(8, dtype=np.float64)
    ok = ulpcert._measure_precision(claim, ref.copy(), ref)
    assert ok.ok and ok.measured == 0.0
    off = ref.copy()
    off[3] = np.nextafter(off[3], 10.0)
    bad = ulpcert._measure_precision(claim, off, ref)
    assert not bad.ok and math.isinf(bad.measured)


def test_a_nan_structure_change_is_a_miss():
    claim = nmod.precision_claim("counter-fast-hybrid")
    ref = np.ones(4)
    prod = np.array([1.0, np.nan, 1.0, 1.0], np.float32)
    assert not ulpcert._measure_precision(claim, prod, ref).ok


def test_a_crashing_harness_fails_the_claim():
    def broken(device):
        raise RuntimeError("kernel did not build")

    saved = ulpcert.HARNESSES["groupsum-recombine-f32"]
    ulpcert.HARNESSES["groupsum-recombine-f32"] = broken
    try:
        r = ulpcert.certify("groupsum-recombine-f32", "cpu")
    finally:
        ulpcert.HARNESSES["groupsum-recombine-f32"] = saved
    assert not r.ok and "harness crashed" in r.detail


def test_a_claim_without_a_harness_fails():
    saved = ulpcert.HARNESSES.pop("counter-epilogue-f32")
    try:
        r = ulpcert.certify("counter-epilogue-f32", "cpu")
    finally:
        ulpcert.HARNESSES["counter-epilogue-f32"] = saved
    assert not r.ok and "no certification harness" in r.detail


def test_the_groupsum_world_at_a_grid_of_several_steps():
    """The engine-shaped variant phase 13 runs on the card (many steps, a
    window of whole steps), here at a small width through the plain
    version: each step's group reports its series' recombined delta."""
    prod, ref, floor = ulpcert.groupsum_delta_world(
        "cpu", S=600, N=200, step_slots=6, window_slots=30, nsteps=28)
    assert prod.shape == ref.shape == (28, 600)
    r = ulpcert._measure_precision(
        nmod.precision_claim("groupsum-recombine-f32"), prod, ref,
        floor[None, :])
    assert r.ok, r.detail


@pytest.mark.parametrize("name", ["counter-exact-slot-index",
                                  "counter-fast-hybrid",
                                  "counter-slide-hybrid"])
def test_a_counter_claim_certified_at_a_wider_world(name):
    """The counter harnesses widened as phase 13 widens them on the card
    (there 4,096 series), here 512: within the claim, over all but the
    knife-edge windows."""
    r = ulpcert.certify(name, "cpu", S=512)
    assert r.ok, r.detail
    n = int(r.detail.rsplit(" over ", 1)[1].split()[0])
    assert 512 * 16 - 8 <= n <= 512 * 16, r.detail


def test_only_knife_edge_windows_leave_the_measurement():
    """A window whose start gap sits on its threshold leaves both sides
    of the measurement; its neighbours stay."""
    g = dict(nsteps=2, w0s=0, w0e=40_000, step=1_000)
    # window 0 [0, 40 s]: samples 11 s apart from 11 s, start gap 11 s,
    # threshold 1.1 * 11 = 12.1 s; window 1 [1 s, 41 s]: start gap 10 s
    ts = np.array([[11_000, 12_100], [22_000, 23_100], [33_000, 34_100]],
                  np.int64)
    prod = np.ones((2, 2), np.float32)
    ref = np.ones((2, 2))
    p, r = ulpcert._off_knife_edges(prod, ref, ts, g)
    # series 1, window 0: start gap 12.1 s = its threshold (1.1 * 11 s)
    assert np.isnan(p[0, 1]) and np.isnan(r[0, 1])
    assert np.isfinite(p[[0, 1, 1], [0, 0, 1]]).all()
    assert np.isfinite(r[[0, 1, 1], [0, 0, 1]]).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ms_to_s_divides_as_the_cpu_does(dtype):
    """The counter evaluators' ms-to-s division (a 0-dim divisor on the
    data's device, so that the card divides truly rather than multiply
    by 1/1000) gives on the CPU exactly what dividing by 1000.0 gives,
    and so the reference's seconds."""
    import torch

    from filodb_tpu_torch.query.tilestore import ms_to_s
    ms = np.random.default_rng(5).integers(-10 ** 7, 10 ** 7, 1 << 16)
    x = torch.as_tensor(ms, dtype=getattr(torch, dtype))
    got = ms_to_s(x)
    assert got.dtype == x.dtype
    assert torch.equal(got, x / 1000.0)
    if dtype == "float64":
        assert np.array_equal(got.numpy(), ms / 1000.0)
