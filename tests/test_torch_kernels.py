"""The port's kernels (filodb_tpu_torch.query.kernels) against the JAX
package's Pallas kernels on identical inputs. On the CPU each port wrapper
runs its plain PyTorch version; the Pallas kernels run in interpret mode.

Group-sum: counts exact; sums within rtol 1e-5, atol 1e-7 (the repo's own
bound for this kernel; the group product is summed in another order than
the MXU's). Boundary extract: bit-exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from filodb_tpu.query import pallas_kernels as pk
from filodb_tpu.query import tilestore as jtst
from filodb_tpu_torch import state
from filodb_tpu_torch.query import kernels as kn
from filodb_tpu_torch.query import tilestore as ptst

# the suite runs in several worker processes on shared cores
torch.set_num_threads(1)

BASE = 1_600_000_000_000
DT = 10_000


def _arrays(S=100, N=288, seed=7, jitter=2000.0):
    """The test_groupsum_kernel fixture: jittered counters near 1e15 with
    one counter reset."""
    rng = np.random.default_rng(seed)
    ts = (BASE + np.arange(N)[None, :] * DT
          + rng.uniform(-jitter, jitter, (S, N)))
    vals = 1e15 + np.cumsum(rng.uniform(0, 5, (S, N)), axis=1)
    vals[5 % S, N // 2:] *= 0.99
    return np.ones((S, N), bool), ts, vals


def _packed(S, N, st, jitter=2000.0):
    """Identical packed kernel inputs, built by the JAX package."""
    valid, ts, vals = _arrays(S, N, jitter=jitter)
    jt = jtst.AlignedTiles([{} for _ in range(S)], BASE, DT, valid, ts,
                           vals)
    v_p = np.array(jt.t_perm_fixed_tiled("cv", st))
    base = np.array(jt.t_fixed_base("cv"))
    pt = state.tiles_from_numpy([{} for _ in range(S)], BASE, DT, valid,
                                ts, vals, device="cpu")
    return v_p, base, pt


def _onehot(S, G, n_s):
    oh = np.zeros((n_s * kn.GS_SS, G), np.float32)
    oh[np.arange(S), np.arange(S) % G] = 1.0
    return oh


def _both(func, st, dspan, hi_mode, lo_mode, v_p, base, oh, kl0, w0e_rel,
          window, step, T):
    want = pk.counter_groupsum(func, st, dspan, hi_mode, lo_mode,
                               jnp.asarray(v_p), jnp.asarray(base),
                               jnp.asarray(oh), kl0, w0e_rel, window, step,
                               T, interpret=True)
    got = kn.counter_groupsum(func, st, dspan, hi_mode, lo_mode,
                              torch.from_numpy(v_p), torch.from_numpy(base),
                              torch.from_numpy(oh), kl0, w0e_rel, window,
                              step, T)
    return ([np.asarray(w) for w in want],
            [g.numpy() for g in got])


def _check(want, got):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("func", ["rate", "increase", "delta"])
@pytest.mark.parametrize("phase, S, G", [
    pytest.param(0, 100, 5, id="0"),
    pytest.param(3000, 100, 5, id="3000"),
    pytest.param(-3000, 100, 5, id="-3000"),
    # a ragged last s-tile and more groups than one staged chunk
    pytest.param(0, 700, 300, id="0-S700-G300")])
def test_groupsum_plain_matches_pallas(func, phase, S, G):
    N = 288
    v_p, base, pt = _packed(S, N, 6)
    steps = np.arange(BASE + 400_000 + phase, BASE + 2_400_000, 60_000,
                      dtype=np.int64)
    plan = ptst.groupsum_plan(pt, func, steps, 300_000)
    assert plan is not None and plan["st"] == 6
    want, got = _both(func, plan["st"], plan["dspan"], plan["hi_mode"],
                      plan["lo_mode"], v_p, base,
                      _onehot(S, G, v_p.shape[0]), plan["kl0"],
                      plan["w0e_rel"], 300_000, 60_000, steps.size)
    _check(want, got)


@pytest.mark.parametrize("hi_mode", [kn.GS_BOTH, kn.GS_CUR, kn.GS_ALT])
@pytest.mark.parametrize("lo_mode", [kn.GS_BOTH, kn.GS_CUR, kn.GS_ALT])
def test_groupsum_plain_matches_pallas_every_mode_pair(hi_mode, lo_mode):
    """Each boundary-mode pair, forced, on the same packed inputs (the
    parity holds whether or not the mode is sound for the jitter)."""
    S, N, G = 40, 288, 3
    v_p, base, _ = _packed(S, N, 6, jitter=500.0)
    T = 20
    kl0 = 40
    want, got = _both("rate", 6, 5, hi_mode, lo_mode, v_p, base,
                      _onehot(S, G, v_p.shape[0]), kl0,
                      (kl0 + 30) * DT + 1000, 300_000, 60_000, T)
    _check(want, got)


@pytest.mark.parametrize("func, S, G, window, T, modes", [
    pytest.param("rate", 48, 3, 300_000, 160, None, id="rate"),
    pytest.param("increase", 48, 3, 300_000, 160, None, id="increase"),
    # the largest ring: dspan = GS_DSPAN_MAX with both fallback families
    # read, a single s-tile, one group, T no multiple of 8
    pytest.param("rate", 100, 1, 480_000, 157, (kn.GS_BOTH, kn.GS_BOTH),
                 id="rate-dspan48-both")])
def test_groupsum_plain_matches_pallas_st1(func, S, G, window, T, modes):
    """step == dt: every boundary family lies in one residue plane."""
    N = 400
    v_p, base, pt = _packed(S, N, 1)
    steps = BASE + 600_000 + np.arange(T, dtype=np.int64) * 10_000
    if modes is None:
        steps = steps - 200_000
    plan = ptst.groupsum_plan(pt, func, steps, window)
    assert plan is not None and plan["st"] == 1
    assert window != 480_000 or plan["dspan"] == kn.GS_DSPAN_MAX
    hi_mode, lo_mode = modes or (plan["hi_mode"], plan["lo_mode"])
    want, got = _both(func, 1, plan["dspan"], hi_mode, lo_mode, v_p, base,
                      _onehot(S, G, v_p.shape[0]), plan["kl0"],
                      plan["w0e_rel"], window, 10_000, steps.size)
    _check(want, got)


def test_groupsum_wrapper_rejects_bad_inputs():
    S, N, G = 16, 288, 2
    v_p, base, _ = _packed(S, N, 6)
    vt, bt = torch.from_numpy(v_p), torch.from_numpy(base)
    oh = torch.from_numpy(_onehot(S, G, v_p.shape[0]))
    with pytest.raises(ValueError):      # wrong dtype
        kn.counter_groupsum("rate", 6, 5, 0, 0, vt.float(), bt, oh, 40,
                            700_000, 300_000, 60_000, 10)
    with pytest.raises(ValueError):      # grid past the packed rows
        kn.counter_groupsum("rate", 6, 5, 0, 0, vt, bt, oh, 40, 700_000,
                            300_000, 60_000, 10_000)
    with pytest.raises(ValueError):      # stride does not match the layout
        kn.counter_groupsum("rate", 3, 5, 0, 0, vt, bt, oh, 40, 700_000,
                            300_000, 60_000, 10)


@pytest.mark.parametrize("n_sm", [132, 114, 1])
def test_groupsum_launch_plan_covers_every_step_once(n_sm):
    for n_s in (1, 2, 16, 100, 128, 133, 300):
        for T in (1, 7, 8, 150, 157, 469, 470, 2881):
            lp = kn.groupsum_launch_plan(n_s, T, 16, kn.GS_BOTH, kn.GS_BOTH,
                                         n_sm)
            chunk, n_chunks = lp["chunk"], lp["n_chunks"]
            hits = np.zeros(T, np.int64)
            for c in range(n_chunks):
                hits[c * chunk:min(T, (c + 1) * chunk)] += 1
            assert (hits == 1).all(), (n_s, T, lp)
            assert chunk >= min(T, kn.GS_TT)
            blocks = n_s * n_chunks
            # the last wave fills >= 90 % of the SMs unless the steps ran out
            waves = -(-blocks // n_sm)
            assert 10 * blocks >= 9 * waves * n_sm or chunk == min(T, kn.GS_TT)


def test_groupsum_launch_plan_fits_shared_memory():
    """The block's shared memory depends on the boundary families read and
    on G (up to GS_GC groups staged at once), not on st or dspan: kl rows
    are streamed, never held for dspan steps."""
    for hi_mode in (kn.GS_BOTH, kn.GS_CUR, kn.GS_ALT):
        for lo_mode in (kn.GS_BOTH, kn.GS_CUR, kn.GS_ALT):
            for G in list(range(1, 70)) + [255, 256, 300, 4096]:
                lp = kn.groupsum_launch_plan(128, 470, G, hi_mode, lo_mode,
                                             132)
                assert lp["smem"] <= kn.GS_SMEM_MAX, (hi_mode, lo_mode, G)
                assert 2 <= lp["stages"] <= kn.GS_STAGES_MAX
                assert 4 * lp["cw"] >= min(G, kn.GS_GC)
                assert lp["fams"] == 2 + (hi_mode != kn.GS_CUR) \
                    + (lo_mode != kn.GS_CUR)


def _ragged(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.integers(1, 12))
    N = int(rng.integers(2, 150))
    T = int(rng.integers(1, 80))
    step = int(rng.integers(1_000, 120_000))
    window = int(rng.integers(1_000, 600_000))
    ts = np.sort(rng.integers(0, 3_000_000, (S, N))).astype(np.int64)
    # duplicate timestamps and a sample exactly on a window edge
    ts[:, N // 2] = ts[:, N // 2 - 1]
    ts[0, 0] = step
    ts = np.sort(ts, axis=1)
    lens = rng.integers(1, N + 1, S)
    vals = rng.normal(1e6, 1.0, (S, N))
    vals[0, -1] = -0.0
    tr = ts.astype(np.int32)
    for i, n in enumerate(lens):
        tr[i, n:] = kn.TR_PAD
    masked = np.where(np.arange(N)[None, :] < lens[:, None], vals, 0.0)
    return tr, masked, step, window, T


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_window_extract_plain_matches_pallas(seed):
    tr, masked, step, window, T = _ragged(seed)
    pay_j = pk.split3(jnp.asarray(masked)).astype(jnp.float32)
    want = pk.window_extract(jnp.asarray(tr), pay_j, step, window, T,
                             interpret=True)
    pay_t = kn.split3(torch.from_numpy(masked))
    got = kn.window_extract(torch.from_numpy(tr), pay_t, step, window, T)
    np.testing.assert_array_equal(np.asarray(pay_j), pay_t.numpy())
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # empty windows really are exercised
    assert (got[0].numpy() == 0).any() or T == 1


def test_split3_combine3_exact_roundtrip():
    rng = np.random.default_rng(3)
    v = rng.normal(0, 1e12, (4, 64)) + rng.normal(0, 1e-6, (4, 64))
    back = kn.combine3(kn.split3(torch.from_numpy(v)))
    np.testing.assert_array_equal(back.numpy(), v)


def test_wrappers_count_no_launch_on_cpu():
    kn.reset_launches()
    tr, masked, step, window, T = _ragged(0)
    kn.window_extract(torch.from_numpy(tr), kn.split3(
        torch.from_numpy(masked)), step, window, T)
    assert kn.LAUNCHES == {"counter_groupsum": 0, "window_extract": 0}
