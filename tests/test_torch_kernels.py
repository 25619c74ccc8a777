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
@pytest.mark.parametrize("phase", [0, 3000, -3000])
def test_groupsum_plain_matches_pallas(func, phase):
    S, N, G = 100, 288, 5
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


@pytest.mark.parametrize("func", ["rate", "increase"])
def test_groupsum_plain_matches_pallas_st1(func):
    """step == dt: every boundary family lies in one residue plane."""
    S, N, G = 48, 400, 3
    v_p, base, pt = _packed(S, N, 1)
    steps = np.arange(BASE + 400_000, BASE + 2_000_000, 10_000,
                      dtype=np.int64)
    plan = ptst.groupsum_plan(pt, func, steps, 300_000)
    assert plan is not None and plan["st"] == 1
    want, got = _both(func, 1, plan["dspan"], plan["hi_mode"],
                      plan["lo_mode"], v_p, base,
                      _onehot(S, G, v_p.shape[0]), plan["kl0"],
                      plan["w0e_rel"], 300_000, 10_000, steps.size)
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
