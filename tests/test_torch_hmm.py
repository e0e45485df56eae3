"""The PyTorch port's HMM dynamic programming and sentence-HMM topology vs
the JAX package.

Seeded numpy inputs go through ``poccala_tpu.ops.hmm`` and
``poccala_tpu_torch.ops.hmm`` (the plain PyTorch versions, which the CPU
runs): alphas, betas, logliks and Viterbi scores agree at rtol = atol =
1e-5 (the bar of ``tests/test_gmm_hmm_kernels.py:102``), Viterbi paths
exactly.  The sentence-HMM tables of ``models/topology.py`` are equal
exactly, and the ``__graft_entry__.entry`` forward step composed from the
port's modules gives the JAX logliks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from poccala_tpu.models import topology as jtop
from poccala_tpu.ops import hmm as jhmm
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.models import topology as ttop
from poccala_tpu_torch.ops import hmm as thmm
from poccala_tpu_torch.ops.cuda import hmm_banded_cuda as hk
from poccala_tpu_torch.ops.gmm_score import gmm_log_scores

from .test_senone_topology import make_bank

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
NEG = -1e30


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def banded_inputs(rng, b, t_pad, n, w, ragged=True):
    """Left-to-right bands with dead edges, log_b at MFCC-GMM scale with
    some impossible states, and ragged frame masks (one all-padded
    utterance when ragged)."""
    band = np.log(rng.dirichlet(np.ones(w), size=(b, n))).astype(np.float32)
    col = np.arange(n)[:, None] + np.arange(w)[None, :]
    band = np.where(col[None] < n, band, NEG).astype(np.float32)
    band[:, :, 3:] = np.where(rng.uniform(size=(b, n, w - 3)) < 0.5, NEG,
                              band[:, :, 3:])
    log_pi = np.log(rng.dirichlet(np.ones(n), size=b)).astype(np.float32)
    log_b = (rng.normal(size=(b, t_pad, n)) * 20 - 60).astype(np.float32)
    log_b[:, :, -1] = NEG
    lens = (rng.integers(1, t_pad + 1, size=b) if ragged
            else np.full(b, t_pad))
    if ragged:
        lens[0], lens[-1] = t_pad, 1
    masks = np.arange(t_pad)[None] < lens[:, None]
    if ragged and b > 2:
        masks[1] = False
    return band, log_pi, log_b, masks


@pytest.mark.parametrize("b,t_pad,n,w", [(4, 18, 11, 5), (3, 40, 26, 5),
                                         (2, 1, 8, 4)])
def test_banded_matches_jax(rng, b, t_pad, n, w):
    band, log_pi, log_b, masks = banded_inputs(rng, b, t_pad, n, w)
    args = (jnp.asarray(band), jnp.asarray(log_pi), jnp.asarray(log_b),
            jnp.asarray(masks))
    la, ll = jhmm.forward_log_banded_batch(*args, w=w)
    lb = jhmm.backward_log_banded_batch(args[0], args[2], args[3], w=w)
    before = [k.launches for k in hk.KERNELS.values()]
    ta, tll = thmm.forward_log_banded_batch(t(band), t(log_pi), t(log_b),
                                            t(masks), w)
    tb = thmm.backward_log_banded_batch(t(band), t(log_b), t(masks), w)
    close(ta, la)
    close(tll, ll)
    close(tb, lb)
    for end_states in (0, 3):
        sc, path, delta = jhmm.viterbi_log_banded_batch(
            *args, w=w, end_states=end_states)
        tsc, tpath, tdelta = thmm.viterbi_log_banded_batch(
            t(band), t(log_pi), t(log_b), t(masks), w, end_states)
        assert tpath.dtype == torch.int32
        assert np.array_equal(tpath.numpy(), np.asarray(path))
        close(tsc, sc)
        close(tdelta, delta)
    # the CPU never launches the kernels
    assert [k.launches for k in hk.KERNELS.values()] == before


def test_single_utterance_wrappers(rng):
    band, log_pi, log_b, masks = banded_inputs(rng, 1, 20, 11, 5, False)
    masks[0, 14:] = False
    la, ll = jhmm.forward_log_banded(band[0], log_pi[0], log_b[0], masks[0],
                                     w=5)
    ta, tll = thmm.forward_log_banded(t(band[0]), t(log_pi[0]), t(log_b[0]),
                                      t(masks[0]), 5)
    close(ta, la)
    close(tll, ll)
    close(thmm.backward_log_banded(t(band[0]), t(log_b[0]), t(masks[0]), 5),
          jhmm.backward_log_banded(band[0], log_b[0], masks[0], w=5))
    sc, path, _ = jhmm.viterbi_log_banded(band[0], log_pi[0], log_b[0],
                                          masks[0], w=5, end_states=2)
    tsc, tpath, _ = thmm.viterbi_log_banded(t(band[0]), t(log_pi[0]),
                                            t(log_b[0]), t(masks[0]), 5, 2)
    assert np.array_equal(tpath.numpy(), np.asarray(path))
    close(tsc, sc)


def test_viterbi_tie_order(rng):
    """Exact ties everywhere: equal band entries and equal scores.  JAX's
    argmax takes the first maximum (smallest offset, lowest final state);
    the port must take the same path."""
    n, w, t_pad = 9, 4, 12
    band = np.full((2, n, w), np.log(0.25), np.float32)
    col = np.arange(n)[:, None] + np.arange(w)[None, :]
    band = np.where(col[None] < n, band, NEG).astype(np.float32)
    log_pi = np.zeros((2, n), np.float32)
    log_b = np.zeros((2, t_pad, n), np.float32)
    masks = np.ones((2, t_pad), bool)
    masks[1, 7:] = False
    sc, path, _ = jhmm.viterbi_log_banded_batch(
        jnp.asarray(band), jnp.asarray(log_pi), jnp.asarray(log_b),
        jnp.asarray(masks), w=w)
    tsc, tpath, _ = thmm.viterbi_log_banded_batch(
        t(band), t(log_pi), t(log_b), t(masks), w)
    assert np.array_equal(tpath.numpy(), np.asarray(path))
    close(tsc, sc)


@pytest.mark.parametrize("n,t_pad", [(6, 25), (12, 40)])
def test_dense_matches_jax(rng, n, t_pad):
    a = rng.dirichlet(np.ones(n), size=n)
    a[rng.uniform(size=(n, n)) < 0.3] = 0.0
    log_A = np.where(a > 0, np.log(np.maximum(a, 1e-30)), NEG).astype(
        np.float32)
    log_pi = np.log(rng.dirichlet(np.ones(n))).astype(np.float32)
    # floor-variance scale per-frame scores, where the renormalised
    # alpha and its Kahan-compensated shift matter
    log_b = (rng.normal(size=(t_pad, n)) * 300 - 800).astype(np.float32)
    mask = np.arange(t_pad) < t_pad - 5
    la, ll = jhmm.forward_log(log_A, log_pi, log_b, mask)
    ta, tll = thmm.forward_log(t(log_A), t(log_pi), t(log_b), t(mask))
    close(ta, la)
    close(tll, ll)
    close(thmm.backward_log(t(log_A), t(log_b), t(mask)),
          jhmm.backward_log(log_A, log_b, mask))
    sc, path, delta = jhmm.viterbi_log(log_A, log_pi, log_b, mask)
    tsc, tpath, tdelta = thmm.viterbi_log(t(log_A), t(log_pi), t(log_b),
                                          t(mask))
    assert np.array_equal(tpath.numpy(), np.asarray(path))
    close(tsc, sc)
    close(tdelta, delta)


def test_band_conversions(rng):
    n, w = 7, 3
    a = np.where(rng.uniform(size=(n, n)) < 0.6,
                 rng.normal(size=(n, n)), NEG).astype(np.float32)
    band = jhmm.dense_to_band(jnp.asarray(a), w)
    tband = thmm.dense_to_band(t(a), w)
    assert np.array_equal(tband.numpy(), np.asarray(band))
    assert np.array_equal(thmm.band_to_dense(tband).numpy(),
                          np.asarray(jhmm.band_to_dense(band)))


# ----------------------------------------------------------------------
# topology
# ----------------------------------------------------------------------

def banks(rng, num_units=5, state_num=5, mix=2, dim=5):
    cfg, jbank = make_bank(rng, num_units=num_units, state_num=state_num,
                           mix=mix, max_mix=mix, dim=dim)
    tbank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                 for f in tsb.FIELDS})
    return cfg, jbank, tbank


def test_build_embedded_matches_jax(rng):
    cfg, jbank, tbank = banks(rng)
    max_l = 4
    labels = rng.integers(0, 5, size=(5, max_l)).astype(np.int32)
    lens = np.array([4, 1, 3, 0, 2], np.int32)
    want = jtop.build_embedded_batch(jbank, jnp.asarray(labels),
                                     jnp.asarray(lens), cfg.state_num, max_l)
    got = ttop.build_embedded_batch(tbank, t(labels), t(lens), cfg.state_num,
                                    max_l)
    assert got.band.shape == (5, ttop.max_states(max_l, 5), 5)
    for f in ("band", "log_pi", "senone_idx", "state_mask", "n_states"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        assert np.array_equal(g, w), f
    one = ttop.build_embedded(tbank, t(labels[2]), 3, cfg.state_num, max_l)
    assert np.array_equal(one.band.numpy(), got.band[2].numpy())
    assert int(one.n_states) == 11

    # log_b and the state -> label map
    t_pad = 9
    scores = rng.normal(size=(5, t_pad, jbank.num_states)).astype(np.float32)
    wlb = jtop.embedded_log_b_batch(jnp.asarray(scores), want)
    glb = ttop.embedded_log_b(t(scores), got)
    assert np.array_equal(glb.numpy(), np.asarray(wlb))
    paths = rng.integers(0, got.band.shape[1], size=(5, t_pad)).astype(
        np.int32)
    for i in range(5):
        wpos, wunit = jtop.states_to_labels(
            jnp.asarray(paths[i]), jax_item(want, i), jnp.asarray(labels[i]),
            cfg.state_num)
        gpos, gunit = ttop.states_to_labels(t(paths[i:i + 1]),
                                            torch_item(got, i),
                                            t(labels[i:i + 1]), cfg.state_num)
        assert np.array_equal(gpos[0].numpy(), np.asarray(wpos))
        assert np.array_equal(gunit[0].numpy(), np.asarray(wunit))


def jax_item(e, i):
    return jtop.EmbeddedHMM(*(getattr(e, f)[i] for f in
                              ("band", "log_pi", "senone_idx", "state_mask",
                               "n_states")))


def torch_item(e, i):
    return ttop.EmbeddedHMM(*(getattr(e, f)[i:i + 1] for f in
                              ("band", "log_pi", "senone_idx", "state_mask",
                               "n_states")))


def test_graft_entry_forward_step():
    """``__graft_entry__.entry``'s forward step on its own bank and batch,
    composed from the port's modules: GMM scores -> sentence HMMs ->
    sentence log_b -> banded forward."""
    fn, args = graft.entry()
    want = np.asarray(fn(*args))
    jbank, labels, lens, xs, masks = args
    bank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                for f in tsb.FIELDS})
    xs = t(np.asarray(xs))
    b, t_pad, d = xs.shape
    scores = gmm_log_scores(xs.reshape(b * t_pad, d), bank.means,
                            bank.log_var, bank.log_w).reshape(b, t_pad, -1)
    ehmm = ttop.build_embedded_batch(bank, t(np.asarray(labels)),
                                     t(np.asarray(lens)), 5, 4)
    log_b = ttop.embedded_log_b(scores, ehmm)
    _, got = thmm.forward_log_banded_batch(ehmm.band, ehmm.log_pi, log_b,
                                           t(np.asarray(masks)), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
