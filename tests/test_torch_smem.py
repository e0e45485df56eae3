"""Split-and-merge EM, PyTorch port vs JAX package.

On ``tests/test_smem_batched.py``'s ``_world`` (six senones of three
mixtures; the even ones start in the classic SMEM local optimum) the
port's batched and serial passes must make JAX's decisions: three moves
accepted, exactly the even senones changed, Q rising where they changed.
The batched pass's programs are held to JAX's one by one: the statistics
at rtol 1e-5 (the log-likelihood sums at 2e-4, ``own`` exactly), the host
candidate selector exactly (it is a copy), and the proposal — fed JAX's
own 2-means seeding uniforms and jitter — against a float64 evaluation
of the same proposal, and against JAX's directly at rtol 1e-4 / atol
1e-4 wherever float32 can hold that (see the test's docstring).
"""

import jax
import numpy as np
import pytest
import torch

from poccala_tpu.train import smem as jsmem
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.ops import em as tem
from poccala_tpu_torch.train import smem as tsmem

from .test_smem_batched import _Tr as _JaxTr, _world

torch.set_num_threads(1)

STATS_RTOL = 1e-5
PROPOSE_TOL = dict(rtol=1e-4, atol=1e-4)
EPS32 = 2.0 ** -24      # float32 unit roundoff
ILL_KAPPA = 10.0        # (μ² + σ²) / σ² from which log σ² is ill-conditioned


class _Tr:
    """Minimal trainer facade for smem_pass_* (bank + cfg + generator)."""

    def __init__(self, bank, cfg, mix_level=3):
        self.bank = bank
        self.cfg = cfg
        self.mix_level = mix_level
        self.generator = torch.Generator().manual_seed(7)


@pytest.fixture
def world():
    jbank, cfg, frames, mask, _ = _world(np.random.default_rng(0))
    bank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                for f in tsb.FIELDS}, device="cpu")
    return jbank, bank, cfg, frames, mask


def t(a):
    return torch.as_tensor(np.array(a))


def bank_q(bank, frames, mask):
    lg, comp = tem.e_step(tem.GmmParams(bank.means, bank.log_var, bank.log_w),
                          t(frames), t(mask))
    return tem.q_value(lg, comp, bank.log_w).numpy()


def test_smem_stats_match_jax(world):
    jbank, bank, cfg, frames, mask = world
    want = jsmem._smem_stats(jbank.means, jbank.log_var, jbank.log_w,
                             frames, mask, mix=3, normalizer="textbook")
    got = tsmem._smem_stats(bank.means, bank.log_var, bank.log_w,
                            t(frames), t(mask), 3, "textbook")
    # q_old and wsum sum γ·log N over 360 frames, each log N a float32
    # expansion x²/σ² − 2xμ/σ² + μ²/σ² whose terms reach ~400 nats: both
    # packages sit up to 7e-5 (relative) from a float64 evaluation
    for name, g, w, rtol in zip(("q_old", "gram", "nk", "wsum"), got, want,
                                (2e-4, STATS_RTOL, STATS_RTOL, 2e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=1e-3, err_msg=name)
    assert np.array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("mix,c_max", [(3, 5), (4, 2), (6, 5)])
def test_select_candidates_is_jax_copy(mix, c_max):
    rng = np.random.default_rng(mix)
    s, f = 40, 30
    gamma = rng.dirichlet(np.ones(mix) * 0.5, size=(s, f))
    gamma[:3, :, 0] = 0.0          # empty components split first
    gram = np.einsum("sfm,sfn->smn", gamma, gamma)
    nk = gamma.sum(1)
    wsum = rng.normal(size=(s, mix)) * 10 * nk
    own = rng.integers(0, 8, size=(s, mix)).astype(np.float32)
    got = tsmem._select_candidates(gram, nk, wsum, own, mix, c_max, 3)
    want = jsmem._select_candidates(gram, nk, wsum, own, mix, c_max, 3)
    assert np.array_equal(got, want)
    assert (got[:, 0] >= 0).any() and (got[:, 0] < 0).any()


def test_smem_propose_with_jax_draws_matches_jax(world):
    """The proposal of both packages, each in float32, held to a float64
    evaluation of the same proposal (the port's ``_smem_propose`` on
    float64 copies of the same inputs, JAX's seeding uniforms and jitter,
    10 polish iterations), then to each other.

    The polish M-step forms ``σ² = Σγx²/n − μ²``, which cancels: its
    condition number is ``κ = (μ² + σ²) / σ²``, about 400-650 here for
    the dimension of a blob centred 6 away from the origin with σ ≈ 0.3.
    A float32 sum over the F = 360 frames carries a relative error of
    about ``√F · ε`` (ε = 2⁻²⁴, rounding as a random walk), which the
    cancellation multiplies by κ; the responsibilities γ couple every
    dimension and component of a senone, so each ``log σ²`` of senone s
    is held to ``2 · κ_s · √F · ε`` with ``κ_s`` the senone's largest κ
    (up to 7.4e-4 · 2 at κ = 655).  Both packages' float32 results sit
    within that bound, the port's no farther from float64 than JAX's by
    a factor of at most 2 (RMS over the ill-conditioned elements), and
    the two differ by up to 4.7e-4 there depending on the host's
    summation order — more than 1e-4.  So the direct 1e-4 comparison
    covers every element that is not ill-conditioned: ``log σ²`` where
    ``κ < ILL_KAPPA`` (both sit within 3e-5 of float64 there), all means
    (κ plays no part: Σγx/n does not cancel), the active slots'
    weights and the candidate Q.
    """
    jbank, bank, cfg, frames, mask = world
    s, d = bank.num_states, bank.dim
    q_old, gram, nk, wsum, own = jsmem._smem_stats(
        jbank.means, jbank.log_var, jbank.log_w, frames, mask, mix=3,
        normalizer="textbook")
    chosen = jsmem._select_candidates(
        np.asarray(gram), np.asarray(nk), np.asarray(wsum), np.asarray(own),
        3, 5, 3)
    assert (chosen >= 0).all()
    chosen[5] = 0                  # a placeholder row must not raise
    ijk = np.where(chosen >= 0, chosen, 0).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), s)
    want = jsmem._smem_propose(
        jbank.means, jbank.log_var, jbank.log_w, frames, mask, ijk, keys,
        mix=3, c_covariance=1e-6, normalizer="textbook", polish_iters=10)

    # JAX's draws: kmeans_plusplus_init splits its key once per centre,
    # the jitter uses fold_in(key, 1)
    seed_u, jitter = [], []
    for key in keys:
        u = []
        kk = key
        for _ in range(2):
            kk, sub = jax.random.split(kk)
            u.append(float(jax.random.uniform(sub, ())))
        seed_u.append(u)
        jitter.append(np.asarray(jax.random.uniform(
            jax.random.fold_in(key, 1), (2, d))))

    def propose(dtype):
        return [a.numpy() for a in tsmem._smem_propose(
            bank.means.to(dtype), bank.log_var.to(dtype),
            bank.log_w.to(dtype), t(frames).to(dtype), t(mask), t(ijk),
            torch.tensor(seed_u, dtype=dtype),
            t(np.stack(jitter)).to(dtype), 3, 1e-6, "textbook",
            polish_iters=10)]

    got = propose(torch.float32)
    ref = propose(torch.float64)
    assert got[0].dtype == np.float32 and ref[0].dtype == np.float64
    want = [np.asarray(w) for w in want]
    rows, act = slice(0, 5), slice(0, 3)   # row 5 is the placeholder

    mu, lv = ref[0][rows, act], ref[1][rows, act]
    kappa = (mu * mu + np.exp(lv)) / np.exp(lv)           # [5, 3, D]
    bound = 2.0 * kappa.max(axis=(1, 2)) * np.sqrt(frames.shape[1]) * EPS32
    err_port = np.abs(got[1][rows, act] - lv)
    err_jax = np.abs(want[1][rows, act] - lv)
    for name, err in (("port", err_port), ("jax", err_jax)):
        assert np.all(err <= bound[:, None, None]), (name, err, bound)
    ill = kappa >= ILL_KAPPA
    assert ill.any() and (~ill).any()
    rms = [np.sqrt(np.mean(e[ill] ** 2)) for e in (err_port, err_jax)]
    assert rms[0] <= 2.0 * rms[1], rms

    np.testing.assert_allclose(got[1][rows, act][~ill],
                               want[1][rows, act][~ill],
                               err_msg="log_var", **PROPOSE_TOL)
    np.testing.assert_allclose(got[0][rows], want[0][rows],
                               err_msg="means", **PROPOSE_TOL)
    np.testing.assert_allclose(got[2][rows, act], want[2][rows, act],
                               err_msg="log_w", **PROPOSE_TOL)
    np.testing.assert_array_equal(got[2][rows, 3:], want[2][rows, 3:])
    np.testing.assert_allclose(got[3][rows], want[3][rows],
                               err_msg="q_new", **PROPOSE_TOL)
    assert np.isfinite(got[3][rows]).all()


@pytest.mark.parametrize("impl", ["batched", "serial"])
def test_pass_makes_jax_decisions(world, impl):
    jbank, bank, cfg, frames, mask = world
    cfg.train.smem_impl = impl
    enough = np.ones(bank.num_states, bool)
    q0 = bank_q(bank, frames, mask)
    tr = _Tr(bank, cfg)
    new, n = tsmem.smem_pass(tr, frames, mask, enough)
    changed = np.any(new.means.numpy() != bank.means.numpy(), axis=(1, 2))
    assert n == 3
    assert np.array_equal(changed, np.asarray([1, 0, 1, 0, 1, 0], bool))
    q1 = bank_q(new, frames, mask)
    assert np.all(q1[changed] > q0[changed])
    np.testing.assert_allclose(q1[~changed], q0[~changed], rtol=1e-6)
    want = np.sort(np.array([[0, 0], [6, 0], [0, 6]], np.float32), axis=0)
    for i in (0, 2, 4):
        got = np.sort(new.means[i, :3].numpy(), axis=0)
        assert np.allclose(got, want, atol=0.5), (i, got)
    # JAX's pass on the same world decides the same
    jnew, jn = jsmem.smem_pass(_JaxTr(jbank, cfg), frames, mask, enough)
    jchanged = np.any(np.asarray(jnew.means) != np.asarray(jbank.means),
                      axis=(1, 2))
    assert jn == n and np.array_equal(jchanged, changed)


def test_noop_guards(world):
    jbank, bank, cfg, frames, mask = world
    tr = _Tr(bank, cfg, mix_level=2)  # SMEM needs mix >= 3
    new, n = tsmem.smem_pass_batched(tr, frames, mask,
                                     np.ones(bank.num_states, bool))
    assert n == 0 and new is bank
    tr = _Tr(bank, cfg)
    new, n = tsmem.smem_pass_batched(tr, frames, mask,
                                     np.zeros(bank.num_states, bool))
    assert n == 0 and new is bank
    new, n = tsmem.smem_pass_serial(tr, frames, mask,
                                    np.zeros(bank.num_states, bool))
    assert n == 0 and torch.equal(new.means, bank.means)


@pytest.mark.parametrize("helper", ["merge_scores", "split_scores",
                                    "_merge_params", "_partial_em"])
def test_serial_host_helpers_are_jax_copies(helper):
    """The serial oracle's float64 host helpers, copied from the JAX
    module, give JAX's results on the same inputs (exactly)."""
    rng = np.random.default_rng(11)
    f, m, d = 50, 4, 3
    gamma = rng.dirichlet(np.ones(m), size=f)
    gamma[:, 3] = 0.0                       # an empty component
    comp = rng.normal(size=(f, m)) * 5 - 10
    params = tem.GmmParams(rng.normal(size=(m, d)),
                           rng.normal(size=(m, d)) * 0.3,
                           np.log(rng.dirichlet(np.ones(m))))
    x = rng.normal(size=(f, d))
    mask = rng.uniform(size=f) < 0.8
    args = {
        "merge_scores": (gamma,),
        "split_scores": (gamma, comp),
        "_merge_params": (params, 0, 2),
        "_partial_em": (x, mask, gamma[:, :3].sum(1), x[:3].copy(),
                        np.ones((3, d)), np.full(3, 1 / 3), 1e-6,
                        "textbook"),
    }[helper]
    got = getattr(tsmem, helper)(*args)
    want = getattr(jsmem, helper)(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, dtype=object),
                                      np.asarray(w, dtype=object))
