"""Grouped k-means and grouped EM, PyTorch port vs JAX package.

k-means: the JAX and torch random streams differ, so Lloyd's iterations
(``kmeans.lloyd``) start from JAX's own ``kmeans_plusplus_init`` centres
and must then reproduce JAX's ``kmeans_grouped``: assignments and counts
exactly, means / variances / alpha at 1e-5.  k-means++ fed JAX's own
uniforms must pick JAX's centres exactly; with the generator's draws it
is held to its properties.  EM: ``em_fit_grouped`` from the same
parameters must run the same number of iterations per group, reach Q at
rtol 1e-5 and parameters at rtol 1e-4 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.ops import em as jem
from poccala_tpu.ops import kmeans as jkm
from poccala_tpu_torch.ops import em as tem
from poccala_tpu_torch.ops import kmeans as tkm

torch.set_num_threads(1)

KM_TOL = dict(rtol=1e-5, atol=1e-5)
Q_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.as_tensor(np.array(a))


def grouped_points(seed, g=5, f=70, d=3):
    """Blobs per group with padded frames far away; group 1 fully masked;
    group 2 holds two distinct points only, so k-means++ at k=3 falls
    back to uniform sampling and duplicates a centre (an empty cluster
    that Lloyd re-seeds)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(g, 3, d)) * 5
    pick = rng.integers(0, 3, size=(g, f))
    x = centers[np.arange(g)[:, None], pick] + rng.normal(size=(g, f, d)) * .4
    mask = rng.uniform(size=(g, f)) < 0.8
    x = np.where(mask[..., None], x, 100.0)
    mask[1] = False
    x[2] = np.where(np.arange(f)[:, None] % 2 == 0, 1.0, -2.0)
    mask[2] = True
    return x.astype(np.float32), mask


def jax_seed_uniforms(key, k):
    """The uniforms ``jax.random.choice`` draws inside
    ``kmeans_plusplus_init(key, ...)`` (one key split per centre)."""
    out = []
    for _ in range(k):
        key, sub = jax.random.split(key)
        out.append(float(jax.random.uniform(sub, ())))
    return out


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 4)])
def test_lloyd_from_jax_seeds_matches_jax_kmeans(seed, k):
    x, mask = grouped_points(seed)
    key = jax.random.PRNGKey(seed)
    keys = jax.random.split(key, x.shape[0])
    init = jax.vmap(lambda kk, xx, mm: jkm.kmeans_plusplus_init(kk, xx, mm, k))(
        keys, jnp.asarray(x), jnp.asarray(mask))
    init = np.asarray(init)
    # group 2 really has duplicated centres (the re-seed path runs)
    assert len(np.unique(init[2], axis=0)) < k
    want = jkm.kmeans_grouped(key, jnp.asarray(x), jnp.asarray(mask), k=k)
    got = tkm.lloyd(t(init), t(x), t(mask), iters=20)
    assert np.array_equal(got["assign"].numpy(), np.asarray(want["assign"]))
    assert np.array_equal(got["counts"].numpy(), np.asarray(want["counts"]))
    for f in ("means", "variances", "alpha"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                   err_msg=f, **KM_TOL)
    # padded frames never join a cluster; the all-masked group is empty
    assert np.all(got["assign"].numpy()[~mask] == -1)
    assert got["counts"][1].sum() == 0
    assert np.all(got["variances"].numpy() >= 1e-4)


def test_kmeans_plusplus_with_jax_uniforms_picks_jax_centres():
    x, mask = grouped_points(3)
    k = 4
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, x.shape[0])
    want = jax.vmap(lambda kk, xx, mm: jkm.kmeans_plusplus_init(kk, xx, mm, k))(
        keys, jnp.asarray(x), jnp.asarray(mask))
    u = torch.tensor([jax_seed_uniforms(kk, k) for kk in keys])
    got = tkm.kmeans_plusplus_init(t(x), t(mask), k, u)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_kmeans_plusplus_properties():
    x, mask = grouped_points(4)
    g, f, d = x.shape
    x[3] = 7.0                      # all points equal: uniform fallback
    gen = torch.Generator().manual_seed(5)
    u = tkm.seed_uniforms(gen, g, 3)
    centres = tkm.kmeans_plusplus_init(t(x), t(mask), 3, u).numpy()
    for gi in (0, 3, 4):            # centres are valid points of the group
        valid = x[gi][mask[gi]]
        for c in centres[gi]:
            assert np.any(np.all(valid == c, axis=1)), (gi, c)
    assert np.all(centres[3] == 7.0)
    # an empty group (p = 0) takes index 0 as jax.random.choice does
    assert np.array_equal(centres[1], np.repeat(x[1, :1], 3, axis=0))
    # one seed, one result
    again = tkm.kmeans_plusplus_init(
        t(x), t(mask), 3, tkm.seed_uniforms(torch.Generator().manual_seed(5),
                                            g, 3))
    assert np.array_equal(again.numpy(), centres)
    out = tkm.kmeans_grouped(torch.Generator().manual_seed(5), t(x),
                             t(mask), k=3)
    np.testing.assert_allclose(out["alpha"].sum(-1).numpy()[[0, 2, 3, 4]],
                               1.0, rtol=1e-6)
    single = tkm.kmeans(torch.Generator().manual_seed(1), t(x[0]),
                        t(mask[0]), k=2)
    assert single["means"].shape == (2, d)


def em_inputs(seed, g=6, f=150, d=3, m=3):
    """Two-to-three blob mixtures per group with separations that make
    the groups converge after different numbers of iterations; one mixture
    slot inactive in every other group; padded frames."""
    rng = np.random.default_rng(seed)
    x = np.zeros((g, f, d), np.float32)
    for gi in range(g):
        sep = 1.0 + gi
        centers = rng.normal(size=(3, d)) * sep
        x[gi] = centers[rng.integers(0, 3, size=f)] \
            + rng.normal(size=(f, d)) * (0.5 + 0.1 * gi)
    mask = np.ones((g, f), bool)
    mask[:, -20:] = rng.uniform(size=(g, 20)) < 0.5
    mix_mask = np.ones((g, m), bool)
    mix_mask[1::2, -1] = False
    means = x[np.arange(g)[:, None], rng.integers(0, f - 20, size=(g, m))] \
        + rng.normal(size=(g, m, d)) * 0.1
    log_var = np.zeros((g, m, d), np.float32)
    log_w = np.where(mix_mask, np.log(1.0 / mix_mask.sum(1, keepdims=True)),
                     -1e30).astype(np.float32)
    return [a.astype(np.float32) for a in (means, log_var, log_w, x)] \
        + [mask, mix_mask]


@pytest.mark.parametrize("normalizer", ["textbook", "reference"])
@pytest.mark.parametrize("floor", ["scalar", "per_dim"])
def test_em_fit_grouped_matches_jax(normalizer, floor):
    means, log_var, log_w, x, mask, mix_mask = em_inputs(7)
    c_cov = 1e-3 if floor == "scalar" else \
        np.array([0.3, 1e-3, 0.05], np.float32)
    kw = dict(c_covariance=c_cov, max_iters=20, normalizer=normalizer)
    wp, wq, wit = jem.em_fit_grouped(
        *(jnp.asarray(a) for a in (means, log_var, log_w, x, mask,
                                   mix_mask)), **kw)
    gp, gq, git = tem.em_fit_grouped(
        *(t(a) for a in (means, log_var, log_w, x, mask, mix_mask)), **kw)
    assert np.array_equal(git.numpy(), np.asarray(wit))
    assert len(set(git.tolist())) > 1, git   # groups stop at different its
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), rtol=Q_RTOL)
    for f in ("means", "log_var", "log_w"):
        np.testing.assert_allclose(getattr(gp, f).numpy(),
                                   np.asarray(getattr(wp, f)),
                                   err_msg=f, **PARAM_TOL)
    if floor == "per_dim":   # the per-dim floor binds on dim 0
        assert np.any(np.isclose(np.exp(gp.log_var[..., 0].numpy()), 0.3,
                                 rtol=1e-5))


def test_em_padded_frames_invariance():
    means, log_var, log_w, x, mask, mix_mask = em_inputs(8)
    args = [t(a) for a in (means, log_var, log_w)]
    p1, q1, it1 = tem.em_fit_grouped(*args, t(x), t(mask), t(mix_mask))
    g = x.shape[0]
    x_pad = np.concatenate([x, np.full((g, 37, 3), 50.0, np.float32)], 1)
    m_pad = np.concatenate([mask, np.zeros((g, 37), bool)], 1)
    p2, q2, it2 = tem.em_fit_grouped(*args, t(x_pad), t(m_pad), t(mix_mask))
    assert torch.equal(it1, it2)
    np.testing.assert_allclose(q2.numpy(), q1.numpy(), rtol=Q_RTOL)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **PARAM_TOL)
    # the single-GMM entry point is the group of one
    p, q, it = tem.em_fit(tem.GmmParams(*(a[0] for a in args)), t(x[0]),
                          t(mask[0]), t(mix_mask[0]))
    assert int(it) == int(it1[0])
    np.testing.assert_allclose(p.means.numpy(), p1.means[0].numpy(),
                               rtol=1e-6, atol=1e-6)
