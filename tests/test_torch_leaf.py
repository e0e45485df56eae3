"""The port's leaf modules against the JAX package's: log-domain math,
distances, hierarchical clustering and binning, SOM and PSO, batched GMM
scoring and the batched observation gather, the profiling ledger, the
checkpoint keywords, the package exports and the error classes.

Inputs are seeded numpy; tolerances are those of the JAX tests of each
function (``tests/test_logmath.py``, ``tests/test_leaf_components.py``,
``tests/test_torch_gmm_score.py``).  SOM and PSO draw from a
``torch.Generator`` where JAX draws from a key, so they are held to the
properties ``tests/test_leaf_components.py`` holds JAX's to, on the same
data.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.config import ModelConfig
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu.models import topology as jtop
from poccala_tpu.ops import distance as jdist
from poccala_tpu.ops import gmm_score as jgmm
from poccala_tpu.ops import hierarchical as jhier
from poccala_tpu.ops import som as jsom
from poccala_tpu.train import checkpoint as jckpt
from poccala_tpu.utils import errors as jerrors
from poccala_tpu.utils import logmath as jlog
from poccala_tpu.utils import profiling as jprof
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.models import topology as ttop
from poccala_tpu_torch.ops import distance as tdist
from poccala_tpu_torch.ops import gmm_score as tgmm
from poccala_tpu_torch.ops import hierarchical as thier
from poccala_tpu_torch.ops import som as tsom
from poccala_tpu_torch.train import checkpoint as tckpt
from poccala_tpu_torch.utils import errors as terrors
from poccala_tpu_torch.utils import logmath as tlog
from poccala_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-4)    # tests/test_torch_gmm_score.py
BF16 = dict(rtol=1e-3, atol=5e-2)


def t(a):
    return torch.as_tensor(np.asarray(a))


# ----------------------------------------------------------------------
# log-domain math (1e-6, tests/test_logmath.py)
# ----------------------------------------------------------------------

def test_logsumexp_matches_jax(rng):
    x = (rng.normal(size=(5, 7)) * 10).astype(np.float32)
    x[2] = -np.inf                      # an all -inf row
    x[3, :4] = -np.inf
    for axis, keep in ((None, False), (-1, False), (0, True), (1, True)):
        got = tlog.logsumexp(t(x), axis=axis, keepdims=keep).numpy()
        want = np.asarray(jlog.logsumexp(jnp.asarray(x), axis=axis,
                                         keepdims=keep))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tlog.logsumexp(torch.full((8,), -np.inf))) == -np.inf


def test_log_matvec_matches_jax(rng):
    log_a = rng.normal(size=(6, 4)).astype(np.float32)
    log_x = rng.normal(size=(6,)).astype(np.float32)
    log_x[1] = -np.inf
    np.testing.assert_allclose(
        tlog.log_matvec(t(log_a), t(log_x)).numpy(),
        np.asarray(jlog.log_matvec(jnp.asarray(log_a), jnp.asarray(log_x))),
        rtol=1e-6)
    # a column of -inf everywhere stays -inf
    log_a[:, 2] = -np.inf
    out = tlog.log_matvec(t(log_a), t(log_x)).numpy()
    assert out[2] == -np.inf and np.isfinite(out[[0, 1, 3]]).all()


@pytest.mark.parametrize("normalizer", ["textbook", "reference"])
def test_diag_gaussian_logpdf_matches_jax(rng, normalizer):
    x = rng.normal(size=(17, 1, 13)).astype(np.float32)
    mean = rng.normal(size=(1, 4, 13)).astype(np.float32)
    log_var = np.log(rng.uniform(0.5, 2.0, size=(1, 4, 13))).astype(
        np.float32)
    got = tlog.diag_gaussian_logpdf(t(x), t(mean), t(log_var),
                                    normalizer=normalizer)
    want = jlog.diag_gaussian_logpdf(jnp.asarray(x), jnp.asarray(mean),
                                     jnp.asarray(log_var),
                                     normalizer=normalizer)
    assert tuple(got.shape) == (17, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError):
        tlog.diag_gaussian_logpdf(t(x), t(mean), t(log_var), normalizer="x")


def test_safe_exp_sub_and_masked_log_match_jax(rng):
    num = rng.normal(size=(6,)).astype(np.float32)
    den = rng.normal(size=(6,)).astype(np.float32)
    den[[0, 3]] = jlog.NEG_INF          # an empty denominator gives 0
    got = tlog.safe_exp_sub(t(num), t(den)).numpy()
    want = np.asarray(jlog.safe_exp_sub(jnp.asarray(num), jnp.asarray(den)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == got[3] == 0.0
    x = np.array([0.0, 1.0, np.e, 3.5], np.float32)
    np.testing.assert_allclose(tlog.masked_log(t(x)).numpy(),
                               np.asarray(jlog.masked_log(jnp.asarray(x))),
                               rtol=1e-6)
    assert tlog.LOG_2PI == jlog.LOG_2PI and tlog.NEG_INF == jlog.NEG_INF


# ----------------------------------------------------------------------
# distances (1e-5)
# ----------------------------------------------------------------------

def test_distances_match_jax(rng):
    a = rng.normal(size=(9, 5)).astype(np.float32)
    b = rng.normal(size=(9, 5)).astype(np.float32)
    prec = rng.uniform(0.2, 2.0, size=5).astype(np.float32)
    full = rng.normal(size=(5, 5)).astype(np.float32)
    full = full @ full.T + np.eye(5, dtype=np.float32)
    for name, args in (("euclidean", ()), ("manhattan", ()),
                       ("minkowski", (3.0,)), ("cosine_similarity", ()),
                       ("mahalanobis", (prec,)), ("mahalanobis", (full,))):
        got = getattr(tdist, name)(a, b, *args)
        want = getattr(jdist, name)(a, b, *args)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # float64 arrays become float32, as jnp.asarray makes them
    x = rng.normal(size=(7, 3))
    y = rng.normal(size=(4, 3))
    got = tdist.pairwise_euclidean(x, y)
    assert got.dtype == torch.float32 and tuple(got.shape) == (7, 4)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jdist.pairwise_euclidean(x, y)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.linalg.norm(x[:, None] - y[None], axis=-1), atol=1e-5)
    # tensors keep their dtype
    assert tdist.euclidean(t(x), t(x[::-1].copy())).dtype == torch.float64


# ----------------------------------------------------------------------
# hierarchical clustering, random centers, binning
# ----------------------------------------------------------------------

def blobs(rng, centers, n, scale):
    return np.concatenate([rng.normal(size=(n, len(c))) * scale + c
                           for c in centers])


def test_layercluster_and_theta_match_jax(rng):
    # 12 points a blob: JAX compiles the distance matrix anew at every
    # merge's shape
    x = blobs(rng, [[0, 0], [8, 8], [0, 8]], 12, 0.2)
    jtree, jcl = jhier.layercluster(x, 3)
    ttree, tcl = thier.layercluster(x, 3)
    assert tcl == jcl and sorted(map(len, tcl.values())) == [12, 12, 12]

    def shape(node):   # (step, size, left, right) without the centers
        if node is None:
            return None
        return (node[0], node[1], shape(node[3]), shape(node[4]))

    assert [shape(n) for n in ttree] == [shape(n) for n in jtree]
    for a, b in zip(ttree, jtree):
        np.testing.assert_allclose(a[2], b[2], rtol=1e-5, atol=1e-5)
    for g, w in zip(thier.theta(x, tcl), jhier.theta(x, jcl)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_randomcenter_matches_jax_exactly():
    x = np.random.default_rng(5).normal(size=(50, 3))
    got = thier.randomcenter(np.random.default_rng(9), x, 4)
    want = jhier.randomcenter(np.random.default_rng(9), x, 4)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.allclose(got[2].sum(), 1.0) and (got[1] >= 1e-4).all()


@pytest.mark.parametrize("k,bins", [(2, 4), (5, 8)])
def test_binning_matches_jax(rng, k, bins):
    x = blobs(rng, [[0, 0], [5, 5]], 100, 0.1)
    got = thier.binning(x, k, bins_per_dim=bins)
    want = jhier.binning(x, k, bins_per_dim=bins)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    if k == 2:
        means = np.sort(got[0], axis=0)
        assert np.allclose(means[0], [0, 0], atol=0.5)
        assert np.allclose(means[1], [5, 5], atol=0.5)


# ----------------------------------------------------------------------
# SOM and PSO: the properties of tests/test_leaf_components.py:43-80
# ----------------------------------------------------------------------

def test_quantization_error_matches_jax(rng):
    x = rng.normal(size=(40, 3)).astype(np.float32)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(tsom.quantization_error(t(w), t(x))),
        float(jsom.quantization_error(jnp.asarray(w), jnp.asarray(x))),
        rtol=1e-5)


def test_som_clusters_blobs(rng):
    x = blobs(rng, [[0, 0], [5, 5]], 60, 0.2).astype(np.float32)
    w, assign = tsom.som(torch.Generator().manual_seed(0), t(x), 2,
                         steps=400)
    got = np.sort(w.numpy(), axis=0)
    assert np.allclose(got[0], [0, 0], atol=0.8)
    assert np.allclose(got[1], [5, 5], atol=0.8)
    a = assign.numpy()
    assert len(set(a[:60])) == 1 and len(set(a[60:])) == 1 and a[0] != a[-1]
    # JAX's SOM on the same data has the same properties
    jw, _ = jsom.som(jax.random.PRNGKey(0), jnp.asarray(x), 2, steps=400)
    assert np.allclose(np.sort(np.asarray(jw), axis=0), got, atol=1.6)


def test_pso_minimizes_quadratic():
    target = torch.tensor([0.3, -0.2, 0.5])
    best, val = tsom.pso(torch.Generator().manual_seed(1),
                         lambda p: torch.sum((p - target) ** 2),
                         num_particles=24, dim=3, iters=120)
    assert float(val) < 1e-3
    assert np.allclose(best.numpy(), target.numpy(), atol=0.05)


def test_p_som(rng):
    x = blobs(rng, [[0, 0], [4, 0]], 40, 0.2).astype(np.float32)
    w, _ = tsom.p_som(torch.Generator().manual_seed(2), t(x), 2, steps=200)
    q = float(tsom.quantization_error(w, t(x)))
    jw, _ = jsom.p_som(jax.random.PRNGKey(2), jnp.asarray(x), 2, steps=200)
    assert q < 1.0
    assert float(jsom.quantization_error(jw, jnp.asarray(x))) < 1.0


# ----------------------------------------------------------------------
# batched scoring and the batched observation gather
# ----------------------------------------------------------------------

def bank_pair(seed=3, units=5, d=6):
    cfg = ModelConfig(state_num=5, mix_level=3, max_mix_level=3)
    jbank = jsb.create_bank(units, cfg, d, key=jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    means = rng.normal(size=np.shape(jbank.means)).astype(np.float32)
    log_var = rng.normal(size=np.shape(jbank.log_var)).astype(
        np.float32) * 0.3
    jbank = dataclasses.replace(jbank, means=jnp.asarray(means),
                                log_var=jnp.asarray(log_var))
    return jbank, tsb.bank_from_numpy(
        {f: np.asarray(getattr(jbank, f)) for f in tsb.FIELDS}, device="cpu")


@pytest.mark.parametrize("normalizer", ["textbook", "reference"])
def test_gmm_log_scores_batch_matches_jax(rng, normalizer):
    jbank, tbank = bank_pair()
    x = rng.normal(size=(3, 11, 6)).astype(np.float32)
    mask = np.arange(11)[None] < np.array([11, 7, 2])[:, None]
    want, wmask = jgmm.gmm_log_scores_batch(
        jnp.asarray(x), jnp.asarray(mask), jbank.means, jbank.log_var,
        jbank.log_w, normalizer=normalizer)
    got, gmask = tgmm.gmm_log_scores_batch(
        t(x), t(mask), tbank.means, tbank.log_var, tbank.log_w,
        normalizer=normalizer)
    assert tuple(got.shape) == (3, 11, tbank.num_states)
    assert np.allclose(got.numpy(), np.asarray(want), **F32)
    assert np.array_equal(gmask.numpy(), np.asarray(wmask))
    # bfloat16: centred on all B·T frames; within the bf16 tolerance of
    # the float32 scores, as JAX's per-utterance centring is
    g16, _ = tgmm.gmm_log_scores_batch(
        t(x), t(mask), tbank.means, tbank.log_var, tbank.log_w,
        normalizer=normalizer, score_dtype="bfloat16")
    w16, _ = jgmm.gmm_log_scores_batch(
        jnp.asarray(x), jnp.asarray(mask), jbank.means, jbank.log_var,
        jbank.log_w, normalizer=normalizer, score_dtype="bfloat16")
    assert np.allclose(g16.numpy(), got.numpy(), **BF16)
    assert np.allclose(np.asarray(w16), np.asarray(want), **BF16)


def test_embedded_log_b_batch_matches_jax(rng):
    jbank, tbank = bank_pair(units=5)
    max_l = 4
    labels = rng.integers(0, 5, size=(4, max_l)).astype(np.int32)
    lens = np.array([4, 1, 3, 2], np.int32)
    je = jtop.build_embedded_batch(jbank, jnp.asarray(labels),
                                   jnp.asarray(lens), 5, max_l)
    te = ttop.build_embedded_batch(tbank, t(labels), t(lens), 5, max_l)
    scores = rng.normal(size=(4, 9, jbank.num_states)).astype(np.float32)
    got = ttop.embedded_log_b_batch(t(scores), te)
    want = jtop.embedded_log_b_batch(jnp.asarray(scores), je)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# profiling
# ----------------------------------------------------------------------

def test_optimer_keys_and_report_match_jax():
    j, p = jprof.OpTimer(), tprof.OpTimer()
    for timer in (j, p):
        with timer.measure("a", flops=2e9, bytes_accessed=4e8):
            pass
        with timer.measure("a", flops=2e9, bytes_accessed=4e8):
            pass
        with timer.measure("b"):
            pass
    assert {k: set(v) for k, v in p.records.items()} == \
        {k: set(v) for k, v in j.records.items()}
    assert p.records["a"]["calls"] == 2
    # the same records give the same report
    records = {"a": {"calls": 4, "seconds": 0.002, "flops": 3e9,
                     "bytes": 5e8},
               "b": {"calls": 1, "seconds": 0.25, "flops": None,
                     "bytes": None}}
    j.records = {k: dict(v) for k, v in records.items()}
    p.records = {k: dict(v) for k, v in records.items()}
    assert p.report() == j.report()
    assert p.report().splitlines()[0] == \
        "a: 0.500 ms/call x4  6.00 TFLOP/s  1000.0 GB/s"
    x = torch.ones(8, 8)
    out, dt = p.timeit("mm", torch.matmul, x, x, iters=3, flops=1024.0)
    _, jdt = j.timeit("mm", jnp.matmul, jnp.ones((8, 8)), jnp.ones((8, 8)),
                      iters=3, flops=1024.0)
    assert torch.equal(out, torch.full((8, 8), 8.0)) and dt > 0
    assert p.records["mm"].keys() == j.records["mm"].keys()
    assert p.records["mm"]["calls"] == 3


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "prof")):
        torch.ones(4, 4) @ torch.ones(4, 4)
    path = tmp_path / "prof" / "trace.json"
    assert path.exists() and path.stat().st_size > 0


# ----------------------------------------------------------------------
# checkpoints, exports, errors
# ----------------------------------------------------------------------

def test_async_save_round_trips_and_cross_reads(tmp_path):
    jbank, tbank = bank_pair()
    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j")
    tckpt.save_checkpoint(tpath, tbank, {"round": 1}, async_save=True)
    tckpt.wait_for_save()
    jckpt.save_checkpoint(jpath, jbank, {"round": 2}, sharded=False,
                          async_save=True)
    jckpt.wait_for_save()
    for path, rnd in ((tpath, 1), (jpath, 2)):
        got, man = tckpt.load_checkpoint(path, device="cpu")
        want, jman = jckpt.load_checkpoint(path)
        assert man["round"] == jman["round"] == rnd
        assert man["format"] == jman["format"] == "npz"
        for f in tsb.FIELDS:
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f
            assert np.array_equal(getattr(got, f).numpy(),
                                  getattr(tbank, f).numpy()), f


@pytest.mark.parametrize("pkg", ["", ".io", ".utils", ".models", ".decoder"])
def test_package_exports_match_jax(pkg):
    jmod = importlib.import_module("poccala_tpu" + pkg)
    tmod = importlib.import_module("poccala_tpu_torch" + pkg)
    assert set(jmod.__all__) <= set(tmod.__all__)
    for name in jmod.__all__:
        got = getattr(tmod, name)
        if hasattr(got, "__module__"):
            assert got.__module__.split(".")[0] == "poccala_tpu_torch", name


ERRORS = ["PoccalaError", "MixtureNumberError", "UnitFileError",
          "ParameterFileError", "ConfigError", "DataUnloadedError",
          "DataDimensionError", "JobIdError", "PathInfoError", "ModeError",
          "ClassError", "AlignmentError"]


@pytest.mark.parametrize("name", ERRORS)
def test_error_classes_match_jax(name):
    got, want = getattr(terrors, name), getattr(jerrors, name)
    assert issubclass(got, terrors.PoccalaError)
    assert [c.__name__ for c in got.__mro__] == \
        [c.__name__ for c in want.__mro__]
    args = {"MixtureNumberError": (9, 8),
            "DataDimensionError": (39, 13)}.get(name, ("x",))
    assert str(got(*args)) == str(want(*args))
