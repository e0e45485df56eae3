"""GMM scoring in the PyTorch port vs the JAX package.

The port's plain version (``poccala_tpu_torch/ops/gmm_score.py``) is held
against ``poccala_tpu.ops.gmm_score.gmm_log_scores`` and against the
Pallas kernel in interpret mode, at the tolerances of
``tests/test_pallas_kernels.py`` (1e-4) and ``tests/test_bf16_scoring.py``
(bf16: rtol 1e-3, atol 5e-2).  The CUDA kernel itself runs only on a GPU
(``tests/test_torch_gpu.py``); here the wrapper's operand packing is
checked by evaluating the kernel's arithmetic on the packed operands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.ops.gmm_score import gmm_log_scores as jax_scores
from poccala_tpu.ops.gmm_score import masked_log_w as jax_masked_log_w
from poccala_tpu.ops.pallas.gmm_score_tpu import gmm_log_scores_pallas
from poccala_tpu_torch.ops import gmm_score as tg
from poccala_tpu_torch.ops.cuda import gmm_score_cuda as gk

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1e-3, atol=5e-2)


def make_inputs(rng, s=20, m=4, d=13, t=100, floor=False):
    """``tests/test_pallas_kernels.py:make_inputs``; ``floor`` makes the
    last two dims degenerate: half the mixtures sit at the 1e-6
    covariance floor there, with frames and means at the floor's scale
    (with |x| of order 1 on a floored dim no two f32 summation orders
    agree to 1e-4 — the absolute floor is ill-conditioned in any
    precision, ``poccala_tpu/config.py:138-148``)."""
    means = rng.normal(size=(s, m, d)).astype(np.float32)
    log_var = rng.uniform(-1, 1, size=(s, m, d)).astype(np.float32)
    w = rng.uniform(0.1, 1, size=(s, m))
    w /= w.sum(1, keepdims=True)
    log_w = np.log(w).astype(np.float32)
    x = rng.normal(size=(t, d)).astype(np.float32)
    if floor:
        hit = rng.uniform(size=(s, m, 1)) < 0.5
        log_var[..., -2:] = np.where(hit, np.log(1e-6), log_var[..., -2:])
        means[..., -2:] = rng.normal(size=(s, m, 2)) * 1e-3
        x[:, -2:] = rng.normal(size=(t, 2)) * 1e-3
    return x, means, log_var, log_w


def mfcc_like_inputs(rng, s=30, m=4, d=39, t=200):
    """``tests/test_bf16_scoring.py:mfcc_like_inputs``, in numpy."""
    offset = np.zeros(d, np.float32)
    offset[0] = 60.0
    centers = rng.normal(size=(s, 1, d)).astype(np.float32) * 3
    means = (offset + centers
             + rng.normal(size=(s, m, d)).astype(np.float32))
    log_var = rng.uniform(0.5, 2.5, size=(s, m, d)).astype(np.float32)
    w = rng.uniform(0.1, 1, size=(s, m))
    w /= w.sum(1, keepdims=True)
    log_w = np.log(w).astype(np.float32)
    which = rng.integers(0, s, size=t)
    x = (offset + centers[which, 0]
         + rng.normal(size=(t, d)).astype(np.float32) * 2).astype(np.float32)
    return x, means, log_var, log_w


def torch_of(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def kernel_arithmetic(x, means, log_var, log_w, normalizer, score_dtype):
    """What ``csrc/gmm_score.cu`` computes from the wrapper's packed
    operands: per mixture ``xa @ weight[m] + bias[m]`` in fp32, folded by
    the same online max/sum logsumexp."""
    center = x.mean(0) if score_dtype == "bfloat16" else None
    weight, bias, center = gk._pack_params(means, log_var, log_w,
                                           normalizer, score_dtype,
                                           center=center)
    xc = x - center[None]
    xa = torch.cat([xc * xc, xc], dim=1).to(weight.dtype).float()
    mx = ss = None
    for m in range(weight.shape[0]):
        v = xa @ weight[m].float() + bias[m]
        if m == 0:
            mx, ss = v, torch.ones_like(v)
        else:
            nm = torch.maximum(mx, v)
            ss = ss * torch.exp(mx - nm) + torch.exp(v - nm)
            mx = nm
    return mx + torch.log(ss)


CASES = {
    "non_tile_t_s": (dict(s=20, m=4, d=13, t=100), "textbook"),
    "reference_normalizer": (dict(s=8, m=2, d=7, t=32), "reference"),
    "floor_variances": (dict(s=20, m=4, d=13, t=100, floor=True), "textbook"),
}


class TestPlainScores:
    @pytest.mark.parametrize("case", list(CASES))
    def test_matches_jax(self, rng, case):
        shape, norm = CASES[case]
        x, means, log_var, log_w = make_inputs(rng, **shape)
        want = np.asarray(jax_scores(x, means, log_var, log_w,
                                     normalizer=norm))
        got = tg.gmm_log_scores(*torch_of(x, means, log_var, log_w),
                                normalizer=norm).numpy()
        assert got.shape == want.shape
        assert np.allclose(got, want, **F32)

    @pytest.mark.parametrize("case", list(CASES))
    def test_matches_pallas_interpret(self, rng, case):
        shape, norm = CASES[case]
        x, means, log_var, log_w = make_inputs(rng, **shape)
        want = np.asarray(gmm_log_scores_pallas(
            x, means, log_var, log_w, normalizer=norm, t_tile=32,
            s_tile=16, interpret=True))
        got = tg.gmm_log_scores(*torch_of(x, means, log_var, log_w),
                                normalizer=norm).numpy()
        assert np.allclose(got, want, **F32)

    def test_bf16_matches_jax_and_pallas(self, rng):
        x, means, log_var, log_w = mfcc_like_inputs(rng, s=20, m=2, d=13,
                                                    t=64)
        got = tg.gmm_log_scores(*torch_of(x, means, log_var, log_w),
                                score_dtype="bfloat16").numpy()
        want = np.asarray(jax_scores(x, means, log_var, log_w,
                                     score_dtype="bfloat16"))
        pallas = np.asarray(gmm_log_scores_pallas(
            x, means, log_var, log_w, t_tile=32, s_tile=16, interpret=True,
            score_dtype="bfloat16"))
        assert np.allclose(got, want, **BF16)
        assert np.allclose(got, pallas, **BF16)

    def test_bf16_drift_budget(self, rng):
        """The port's bf16 path keeps the documented drift budget vs f32
        (``tests/test_bf16_scoring.py:test_xla_drift_under_budget``)."""
        args = torch_of(*mfcc_like_inputs(rng))
        f32 = tg.gmm_log_scores(*args).numpy()
        bf16 = tg.gmm_log_scores(*args, score_dtype="bfloat16").numpy()
        drift = np.abs(bf16 - f32)
        assert drift.mean() < 0.1 and drift.max() < 0.5

    def test_return_components(self, rng):
        x, means, log_var, log_w = make_inputs(rng, s=8, m=3, d=5, t=16)
        ws, wc = jax_scores(x, means, log_var, log_w, return_components=True)
        gs, gc = tg.gmm_log_scores(*torch_of(x, means, log_var, log_w),
                                   return_components=True)
        assert gc.shape == (16, 8, 3)
        assert np.allclose(gs.numpy(), np.asarray(ws), **F32)
        assert np.allclose(gc.numpy(), np.asarray(wc), **F32)

    def test_masked_log_w(self, rng):
        log_w = np.log(rng.uniform(0.1, 1, size=(6, 4))).astype(np.float32)
        counts = np.array([1, 2, 3, 4, 2, 1], np.int32)
        want = np.asarray(jax_masked_log_w(jnp.asarray(log_w),
                                           jnp.asarray(counts)))
        got = tg.masked_log_w(*torch_of(log_w, counts)).numpy()
        assert np.array_equal(got, want)

    def test_unknown_options_raise(self, rng):
        args = torch_of(*make_inputs(rng, s=2, m=1, d=3, t=4))
        with pytest.raises(ValueError):
            tg.gmm_log_scores(*args, normalizer="nope")
        with pytest.raises(ValueError):
            tg.gmm_log_scores(*args, score_dtype="float16")


class TestKernelWrapper:
    @pytest.mark.parametrize("score_dtype,tol", [("float32", F32),
                                                 ("bfloat16", BF16)])
    @pytest.mark.parametrize("normalizer", ["textbook", "reference"])
    def test_packed_operands_reproduce_scores(self, rng, score_dtype, tol,
                                              normalizer):
        args = torch_of(*mfcc_like_inputs(rng, s=21, m=3, d=13, t=70))
        got = kernel_arithmetic(*args, normalizer, score_dtype)
        want = tg.gmm_log_scores(*args, normalizer=normalizer,
                                 score_dtype=score_dtype)
        assert torch.allclose(got, want, **tol)

    def test_padded_mixtures_drop_out(self, rng):
        x, means, log_var, log_w = make_inputs(rng, s=6, m=3, d=4, t=9)
        log_w[:, 2] = -np.inf  # a real -inf weight is clamped to NEG_INF
        args = torch_of(x, means, log_var, log_w)
        got = kernel_arithmetic(*args, "textbook", "float32")
        want = tg.gmm_log_scores(*torch_of(x[:], means[:, :2],
                                           log_var[:, :2], log_w[:, :2]))
        assert torch.isfinite(got).all()
        assert torch.allclose(got, want, **F32)

    def test_cpu_dispatch_takes_plain_path(self, rng):
        args = torch_of(*make_inputs(rng))
        gk.gmm_log_scores_cuda.launches = 0
        got = gk.gmm_log_scores_fast(*args)
        assert torch.equal(got, tg.gmm_log_scores(*args))
        assert gk.gmm_log_scores_cuda.launches == 0

    def test_kernel_wrapper_refuses_cpu_tensors(self, rng):
        with pytest.raises(ValueError):
            gk.gmm_log_scores_cuda(*torch_of(*make_inputs(rng)))

