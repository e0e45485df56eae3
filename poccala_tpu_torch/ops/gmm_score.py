"""Diagonal-GMM log-likelihood scoring as matmuls — the plain PyTorch
version (port of ``poccala_tpu/ops/gmm_score.py``).

The Mahalanobis term expands as

    Σ_d (x-μ)²/σ²  =  Σ_d x²·p  -  2·Σ_d x·(μp)  +  Σ_d μ²·p,   p = 1/σ²

so all frames × all (state, mixture) pairs reduce to two ``[T,D]@[D,SM]``
matmuls plus a constant fold, followed by a logsumexp over the mixtures
of the materialised ``[T, S, M]`` lattice.  This is what the CPU runs and
what the CUDA kernel (:mod:`poccala_tpu_torch.ops.cuda.gmm_score_cuda`)
is held against on the GPU.

Precision: the f32 path must run in true float32.  At the covariance
floor p = 1/σ² reaches 1e6 and the ``x²p - 2xμp`` cancellation turns
TF32's 10-bit mantissa into errors of thousands of nats, so on a GPU
``torch.backends.cuda.matmul.allow_tf32`` must stay False (PyTorch's
default).  The bf16 path is the deliberate reduced-precision one: the
operands are centred on the frame mean, rounded to bfloat16, and then
multiplied as float32 — which is what JAX's bf16 dot with
``preferred_element_type=float32`` computes (a bf16×bf16 product is exact
in fp32; only the sum order differs).  A bf16 ``torch.matmul`` would
round the sums to bf16 too, so it is not used.
"""

from __future__ import annotations

import torch

from poccala_tpu_torch.utils.logmath import LOG_2PI, NEG_INF


def normalizer_const(log_var: torch.Tensor, normalizer: str) -> torch.Tensor:
    """``[S, M]`` Gaussian normalizer: 'textbook' ``-0.5Σ log σ²`` or
    'reference' ``-0.5Σ σ²`` (reproducing ``util.py:29``), both with the
    ``-D/2·log 2π`` term."""
    d = log_var.shape[-1]
    if normalizer == "textbook":
        return -0.5 * d * LOG_2PI - 0.5 * torch.sum(log_var, dim=-1)
    if normalizer == "reference":
        return -0.5 * d * LOG_2PI - 0.5 * torch.sum(torch.exp(log_var),
                                                    dim=-1)
    raise ValueError(f"unknown normalizer: {normalizer!r}")


def _round_bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


def gmm_component_logpdf(
    x: torch.Tensor,
    means: torch.Tensor,
    log_var: torch.Tensor,
    normalizer: str = "textbook",
    score_dtype: str = "float32",
) -> torch.Tensor:
    """Per-component Gaussian log-densities for all frames × states.

    Leading batch axes are allowed and must match between ``x`` and the
    parameters (the training E-step scores each utterance against its own
    gathered sentence senones: ``x [B, T, D]``, ``means [B, N_s, M, D]``).

    :param x: ``[..., T, D]`` frames
    :param means: ``[..., S, M, D]`` mixture means
    :param log_var: ``[..., S, M, D]`` log diagonal variances
    :param score_dtype: 'float32' (exact) or 'bfloat16' (operands centred
        on the mean of the ``T`` frames given — padding included — rounded
        to bf16, fp32 products and sums)
    :returns: ``[..., T, S, M]`` log N(x_t | μ_sm, σ²_sm)
    """
    *lead, s, m, d = means.shape
    prec = torch.exp(-log_var)
    const = normalizer_const(log_var, normalizer)
    if score_dtype == "bfloat16":
        # shift-invariant centering (see poccala_tpu/ops/gmm_score.py:72-81)
        c = torch.mean(x, dim=-2)
        x = x - c[..., None, :]
        means = means - c[..., None, None, :]
        op = _round_bf16
    elif score_dtype == "float32":
        op = None
    else:
        raise ValueError(f"unknown score_dtype: {score_dtype!r}")
    a1 = prec.reshape(*lead, s * m, d)
    a2 = (means * prec).reshape(*lead, s * m, d)
    mu2p = torch.sum(means * means * prec, dim=-1)  # [..., S, M]
    x2, x1 = x * x, x
    if op is not None:
        x2, x1, a1, a2 = op(x2), op(x1), op(a1), op(a2)
    quad = x2 @ a1.transpose(-1, -2) - 2.0 * (x1 @ a2.transpose(-1, -2))
    t = x.shape[-2]
    return (-0.5 * (quad.reshape(*lead, t, s, m) + mu2p[..., None, :, :])
            + const[..., None, :, :])


def gmm_log_scores(
    x: torch.Tensor,
    means: torch.Tensor,
    log_var: torch.Tensor,
    log_w: torch.Tensor,
    normalizer: str = "textbook",
    return_components: bool = False,
    score_dtype: str = "float32",
):
    """State-level GMM log-likelihoods ``logsumexp_m(log w + log N)``
    (``GMM.point(x, log=True)``, ``Clustering.py:740-767``) for the whole
    ``[T, S, M]`` lattice at once; padded mixtures carry NEG_INF weights.

    :returns: ``[T, S]``; with ``return_components`` also the
        ``[T, S, M]`` weighted component log-probs
    """
    comp = gmm_component_logpdf(x, means, log_var, normalizer=normalizer,
                                score_dtype=score_dtype)
    weighted = comp + log_w[None]
    scores = torch.logsumexp(weighted, dim=-1)
    if return_components:
        return scores, weighted
    return scores


def gmm_log_scores_batch(x, x_mask, means, log_var, log_w,
                         normalizer: str = "textbook",
                         score_dtype: str = "float32"):
    """Batched scoring: ``x [B, T, D]`` -> ``([B, T, S], x_mask)``; padded
    frames are scored but the mask is passed through for downstream DP
    kernels.  The ``B·T`` frames go through one call of
    :func:`~poccala_tpu_torch.ops.cuda.gmm_score_cuda.gmm_log_scores_fast`:
    one kernel launch for a CUDA tensor, the plain version for a CPU one.
    In bfloat16 the operands are centred on the mean of all ``B·T`` frames,
    where JAX's ``vmap`` centres each utterance on its own: both stay within
    the bfloat16 tolerance of the float32 scores."""
    # imported here: the wrapper module imports this one
    from poccala_tpu_torch.ops.cuda.gmm_score_cuda import gmm_log_scores_fast

    b, t, d = x.shape
    scores = gmm_log_scores_fast(
        x.reshape(b * t, d).contiguous(), means, log_var, log_w,
        normalizer=normalizer, score_dtype=score_dtype)
    return scores.reshape(b, t, -1), x_mask


def mixture_mask(mix_counts: torch.Tensor, max_mix: int) -> torch.Tensor:
    """``[S, M]`` bool — True for active mixture slots."""
    slots = torch.arange(max_mix, device=mix_counts.device)
    return slots[None, :] < mix_counts[:, None]


def masked_log_w(log_w: torch.Tensor, mix_counts: torch.Tensor) -> torch.Tensor:
    """Force padded mixture slots to NEG_INF."""
    keep = mixture_mask(mix_counts, log_w.shape[1])
    return torch.where(keep, log_w, torch.full_like(log_w, NEG_INF))
