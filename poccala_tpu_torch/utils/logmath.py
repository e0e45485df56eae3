"""Log-domain math primitives (port of ``poccala_tpu/utils/logmath.py``).

Batched replacements for the reference's scalar helpers in
``StatisticalModel/util.py:20-92``: ``log_sum_exp`` (scalar/rowwise Python
loops), ``matrix_log_sum_exp`` (list folds) and ``gaussian_function``
(per-vector diagonal Gaussian).

``NEG_INF`` is a large-but-finite stand-in for log(0): ``(-inf) - (-inf)``
is nan, and the online logsumexp of the GMM kernel and the decoder's
clamps rely on every score staying finite.  Never use a real ``-inf`` in
masked arithmetic.

Numerics note: the reference's log-space Gaussian normalizer is
``-D/2*log(2π) - 0.5*Σ diag(cov)`` (``util.py:29``); the textbook formula
has ``0.5*Σ log diag``.  Both are implemented; ``normalizer='reference'``
reproduces the reference's numerics, ``'textbook'`` (default) is the
correct density.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
NEG_INF = -1e30


def logsumexp(x: torch.Tensor, axis=None, keepdims: bool = False):
    """Numerically-stable log-sum-exp over ``axis`` (None: every axis)
    (reference ``util.py:54-77``).  An all-``-inf`` row gives ``-inf``, the
    reference's edge case (``util.py:63-65``)."""
    x = torch.as_tensor(x)
    dim = tuple(range(x.dim())) if axis is None else axis
    return torch.logsumexp(x, dim=dim, keepdim=keepdims)


def log_matvec(log_A: torch.Tensor, log_x: torch.Tensor) -> torch.Tensor:
    """Log-domain matrix-vector product: ``out[j] = LSE_i(log_x[i] +
    log_A[i, j])`` (``util.matrix_dot``, ``util.py:39-51``).  Shapes:
    ``log_A[N, M]``, ``log_x[N]`` -> ``out[M]``."""
    return logsumexp(log_x[:, None] + log_A, axis=0)


def diag_gaussian_logpdf(x: torch.Tensor, mean: torch.Tensor,
                         log_var: torch.Tensor,
                         normalizer: str = "textbook") -> torch.Tensor:
    """Diagonal-covariance Gaussian log-density, batched
    (``util.gaussian_function(..., log=True)``, ``util.py:20-31``).

    :param x:       ``[..., D]`` data
    :param mean:    ``[..., D]`` means (broadcast against x)
    :param log_var: ``[..., D]`` log of the diagonal variances
    :param normalizer: 'textbook' -> ``-0.5*Σ log σ²``; 'reference' ->
        ``-0.5*Σ σ²`` (reproduces ``util.py:29``)
    :returns: ``[...]`` log densities
    """
    d = x.shape[-1]
    diff = x - mean
    quad = -0.5 * torch.sum(diff * diff * torch.exp(-log_var), dim=-1)
    if normalizer == "textbook":
        norm = -0.5 * d * LOG_2PI - 0.5 * torch.sum(log_var, dim=-1)
    elif normalizer == "reference":
        norm = -0.5 * d * LOG_2PI - 0.5 * torch.sum(torch.exp(log_var),
                                                    dim=-1)
    else:
        raise ValueError(f"unknown normalizer: {normalizer!r}")
    return norm + quad


def masked_log(x: torch.Tensor) -> torch.Tensor:
    """``log(x)`` with log(0) -> NEG_INF instead of -inf (the reference
    silences these via ``np.seterr(divide='ignore')``, ``LHMM.py:570``)."""
    return torch.where(x > 0, torch.log(torch.clamp(x, min=1e-300)),
                       torch.full_like(x, NEG_INF))


def safe_exp_sub(log_num: torch.Tensor, log_den: torch.Tensor):
    """``exp(log_num - log_den)`` with 0 when the denominator is empty
    (reference guards: ``LHMM.py:517-518``, ``Clustering.py:685-693``)."""
    ok = log_den > NEG_INF / 2
    return torch.where(ok, torch.exp(log_num - torch.where(ok, log_den, 0.0)),
                       0.0)
