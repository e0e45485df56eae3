"""Distance metrics, batched (port of ``poccala_tpu/ops/distance.py``).

Replaces ``StatisticalModel/Distance.py:15-46`` (scalar
``euclidean_metric`` / ``cosine_similarity`` and an *unimplemented*
``mahalanobis_distance`` stub) and the per-pair ``cal_distance``
Minkowski helper (``Clustering.py:796-801``).  All functions accept
``[..., D]`` batches and broadcast.  Arrays become tensors of torch's
default dtype, as ``jnp.asarray`` makes float64 arrays float32; tensors
keep their dtype and device.

Precision: :func:`pairwise_euclidean`'s ``|x|² − 2x·y + |y|²`` cancels, so
its product runs in true float32 (``torch.backends.cuda.matmul.
allow_tf32`` stays False, PyTorch's default).
"""

from __future__ import annotations

import torch


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = torch.as_tensor(a)
    return a.to(torch.get_default_dtype()) if a.is_floating_point() else a


def euclidean(a, b):
    """``sqrt(Σ(a-b)²)`` (``Distance.py:23-26``)."""
    d = _t(a) - _t(b)
    return torch.sqrt(torch.sum(d * d, dim=-1))


def manhattan(a, b):
    d = torch.abs(_t(a) - _t(b))
    return torch.sum(d, dim=-1)


def minkowski(a, b, p: float = 2.0):
    """General Minkowski (``Clustering.cal_distance``'s ``arg`` parameter,
    ``Clustering.py:789-801``)."""
    d = torch.abs(_t(a) - _t(b))
    return torch.sum(d ** p, dim=-1) ** (1.0 / p)


def cosine_similarity(a, b):
    """``a·b / (|a||b|)`` (``Distance.py:33-36``)."""
    a, b = _t(a), _t(b)
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)
    return num / torch.clamp(den, min=1e-30)


def mahalanobis(a, b, precision):
    """``sqrt((a-b)ᵀ Σ⁻¹ (a-b))`` — implements the reference's declared
    but empty ``mahalanobis_distance`` (``Distance.py:44-46``).

    :param precision: ``[D, D]`` inverse covariance, or ``[D]`` diagonal
        precisions.
    """
    d = _t(a) - _t(b)
    precision = _t(precision)
    if precision.dim() == 1:
        q = torch.sum(d * d * precision, dim=-1)
    else:
        q = torch.einsum("...i,ij,...j->...", d, precision, d)
    return torch.sqrt(torch.clamp(q, min=0.0))


def pairwise_euclidean(x, y):
    """``[N, M]`` distance matrix in matmul form (the batched version of
    every per-pair distance loop in the reference's clustering code)."""
    x, y = _t(x), _t(y)
    x2 = torch.sum(x * x, dim=-1)[:, None]
    y2 = torch.sum(y * y, dim=-1)[None, :]
    xy = x @ y.T
    return torch.sqrt(torch.clamp(x2 - 2 * xy + y2, min=0.0))
