"""K-means clustering, batched over groups: k-means++ seeding + Lloyd
iterations (port of ``poccala_tpu/ops/kmeans.py``).

Every function works on a written-out group axis — ``x [G, F, D]``,
``mask [G, F]`` — where the JAX package ``vmap``s one clustering; one
clustering is the group of one (:func:`kmeans`).  Assignment is one
``[G, F, k]`` distance product per iteration.

Semantics kept from the JAX package (and through it the reference,
``Clustering.py:838-1044``):

* k-means++ seeding with distance-proportional sampling, including the
  degenerate all-points-equal fallback to uniform sampling;
* the empty-cluster re-seed at the point farthest from its centre;
* first-index ties of ``argmin`` / ``argmax``;
* per-dimension variances floored at 1e-4;
* the result: means, variances, ``alpha`` = cluster fractions,
  ``assign`` (-1 on masked points) and ``counts``.

Randomness: each draw of ``jax.random.choice(p=...)`` is an inverse-CDF
lookup, ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))``.  The port
draws the uniforms ``u`` on the CPU from a ``torch.Generator`` and inverts
the CDF on the device, so one seed gives the same draws on every device,
and a group without valid points (p = 0) gives index 0 as JAX does —
``torch.multinomial`` would raise there.  A test can hand
:func:`kmeans_plusplus_init` JAX's own uniforms.

Precision: ``x² − 2x·c + c²`` and ``Σx²/n − μ²`` cancel, so the products
must run in true float32 (``torch.backends.cuda.matmul.allow_tf32`` stays
False, PyTorch's default).
"""

from __future__ import annotations

import torch

_VAR_FLOOR = 1e-4
_BIG = 1e30


def _pairwise_sq_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``[..., F, k]`` squared Euclidean distances in matmul form."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)              # [..., F, 1]
    c2 = torch.sum(centers * centers, dim=-1)                # [..., k]
    xc = x @ centers.transpose(-1, -2)                       # [..., F, k]
    return x2 - 2.0 * xc + c2[..., None, :]


def _choice(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, F, p=p)`` per group, from its uniform
    ``u [G]``: the inverse CDF of ``p [G, F]``."""
    cdf = torch.cumsum(p, dim=-1)
    r = cdf[:, -1:] * (1.0 - u[:, None])
    return torch.searchsorted(cdf, r).squeeze(-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[g, idx[g]]`` for ``x [G, F, D]``, ``idx [G]`` -> ``[G, D]``."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def seed_uniforms(generator: torch.Generator, groups: int, k: int,
                  device=None) -> torch.Tensor:
    """The ``[G, k]`` uniforms k-means++ consumes, drawn on the CPU."""
    return torch.rand((groups, k), generator=generator).to(device)


def kmeans_plusplus_init(x: torch.Tensor, mask: torch.Tensor, k: int,
                         u: torch.Tensor) -> torch.Tensor:
    """k-means++ seeding (``Clustering.py:975-1020``) per group.

    :param x: ``[G, F, D]`` points (padded); ``mask [G, F]`` validity
    :param u: ``[G, k]`` uniforms in [0, 1), one per centre drawn
    :returns: ``[G, k, D]`` initial centres
    """
    g, f, d = x.shape
    maskf = mask.to(x.dtype)
    p0 = maskf / torch.clamp(maskf.sum(dim=-1, keepdim=True), min=1.0)
    centers = torch.zeros((g, k, d), dtype=x.dtype, device=x.device)
    centers[:, 0] = _take(x, _choice(u[:, 0], p0))
    slot = torch.arange(k, device=x.device)[None, None, :]
    for i in range(1, k):
        dist = torch.amin(_pairwise_sq_dist(x, centers)
                          + torch.where(slot < i, 0.0, _BIG), dim=-1)
        dist = torch.sqrt(torch.clamp(dist, min=0.0)) * maskf
        total = dist.sum(dim=-1, keepdim=True)
        # degenerate data (all points identical): uniform choice
        # (Clustering.py:997-1009)
        p = torch.where(total > 0, dist / torch.clamp(total, min=1e-30), p0)
        centers[:, i] = _take(x, _choice(u[:, i], p))
    return centers


def _assign(x, centers, maskf, k):
    """Nearest centre per point -> (distances, assignment, masked one-hot,
    counts ``[G, k]``, sums ``[G, k, D]``)."""
    dist = _pairwise_sq_dist(x, centers)
    assign = torch.argmin(dist, dim=-1)
    onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype) \
        * maskf[..., None]
    counts = onehot.sum(dim=-2)
    sums = onehot.transpose(-1, -2) @ x
    return dist, assign, onehot, counts, sums


def lloyd(centers: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
          iters: int = 20) -> dict:
    """Lloyd iterations from ``centers [G, k, D]`` and the final
    statistics (``kmeans.py:90-124``).

    :returns: dict with ``means [G, k, D]``, ``variances [G, k, D]``
        (diagonal, floored at 1e-4), ``alpha [G, k]`` cluster fractions,
        ``assign [G, F]`` (int32, -1 where masked) and ``counts [G, k]``
    """
    k = centers.shape[-2]
    maskf = mask.to(x.dtype)
    n_valid = torch.clamp(maskf.sum(dim=-1, keepdim=True), min=1.0)
    for _ in range(iters):
        dist, _, _, counts, sums = _assign(x, centers, maskf, k)
        new = sums / torch.clamp(counts[..., None], min=1.0)
        # empty cluster: re-seed at the point farthest from its centre
        far = torch.argmax(torch.amin(dist, dim=-1) * maskf, dim=-1)
        centers = torch.where((counts > 0)[..., None], new,
                              _take(x, far)[:, None, :])

    _, assign, onehot, counts, sums = _assign(x, centers, maskf, k)
    occupied = (counts > 0)[..., None]
    safe = torch.clamp(counts[..., None], min=1.0)
    means = sums / safe
    # clusters that stayed empty keep their (re-seeded) centre
    means = torch.where(occupied, means, centers)
    sq = onehot.transpose(-1, -2) @ (x * x)
    variances = sq / safe - means * means
    variances = torch.where(occupied, torch.clamp(variances, min=_VAR_FLOOR),
                            _VAR_FLOOR)
    return {
        "means": means,
        "variances": variances,
        "alpha": counts / n_valid,
        "assign": torch.where(mask, assign, -1).to(torch.int32),
        "counts": counts,
    }


def kmeans_grouped(generator: torch.Generator, x: torch.Tensor,
                   mask: torch.Tensor, k: int, iters: int = 20) -> dict:
    """One independent k-means per group (e.g. per senone during mixture
    re-initialization, ``AcousticModel.__cal_gmm``,
    ``AcousticModel.py:552-558``): ``x [G, F, D]``, ``mask [G, F]``.
    The seeding uniforms come from ``generator`` (CPU)."""
    u = seed_uniforms(generator, x.shape[0], k, x.device)
    return lloyd(kmeans_plusplus_init(x, mask, k, u), x, mask, iters)


def kmeans(generator: torch.Generator, x: torch.Tensor, mask: torch.Tensor,
           k: int, iters: int = 20) -> dict:
    """One k-means of ``x [F, D]`` with ``mask [F]`` (the group of one)."""
    out = kmeans_grouped(generator, x[None], mask[None], k, iters)
    return {name: value[0] for name, value in out.items()}
