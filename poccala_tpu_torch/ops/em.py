"""GMM expectation-maximization, batched over senone groups (port of
``poccala_tpu/ops/em.py``).

Replaces ``Clustering.GMM.em`` (``StatisticalModel/Clustering.py:695-719``)
and its helpers ``expectation``, ``maximization`` and ``q_function`` in
scaled linear-domain statistics, as the JAX package does: means
Σγx/Σγ, covariances about the new mean floored at ``c_covariance`` (a
scalar or a per-dim ``[D]`` floor), weights Σγ/F.

Every function takes a leading group axis: ``means [G, M, D]``,
``x [G, F, D]``, ``mask [G, F]``.  Where JAX ``vmap``s a ``while_loop``,
:func:`em_fit_grouped` runs one batched loop with an ``active`` mask: a
group stops when its own ``(it < max_iters) & (ΔQ > converge_delta)``
fails and keeps its values from then on, exactly as the vmapped loop
does; the loop makes one host sync per iteration.

Precision: ``Σγx²/n − μ²`` cancels, so the moment products must run in
true float32 (TF32 stays off).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from poccala_tpu_torch.ops.gmm_score import gmm_component_logpdf
from poccala_tpu_torch.utils.logmath import NEG_INF


class GmmParams(NamedTuple):
    means: torch.Tensor    # [G, M, D]
    log_var: torch.Tensor  # [G, M, D]
    log_w: torch.Tensor    # [G, M]


def floor_tensor(c_covariance, device, dtype) -> torch.Tensor:
    """The covariance floor (a scalar or a ``[D]`` vector) as a tensor of
    the frames' ``dtype`` on ``device``."""
    return torch.as_tensor(c_covariance, dtype=dtype, device=device)


def e_step(params: GmmParams, x: torch.Tensor, mask: torch.Tensor,
           normalizer: str = "textbook"):
    """Log responsibilities (``Clustering.expectation``,
    ``Clustering.py:583-599``): ``log γ[g, f, m] = log w_m + log N_m(x_f)
    − LSE_m'(...)``; masked frames get NEG_INF.

    :returns: (log γ ``[G, F, M]``, component log-pdfs ``[G, F, M]``)
    """
    comp = gmm_component_logpdf(x, params.means[:, None],
                                params.log_var[:, None],
                                normalizer=normalizer)[:, :, 0, :]
    weighted = comp + params.log_w[:, None, :]
    log_gamma = weighted - torch.logsumexp(weighted, dim=-1, keepdim=True)
    log_gamma = torch.where(mask[..., None], log_gamma, NEG_INF)
    return log_gamma, comp


def q_value(log_gamma: torch.Tensor, comp: torch.Tensor,
            log_w: torch.Tensor) -> torch.Tensor:
    """EM Q function per group (``Clustering.q_function``,
    ``Clustering.py:607-616``): ``Σ_m N_m log α_m + Σ_{f,m} γ_fm log
    N_m(x_f)``."""
    gamma = torch.exp(log_gamma)
    nk = gamma.sum(dim=-2)                                        # [G, M]
    v1 = torch.sum(nk * torch.where(log_w > NEG_INF / 2, log_w, 0.0), dim=-1)
    v2 = torch.sum(gamma * torch.where(comp > NEG_INF / 2, comp, 0.0),
                   dim=(-2, -1))
    return v1 + v2


def m_step(log_gamma: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
           floor: torch.Tensor, mix_mask: torch.Tensor) -> GmmParams:
    """Maximization (``Clustering.maximization``, ``Clustering.py:624-651``)
    in linear domain; ``floor`` from :func:`floor_tensor`."""
    gamma = torch.exp(log_gamma) * mask[..., None].to(x.dtype)
    nk = gamma.sum(dim=-2)                                        # [G, M]
    nk_safe = torch.clamp(nk, min=1e-10)[..., None]
    gamma_t = gamma.transpose(-1, -2)
    means = (gamma_t @ x) / nk_safe
    sq = (gamma_t @ (x * x)) / nk_safe
    var = torch.maximum(sq - means * means, floor)
    n_valid = torch.clamp(mask.sum(dim=-1).to(x.dtype), min=1.0)
    alpha = nk / n_valid[:, None]
    log_w = torch.where(mix_mask, torch.log(torch.clamp(alpha, min=1e-30)),
                        NEG_INF)
    return GmmParams(means=means, log_var=torch.log(var), log_w=log_w)


def em_fit_grouped(
    means: torch.Tensor, log_var: torch.Tensor, log_w: torch.Tensor,
    x: torch.Tensor, mask: torch.Tensor, mix_mask: torch.Tensor,
    c_covariance=1e-6,
    converge_delta: float = 1.28,
    max_iters: int = 20,
    normalizer: str = "textbook",
):
    """EM per group until ΔQ ≤ ``converge_delta`` (``Clustering.py:706``)
    or ``max_iters`` (``em.py:76-139``).  Replaces the per-unit
    ``Pool.apply_async(multi_training)`` fan-out
    (``AcousticModel.py:790-797``).

    :param x: ``[G, F, D]`` frames (padded); ``mask [G, F]``
    :param mix_mask: ``[G, M]`` active mixture slots
    :returns: (GmmParams, final Q ``[G]``, iterations run ``[G]`` int32)
    """
    floor = floor_tensor(c_covariance, x.device, x.dtype)
    p = GmmParams(means, log_var, log_w)
    g = means.shape[0]
    q = torch.full((g,), -float("inf"), dtype=x.dtype, device=x.device)
    dq = torch.full((g,), float("inf"), dtype=x.dtype, device=x.device)
    it = torch.zeros((g,), dtype=torch.int32, device=x.device)
    # the E-step of the current parameters, carried from the previous
    # iteration's Q evaluation (the vmapped loop recomputes it)
    lg, _ = e_step(p, x, mask, normalizer)
    while True:
        active = (it < max_iters) & (dq > converge_delta)
        if not bool(active.any()):
            break
        new_p = m_step(lg, x, mask, floor, mix_mask)
        new_lg, new_comp = e_step(new_p, x, mask, normalizer)
        new_q = q_value(new_lg, new_comp, new_p.log_w)
        a1, a2 = active[:, None], active[:, None, None]
        p = GmmParams(torch.where(a2, new_p.means, p.means),
                      torch.where(a2, new_p.log_var, p.log_var),
                      torch.where(a1, new_p.log_w, p.log_w))
        lg = torch.where(a2, new_lg, lg)
        dq = torch.where(active, new_q - q, dq)
        q = torch.where(active, new_q, q)
        it = it + active.to(torch.int32)
    return p, q, it


def em_fit(params: GmmParams, x: torch.Tensor, mask: torch.Tensor,
           mix_mask: torch.Tensor, c_covariance=1e-6,
           converge_delta: float = 1.28, max_iters: int = 20,
           normalizer: str = "textbook"):
    """One GMM (``params`` of ``[M, D]``, ``x [F, D]``): the group of one
    of :func:`em_fit_grouped`.  :returns: (GmmParams, Q, iterations)"""
    p, q, it = em_fit_grouped(
        params.means[None], params.log_var[None], params.log_w[None],
        x[None], mask[None], mix_mask[None], c_covariance=c_covariance,
        converge_delta=converge_delta, max_iters=max_iters,
        normalizer=normalizer)
    return GmmParams(p.means[0], p.log_var[0], p.log_w[0]), q[0], it[0]
