"""Split-and-Merge EM (SMEM) for GMM mixture management (port of
``poccala_tpu/train/smem.py``).

After EM converges, propose merging the two most-correlated components
and splitting the worst-fit one, partially re-estimate the affected
triple, and accept iff the total Q improves (``Clustering.GMM.__SMEM``,
``StatisticalModel/Clustering.py:373-577``).  The JAX module's docstring
lists what is kept from the reference and the one documented deviation
(the split criterion ranks by own-point log-likelihood deficit).

Two implementations, chosen by ``cfg.train.smem_impl`` in
:func:`smem_pass`:

* ``'batched'`` (the default): the whole bank in two batched device
  programs — :func:`_smem_stats` (responsibility Gram matrix, ownership
  counts, split-deficit scores, Q) and :func:`_smem_propose` (masked
  2-means split, merge, 5-step partial EM of the triple, candidate Q,
  post-accept polish) — around the host candidate selector
  :func:`_select_candidates` (NumPy, copied verbatim).  Where JAX draws
  the proposal's randomness inside the program from per-senone keys, the
  caller here draws it from the trainer's CPU ``torch.Generator`` and
  passes it in as tensors: the 2-means seeding uniforms ``[S, 2]`` and
  the centre jitter ``[S, 2, D]``.  A test can feed it JAX's draws.
* ``'serial'`` (the oracle): one host-driven proposal per senone
  (:func:`smem_step`) with the float64 host helpers copied from the JAX
  module.  The split's 2-means seeding and jitter come from the
  generator.
"""

from __future__ import annotations

import numpy as np
import torch

from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.ops import em as em_ops
from poccala_tpu_torch.ops import kmeans as km_ops
from poccala_tpu_torch.utils.logmath import LOG_2PI, NEG_INF, masked_log


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array -> host ndarray."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _c_covariance(trainer):
    return getattr(trainer, "var_floor", trainer.cfg.model.c_covariance)


# ----------------------------------------------------------------------
# Serial SMEM: the host-driven oracle
# ----------------------------------------------------------------------

def _posteriors(params, x, mask, normalizer):
    """Host responsibilities (masked) and component log-pdfs of one GMM."""
    log_gamma, comp = em_ops.e_step(
        em_ops.GmmParams(*(t[None] for t in params)), x[None], mask[None],
        normalizer)
    gamma = _host(torch.exp(log_gamma[0])) * _host(mask)[:, None]
    return gamma, _host(comp[0])


def merge_scores(gamma: np.ndarray) -> list[tuple[int, int, float]]:
    """``__J_merge`` (Clustering.py:373-386): cosine similarity between
    responsibility columns, sorted descending."""
    m = gamma.shape[1]
    norms = np.linalg.norm(gamma, axis=0) + 1e-30
    out = []
    for i in range(m):
        for j in range(i + 1, m):
            out.append((i, j, float(gamma[:, i] @ gamma[:, j] / (norms[i] * norms[j]))))
    out.sort(key=lambda r: r[2], reverse=True)
    return out


def split_scores(gamma: np.ndarray, comp: np.ndarray) -> list[tuple[int, float]]:
    """Rank components by average own-point log-likelihood deficit (see
    the JAX module's docstring for the deviation from ``__J_split``)."""
    m = gamma.shape[1]
    out = []
    for k in range(m):
        nk = gamma[:, k].sum()
        if nk <= 1e-6:
            out.append((k, np.inf))  # empty components split first
            continue
        avg_ll = float((gamma[:, k] * comp[:, k]).sum() / nk)
        out.append((k, -avg_ll))
    out.sort(key=lambda r: r[1], reverse=True)
    return out


def _merge_params(params, i, j):
    """``__merge`` (Clustering.py:431-440); ``params`` holds host arrays."""
    w = np.exp(np.asarray(params.log_w, np.float64))
    mu = np.asarray(params.means, np.float64)
    var = np.exp(np.asarray(params.log_var, np.float64))
    a = w[i] + w[j]
    mean = (mu[i] * w[i] + mu[j] * w[j]) / a
    v = (var[i] * w[i] + var[j] * w[j]) / a
    return mean, v, a


def _split_params(params, k, x, mask, gamma, generator, mix_level, device):
    """``__split`` (Clustering.py:442-467): 2-means over the component's
    argmax points; None when the component owns too few points."""
    assign = np.argmax(gamma, axis=1)
    sel = (assign == k) & np.asarray(mask)
    if sel.sum() < mix_level:
        return None
    pts = np.asarray(x)[sel]
    res = km_ops.kmeans(
        generator, torch.as_tensor(pts, device=device),
        torch.ones(len(pts), dtype=torch.bool, device=device), k=2, iters=10)
    centers = _host(res["means"]).astype(np.float64)
    jitter = torch.rand(centers.shape, generator=generator,
                        dtype=torch.float64).numpy() * 1e-2
    centers = centers + jitter
    # isotropic covariance from the generalized variance (det^(1/D))
    old_var = np.exp(np.asarray(params.log_var[k], np.float64))
    iso = float(np.exp(np.mean(np.log(old_var))))
    var = np.full_like(centers, iso)
    a = float(np.exp(params.log_w[k])) * 0.5
    return centers, var, (a, a)


def _partial_em(x, mask, gamma_sum, means3, var3, w3, c_covariance,
                normalizer, iters=5):
    """``__reestimate`` + one maximization (Clustering.py:469-481,
    541-552): EM restricted to the triple, responsibilities scaled by the
    triple's old total responsibility per point."""
    x = np.asarray(x, np.float64)
    maskf = np.asarray(mask, np.float64)
    for _ in range(iters):
        logn = np.zeros((len(x), 3))
        for c in range(3):
            diff = x - means3[c]
            logn[:, c] = (
                -0.5 * x.shape[1] * np.log(2 * np.pi)
                - 0.5 * np.sum(np.log(var3[c]))
                - 0.5 * (diff * diff / var3[c]).sum(-1)
            ) + np.log(max(w3[c], 1e-30))
        mx = logn.max(axis=1, keepdims=True)
        post = np.exp(logn - mx)
        post /= post.sum(axis=1, keepdims=True)
        g = post * gamma_sum[:, None] * maskf[:, None]
        nk = g.sum(axis=0) + 1e-30
        means3 = (g.T @ x) / nk[:, None]
        var3 = np.maximum(
            (g.T @ (x * x)) / nk[:, None] - means3 ** 2, c_covariance
        )
        # within-triple weight fractions (the triple's total mass is
        # reattached by the caller)
        w3 = nk / nk.sum()
    return means3, var3, w3


def smem_step(params: em_ops.GmmParams, x, mask, generator: torch.Generator,
              mix_level: int, c_max: int = 5, c_covariance=1e-6,
              normalizer: str = "textbook"):
    """One SMEM proposal for a single GMM (``params`` of ``[M, D]`` tensors;
    ``x [F, D]``, ``mask [F]`` host arrays).  Device work runs where the
    parameters live.

    :returns: (new params, accepted: bool)
    """
    m_active = mix_level
    if m_active < 3:
        return params, False
    dev = params.means.device
    x_t = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    mask_t = torch.as_tensor(np.asarray(mask, bool), device=dev)
    host = em_ops.GmmParams(*(_host(t) for t in params))

    gamma, comp = _posteriors(params, x_t, mask_t, normalizer)
    gamma_a = gamma[:, :m_active]
    comp_a = comp[:, :m_active]
    q_old = float(em_ops.q_value(
        # 1e-300 underflows f32
        torch.as_tensor(np.log(np.maximum(gamma_a, 1e-30)), device=dev)[None],
        torch.as_tensor(comp_a, device=dev)[None],
        params.log_w[None, :m_active],
    )[0])

    merges = merge_scores(gamma_a)
    splits = split_scores(gamma_a, comp_a)
    candidates = []
    for (i, j, _) in merges:
        for (k, _) in splits:
            if k in (i, j):
                continue
            candidates.append((i, j, k))
            break
        if len(candidates) >= c_max:
            break

    triple_w_old = np.exp(np.asarray(host.log_w, np.float64))
    for (i, j, k) in candidates:
        sp = _split_params(host, k, x, mask, gamma_a, generator, mix_level,
                           dev)
        if sp is None:
            continue
        mean_m, var_m, a_m = _merge_params(host, i, j)
        centers, var_s, (a1, a2) = sp
        means3 = np.stack([mean_m, centers[0], centers[1]])
        var3 = np.stack([var_m, var_s[0], var_s[1]])
        w3 = np.array([a_m, a1, a2])
        gamma_sum = gamma_a[:, i] + gamma_a[:, j] + gamma_a[:, k]
        means3, var3, w3 = _partial_em(
            x, mask, gamma_sum, means3, var3, w3, c_covariance, normalizer
        )
        # rebuild the full mixture with (i, j, k) replaced by the triple
        new_means = np.asarray(host.means, np.float64).copy()
        new_var = np.exp(np.asarray(host.log_var, np.float64)).copy()
        new_w = triple_w_old.copy()
        triple_mass = triple_w_old[i] + triple_w_old[j] + triple_w_old[k]
        for slot, c in zip((i, j, k), range(3)):
            new_means[slot] = means3[c]
            new_var[slot] = var3[c]
            new_w[slot] = w3[c] * triple_mass
        # renormalize active weights
        new_w[:m_active] = np.maximum(new_w[:m_active], 1e-10)
        new_w[:m_active] /= new_w[:m_active].sum()
        cand = em_ops.GmmParams(
            means=torch.as_tensor(new_means, dtype=torch.float32, device=dev),
            log_var=torch.as_tensor(
                np.log(np.maximum(new_var, c_covariance)),
                dtype=torch.float32, device=dev),
            log_w=masked_log(torch.as_tensor(
                np.where(np.arange(len(new_w)) < m_active, new_w, 0.0),
                dtype=torch.float32, device=dev)),
        )
        lg, cmp_new = em_ops.e_step(
            em_ops.GmmParams(*(t[None] for t in cand)), x_t[None],
            mask_t[None], normalizer)
        q_new = float(em_ops.q_value(lg, cmp_new, cand.log_w[None])[0])
        if q_new > q_old:
            # post-accept EM polish (the reference continues its EM loop
            # after acceptance, Clustering.py:711-714)
            mix_mask = torch.arange(params.means.shape[0], device=dev) \
                < m_active
            polished, _, _ = em_ops.em_fit(
                cand, x_t, mask_t, mix_mask, c_covariance=c_covariance,
                max_iters=10, normalizer=normalizer)
            return polished, True
        # first evaluable candidate decides (Clustering.py:565-577)
        return params, False
    return params, False


def smem_pass(trainer, frames, mask, enough: np.ndarray,
              generator: torch.Generator | None = None) -> tuple:
    """One SMEM proposal per eligible senone of ``trainer.bank`` (a state
    shard's rows on a sharded trainer), dispatched on
    ``cfg.train.smem_impl``: ``'batched'`` (default) or ``'serial'`` (the
    oracle).  ``frames [S, F, D]`` and ``mask [S, F]`` may be host arrays
    or tensors.  The random draws come from ``generator`` (default
    ``trainer.generator``).

    :returns: (bank, number of accepted moves)
    """
    impl = getattr(trainer.cfg.train, "smem_impl", "batched")
    if impl == "serial":
        return smem_pass_serial(trainer, frames, mask, enough, generator)
    return smem_pass_batched(trainer, frames, mask, enough, generator)


def smem_pass_serial(trainer, frames, mask, enough: np.ndarray,
                     generator: torch.Generator | None = None) -> tuple:
    """Run one SMEM proposal per eligible senone (host-driven loop around
    device work; runs on init rounds only, ``AcousticModel.py:835``)."""
    if generator is None:
        generator = trainer.generator
    bank = trainer.bank
    mix = trainer.mix_level
    frames, mask = _host(frames), _host(mask)
    n_accepted = 0
    means = bank.means.clone()
    log_var = bank.log_var.clone()
    log_w = bank.log_w.clone()
    for s in range(bank.num_states):
        if not enough[s] or mask[s].sum() < 3 * mix:
            continue
        params = em_ops.GmmParams(means[s], log_var[s], log_w[s])
        new_params, accepted = smem_step(
            params, frames[s], mask[s], generator, mix,
            c_max=trainer.cfg.train.smem_c_max,
            c_covariance=_c_covariance(trainer),
            normalizer=trainer.cfg.model.gaussian_normalizer,
        )
        if accepted:
            n_accepted += 1
            means[s] = new_params.means
            log_var[s] = new_params.log_var
            log_w[s] = new_params.log_w
    return sb.replace(bank, means=means, log_var=log_var, log_w=log_w), \
        n_accepted


# ----------------------------------------------------------------------
# Batched SMEM: the whole bank in two device programs
# ----------------------------------------------------------------------
#
#   _smem_stats        batched e-step   -> q_old, responsibility Gram
#                                          matrix, ownership counts,
#                                          split-deficit scores
#   (host)             candidate select -> first evaluable (i, j, k) per
#                                          senone, exactly the serial order
#   _smem_propose      batched propose  -> masked 2-means split, merge,
#                                          triple partial-EM, candidate
#                                          Q, post-accept polish
#   (host)             accept/reject    -> where() over accepted rows
#
# Deviations from the serial path (as in the JAX package): the split
# 2-means sees the component's points as a masked [cap, D] array instead
# of a compacted copy, and the triple's partial EM runs in float32 on the
# device instead of float64 on the host.


def _smem_stats(means, log_var, log_w, x, mask, mix: int, normalizer: str):
    """Per-senone responsibilities folded to the fixed-size statistics the
    host selector needs: (q_old ``[S]``, gram ``[S, mix, mix]``,
    nk ``[S, mix]``, wsum ``[S, mix]``, own ``[S, mix]``)."""
    lg, comp = em_ops.e_step(em_ops.GmmParams(means, log_var, log_w), x,
                             mask, normalizer)
    lg_a = lg[..., :mix]
    comp_a = comp[..., :mix]
    maskf = mask[..., None].to(torch.float32)
    gamma = torch.exp(lg_a) * maskf                            # [S, F, mix]
    q_old = em_ops.q_value(lg_a, comp_a, log_w[:, :mix])
    gram = gamma.transpose(-1, -2) @ gamma                     # [S, mix, mix]
    nk = gamma.sum(dim=1)                                      # [S, mix]
    wsum = torch.sum(
        gamma * torch.where(comp_a > NEG_INF / 2, comp_a, 0.0), dim=1)
    assign = torch.argmax(gamma, dim=-1)                       # [S, F]
    own = torch.sum(torch.nn.functional.one_hot(assign, mix)
                    .to(torch.float32) * maskf, dim=1)         # [S, mix]
    return q_old, gram, nk, wsum, own


def _select_candidates(gram, nk, wsum, own, mix, c_max, mix_level):
    """Host candidate selection, the serial order vectorized over S:
    merge pairs by responsibility cosine (``__J_merge``), split ranks by
    own-point log-likelihood deficit, candidate list = per merge pair
    the best split not in the pair, capped at ``c_max``; the decided
    candidate is the first with enough owned points (``__split``'s
    eligibility)."""
    s = gram.shape[0]
    norms = np.sqrt(np.maximum(np.diagonal(gram, axis1=1, axis2=2), 0.0))
    pairs = [(i, j) for i in range(mix) for j in range(i + 1, mix)]
    pi = np.asarray([p[0] for p in pairs])
    pj = np.asarray([p[1] for p in pairs])
    sim = gram[:, pi, pj] / (norms[:, pi] * norms[:, pj] + 1e-30)  # [S, P]
    merge_order = np.argsort(-sim, axis=1, kind="stable")          # [S, P]

    deficit = np.where(nk <= 1e-6, np.inf,
                       -(wsum / np.maximum(nk, 1e-30)))            # [S, M]
    split_order = np.argsort(-deficit, axis=1, kind="stable")      # [S, M]

    # per merge pair: the first split component not in the pair
    # (mix >= 3 guarantees one of the top-3 qualifies)
    rows = np.arange(s)[:, None]
    top3 = split_order[:, :3]                                      # [S, 3]
    cand_i = pi[merge_order]                                       # [S, P]
    cand_j = pj[merge_order]
    k_of_pair = np.full(cand_i.shape, -1, np.int64)
    remaining = np.ones(cand_i.shape, bool)
    for t in range(3):
        kt = top3[:, t][:, None]                                   # [S, 1]
        ok = remaining & (kt != cand_i) & (kt != cand_j)
        k_of_pair = np.where(ok, kt, k_of_pair)
        remaining &= ~ok

    # first candidate (serial list order) whose split component owns
    # enough points; c_max caps how deep we look
    n_c = min(c_max, cand_i.shape[1])
    chosen = np.full((s, 3), -1, np.int64)
    undecided = np.ones(s, bool)
    for c in range(n_c):
        i_c, j_c, k_c = cand_i[:, c], cand_j[:, c], k_of_pair[:, c]
        ev = undecided & (k_c >= 0) & (
            own[rows[:, 0], np.clip(k_c, 0, None)] >= mix_level)
        chosen[ev] = np.stack(
            [i_c[ev], j_c[ev], k_c[ev]], axis=1)
        undecided &= ~ev
    return chosen  # [S, 3], -1 rows have no evaluable candidate


def _smem_propose(means, log_var, log_w, x, mask, ijk, seed_u, jitter,
                  mix: int, c_covariance, normalizer: str,
                  polish_iters: int):
    """Proposal construction + evaluation + polish for every senone at
    once (``smem.py:394-498``): merge (``Clustering.py:431-440``), split
    (``:442-467``), partial re-estimation (``:469-481``).  Rows whose
    ``ijk`` is a placeholder are computed and discarded by the caller.

    :param ijk: ``[S, 3]`` (merge i, merge j, split k)
    :param seed_u: ``[S, 2]`` k-means++ uniforms of the split's 2-means
    :param jitter: ``[S, 2, D]`` uniforms; the split centres move by
        ``1e-2 * jitter``
    :returns: (polished means, log_var, log_w, candidate Q ``[S]``)
    """
    s, m_cap, d = means.shape
    floor = em_ops.floor_tensor(c_covariance, x.device, x.dtype)
    maskf = mask.to(x.dtype)
    lg, _ = em_ops.e_step(em_ops.GmmParams(means, log_var, log_w), x, mask,
                          normalizer)
    gamma = torch.exp(lg[..., :mix]) * maskf[..., None]
    assign = torch.argmax(gamma, dim=-1)                        # [S, F]

    ii, jj, kk = ijk.long().unbind(-1)
    oh_i, oh_j, oh_k = (torch.nn.functional.one_hot(v, m_cap)
                        .to(x.dtype) for v in (ii, jj, kk))
    w = torch.exp(log_w)                                        # [S, M]
    var = torch.exp(log_var)                                    # [S, M, D]

    def pick_vec(oh, a):   # [S, M, D] -> [S, D]
        return torch.einsum("sm,smd->sd", oh, a)

    wi, wj, wk = ((oh * w).sum(-1) for oh in (oh_i, oh_j, oh_k))

    # merge (i, j) -> slot 0
    a_m = wi + wj
    den = torch.clamp(a_m, min=1e-30)[:, None]
    mean_m = (pick_vec(oh_i, means) * wi[:, None]
              + pick_vec(oh_j, means) * wj[:, None]) / den
    var_m = (pick_vec(oh_i, var) * wi[:, None]
             + pick_vec(oh_j, var) * wj[:, None]) / den

    # split k -> slots 1, 2: masked 2-means over k's argmax points
    sel = (assign == kk[:, None]) & mask
    res = km_ops.lloyd(km_ops.kmeans_plusplus_init(x, sel, 2, seed_u), x,
                       sel, iters=10)
    centers = res["means"] + jitter * 1e-2                      # [S, 2, D]
    iso = torch.exp(torch.mean(pick_vec(oh_k, log_var), dim=-1))
    var_s = iso[:, None, None].expand_as(centers)
    a_s = wk * 0.5

    m3 = torch.cat([mean_m[:, None], centers], dim=1)           # [S, 3, D]
    v3 = torch.cat([var_m[:, None], var_s], dim=1)
    w3 = torch.stack([a_m, a_s, a_s], dim=-1)                   # [S, 3]
    gamma_sum = torch.einsum("sfm,sm->sf", gamma,
                             (oh_i + oh_j + oh_k)[:, :mix])     # [S, F]

    # partial EM on the triple (float32 device form of __reestimate)
    g_weight = (gamma_sum * maskf)[..., None]
    x2 = x * x
    for _ in range(5):
        diff = x[:, :, None, :] - m3[:, None]                   # [S, F, 3, D]
        logn = (
            -0.5 * d * LOG_2PI
            - 0.5 * torch.sum(torch.log(v3), dim=-1)[:, None]
            - 0.5 * torch.sum(diff * diff / v3[:, None], dim=-1)
        ) + torch.log(torch.clamp(w3, min=1e-30))[:, None]
        g = torch.softmax(logn, dim=-1) * g_weight              # [S, F, 3]
        nk3 = g.sum(dim=1) + 1e-30                              # [S, 3]
        g_t = g.transpose(-1, -2)
        m3 = (g_t @ x) / nk3[..., None]
        v3 = torch.maximum((g_t @ x2) / nk3[..., None] - m3 * m3, floor)
        w3 = nk3 / nk3.sum(dim=-1, keepdim=True)

    # rebuild the mixture with slots (i, j, k) <- triple
    oh3 = torch.stack([oh_i, oh_j, oh_k], dim=1)                # [S, 3, M]
    keep = (1 - oh3.sum(dim=1))                                 # [S, M]
    new_means = means * keep[..., None] + torch.einsum("scm,scd->smd",
                                                       oh3, m3)
    new_var = var * keep[..., None] + torch.einsum("scm,scd->smd", oh3, v3)
    triple_mass = wi + wj + wk
    new_w = w * keep + torch.einsum("sc,scm->sm", w3 * triple_mass[:, None],
                                    oh3)
    active = (torch.arange(m_cap, device=x.device) < mix).expand(s, m_cap)
    new_w = torch.where(active, torch.clamp(new_w, min=1e-10), 0.0)
    new_w = new_w / new_w.sum(dim=-1, keepdim=True)
    cand = em_ops.GmmParams(
        means=new_means,
        log_var=torch.log(torch.maximum(new_var, floor)),
        log_w=torch.where(active, torch.log(torch.clamp(new_w, min=1e-30)),
                          NEG_INF),
    )
    lg_c, comp_c = em_ops.e_step(cand, x, mask, normalizer)
    q_new = em_ops.q_value(lg_c, comp_c, cand.log_w)
    polished, _, _ = em_ops.em_fit_grouped(
        *cand, x, mask, active, c_covariance=c_covariance,
        max_iters=polish_iters, normalizer=normalizer)
    return polished.means, polished.log_var, polished.log_w, q_new


def smem_pass_batched(trainer, frames, mask, enough: np.ndarray,
                      generator: torch.Generator | None = None) -> tuple:
    """Batched SMEM pass: the whole senone bank in two device programs
    plus host candidate selection and accept/reject."""
    if generator is None:
        generator = trainer.generator
    bank = trainer.bank
    mix = trainer.mix_level
    if mix < 3:
        return bank, 0
    cfg = trainer.cfg
    normalizer = cfg.model.gaussian_normalizer
    c_cov = _c_covariance(trainer)
    dev = bank.means.device
    x = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    m = torch.as_tensor(mask, device=dev).to(torch.bool)

    eligible = np.asarray(enough) & _host(m.sum(dim=1) >= 3 * mix)
    if not eligible.any():
        return bank, 0

    q_old, gram, nk, wsum, own = _smem_stats(
        bank.means, bank.log_var, bank.log_w, x, m, mix, normalizer)
    chosen = _select_candidates(
        _host(gram), _host(nk), _host(wsum), _host(own), mix,
        cfg.train.smem_c_max, mix)
    eligible &= chosen[:, 0] >= 0
    if not eligible.any():
        return bank, 0

    s, _, d = bank.means.shape
    seed_u = torch.rand((s, 2), generator=generator).to(dev)
    jitter = torch.rand((s, 2, d), generator=generator).to(dev)
    ijk = torch.as_tensor(np.where(chosen >= 0, chosen, 0), device=dev)
    new_means, new_lv, new_lw, q_new = _smem_propose(
        bank.means, bank.log_var, bank.log_w, x, m, ijk, seed_u, jitter,
        mix, c_cov, normalizer, polish_iters=10)
    q_new = _host(q_new)
    accept = eligible & np.isfinite(q_new) & (q_new > _host(q_old))
    n_accepted = int(accept.sum())
    if not n_accepted:
        return bank, 0

    sel = torch.as_tensor(accept, device=dev)
    return sb.replace(
        bank,
        means=torch.where(sel[:, None, None], new_means, bank.means),
        log_var=torch.where(sel[:, None, None], new_lv, bank.log_var),
        log_w=torch.where(sel[:, None], new_lw, bank.log_w),
    ), n_accepted
