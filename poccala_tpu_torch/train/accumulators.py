"""Embedded Baum-Welch sufficient statistics and the M-step (port of
``poccala_tpu/train/accumulators.py``).

The statistics are one linear-domain :class:`BwStats` per batch:
γ-weighted zeroth/first/second moments per (senone, mixture) and the
transition numerators/denominators scattered from sentence rows back to
per-unit (row, col) slots.  Per-utterance statistics are normalised by
P(O|λ).  They add, so folding batches is :func:`add_stats`.

Where the JAX package ``vmap``s a one-utterance ``utterance_stats`` and
folds the batch afterwards, :func:`batch_stats` computes the whole batch
at once: the forward and backward passes go through
:mod:`poccala_tpu_torch.ops.hmm`'s batched dispatchers (the CUDA kernels
on the GPU), and the per-utterance contributions — weighted 0 for
batch-padding utterances (``label_len == 0``), as ``accumulators.py:347-352``
does — are scattered with ``index_add_``.  On a GPU ``index_add_`` adds
with atomics in no fixed order, so sums agree with the CPU and with JAX
to float32 rounding, not bit for bit.  The GMM moments come, for float32
CUDA tensors, from one launch of the statistics kernel
(:func:`~poccala_tpu_torch.ops.cuda.gmm_score_cuda.sentence_stats_cuda`),
which sums the terms of the nonzero state posteriors only, and otherwise
from the plain lines of :func:`_mixture_moments`; both sum in true
float32, never TF32 (the M-step's ``x²p − 2xμp`` recentring cancels as
scoring does).

With ``state_axis_name`` (the state axis's process group, the
counterpart of JAX's axis name) the bank's GMM tensors are one state
shard, rows ``[s_offset, s_offset + S_local)``: each rank scores only the
sentence states whose senone it owns, the ``[B, T, N_s]`` state scores
are exchanged by ``all_reduce(MAX)`` before ``log_b`` (exactly one shard
owns each senone, the others hold NEG_INF), the forward and backward
kernels run unchanged on every rank, and the GMM statistics come back
local (``[S_local]``) — ``poccala_tpu/train/accumulators.py:159-172,
241-247`` (:mod:`poccala_tpu_torch.parallel.mesh`).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable

import numpy as np
import torch

from poccala_tpu_torch.models.senone_bank import SenoneBank
from poccala_tpu_torch.models.topology import EmbeddedHMM, build_embedded_batch
from poccala_tpu_torch.ops import hmm as hmm_ops
from poccala_tpu_torch.ops.gmm_score import gmm_component_logpdf
from poccala_tpu_torch.utils import profiling
from poccala_tpu_torch.utils.device import resolve
from poccala_tpu_torch.utils.logmath import NEG_INF, masked_log


@dataclass
class BwStats:
    """Linear-domain Baum-Welch sufficient statistics."""

    occ: torch.Tensor        # [S]        Σ_t γ_t(s)
    c: torch.Tensor          # [S, M]     Σ_t γ_t(s, m)
    cx: torch.Tensor         # [S, M, D]  Σ_t γ_t(s, m) · x_t
    cxx: torch.Tensor        # [S, M, D]  Σ_t γ_t(s, m) · x_t²
    trans: torch.Tensor      # [U, N, N]  ξ sums per unit transition
    trans_den: torch.Tensor  # [U, N]     Σ_{t<T-1} γ_t per unit state
    loglik: torch.Tensor     # scalar     Σ_utt log P(O|λ)
    n_frames: torch.Tensor   # scalar     Σ_utt T_true
    n_utts: torch.Tensor     # scalar


STATS_FIELDS = tuple(f.name for f in fields(BwStats))


def zero_stats(bank: SenoneBank) -> BwStats:
    s, m, d = bank.means.shape
    u, n, _ = bank.log_A.shape
    dev = bank.means.device

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return BwStats(occ=z(s), c=z(s, m), cx=z(s, m, d), cxx=z(s, m, d),
                   trans=z(u, n, n), trans_den=z(u, n), loglik=z(),
                   n_frames=z(), n_utts=z())


def add_stats(a: BwStats, b: BwStats) -> BwStats:
    return BwStats(**{f: getattr(a, f) + getattr(b, f) for f in STATS_FIELDS})


def stats_to_numpy(stats: BwStats) -> dict:
    """:class:`BwStats` -> ``{field: ndarray}`` (host copies)."""
    return {f: getattr(stats, f).detach().cpu().numpy() for f in STATS_FIELDS}


def stats_from_numpy(arrays: dict, device=None) -> BwStats:
    """``{field: ndarray}`` (e.g. a JAX ``BwStats``'s fields through
    ``np.asarray``) -> :class:`BwStats` on ``device`` (None = the card)."""
    device = resolve(device)
    return BwStats(**{f: torch.as_tensor(np.array(arrays[f], np.float32),
                                         device=device)
                      for f in STATS_FIELDS})


# ----------------------------------------------------------------------
# E step
# ----------------------------------------------------------------------

def local_senones(bank: SenoneBank, ehmm: EmbeddedHMM,
                  state_axis_name=None, s_offset: int = 0):
    """Each sentence state's row in the bank's GMM tensors (clipped) and
    whether this bank holds it: every emitting state unsharded, the
    senones of rows ``[s_offset, s_offset + S_local)`` on a state shard.

    :returns: (rows ``[B, N_s]`` int64, owned ``[B, N_s]`` bool)"""
    s_local = bank.num_states
    if state_axis_name is None:
        return (torch.clamp(ehmm.senone_idx, 0, s_local - 1).long(),
                ehmm.senone_idx >= 0)
    lsen = ehmm.senone_idx.long() - s_offset
    owned = (lsen >= 0) & (lsen < s_local) & (ehmm.senone_idx >= 0)
    return torch.clamp(lsen, 0, s_local - 1), owned


def sentence_scores(bank: SenoneBank, ehmm: EmbeddedHMM, xs: torch.Tensor,
                    normalizer: str = "textbook",
                    score_dtype: str = "float32", state_axis_name=None,
                    s_offset: int = 0, components: bool = True):
    """GMM scores of each utterance's own sentence states only (the
    gather keeps the lattice ``[B, T, N_s, M]`` instead of
    ``[B, T, S, M]``; ``accumulators.py:152-158``, ``alignment.py:62-67``).
    With ``state_axis_name`` (a state shard's bank, see the module
    docstring) the state scores are the max over that group.

    Float32 CUDA tensors take the sentence kernel
    (:func:`~poccala_tpu_torch.ops.cuda.gmm_score_cuda.sentence_scores_cuda`,
    one launch, no gathered bank, no product in device memory), which
    writes the components only when ``components`` asks for them; CPU
    tensors and the bfloat16 scoring take the plain version.

    :returns: (weighted component log-probs ``[B, T, N_s, M]``, None from
        the kernel without ``components``, state scores ``[B, T, N_s]``,
        sentence ``log_b [B, T, N_s]``)
    """
    sen, owned = local_senones(bank, ehmm, state_axis_name, s_offset)
    if state_axis_name is not None:
        from poccala_tpu_torch.parallel.mesh import all_reduce
    if xs.is_cuda and score_dtype == "float32":
        from poccala_tpu_torch.ops.cuda.gmm_score_cuda import (
            sentence_scores_cuda)

        scores, comp = sentence_scores_cuda(
            xs.contiguous(), sen.contiguous(), bank.means, bank.log_var,
            bank.log_w, normalizer=normalizer, components=components)
        if state_axis_name is not None:
            # the senones of other shards, as the plain version masks them
            # before its logsumexp
            if comp is not None:
                comp = torch.where(owned[:, None, :, None], comp, NEG_INF)
            scores = all_reduce(
                torch.where(owned[:, None, :], scores, NEG_INF),
                torch.distributed.ReduceOp.MAX, state_axis_name)
    else:
        comp = gmm_component_logpdf(xs, bank.means[sen], bank.log_var[sen],
                                    normalizer=normalizer,
                                    score_dtype=score_dtype)
        comp = comp + bank.log_w[sen][:, None]             # [B, T, N_s, M]
        if state_axis_name is not None:
            comp = torch.where(owned[:, None, :, None], comp, NEG_INF)
            # exchange the [B, T, N_s] lattice, not the bank
            scores = all_reduce(torch.logsumexp(comp, dim=-1),
                                torch.distributed.ReduceOp.MAX,
                                state_axis_name)
        else:
            scores = torch.logsumexp(comp, dim=-1)         # [B, T, N_s]
    n_s = sen.shape[1]
    r = torch.arange(n_s, device=xs.device)[None, :]
    is_entry = r == 0
    is_exit = r == ehmm.n_states[:, None] - 1
    log_b = torch.where((ehmm.senone_idx >= 0)[:, None, :], scores, NEG_INF)
    log_b = torch.where(is_entry[:, None, :], 0.0, log_b)
    log_b = torch.where((is_exit | ~ehmm.state_mask)[:, None, :], NEG_INF,
                        log_b)
    return comp, scores, log_b


def _posterior(log_p: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``exp(min(log_p, 0))`` where ``keep`` and the value is possible."""
    return torch.where(keep & (log_p > NEG_INF / 2),
                       torch.exp(torch.clamp(log_p, max=0.0)), 0.0)


def _weighted_stats(bank, ehmm, labels, xs, t_masks, weight, state_num,
                    max_label_len, normalizer, count_final_exit,
                    bw_inner_iters, bw_converge_delta, score_dtype, mark,
                    state_axis_name=None, s_offset=0):
    """The batch's statistics with utterance ``b`` weighted by
    ``weight[b]``, and the per-utterance log-likelihoods ``[B]``: the
    scoring, the forward-backward and the statistics, each a span."""
    dev = xs.device
    with profiling.span("train.estep.scoring", dev):
        comp, scores, log_b = sentence_scores(bank, ehmm, xs, normalizer,
                                              score_dtype, state_axis_name,
                                              s_offset)
    mark("scoring")
    with profiling.span("train.estep.forward_backward", dev):
        log_alpha, log_beta, loglik = _forward_backward(
            ehmm, log_b, t_masks, state_num, bw_inner_iters,
            bw_converge_delta)
    mark("forward_backward")
    with profiling.span("train.estep.statistics", dev):
        stats = _statistics(bank, ehmm, labels, xs, t_masks, weight,
                            state_num, max_label_len, count_final_exit,
                            state_axis_name, s_offset, score_dtype, comp,
                            scores, log_b, log_alpha, log_beta, loglik)
    mark("statistics")
    return stats, loglik


def _forward_backward(ehmm, log_b, t_masks, state_num, bw_inner_iters,
                      bw_converge_delta):
    """``(log_alpha, log_beta, loglik)`` of the sentence HMMs."""
    def fb(log_pi):
        la, ll = hmm_ops.forward_log_banded_batch(
            ehmm.band, log_pi, log_b, t_masks, state_num)
        lb = hmm_ops.backward_log_banded_batch(ehmm.band, log_b, t_masks,
                                               state_num)
        return la, lb, ll

    log_pi_used = ehmm.log_pi
    if bw_inner_iters > 1:
        # per-utterance inner loop re-estimating the sentence pi
        # (LHMM.py:526-544), the while_loop of accumulators.py:202-216
        # with its condition evaluated per utterance
        la0, lb0, ll0 = fb(log_pi_used)
        g0 = la0[:, 0] + lb0[:, 0]
        prev_ll = torch.full_like(ll0, -float("inf"))
        cur_ll = ll0
        it = 1
        while True:
            active = (cur_ll - prev_ll > bw_converge_delta)
            if it >= bw_inner_iters or not bool(active.any()):
                break
            norm = torch.logsumexp(
                torch.where(ehmm.state_mask, g0, NEG_INF), dim=-1)
            pi = g0 - norm[:, None]
            pi = torch.where(ehmm.state_mask & (pi > NEG_INF / 2), pi,
                             NEG_INF)
            la, lb, ll = fb(pi)
            a1 = active[:, None]
            log_pi_used = torch.where(a1, pi, log_pi_used)
            prev_ll = torch.where(active, cur_ll, prev_ll)
            cur_ll = torch.where(active, ll, cur_ll)
            g0 = torch.where(a1, la[:, 0] + lb[:, 0], g0)
            it += 1

    return fb(log_pi_used)


def _mixture_moments(comp, scores, gamma, emitting, xs):
    """The GMM moments of each utterance's sentence states, plain: the
    mixture posterior within a state times the state posterior ``gamma``,
    on the emitting states, summed over the frames with ``1``, ``x`` and
    ``x²``.

    :returns: (``c_r [B, N_s, M]``, ``cx_r``, ``cxx_r [B, N_s, M, D]``)"""
    comp_post = torch.exp(torch.clamp(comp - scores[..., None], max=0.0))
    gamma_rm = gamma[..., None] * comp_post                       # [B,T,N_s,M]
    gamma_rm = torch.where(emitting[:, None, :, None], gamma_rm, 0.0)
    c_r = gamma_rm.sum(dim=1)                                     # [B,N_s,M]
    cx_r = torch.einsum("btrm,btd->brmd", gamma_rm, xs)
    cxx_r = torch.einsum("btrm,btd->brmd", gamma_rm, xs * xs)
    return c_r, cx_r, cxx_r


def _statistics(bank, ehmm, labels, xs, t_masks, weight, state_num,
                max_label_len, count_final_exit, state_axis_name, s_offset,
                score_dtype, comp, scores, log_b, log_alpha, log_beta,
                loglik) -> BwStats:
    """The weighted GMM and transition statistics from the lattice's
    posteriors.  Float32 CUDA tensors sum the GMM moments in the
    statistics kernel, the CPU and the bfloat16 scoring in
    :func:`_mixture_moments`."""
    emit = state_num - 2
    s_total = bank.num_states
    u_total, n, _ = bank.log_A.shape
    dev = xs.device
    b = xs.shape[0]
    n_s = ehmm.senone_idx.shape[1]
    r = torch.arange(n_s, device=dev)[None, :]
    w3 = weight[:, None, None]
    emitting = ehmm.senone_idx >= 0                                # [B, N_s]
    ll3 = loglik[:, None, None]

    # --- state posteriors γ_t(r), normalised by P(O)
    gamma = _posterior(log_alpha + log_beta - ll3,
                       t_masks[:, :, None] & ehmm.state_mask[:, None, :])

    # --- GMM statistics: mixture posterior within a state
    if xs.is_cuda and score_dtype == "float32":
        from poccala_tpu_torch.ops.cuda.gmm_score_cuda import (
            sentence_stats_cuda)

        c_r, cx_r, cxx_r = sentence_stats_cuda(comp, scores, gamma, emitting,
                                               xs.contiguous())
    else:
        c_r, cx_r, cxx_r = _mixture_moments(comp, scores, gamma, emitting,
                                            xs)
    occ_r = torch.where(emitting, gamma.sum(dim=1), 0.0)          # [B,N_s]

    # dummy bucket s_total for virtual states and (state-sharded) the
    # senones of other shards: local statistics stay [S_local]
    sen, owned = local_senones(bank, ehmm, state_axis_name, s_offset)
    seg = torch.where(emitting & owned, sen, s_total).reshape(-1)
    m, d = bank.max_mix, bank.dim

    def scatter(rows, width):
        out = torch.zeros((s_total + 1,) + width, dtype=torch.float32,
                          device=dev)
        return out.index_add_(0, seg, rows.reshape((-1,) + width))[:s_total]

    wb = weight[:, None]
    occ = scatter(occ_r * wb, ())
    c = scatter(c_r * w3, (m,))
    cx = scatter(cx_r * w3[..., None], (m, d))
    cxx = scatter(cxx_r * w3[..., None], (m, d))

    # --- transition statistics ξ_t(r, k), normalised by P(O)
    t_next = t_masks[:, 1:, None]                  # transition t -> t+1 exists
    s_next = log_b[:, 1:] + log_beta[:, 1:]        # [B, T-1, N_s]
    ksai_k = []
    for k in range(state_num):
        shifted = torch.nn.functional.pad(s_next[..., k:], (0, k),
                                          value=NEG_INF)
        log_ksai = (log_alpha[:, :-1] + ehmm.band[:, None, :, k] + shifted
                    - ll3)
        ksai_k.append(_posterior(log_ksai, t_next).sum(dim=1))    # [B, N_s]
    ksai_rk = torch.stack(ksai_k, dim=-1)                         # [B,N_s,W]
    gamma_den_r = (gamma[:, :-1] * t_next).sum(dim=1)             # [B, N_s]

    if count_final_exit:
        # final-frame flow into the exit state; padded timesteps carry the
        # last valid alpha, so log_alpha[:, -1] is alpha at T_true - 1
        alpha_last = log_alpha[:, -1]                             # [B, N_s]
        k_off = torch.arange(state_num, device=dev)[None, None, :]
        into_exit = (r[..., None] + k_off) == (ehmm.n_states[:, None, None]
                                               - 1)
        log_ksai_exit = alpha_last[..., None] + ehmm.band - ll3
        ksai_rk = ksai_rk + _posterior(log_ksai_exit, into_exit)
        gamma_den_r = gamma_den_r + _posterior(
            alpha_last - loglik[:, None], torch.ones_like(alpha_last,
                                                          dtype=torch.bool))

    # scatter sentence rows -> per-unit (row, col) slots; emitting rows only
    labels = labels.long()
    pos = torch.clamp(r - 1, min=0)
    local = pos % emit + 1                                        # [1, N_s]
    unit = labels.gather(1, torch.clamp(pos // emit, 0, max_label_len - 1)
                         .expand(b, n_s))                         # [B, N_s]
    k_idx = torch.arange(state_num, device=dev)[None, None, :]
    local_col = local[..., None] + k_idx                          # [1,N_s,W]
    valid_rk = emitting[..., None] & (local_col < n)
    flat_idx = (unit[..., None] * (n * n) + local[..., None] * n
                + torch.clamp(local_col, 0, n - 1))
    flat_idx = torch.where(valid_rk, flat_idx, u_total * n * n)
    trans = torch.zeros((u_total * n * n + 1,), dtype=torch.float32,
                        device=dev).index_add_(
        0, flat_idx.reshape(-1),
        torch.where(valid_rk, ksai_rk * w3, 0.0).reshape(-1))
    trans = trans[:-1].reshape(u_total, n, n)

    den_idx = torch.where(emitting, unit * n + local, u_total * n)
    trans_den = torch.zeros((u_total * n + 1,), dtype=torch.float32,
                            device=dev).index_add_(
        0, den_idx.reshape(-1), (gamma_den_r * wb).reshape(-1))
    trans_den = trans_den[:-1].reshape(u_total, n)

    n_frames = t_masks.sum(dim=1).to(torch.float32)
    return BwStats(occ=occ, c=c, cx=cx, cxx=cxx, trans=trans,
                   trans_den=trans_den, loglik=(loglik * weight).sum(),
                   n_frames=(n_frames * weight).sum(), n_utts=weight.sum())


def _no_mark(_: str) -> None:
    pass


def batch_stats(
    bank: SenoneBank,
    labels, label_lens, xs, t_masks,
    state_num: int,
    max_label_len: int,
    normalizer: str = "textbook",
    count_final_exit: bool = True,
    bw_inner_iters: int = 1,
    state_axis_name=None,
    s_offset: int = 0,
    score_dtype: str = "float32",
    mark: Callable[[str], None] | None = None,
):
    """A batch's Baum-Welch statistics (the ``Pool``-of-utterances map
    phase, ``AcousticModel.py:861-870``, folded), and the per-utterance
    log-likelihoods ``[B]``.

    :param labels: ``[B, L_max]`` unit ids; :param label_lens: ``[B]``
        (0 marks a batch-padding utterance, which contributes nothing)
    :param xs: ``[B, T, D]`` features; :param t_masks: ``[B, T]`` bool
    :param mark: called with ``"scoring"``, ``"forward_backward"`` and
        ``"statistics"`` as each stage is enqueued (for timing)
    See ``poccala_tpu/train/accumulators.py:utterance_stats`` for
    ``count_final_exit`` and ``bw_inner_iters`` (whose convergence delta
    is the reference's 0.64 here, as in the JAX ``batch_stats``).
    :param state_axis_name: the state axis's process group when ``bank``
        is one state shard starting at senone ``s_offset`` (module
        docstring); the GMM statistics are then this shard's rows
    """
    dev = bank.means.device
    labels = torch.as_tensor(labels, device=dev)
    label_lens = torch.as_tensor(label_lens, device=dev)
    xs = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    t_masks = torch.as_tensor(t_masks, device=dev).to(torch.bool)
    ehmm = build_embedded_batch(bank, labels, label_lens, state_num,
                                max_label_len)
    weight = (label_lens > 0).to(torch.float32)
    return _weighted_stats(bank, ehmm, labels, xs, t_masks, weight,
                           state_num, max_label_len, normalizer,
                           count_final_exit, bw_inner_iters, 0.64,
                           score_dtype, mark or _no_mark, state_axis_name,
                           s_offset)


def utterance_stats(bank, label, label_len, x, t_mask, state_num: int,
                    max_label_len: int, normalizer: str = "textbook",
                    count_final_exit: bool = True, bw_inner_iters: int = 1,
                    bw_converge_delta: float = 0.64,
                    state_axis_name=None, s_offset: int = 0,
                    score_dtype: str = "float32"):
    """One utterance's statistics and log P(O|λ) (the batch of one of
    :func:`batch_stats`, not weighted by ``label_len > 0``)."""
    dev = bank.means.device
    labels = torch.as_tensor(label, device=dev)[None]
    lens = torch.as_tensor(label_len, device=dev).reshape(1)
    xs = torch.as_tensor(x, dtype=torch.float32, device=dev)[None]
    masks = torch.as_tensor(t_mask, device=dev).to(torch.bool)[None]
    ehmm = build_embedded_batch(bank, labels, lens, state_num, max_label_len)
    stats, ll = _weighted_stats(
        bank, ehmm, labels, xs, masks, torch.ones(1, device=dev), state_num,
        max_label_len, normalizer, count_final_exit, bw_inner_iters,
        bw_converge_delta, score_dtype, _no_mark, state_axis_name, s_offset)
    return stats, ll[0]


# ----------------------------------------------------------------------
# M step
# ----------------------------------------------------------------------

def apply_update(
    bank: SenoneBank,
    stats: BwStats,
    c_covariance=1e-6,
    min_occ: float = 1e-3,
    update_transmat: bool = True,
    update_gmm: bool = True,
) -> SenoneBank:
    """Re-estimate the bank from folded statistics (``LHMM.update_param``
    + ``GMM.update_param``, ``LHMM.py:509-524``, ``Clustering.py:682-693``);
    returns a new bank.  ``c_covariance`` is the variance floor: a scalar,
    or a per-dim ``[D]`` vector (the relative floor of
    ``Trainer.var_floor``).  Rows and senones without occupancy keep
    their old values; only emitting transition rows update."""
    log_A = bank.log_A
    means, log_var, log_w = bank.means, bank.log_var, bank.log_w
    n = bank.state_num

    if update_transmat:
        den = stats.trans_den[:, :, None]
        row_ok = den > min_occ
        a_new = torch.where(row_ok, stats.trans / torch.clamp(den, min=min_occ),
                            0.0)
        rowsum = a_new.sum(dim=-1, keepdim=True)
        a_new = torch.where(rowsum > 0,
                            a_new / torch.clamp(rowsum, min=1e-30), a_new)
        row_idx = torch.arange(n, device=log_A.device)[None, :, None]
        is_emit_row = (row_idx >= 1) & (row_idx <= n - 2)
        log_A = torch.where(is_emit_row & row_ok, masked_log(a_new), log_A)

    if update_gmm:
        occ_ok = stats.occ > min_occ
        c_ok = stats.c > min_occ
        c_safe = torch.clamp(stats.c, min=min_occ)[..., None]
        mean_new = stats.cx / c_safe
        mu_old = bank.means
        var_new = (stats.cxx - 2.0 * mu_old * stats.cx
                   + mu_old * mu_old * stats.c[..., None]) / c_safe
        floor = torch.as_tensor(c_covariance, dtype=torch.float32,
                                device=var_new.device)
        var_new = torch.maximum(var_new, floor)
        upd = occ_ok[:, None, None] & c_ok[..., None]
        means = torch.where(upd, mean_new, bank.means)
        log_var = torch.where(upd, torch.log(var_new), bank.log_var)
        alpha_new = stats.c / torch.clamp(stats.occ, min=min_occ)[:, None]
        active = bank.log_w > NEG_INF / 2
        log_w = torch.where(occ_ok[:, None] & c_ok & active,
                            masked_log(alpha_new), bank.log_w)

    return SenoneBank(means, log_var, log_w, log_A, bank.log_pi,
                      bank.mix_counts, bank.senone_map)
