"""Plain reference of training: embedded Baum-Welch epochs and Viterbi
forced alignment over sentence HMMs, in float64.

Imports nothing of the program.  It takes the benchmark's inputs (the bank
training starts from, the corpus's features and unit labels) and works
the rest out itself: each utterance's sentence HMM, the Gaussian scores,
forward and backward, the posteriors, the statistics and the update.

The semantics are those the configuration states for its trainer
(``train`` in the configuration's file): a sentence HMM is a virtual entry
state, the emitting states of each label unit in order and a virtual exit
state; its start distribution is uniform over all of them; the flow into
the exit on the last frame counts (``count_final_exit``); the update keeps
rows and Gaussians whose occupancy is at most ``min_occ``, floors the
variances at ``c_covariance`` and takes each new variance about the old
mean.  Transitions must be left to right.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from asrbench.harness.ref_decode import _f64

LEAVES = ("means", "log_var", "log_w", "log_A")


def _sentences(labels, lens, a, smap, state_num: int):
    """Each utterance's sentence HMM: senone ``[B, R]`` (-1 where not
    emitting), self loop and forward step ``[B, R]``, and its state count
    ``[B]``."""
    dev = a.device
    emit = state_num - 2
    labels = torch.as_tensor(labels, device=dev).long()
    lens = torch.as_tensor(lens, device=dev).long()
    n_true = 2 + emit * lens
    r_max = int(n_true.max())
    r = torch.arange(r_max, device=dev)[None]
    pos = torch.clamp(r - 1, min=0)
    unit = labels.gather(1, torch.clamp(pos // emit, 0, labels.shape[1] - 1)
                         .expand(len(lens), r_max))
    local = (pos % emit + 1).expand_as(unit)
    is_emit = (r >= 1) & (r < n_true[:, None] - 1)
    inf = torch.tensor(-math.inf, dtype=torch.float64, device=dev)
    stay = torch.where(is_emit, a[unit, local, local], inf)
    go = torch.where(is_emit, a[unit, local, local + 1], inf)
    go[:, 0] = a[labels[:, 0], 0, 1]
    senone = torch.where(is_emit, smap[unit, local - 1], -1)
    return senone, stay, go, n_true


def _log_b(senone, n_true, x, bank64):
    """``[B, T, R]`` observation log-scores (0 at the entry, -inf at the
    exit and past the HMM) and the weighted component log-densities of the
    emitting states ``[B, T, R, M]``."""
    mu, lv, lw = bank64
    d = mu.shape[-1]
    s = senone.clamp(min=0)
    m_u, lv_u, lw_u = mu[s], lv[s], lw[s]                 # [B, R, M, (D)]
    prec = torch.exp(-lv_u)
    b, r, m, _ = m_u.shape
    x = x.to(torch.float64)
    quad = (torch.bmm(x * x, prec.reshape(b, r * m, d).transpose(1, 2))
            - 2 * torch.bmm(x, (m_u * prec).reshape(b, r * m, d)
                            .transpose(1, 2))).reshape(b, -1, r, m)
    quad = quad + (m_u * m_u * prec).sum(-1)[:, None]
    const = lw_u - 0.5 * lv_u.sum(-1) - 0.5 * d * math.log(2 * math.pi)
    comp = const[:, None] - 0.5 * quad                    # [B, T, R, M]
    score = torch.logsumexp(comp, dim=-1)
    rr = torch.arange(r, device=x.device)[None]
    log_b = torch.where((senone >= 0)[:, None], score, -math.inf)
    log_b[:, :, 0] = 0.0
    log_b = torch.where((rr < n_true[:, None])[:, None], log_b, -math.inf)
    return log_b, comp


def _forward(stay, go, log_pi, log_b, n):
    alpha = log_pi + log_b[:, 0]
    rows = [alpha]
    neg = torch.full_like(alpha[:, :1], -math.inf)
    for t in range(1, log_b.shape[1]):
        moved = torch.cat([neg, (alpha + go)[:, :-1]], dim=1)
        nxt = torch.logaddexp(alpha + stay, moved) + log_b[:, t]
        alpha = torch.where((t < n)[:, None], nxt, alpha)
        rows.append(alpha)
    return torch.stack(rows, 1), torch.logsumexp(alpha, dim=-1)


def _backward(stay, go, log_b, n):
    beta = torch.zeros_like(log_b[:, 0])
    rows = [beta]
    neg = torch.full_like(beta[:, :1], -math.inf)
    for t in range(log_b.shape[1] - 2, -1, -1):
        s = log_b[:, t + 1] + beta
        nxt = torch.logaddexp(stay + s, go + torch.cat([s[:, 1:], neg], 1))
        beta = torch.where((t + 1 < n)[:, None], nxt, torch.zeros_like(nxt))
        rows.append(beta)
    return torch.stack(rows[::-1], 1)


def _corpus(batches):
    """The corpus as one padded batch (features stay where they are)."""
    t = max(b.feats.shape[1] for b in batches)
    lmax = max(b.labels.shape[1] for b in batches)
    feats = torch.cat([torch.nn.functional.pad(
        b.feats, (0, 0, 0, t - b.feats.shape[1])) for b in batches])
    labels = np.concatenate([np.pad(b.labels, ((0, 0), (0, lmax - b.labels.shape[1])))
                             for b in batches])
    lens = np.concatenate([b.label_lens for b in batches])
    n = np.concatenate([b.n_frames for b in batches])
    return feats, labels, lens, n


def loglik(bank: dict, batches, state_num: int, block: int = 256) -> float:
    """The corpus log-likelihood under ``bank`` (the forward pass of
    :func:`em_epoch` alone)."""
    dev = batches[0].feats.device
    feats, labels, lens, n_np = _corpus(batches)
    n = torch.as_tensor(n_np, device=dev)
    a = _f64(bank["log_A"], dev)
    gmm = tuple(_f64(bank[k], dev) for k in ("means", "log_var", "log_w"))
    smap = torch.as_tensor(bank["senone_map"], device=dev).long()
    total = 0.0
    for i in range(0, len(lens), block):
        sl = slice(i, i + block)
        senone, stay, go, n_true = _sentences(labels[sl], lens[sl], a, smap,
                                              state_num)
        nb = n[sl]
        log_b, _ = _log_b(senone, n_true, feats[sl, :int(nb.max())], gmm)
        rr = torch.arange(senone.shape[1], device=dev)[None]
        log_pi = torch.where(rr < n_true[:, None],
                             -torch.log(n_true.to(torch.float64))[:, None],
                             -math.inf)
        total += float(_forward(stay, go, log_pi, log_b, nb)[1].sum())
    return total


def em_epoch(bank: dict, batches, train: dict, state_num: int,
             block: int = 256):
    """One embedded Baum-Welch epoch over the corpus: the new bank (float64
    leaves, the rest as given) and the corpus log-likelihood."""
    if train["bw_inner_iters"] != 1:
        raise ValueError("the reference re-estimates no sentence start "
                         "distribution (bw_inner_iters must be 1)")
    dev = batches[0].feats.device
    feats, labels, lens, n_np = _corpus(batches)
    n = torch.as_tensor(n_np, device=dev)
    a = _f64(bank["log_A"], dev)
    mu, lv, lw = (_f64(bank[k], dev) for k in ("means", "log_var", "log_w"))
    smap = torch.as_tensor(bank["senone_map"], device=dev).long()
    s_n, m_n, d = mu.shape
    u_n = a.shape[0]
    emit = state_num - 2
    occ = torch.zeros(s_n, dtype=torch.float64, device=dev)
    c = torch.zeros(s_n, m_n, dtype=torch.float64, device=dev)
    cx = torch.zeros(s_n, m_n, d, dtype=torch.float64, device=dev)
    cxx = torch.zeros_like(cx)
    trans = torch.zeros(u_n, state_num, state_num, dtype=torch.float64,
                        device=dev)
    den = torch.zeros(u_n, state_num, dtype=torch.float64, device=dev)
    total_ll = 0.0
    for i in range(0, len(lens), block):
        sl = slice(i, i + block)
        senone, stay, go, n_true = _sentences(labels[sl], lens[sl], a, smap,
                                              state_num)
        nb = n[sl]
        x = feats[sl, :int(nb.max())]
        log_b, comp = _log_b(senone, n_true, x, (mu, lv, lw))
        rr = torch.arange(senone.shape[1], device=dev)[None]
        log_pi = torch.where(rr < n_true[:, None],
                             -torch.log(n_true.to(torch.float64))[:, None],
                             -math.inf)
        alpha, ll = _forward(stay, go, log_pi, log_b, nb)
        beta = _backward(stay, go, log_b, nb)
        total_ll += float(ll.sum())
        tt = torch.arange(x.shape[1], device=dev)[None]
        valid = (tt < nb[:, None])[..., None] & (rr < n_true[:, None])[:, None]
        gamma = torch.where(valid, torch.exp(torch.clamp(
            alpha + beta - ll[:, None, None], max=0.0)), 0.0)
        emitting = senone >= 0
        post = torch.exp(comp - torch.logsumexp(comp, -1, keepdim=True))
        g_rm = gamma[..., None] * post * emitting[:, None, :, None]
        seg = torch.where(emitting, senone, s_n).reshape(-1)

        def scat(rows, shape):
            out = torch.zeros((s_n + 1,) + shape, dtype=torch.float64,
                              device=dev)
            return out.index_add_(0, seg, rows.reshape((-1,) + shape))[:s_n]

        occ += scat(torch.where(emitting, gamma.sum(1), 0.0), ())
        c += scat(g_rm.sum(1), (m_n,))
        cx += scat(torch.einsum("btrm,btd->brmd", g_rm, x.to(torch.float64)),
                   (m_n, d))
        cxx += scat(torch.einsum("btrm,btd->brmd", g_rm,
                                 x.to(torch.float64) ** 2), (m_n, d))
        # transitions: t -> t + 1 where t + 1 is a valid frame
        nxt = (tt[:, 1:] < nb[:, None])[..., None]
        s_next = log_b[:, 1:] + beta[:, 1:]
        ll3 = ll[:, None, None]
        xi_stay = torch.where(nxt, torch.exp(torch.clamp(
            alpha[:, :-1] + stay[:, None] + s_next - ll3, max=0.0)), 0.0).sum(1)
        s_up = torch.cat([s_next[..., 1:], torch.full_like(s_next[..., :1],
                                                           -math.inf)], -1)
        xi_go = torch.where(nxt, torch.exp(torch.clamp(
            alpha[:, :-1] + go[:, None] + s_up - ll3, max=0.0)), 0.0).sum(1)
        g_den = (gamma[:, :-1] * nxt).sum(1)
        if train["count_final_exit"]:
            last = alpha.gather(1, (nb - 1).clamp(min=0)[:, None, None]
                                .expand(-1, 1, alpha.shape[2]))[:, 0]
            into_exit = rr == n_true[:, None] - 2
            xi_go = xi_go + torch.where(into_exit, torch.exp(torch.clamp(
                last + go - ll[:, None], max=0.0)), 0.0)
            g_den = g_den + torch.where(rr < n_true[:, None], torch.exp(
                torch.clamp(last - ll[:, None], max=0.0)), 0.0)
        pos = torch.clamp(rr - 1, min=0)
        lab = torch.as_tensor(labels[sl], device=dev).long()
        unit = lab.gather(1, torch.clamp(pos // emit, 0, lab.shape[1] - 1)
                          .expand_as(senone))
        local = (pos % emit + 1).expand_as(senone)
        e = emitting
        flat = (unit * state_num + local)[e]
        den.view(-1).index_add_(0, flat, g_den[e])
        tv = trans.view(-1)
        base = (unit * state_num * state_num + local * state_num + local)[e]
        tv.index_add_(0, base, xi_stay[e])
        tv.index_add_(0, base + 1, xi_go[e])
        del log_b, comp, alpha, beta, gamma, post, g_rm
    return _update(bank, dict(occ=occ, c=c, cx=cx, cxx=cxx, trans=trans,
                              den=den), train, state_num), total_ll


def _update(bank, st, train, state_num):
    """The M-step on the epoch's statistics."""
    dev = st["occ"].device
    min_occ = train["min_occ"]
    a = _f64(bank["log_A"], dev)
    mu, lv, lw = (_f64(bank[k], dev) for k in ("means", "log_var", "log_w"))
    den = st["den"][:, :, None]
    row_ok = den > min_occ
    a_new = torch.where(row_ok, st["trans"] / den.clamp(min=min_occ), 0.0)
    rs = a_new.sum(-1, keepdim=True)
    a_new = torch.where(rs > 0, a_new / rs.clamp(min=1e-300), a_new)
    row = torch.arange(state_num, device=dev)[None, :, None]
    emit_row = (row >= 1) & (row <= state_num - 2)
    a = torch.where(emit_row & row_ok, torch.log(a_new), a)
    occ, c = st["occ"], st["c"]
    occ_ok, c_ok = occ > min_occ, c > min_occ
    c_safe = c.clamp(min=min_occ)[..., None]
    mean_new = st["cx"] / c_safe
    var_new = (st["cxx"] - 2 * mu * st["cx"] + mu * mu * c[..., None]) / c_safe
    var_new = torch.clamp(var_new, min=train["c_covariance"])
    upd = (occ_ok[:, None] & c_ok)[..., None]
    w_new = torch.log(c / occ.clamp(min=min_occ)[:, None])
    return dict(bank,
                means=torch.where(upd, mean_new, mu),
                log_var=torch.where(upd, torch.log(var_new), lv),
                log_w=torch.where(occ_ok[:, None] & c_ok & (lw > -math.inf),
                                  w_new, lw),
                log_A=a)


def align(bank: dict, batches, state_num: int, block: int = 256):
    """Viterbi forced alignment of the corpus: each utterance's best score
    ``[B]`` and its label position a frame ``[B, T]`` (-1 off the emitting
    states and past the end), numpy."""
    dev = batches[0].feats.device
    feats, labels, lens, n_np = _corpus(batches)
    n = torch.as_tensor(n_np, device=dev)
    a = _f64(bank["log_A"], dev)
    mu, lv, lw = (_f64(bank[k], dev) for k in ("means", "log_var", "log_w"))
    smap = torch.as_tensor(bank["senone_map"], device=dev).long()
    emit = state_num - 2
    scores, paths = [], []
    for i in range(0, len(lens), block):
        sl = slice(i, i + block)
        senone, stay, go, n_true = _sentences(labels[sl], lens[sl], a, smap,
                                              state_num)
        nb = n[sl]
        t_max = int(nb.max())
        log_b, _ = _log_b(senone, n_true, feats[sl, :t_max], (mu, lv, lw))
        rr = torch.arange(senone.shape[1], device=dev)[None]
        delta = torch.where(rr < n_true[:, None],
                            -torch.log(n_true.to(torch.float64))[:, None],
                            -math.inf) + log_b[:, 0]
        neg = torch.full_like(delta[:, :1], -math.inf)
        bps = []
        for t in range(1, t_max):
            moved = torch.cat([neg, (delta + go)[:, :-1]], dim=1)
            kept = delta + stay
            bp = moved > kept
            nxt = torch.maximum(kept, moved) + log_b[:, t]
            act = (t < nb)[:, None]
            delta = torch.where(act, nxt, delta)
            bps.append(bp & act)
        state = torch.argmax(delta, dim=1)
        best = delta.gather(1, state[:, None])[:, 0]
        path = [state]
        for bp in reversed(bps):
            state = state - bp.gather(1, state[:, None])[:, 0].long()
            path.append(state)
        path = torch.stack(path[::-1], 1)
        tt = torch.arange(t_max, device=dev)[None]
        ok = (path >= 1) & (path < n_true[:, None] - 1) & (tt < nb[:, None])
        lp = torch.where(ok, torch.div(path - 1, emit, rounding_mode="floor"),
                         -1)
        scores.append(best.cpu().numpy())
        full = np.full((len(nb), feats.shape[1]), -1, np.int64)
        full[:, :t_max] = lp.cpu().numpy()
        paths.append(full)
    return np.concatenate(scores), np.concatenate(paths)
