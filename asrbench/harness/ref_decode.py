"""Plain reference of the decode: Viterbi over the lexicon tree, in float64.

Imports nothing of the program.  It takes the benchmark's inputs (the
generating bank's arrays, the lexicon tree the benchmark built, the
features) and works everything else out itself: the Gaussian scores, each
node's HMM and the search.

The search semantics are those of a frame-synchronous tree decoder with no
language model.  Each tree node is one syllable of two units, ``2·emit``
emitting states in a row; a token enters a node through its virtual entry
state, which holds at frame t the score of the parent's exit at frame t
(or, at a first-level node, the best word end of frame t minus the word
penalty; 0 before the first frame) and feeds the node's first emitting
state at frame t + 1.  A hypothesis ends at a word end on the last frame.

:func:`best_scores` gives each utterance's best path score;
:func:`chain_scores` the best score of the paths that spell a given word
sequence, which judges a decoder's answer by what the words are worth,
whatever ties in the search picked among paths of one syllable string.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DEAD = -1e29     # at or below: an impossible log-score in the inputs


def _f64(a, device) -> torch.Tensor:
    t = torch.as_tensor(a, device=device).to(torch.float64)
    return torch.where(t <= DEAD, -math.inf, t)


def gmm_scores(x: torch.Tensor, bank: dict, chunk: int = 256) -> torch.Tensor:
    """``log Σ_m w_m N(x_t; μ_sm, σ²_sm)`` for frames ``x [F, D]`` and every
    senone, float64 ``[F, S]``, straight from the definition."""
    dev = x.device
    mu = _f64(bank["means"], dev)                     # [S, M, D]
    lv = _f64(bank["log_var"], dev)
    lw = _f64(bank["log_w"], dev)                     # [S, M]
    d = mu.shape[-1]
    const = lw - 0.5 * lv.sum(-1) - 0.5 * d * math.log(2 * math.pi)
    prec = torch.exp(-lv)
    out = []
    for i in range(0, x.shape[0], chunk):
        xi = x[i:i + chunk].to(torch.float64)[:, None, None, :]
        quad = ((xi - mu[None]) ** 2 * prec[None]).sum(-1)   # [c, S, M]
        out.append(torch.logsumexp(const[None] - 0.5 * quad, dim=-1))
    return torch.cat(out)


def frame_scores(feats: torch.Tensor, bank: dict) -> torch.Tensor:
    """:func:`gmm_scores` of padded features ``[B, T, D]``: ``[B, T, S]``."""
    b, t_pad, _ = feats.shape
    return gmm_scores(feats.reshape(b * t_pad, -1), bank).reshape(b, t_pad, -1)


def node_tables(units: torch.Tensor, bank: dict, state_num: int):
    """Each node's HMM from its two units ``[..., 2]``: the senone, self
    loop and forward step (the last one into the exit) of its ``2·emit``
    emitting states, and the step from the entry state into the first.
    The units' transitions must be left to right (no skips)."""
    dev = units.device
    a = _f64(bank["log_A"], dev)                       # [U, n, n]
    n = state_num
    emit = n - 2
    skip = torch.triu(torch.ones(n, n, dtype=torch.bool, device=dev), 2)
    back = torch.tril(torch.ones(n, n, dtype=torch.bool, device=dev), -1)
    if bool(torch.isfinite(a[:, skip | back]).any()):
        raise ValueError("reference decode takes left-to-right units only")
    smap = torch.as_tensor(bank["senone_map"], device=dev).long()
    u = units.long().clamp(min=0)
    dead = (units < 0).any(-1)
    per = torch.arange(emit, device=dev)
    which = torch.cat([u[..., :1].expand(*u.shape[:-1], emit),
                       u[..., 1:].expand(*u.shape[:-1], emit)], -1)
    local = torch.cat([per, per]) + 1                  # 1..emit, twice
    senone = smap[which, local - 1]
    stay = a[which, local, local]
    go = a[which, local, local + 1]
    enter = a[u[..., 0], 0, 1]
    inf = torch.tensor(-math.inf, dtype=torch.float64, device=dev)
    stay = torch.where(dead[..., None], inf, stay)
    go = torch.where(dead[..., None], inf, go)
    enter = torch.where(dead, inf, enter)
    return senone, stay, go, enter


def _step(d, entry, stay, go, enter, sc):
    """One frame of every node's HMM: the new emitting scores and exits."""
    moved = torch.cat([entry[..., None] + enter[..., None],
                       d[..., :-1] + go[..., :-1]], dim=-1)
    new = torch.maximum(d + stay, moved) + sc
    return new, new[..., -1] + go[..., -1]


def best_scores(node_units, parent, word_node, bank: dict, feats,
                n_frames, state_num: int, penalty: float = 0.0, scores=None):
    """Best path score of each utterance over the tree (``node_units
    [N, 2]``, root row -1; ``parent [N]``, 0 for first-level nodes, -1 at
    the root; ``word_node [V]``), float64 ``[B]``; ``scores``: the
    features' :func:`frame_scores`, where already worked out."""
    dev = feats.device
    units = torch.as_tensor(np.asarray(node_units), device=dev)
    par = torch.as_tensor(np.asarray(parent), device=dev).long()
    wn = torch.as_tensor(np.unique(np.asarray(word_node)), device=dev).long()
    senone, stay, go, enter = node_tables(units, bank, state_num)
    first = par == 0
    has_par = par > 0
    b, t_pad, _ = feats.shape
    n = torch.as_tensor(np.asarray(n_frames), device=dev)
    if scores is None:
        scores = frame_scores(feats, bank)
    inf = -math.inf
    d = torch.full((b,) + senone.shape, inf, dtype=torch.float64, device=dev)
    entry = torch.where(first, 0.0, inf).to(torch.float64).expand(b, -1)
    final = torch.full((b,), inf, dtype=torch.float64, device=dev)
    for t in range(int(n.max())):
        new, ex = _step(d, entry, stay, go, enter, scores[:, t][:, senone])
        word = ex[:, wn].amax(dim=1) - penalty
        flow = torch.where(has_par, ex[:, par.clamp(min=0)], inf)
        new_entry = torch.where(first, word[:, None], flow)
        act = (t < n)[:, None]
        d = torch.where(act[..., None], new, d)
        entry = torch.where(act, new_entry, entry)
        final = torch.where(n - 1 == t, word, final)
    return final


def chain_scores(word_units: list, hyps: list, bank: dict, feats, n_frames,
                 state_num: int, penalty: float = 0.0, scores=None):
    """Best score of the paths that spell each utterance's word sequence
    ``hyps[b]`` (word ids into ``word_units``, each word's bank units two a
    syllable), float64 ``[B]``; ``-inf`` where the sequence is empty;
    ``scores`` as in :func:`best_scores`."""
    dev = feats.device
    b, t_pad, _ = feats.shape
    sylls, ends = [], []
    for ws in hyps:
        s, e = [], []
        for v in ws:
            u = np.asarray(word_units[v]).reshape(-1, 2)
            s.extend(u.tolist())
            e.extend([False] * (len(u) - 1) + [True])
        sylls.append(s)
        ends.append(e)
    k = max(1, max(len(s) for s in sylls))
    units = np.full((b, k, 2), -1, np.int64)
    end = np.zeros((b, k), bool)
    for i, (s, e) in enumerate(zip(sylls, ends)):
        if s:
            units[i, :len(s)] = s
            end[i, :len(e)] = e
    last = torch.as_tensor([max(len(s), 1) - 1 for s in sylls], device=dev)
    empty = torch.as_tensor([not s for s in sylls], device=dev)
    senone, stay, go, enter = node_tables(
        torch.as_tensor(units, device=dev), bank, state_num)
    cost = torch.where(torch.as_tensor(end, device=dev), -float(penalty), 0.0)
    n = torch.as_tensor(np.asarray(n_frames), device=dev)
    if scores is None:
        scores = frame_scores(feats, bank)
    inf = -math.inf
    d = torch.full(senone.shape, inf, dtype=torch.float64, device=dev)
    entry = torch.full((b, k), inf, dtype=torch.float64, device=dev)
    entry[:, 0] = 0.0
    rows = torch.arange(b, device=dev)
    final = torch.full((b,), inf, dtype=torch.float64, device=dev)
    for t in range(int(n.max())):
        sc = scores[rows[:, None, None], t, senone]
        new, ex = _step(d, entry, stay, go, enter, sc)
        new_entry = torch.cat([torch.full((b, 1), inf, dtype=torch.float64,
                                          device=dev),
                               (ex + cost)[:, :-1]], dim=1)
        act = (t < n)[:, None]
        d = torch.where(act[..., None], new, d)
        entry = torch.where(act, new_entry, entry)
        done = ex[rows, last] - penalty
        final = torch.where(n - 1 == t, done, final)
    return torch.where(empty, inf, final)
