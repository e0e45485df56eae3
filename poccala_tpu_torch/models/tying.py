"""Data-driven state tying (port of ``poccala_tpu/models/tying.py``).

The bank supports tying structurally via ``senone_map`` (every statistics
scatter and parameter gather keys on it); this module builds the map.

:func:`tie_by_kmeans` is bottom-up data-driven tying: cluster the current
senone GMMs — mixture-weighted means plus log-variances — into the target
senone count with k-means (:mod:`poccala_tpu_torch.ops.kmeans`, on the
bank's device), merge each cluster's members into one shared senone
(occupancy-weighted when occupancies are given), and emit the reduced
bank + map.

:func:`tie_by_tree` is top-down decision-tree tying with phonetic
questions (host NumPy, copied); the questions default to
:func:`poccala_tpu_torch.models.questions.default_questions` on the unit
names, and ``questions=`` overrides them with objects that have a ``name``
and a ``members`` set of unit indices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poccala_tpu_torch.models import questions as q_mod
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.models.senone_bank import SenoneBank
from poccala_tpu_torch.ops import kmeans as km_ops
from poccala_tpu_torch.utils.logmath import masked_log


def senone_embedding(bank: SenoneBank) -> np.ndarray:
    """Per-senone embedding: weight-averaged mixture mean ++ mean
    log-variance — a compact acoustic signature for similarity tying."""
    arrays = sb.bank_to_numpy(bank)
    w = np.exp(arrays["log_w"])                   # [S, M]
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-10)
    avg_mean = np.einsum("sm,smd->sd", w, arrays["means"])
    avg_lv = np.einsum("sm,smd->sd", w, arrays["log_var"])
    return np.concatenate([avg_mean, avg_lv], axis=-1).astype(np.float32)


def tie_by_kmeans(
    bank: SenoneBank,
    target_senones: int,
    occupancy: np.ndarray | None = None,
    generator: torch.Generator | None = None,
    same_position_only: bool = True,
) -> SenoneBank:
    """Tie the bank down to ``target_senones`` shared states.

    :param occupancy: optional ``[S]`` state occupancies (e.g.
        ``BwStats.occ``) used as merge weights; uniform otherwise.
    :param generator: CPU ``torch.Generator`` for the k-means seeding (a
        fixed seed of 0 when None).
    :param same_position_only: only tie states at the same emitting
        position (first states with first states, etc.); the
        per-position budget splits evenly.
    :returns: a new bank with ``S = target_senones`` (at most) and an
        updated ``senone_map``.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    emit = bank.emit_states
    s_old = bank.num_states
    dev = bank.means.device
    emb = senone_embedding(bank)
    occ = (np.ones(s_old) if occupancy is None
           else np.maximum(np.asarray(occupancy, np.float64), 1e-6))
    old_map = bank.senone_map.cpu().numpy()

    # group old senones by emitting position (or one global group)
    if same_position_only:
        groups = [np.unique(old_map[:, e]) for e in range(emit)]
        budgets = [max(1, target_senones // emit)] * emit
    else:
        groups = [np.unique(old_map)]
        budgets = [target_senones]

    assign_of = np.zeros(s_old, np.int64)
    next_id = 0
    for members, k in zip(groups, budgets):
        k = min(k, len(members))
        res = km_ops.kmeans(
            generator, torch.as_tensor(emb[members], device=dev),
            torch.ones(len(members), dtype=torch.bool, device=dev),
            k=k, iters=25)
        assign_of[members] = next_id + res["assign"].cpu().numpy()
        next_id += k

    return _merge_assignments(bank, assign_of, next_id, occ)


def _merge_assignments(
    bank: SenoneBank, assign_of: np.ndarray, s_new: int, occ: np.ndarray
) -> SenoneBank:
    """Collapse old senones into ``s_new`` shared ones per
    ``assign_of[s_old] -> new id``, occupancy-weighted (same slot-wise
    mixture structure; a post-tie EM round re-fits properly)."""
    # compact away empty classes (k-means may leave clusters unused)
    used = np.unique(assign_of)
    assign_of = np.searchsorted(used, assign_of)
    s_new = len(used)
    arrays = sb.bank_to_numpy(bank)
    old_map = arrays["senone_map"]
    u_total, emit = old_map.shape
    m, d = bank.max_mix, bank.dim
    means = np.zeros((s_new, m, d), np.float32)
    log_var = np.zeros((s_new, m, d), np.float32)
    w = np.zeros((s_new, m), np.float32)
    mix_counts = np.zeros((s_new,), np.int32)
    old_means = arrays["means"]
    old_lv = arrays["log_var"]
    old_w = np.exp(arrays["log_w"])
    for s in range(s_new):
        members = np.where(assign_of == s)[0]
        wts = occ[members] / occ[members].sum()
        means[s] = np.einsum("u,umd->md", wts, old_means[members])
        log_var[s] = np.einsum("u,umd->md", wts, old_lv[members])
        w[s] = np.einsum("u,um->m", wts, old_w[members])
        mix_counts[s] = int(arrays["mix_counts"][members].max())
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-10)

    new_map = assign_of[old_map.reshape(-1)].reshape(u_total, emit)
    dev = bank.means.device
    return sb.replace(
        bank,
        means=torch.as_tensor(means, device=dev),
        log_var=torch.as_tensor(log_var, device=dev),
        log_w=masked_log(torch.as_tensor(w, device=dev)),
        mix_counts=torch.as_tensor(mix_counts, device=dev),
        senone_map=torch.as_tensor(new_map.astype(np.int32), device=dev),
    )


# ----------------------------------------------------------------------
# Decision-tree tying with phonetic questions (host code, copied)
# ----------------------------------------------------------------------

def _single_gaussian_moments(bank: SenoneBank):
    """Moment-matched single Gaussian per senone: the sufficient node
    statistic for tree likelihoods.  ``mu = sum_m w_m mu_m``,
    ``ex2 = sum_m w_m (var_m + mu_m^2)`` (second raw moment)."""
    arrays = sb.bank_to_numpy(bank)
    w = np.exp(arrays["log_w"].astype(np.float64))        # [S, M]
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-12)
    means = arrays["means"].astype(np.float64)            # [S, M, D]
    var = np.exp(arrays["log_var"].astype(np.float64))
    mu = np.einsum("sm,smd->sd", w, means)
    ex2 = np.einsum("sm,smd->sd", w, var + means**2)
    return mu, ex2


def _node_loglik(occ_s, mu_s, ex2_s, members, var_floor=1e-4):
    """Log-likelihood of the pooled members under one diagonal
    Gaussian (the standard tree-clustering objective:
    ``L = -OCC/2 * sum_d (log(2*pi*VAR_d) + 1)``)."""
    o = occ_s[members]
    total = o.sum()
    if total <= 0:
        return 0.0, 0.0
    mu = (o[:, None] * mu_s[members]).sum(0) / total
    ex2 = (o[:, None] * ex2_s[members]).sum(0) / total
    var = np.maximum(ex2 - mu**2, var_floor)
    ll = -0.5 * total * float(np.sum(np.log(2 * np.pi * var) + 1.0))
    return ll, float(total)


@dataclasses.dataclass
class TreeSplit:
    """One internal node of a tying tree (for inspection/routing)."""

    question: str
    gain: float
    yes_units: list[str]
    no_units: list[str]


def tie_by_tree(
    bank: SenoneBank,
    units,
    target_senones: int,
    occupancy: np.ndarray | None = None,
    questions=None,
    min_occ: float = 1e-3,
    min_gain: float = 0.0,
    return_trees: bool = False,
):
    """Tie the bank down to at most ``target_senones`` shared states by
    growing one phonetic-question decision tree per emitting position
    (``poccala_tpu/models/tying.py:186-290``: greedy pooled
    single-Gaussian log-likelihood gain, per-position budget
    ``target_senones // emit``, stop below ``min_gain`` or ``min_occ``).

    :param units: the unit-name list (or a ``UnitInventory``) aligned with
        the bank's unit axis.
    :param questions: override the question list (defaults to
        :func:`poccala_tpu_torch.models.questions.default_questions`).
    :returns: the tied bank, plus ``{position: [TreeSplit, ...]}`` when
        ``return_trees``.
    """
    names = list(getattr(units, "units", units))
    if len(names) != bank.num_units:
        raise ValueError(
            f"{len(names)} unit names for a {bank.num_units}-unit bank")
    emit = bank.emit_states
    s_old = bank.num_states
    old_map = bank.senone_map.cpu().numpy()
    occ = (np.ones(s_old) if occupancy is None
           else np.maximum(np.asarray(occupancy, np.float64), 1e-6))
    mu_s, ex2_s = _single_gaussian_moments(bank)
    if questions is None:
        questions = q_mod.default_questions(names)

    # per-senone owning-unit sets (atoms may be pre-tied groups)
    units_of = [set() for _ in range(s_old)]
    for u in range(bank.num_units):
        for e in range(emit):
            units_of[old_map[u, e]].add(u)

    budget = max(1, target_senones // emit)
    assign_of = np.full(s_old, -1, np.int64)
    next_id = 0
    trees: dict[int, list[TreeSplit]] = {}

    for e in range(emit):
        atoms = np.unique(old_map[:, e])
        leaves: list[np.ndarray] = [atoms]
        splits: list[TreeSplit] = []
        while len(leaves) < min(budget, len(atoms)):
            best = None  # (gain, leaf_idx, yes, no, q)
            for li, members in enumerate(leaves):
                if len(members) < 2:
                    continue
                l_parent, _ = _node_loglik(occ, mu_s, ex2_s, members)
                for q in questions:
                    ans = [units_of[s] <= q.members
                           if units_of[s] & q.members == units_of[s]
                           else (False if not (units_of[s] & q.members)
                                 else None)
                           for s in members]
                    if any(a is None for a in ans):
                        continue  # mixed atom: inapplicable here
                    yes = members[[a is True for a in ans]]
                    no = members[[a is False for a in ans]]
                    if len(yes) == 0 or len(no) == 0:
                        continue
                    l_yes, o_yes = _node_loglik(occ, mu_s, ex2_s, yes)
                    l_no, o_no = _node_loglik(occ, mu_s, ex2_s, no)
                    if o_yes < min_occ or o_no < min_occ:
                        continue
                    gain = l_yes + l_no - l_parent
                    if gain > min_gain and (best is None or gain > best[0]):
                        best = (gain, li, yes, no, q)
            if best is None:
                break
            gain, li, yes, no, q = best
            leaves[li] = yes
            leaves.append(no)
            uy = sorted({u for s in yes for u in units_of[s]})
            un = sorted({u for s in no for u in units_of[s]})
            splits.append(TreeSplit(
                question=q.name, gain=float(gain),
                yes_units=[names[u] for u in uy],
                no_units=[names[u] for u in un],
            ))
        for members in leaves:
            assign_of[members] = next_id
            next_id += 1
        trees[e] = splits

    tied = _merge_assignments(bank, assign_of, next_id, occ)
    return (tied, trees) if return_trees else tied
