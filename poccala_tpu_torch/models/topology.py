"""Embedded sentence-HMM construction as index tables (port of
``poccala_tpu/models/topology.py``).

Sentence state ``r`` maps to (unit index in the label, local state), and
its outgoing band row is read straight from the bank's ``log_A``; the
sentence HMM is never a dense matrix.  Layout (``AcousticModel.py:966-1006``):

* ``n_states = 2 + L * (state_num - 2)``: one entry virtual state, the
  emitting states of each label unit in order, one exit virtual state;
* unit i's local exit column lands on unit i+1's first emitting state;
* observation rows: entry scores 0, exit scores NEG_INF;
* sentence pi is uniform over all true sentence states.

Where the JAX package ``vmap``s a one-label builder, :func:`build_embedded_batch`
works on a label batch ``[B, L_max]`` directly; :func:`build_embedded` is
its batch of one.  Everything is padded to ``max_label_len`` and masked.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from poccala_tpu_torch.models.senone_bank import SenoneBank
from poccala_tpu_torch.utils.logmath import NEG_INF


@dataclass
class EmbeddedHMM:
    """A batch of sentence-level HMMs in banded form."""

    band: torch.Tensor        # [B, N_s, W] outgoing log-transitions (W = state_num)
    log_pi: torch.Tensor      # [B, N_s]
    senone_idx: torch.Tensor  # [B, N_s] int32; -1 for virtual/padded states
    state_mask: torch.Tensor  # [B, N_s] bool
    n_states: torch.Tensor    # [B] int32 true sentence-state count

    @property
    def width(self) -> int:
        return self.band.shape[-1]


def max_states(max_label_len: int, state_num: int) -> int:
    return 2 + max_label_len * (state_num - 2)


def build_embedded_batch(bank: SenoneBank, labels: torch.Tensor,
                         label_lens: torch.Tensor, state_num: int,
                         max_label_len: int) -> EmbeddedHMM:
    """Sentence HMMs for padded labels ``[B, max_label_len]`` int with
    ``label_lens [B]`` valid units each (padding arbitrary)."""
    dev = bank.log_A.device
    labels = torch.as_tensor(labels, device=dev).long()
    label_lens = torch.as_tensor(label_lens, device=dev).long()
    emit = state_num - 2
    n_s = max_states(max_label_len, state_num)
    n_true = (2 + label_lens * emit)[:, None]           # [B, 1]
    u_max = bank.num_units - 1

    r = torch.arange(n_s, device=dev)[None, :]           # [1, N_s]
    is_entry = r == 0
    is_exit = r == n_true - 1
    pos = torch.clamp(r - 1, min=0)
    label_pos = pos // emit
    local = pos % emit + 1                               # [1, N_s]
    unit = labels.gather(1, torch.clamp(label_pos, 0, max_label_len - 1)
                         .expand(labels.shape[0], n_s))  # [B, N_s]
    unit_c = torch.clamp(unit, 0, u_max)
    is_emit = (r >= 1) & (r < n_true - 1)
    state_mask = r < n_true

    senone = bank.senone_map[unit_c, (local - 1).expand_as(unit_c)]
    senone_idx = torch.where(is_emit, senone, -1).to(torch.int32)

    # band[r, k] = sentence log A[r, r+k]; emitting row (unit u, local l)
    # reads log_A[u, l, l+k] while l+k < N
    k = torch.arange(state_num, device=dev)[None, None, :]
    local_col = local[..., None] + k                     # [1, N_s, W]
    emit_band = torch.where(
        (local_col < state_num) & is_emit[..., None],
        bank.log_A[unit_c[..., None], local[..., None],
                   torch.clamp(local_col, 0, state_num - 1)],
        NEG_INF)
    # entry row: the first unit's virtual-entry row (AcousticModel.py:981)
    entry_band = bank.log_A[labels[:, 0], 0, :]          # [B, W]
    band = torch.where(is_entry[..., None], entry_band[:, None, :], emit_band)
    # exit row absorbing, padded rows dead, no transition past the exit
    band = torch.where((is_exit | ~state_mask)[..., None], NEG_INF, band)
    col = r[..., None] + k
    band = torch.where(col >= n_true[..., None], NEG_INF, band)

    log_pi = torch.where(
        state_mask, -torch.log(n_true.to(torch.float32)), NEG_INF)
    return EmbeddedHMM(band=band, log_pi=log_pi, senone_idx=senone_idx,
                       state_mask=state_mask,
                       n_states=n_true[:, 0].to(torch.int32))


def build_embedded(bank: SenoneBank, label, label_len, state_num: int,
                   max_label_len: int) -> EmbeddedHMM:
    """One sentence HMM from a padded label ``[max_label_len]``: the batch
    of one of :func:`build_embedded_batch`, with the batch axis dropped."""
    label = torch.as_tensor(label)[None]
    label_len = torch.as_tensor(label_len).reshape(1)
    e = build_embedded_batch(bank, label, label_len, state_num, max_label_len)
    return EmbeddedHMM(band=e.band[0], log_pi=e.log_pi[0],
                       senone_idx=e.senone_idx[0], state_mask=e.state_mask[0],
                       n_states=e.n_states[0])


def embedded_log_b(scores: torch.Tensor, ehmm: EmbeddedHMM) -> torch.Tensor:
    """Sentence observation log-probs from bank-level GMM scores
    ``[B, T, S]`` -> ``[B, T, N_s]``: ``scores[t, senone(r)]`` for emitting
    states, 0 for the entry state, NEG_INF for the exit and padded states
    (``AcousticModel.py:990-1001, 1029-1043``)."""
    sen = ehmm.senone_idx
    b, n_s = sen.shape
    r = torch.arange(n_s, device=sen.device)[None, :]
    is_entry = (r == 0)[:, None, :]
    is_exit = (r == ehmm.n_states[:, None] - 1)[:, None, :]
    idx = torch.clamp(sen, min=0).long()[:, None, :].expand(
        b, scores.shape[1], n_s)
    gathered = scores.gather(2, idx)                     # [B, T, N_s]
    log_b = torch.where((sen >= 0)[:, None, :], gathered, NEG_INF)
    log_b = torch.where(is_entry, 0.0, log_b)
    log_b = torch.where(is_exit, NEG_INF, log_b)
    return torch.where(ehmm.state_mask[:, None, :], log_b, NEG_INF)


# JAX's ``jax.vmap(embedded_log_b)``: here the gather is batched already
embedded_log_b_batch = embedded_log_b


def states_to_labels(path: torch.Tensor, ehmm: EmbeddedHMM,
                     labels: torch.Tensor, state_num: int):
    """Sentence-state Viterbi paths ``[B, T]`` -> per-frame (label_pos,
    unit_id), each ``[B, T]`` int32 and -1 on virtual states
    (``LHMM.py:601-607``)."""
    emit = state_num - 2
    path = path.long()
    labels = torch.as_tensor(labels, device=path.device).long()
    pos = torch.div(path - 1, emit, rounding_mode="floor")
    is_emit = (path >= 1) & (path < ehmm.n_states[:, None].long() - 1)
    label_pos = torch.where(is_emit, pos, -1).to(torch.int32)
    unit = labels.gather(1, torch.clamp(pos, 0, labels.shape[1] - 1))
    unit_id = torch.where(is_emit, unit, -1).to(torch.int32)
    return label_pos, unit_id
