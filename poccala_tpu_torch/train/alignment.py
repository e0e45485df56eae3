"""Viterbi forced alignment and host-side frame grouping (port of
``poccala_tpu/train/alignment.py``).

:func:`align_batch` builds each utterance's sentence HMM, scores its own
senones and runs the banded Viterbi through
:func:`poccala_tpu_torch.ops.hmm.viterbi_log_banded_batch` (the CUDA
kernel on the GPU, backtrace included); on the GPU the scores come from
the sentence kernel, which then writes no components.  With
``state_axis_name`` (the state axis's process group) the bank is one
state shard: the sentence lattice is assembled by ``all_reduce(MAX)``
before the Viterbi kernel, as the state-sharded E-step does (JAX
``alignment.py:61-80``).  The host helpers (:func:`uniform_label_pos`,
:func:`check_alignment`, :func:`group_frames_by_senone`) are NumPy code
copied verbatim — the JAX module imports jax — and
``tests/test_torch_train.py`` pins the copies.
"""

from __future__ import annotations

import numpy as np
import torch

from poccala_tpu_torch.models.senone_bank import SenoneBank
from poccala_tpu_torch.models.topology import build_embedded_batch
from poccala_tpu_torch.ops import hmm as hmm_ops
from poccala_tpu_torch.train.accumulators import sentence_scores
from poccala_tpu_torch.utils import profiling


def align_batch(bank: SenoneBank, labels, label_lens, xs, t_masks,
                state_num: int, max_label_len: int,
                normalizer: str = "textbook", score_dtype: str = "float32",
                state_axis_name=None, s_offset: int = 0):
    """Viterbi-align a batch against its sentence HMMs.

    :returns: (scores ``[B]``, label_pos ``[B, T]`` int32 — per-frame
        index into the label sequence, -1 on virtual states and padding)
    """
    dev = bank.means.device
    with profiling.span("train.align", dev):
        labels = torch.as_tensor(labels, device=dev)
        label_lens = torch.as_tensor(label_lens, device=dev)
        xs = torch.as_tensor(xs, dtype=torch.float32, device=dev)
        t_masks = torch.as_tensor(t_masks, device=dev).to(torch.bool)
        ehmm = build_embedded_batch(bank, labels, label_lens, state_num,
                                    max_label_len)
        _, _, log_b = sentence_scores(bank, ehmm, xs, normalizer,
                                      score_dtype, state_axis_name, s_offset,
                                      components=False)
        score, path, _ = hmm_ops.viterbi_log_banded_batch(
            ehmm.band, ehmm.log_pi, log_b, t_masks, state_num)
        emit = state_num - 2
        path = path.long()
        pos = torch.div(path - 1, emit, rounding_mode="floor")
        is_emit = ((path >= 1) & (path < ehmm.n_states[:, None].long() - 1)
                   & t_masks)
        return score, torch.where(is_emit, pos, -1).to(torch.int32)


def align_utterance(bank, label, label_len, x, t_mask, state_num: int,
                    max_label_len: int, normalizer: str = "textbook",
                    score_dtype: str = "float32",
                    state_axis_name=None, s_offset: int = 0):
    """One utterance: (score, label_pos ``[T]``)."""
    dev = bank.means.device
    score, lp = align_batch(
        bank, torch.as_tensor(label, device=dev)[None],
        torch.as_tensor(label_len, device=dev).reshape(1),
        torch.as_tensor(x, device=dev)[None],
        torch.as_tensor(t_mask, device=dev)[None], state_num, max_label_len,
        normalizer=normalizer, score_dtype=score_dtype,
        state_axis_name=state_axis_name, s_offset=s_offset)
    return score[0], lp[0]


# ----------------------------------------------------------------------
# Host-side frame grouping (copied verbatim from the JAX module)
# ----------------------------------------------------------------------

def uniform_label_pos(label_lens: np.ndarray, t_masks: np.ndarray) -> np.ndarray:
    """Uniform segmentation (``__eq_segment`` mode 'e',
    ``AcousticModel.py:605-612``): frame t of an utterance with L label
    units and T frames maps to label position ``min(t // (T // L), L-1)``
    — the reference gives ``T // L`` frames to each unit and drops the
    remainder; we assign the remainder to the last unit instead of
    discarding frames.  Fully vectorized over the batch."""
    b, t_pad = t_masks.shape
    t_true = t_masks.sum(axis=1).astype(np.int64)             # [B]
    l = np.maximum(np.asarray(label_lens, np.int64), 1)       # [B]
    chunk = np.maximum(t_true // l, 1)                        # [B]
    t = np.arange(t_pad, dtype=np.int64)[None, :]             # [1, T]
    pos = np.minimum(t // chunk[:, None], (l - 1)[:, None])
    return np.where(t < t_true[:, None], pos, -1).astype(np.int32)


def check_alignment(label_pos: np.ndarray, labels: np.ndarray,
                    label_lens: np.ndarray) -> np.ndarray:
    """Per-utterance alignment sanity (``AcousticModel.py:751-757``): the
    aligned path must visit at least as many distinct units as the label
    contains; failures are dropped with a warning upstream.  Vectorized
    over the batch (one ``unique`` per side, no per-utterance Python —
    this runs every scheme-1 epoch)."""
    lp = np.asarray(label_pos)
    labels = np.asarray(labels)
    lens = np.asarray(label_lens)
    b = lp.shape[0]
    ui, ti = np.nonzero(lp >= 0)
    vis = np.unique(np.stack(
        [ui, labels[ui, lp[ui, ti]]], axis=1), axis=0) if len(ui) else \
        np.zeros((0, 2), np.int64)
    n_seen = np.bincount(vis[:, 0], minlength=b)
    wi, wj = np.nonzero(np.arange(labels.shape[1])[None] < lens[:, None])
    want = np.unique(np.stack([wi, labels[wi, wj]], axis=1), axis=0) \
        if len(wi) else np.zeros((0, 2), np.int64)
    n_want = np.bincount(want[:, 0], minlength=b)
    return n_seen >= n_want


def group_frames_by_senone(
    xs: np.ndarray,
    labels: np.ndarray,
    label_lens: np.ndarray,
    label_pos: np.ndarray,
    num_senones: int,
    emit_states: int,
    max_frames_per_senone: int,
    utt_ok: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
    senone_map: np.ndarray | None = None,
):
    """Build fixed-shape per-senone frame buckets for grouped k-means/EM.

    For each utterance and each contiguous run of one label position (one
    unit occurrence), the run's frames are split equally across the
    unit's emitting states (``__eq_segment`` mode 'g' + ``__get_gmmdata``,
    ``AcousticModel.py:613-644``) and appended to the owning senone's
    bucket.  Buckets overflowing ``max_frames_per_senone`` are subsampled
    uniformly (a capacity cap the Python reference does not need; flagged
    per the no-silent-caps rule by the returned ``n_dropped``).

    Fully vectorized (run-length encoding over the whole batch + one
    stable sort by senone id): the host cost is O(N log N) numpy on the
    total valid-frame count N, not Python loops per utterance/run —
    the reference's per-utterance ``__eq_segment`` loops
    (``AcousticModel.py:587-644``) were the scheme-1 wall-clock at
    corpus scale (VERDICT round-1 item 9).

    :returns: (frames ``[S, F, D]`` float32, mask ``[S, F]`` bool,
        n_dropped int)
    """
    b, t_pad, d = xs.shape
    cap = max_frames_per_senone
    if rng is None:
        rng = np.random.default_rng(0)
    out = np.zeros((num_senones, cap, d), np.float32)
    mask = np.zeros((num_senones, cap), bool)

    lp = np.asarray(label_pos)
    ok = np.ones(b, bool) if utt_ok is None else np.asarray(utt_ok, bool)
    ui, ti = np.nonzero((lp >= 0) & ok[:, None])  # valid frames, time order
    if ui.size == 0:
        return out, mask, 0
    pos = lp[ui, ti]

    # contiguous runs of equal label position within one utterance = unit
    # occurrences (gaps of masked frames do NOT split a run, matching the
    # reference's split on diff(lp[valid]))
    new_run = np.ones(len(ui), bool)
    new_run[1:] = (ui[1:] != ui[:-1]) | (pos[1:] != pos[:-1])
    run_id = np.cumsum(new_run) - 1
    run_len = np.bincount(run_id)
    run_start = np.concatenate([[0], np.cumsum(run_len)[:-1]])
    pos_in_run = np.arange(len(ui)) - run_start[run_id]

    # per-run equal split over emitting states; runs shorter than the
    # state count give every frame to the last state (__get_gmmdata)
    chunk = (run_len // emit_states)[run_id]
    e = np.where(
        chunk == 0,
        emit_states - 1,
        np.minimum(pos_in_run // np.maximum(chunk, 1), emit_states - 1),
    )
    unit = np.asarray(labels)[ui, pos]
    if senone_map is not None:
        sid = np.asarray(senone_map)[unit, e]
    else:
        sid = unit * emit_states + e

    # bucket fill: random permutation + stable sort by senone id groups
    # frames per senone with a uniform-random order inside each group,
    # so truncating at the cap IS the uniform subsample
    perm = rng.permutation(len(sid))
    sel = perm[np.argsort(sid[perm], kind="stable")]
    sid_s = sid[sel]
    counts = np.bincount(sid_s, minlength=num_senones)[:num_senones]
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_in_seg = np.arange(len(sel)) - seg_start[sid_s]
    keep = pos_in_seg < cap
    out[sid_s[keep], pos_in_seg[keep]] = xs[ui[sel[keep]], ti[sel[keep]]]
    mask[sid_s[keep], pos_in_seg[keep]] = True
    n_dropped = int(np.maximum(counts - cap, 0).sum())
    return out, mask, n_dropped
