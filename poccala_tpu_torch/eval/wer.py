"""Word/character error rate.

The reference defines no evaluation at all (SURVEY.md §4/§6); WER parity
is the BASELINE.json acceptance metric, so the harness lives here:
Levenshtein alignment plus decoder-over-corpus evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def edit_distance(ref: list, hyp: list) -> tuple[int, int, int, int]:
    """Levenshtein with operation counts.

    :returns: (substitutions, deletions, insertions, distance)
    """
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, dels, ins)
    dp = np.zeros((n + 1, m + 1), np.int32)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dp[i, j] = min(sub, dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    # backtrace for op counts
    i, j = n, m
    subs = dels = ins = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            subs += ref[i - 1] != hyp[j - 1]
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return int(subs), int(dels), int(ins), int(dp[n, m])


@dataclass
class WerResult:
    wer: float
    substitutions: int
    deletions: int
    insertions: int
    ref_tokens: int
    sentences: int
    sentence_errors: int

    @property
    def ser(self) -> float:
        return self.sentence_errors / max(self.sentences, 1)


def wer(refs: list[list], hyps: list[list]) -> WerResult:
    """Corpus-level WER over token sequences."""
    subs = dels = ins = total = serr = 0
    for r, h in zip(refs, hyps):
        s, d, i, dist = edit_distance(list(r), list(h))
        subs += s
        dels += d
        ins += i
        total += len(r)
        serr += dist > 0
    return WerResult(
        wer=(subs + dels + ins) / max(total, 1),
        substitutions=subs, deletions=dels, insertions=ins,
        ref_tokens=total, sentences=len(refs), sentence_errors=serr,
    )


def evaluate_decoder(decoder, utterances: list[tuple[np.ndarray, list]],
                     n_frames: list[int] | None = None) -> WerResult:
    """Decode each (features, reference-words) pair and score WER."""
    refs, hyps = [], []
    for idx, (feats, ref_words) in enumerate(utterances):
        nf = n_frames[idx] if n_frames is not None else None
        out = decoder.decode(feats, n_frames=nf, return_nbest=1)
        hyps.append(list(out[0].words) if out else [])
        refs.append(list(ref_words))
    return wer(refs, hyps)
