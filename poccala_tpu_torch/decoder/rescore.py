"""Host-side N-best rescoring: trade the decode-time LM for a stronger
(higher-order) one (copy of ``poccala_tpu/decoder/rescore.py``, whose
import chain loads jax; ``tests/test_torch_rescore.py`` pins the copy).

The reference's serving path constructs ``Ngram(k)`` for every order
1..n (the reference's ``Decoder.py:201-204``) but its token passer never
applies more than the previous word of context.  The device decoder here
is in the same position by design: its per-state packed context carries
exactly one previous word (``decoder/device.py`` ctx packing), which
makes the on-device search a bigram-exact word-level Viterbi.  Higher
orders come from the standard two-pass recipe instead: decode with the
bigram, extract the device n-best, and **rescore** each hypothesis by
subtracting the LM contribution the decoder added and adding the
higher-order LM's score over the same word sequence.

The decode-time contribution is reconstructed exactly: the device tier
adds ``lm_weight * logprob(w_t | w_{t-1}) - word_penalty`` per emitted
word (the first word uses the unigram row — the decoder's no-previous-
word context), so acoustic scores recover to the float32 rounding of
the decode scan (pinned by ``tests/test_rescore.py``: rescoring with
the decode LM itself is a no-op).
"""

from __future__ import annotations

from poccala_tpu_torch.decoder.beam import Hypothesis


def decode_lm_score(lm, words, lm_weight: float,
                    word_penalty: float) -> float:
    """Total LM contribution the decoder added for ``words``: one
    ``lm_weight · logprob(w_t | context) − word_penalty`` per word,
    where the context is however much history ``lm`` consumes (empty
    for the first word — the decoder's unigram row).  ``lm=None``
    reproduces the no-LM decoder's constant insertion penalty."""
    total = -word_penalty * len(words)
    if lm is None:
        return total
    hist: list[str] = []
    for w in words:
        total += lm_weight * lm.logprob(w, hist)
        hist.append(w)
    return total


def rescore_hyps(hyps, decode_lm, rescore_lm, lm_weight: float,
                 word_penalty: float, rescore_lm_weight: float | None = None,
                 rescore_word_penalty: float | None = None):
    """Rescore one n-best list: remove ``decode_lm``'s contribution
    (computed exactly as the decoder applied it), add ``rescore_lm``'s.

    Context length follows each LM's own order — a trigram consumes two
    previous words where the decode bigram consumed one.

    :param hyps: n-best ``Hypothesis`` list from any decoder tier
    :param decode_lm: the LM the decoder ran with (``None`` = no LM)
    :param rescore_lm: the replacement LM (e.g. ``Ngram(3)``)
    :param lm_weight / word_penalty: the decode-time values
    :param rescore_lm_weight / rescore_word_penalty: override the
        weight/penalty for the new LM (default: same as decode)
    :returns: re-sorted ``Hypothesis`` list (same words, new scores)
    """
    w_new = lm_weight if rescore_lm_weight is None else rescore_lm_weight
    p_new = (word_penalty if rescore_word_penalty is None
             else rescore_word_penalty)
    out = []
    for h in hyps:
        acoustic = h.score - decode_lm_score(
            decode_lm, h.words, lm_weight, word_penalty)
        s = acoustic + decode_lm_score(rescore_lm, h.words, w_new, p_new)
        out.append(Hypothesis(score=s, words=h.words))
    out.sort(reverse=True)
    return out


def rescore_nbest(nbest_lists, decode_lm, rescore_lm, lm_weight: float,
                  word_penalty: float, **kw):
    """Batch form: rescore every utterance's n-best list."""
    return [
        rescore_hyps(h, decode_lm, rescore_lm, lm_weight, word_penalty,
                     **kw)
        for h in nbest_lists
    ]


# ----------------------------------------------------------------------
# Homophone sausage rescoring (pinyin -> hanzi conversion)
# ----------------------------------------------------------------------

def homophone_groups(lexicon) -> dict[str, tuple[str, ...]]:
    """Map each word to the tuple of words sharing its lexicon node —
    exact homophones (identical unit sequence, hence identical
    acoustics and decode penalty).  Built from ``node_words``, the
    ``'word'`` leaf lists of the reference's prefix tree
    (``PronunciationLexicon.py:79-94``)."""
    groups: dict[str, tuple[str, ...]] = {}
    for words in lexicon.node_words:
        if len(words) < 2:
            continue
        tup = tuple(words)
        for w in words:
            groups[w] = tup
    return groups


def best_homophone_path(words, groups, lm, lm_weight: float,
                        beam: int = 8):
    """Best hanzi sequence over the homophone sausage of ``words``.

    Every position may swap to any homophone of the decoded word at
    ZERO acoustic cost (same pronunciation -> same frames, same
    penalty), so the optimum over the sausage under ``lm`` is exact
    pinyin->hanzi conversion — the task the reference's per-order
    ``Ngram`` stack exists for (``Decoder.py:201-204``).  A beam of
    ``beam`` histories makes this exact for any LM order <= beam depth
    in practice (histories are (n-1)-word tuples; ties keep the
    decoded word first).

    :returns: (best words tuple, total weighted LM score)
    """
    # beam entries: (score, history tuple, words-so-far tuple)
    entries = [(0.0, (), ())]
    for w in words:
        alts = groups.get(w, (w,))
        # decoded word first so exact ties preserve the decoder's choice
        alts = (w,) + tuple(a for a in alts if a != w)
        nxt = []
        for score, hist, seq in entries:
            for a in alts:
                s = score + lm_weight * lm.logprob(a, list(hist))
                h = (hist + (a,))[-(lm.n - 1):] if lm.n > 1 else ()
                nxt.append((s, h, seq + (a,)))
        # keep the best entry per history (Viterbi recombination),
        # then the top `beam` overall
        best_by_hist: dict[tuple, tuple] = {}
        for e in nxt:
            k = e[1]
            if k not in best_by_hist or e[0] > best_by_hist[k][0]:
                best_by_hist[k] = e
        entries = sorted(best_by_hist.values(),
                         key=lambda e: e[0], reverse=True)[:beam]
    return entries[0][2], entries[0][0]


def rescore_sausage(nbest_lists, groups, decode_lm, rescore_lm,
                    lm_weight: float, word_penalty: float,
                    rescore_lm_weight: float | None = None,
                    beam: int = 8):
    """Two-pass homophone-aware rescoring: for each hypothesis, strip
    the decode LM's exact contribution, then pick the best homophone
    sequence under ``rescore_lm`` (``best_homophone_path``) and re-rank.
    The acoustic+penalty part is invariant under homophone swaps, so
    this is exact sausage decoding, not an approximation."""
    w_new = lm_weight if rescore_lm_weight is None else rescore_lm_weight
    out = []
    for hyps in nbest_lists:
        res = []
        for h in hyps:
            base = h.score - decode_lm_score(
                decode_lm, h.words, lm_weight, word_penalty)
            seq, lm_s = best_homophone_path(
                h.words, groups, rescore_lm, w_new, beam=beam)
            res.append(Hypothesis(
                score=base + lm_s - word_penalty * len(seq), words=seq))
        res.sort(reverse=True)
        out.append(res)
    return out
