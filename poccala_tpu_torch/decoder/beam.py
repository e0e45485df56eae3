"""Frame-synchronous Viterbi-beam decoder over the lexicon tree (port of
``poccala_tpu/decoder/beam.py``): the simple host tier, and the base of the
vectorized and device tiers.

Tokens live on lexicon-tree nodes; each node's acoustic model is the
two-unit (initial+final) embedded HMM of its syllable (``Token.__init__``,
``Decoder.py:224-237``), stored as a banded transition table
``[n_nodes, n_tok_states, W]`` and a senone map ``[n_nodes,
n_tok_states]``.  Per frame every token advances one banded max-plus step,
its exit score flows to its children and, at word nodes, across the word
boundary with the N-gram LM score back into the tree root; pruning keeps
the top ``beam`` fraction, at most ``max_tokens``.

Compute split, as in JAX: the GMM scores of all frames against the whole
bank run once on the bank's device (:meth:`BeamDecoder._frame_scores`:
the CUDA kernel of ``csrc/gmm_score.cu`` for a bank on the card, its
plain version on the CPU); the token bookkeeping runs on the host in
NumPy float64 over that score matrix.  Everything but ``_frame_scores``
is the JAX module's host code, copied verbatim
(``tests/test_torch_lexicon.py`` pins it).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from poccala_tpu_torch.lexicon.lexicon import FlatLexicon
from poccala_tpu_torch.models.senone_bank import SenoneBank
from poccala_tpu_torch.ops.cuda.gmm_score_cuda import gmm_log_scores_fast
from poccala_tpu_torch.utils.logmath import NEG_INF


@dataclass(order=True)
class Hypothesis:
    score: float
    words: tuple = field(compare=False)


class BeamDecoder:
    def __init__(
        self,
        bank: SenoneBank,
        lexicon: FlatLexicon,
        beam: float = 0.85,          # keep fraction (Decoder.py:34)
        max_tokens: int = 64,
        candidate: int = 10,         # first-word seeds (Decoder.py:63)
        lm=None,
        lm_weight: float = 10.0,
        word_penalty: float = 0.0,
        normalizer: str = "textbook",
        score_dtype: str = "float32",
    ):
        """``word_penalty``: fixed log-score cost per emitted word (the
        standard insertion penalty; counters over-segmentation into
        short words).  Applied uniformly by every tier at word
        boundaries together with the LM score."""
        self.bank = bank
        self.lexicon = lexicon
        self.beam = beam
        self.max_tokens = max_tokens
        self.candidate = candidate
        self.lm = lm
        self.lm_weight = lm_weight
        self.word_penalty = float(word_penalty)
        self.normalizer = normalizer
        self.score_dtype = score_dtype

        n = bank.state_num
        emit = n - 2
        self.n_tok_states = 2 + 2 * emit  # two-unit syllable HMM
        self._build_node_tables()

    # ------------------------------------------------------------------
    def _build_node_tables(self) -> None:
        """Precompute every node's banded transmat + senone map (the
        arrayized ``am.embedded`` of ``Token.__init__``)."""
        bank = self.bank
        n = bank.state_num
        emit = n - 2
        w = n
        n_s = self.n_tok_states
        log_a = bank.log_A.detach().cpu().numpy()
        senone_map = bank.senone_map.detach().cpu().numpy()
        n_nodes = self.lexicon.n_nodes
        bands = np.full((n_nodes, n_s, w), NEG_INF, np.float32)
        senone = np.full((n_nodes, n_s), -1, np.int32)
        for nid in range(1, n_nodes):
            u1, u2 = self.lexicon.node_units[nid]
            units = (u1, u2)
            # entry row
            bands[nid, 0, :] = log_a[u1, 0, :w]
            for i, u in enumerate(units):
                for l in range(1, emit + 1):
                    r = i * emit + l
                    senone[nid, r] = senone_map[u, l - 1]
                    for k in range(w):
                        if l + k < n and r + k < n_s:
                            bands[nid, r, k] = log_a[u, l, l + k]
        self._bands = bands
        self._senone = senone

    # ------------------------------------------------------------------
    def _frame_scores(self, feats) -> np.ndarray:
        """All-frames × all-senones GMM scores ``[T, S]`` as host float64,
        for ``[T, D]`` features (an array, or a tensor on any device)
        scored on the bank's device: the CUDA kernel for a bank on the
        card, the plain version on the CPU; no fallback between them."""
        bank = self.bank
        x = torch.as_tensor(feats, dtype=torch.float32,
                            device=bank.means.device).contiguous()
        scores = gmm_log_scores_fast(
            x, bank.means, bank.log_var, bank.log_w,
            normalizer=self.normalizer, score_dtype=self.score_dtype,
        )
        return scores.cpu().numpy().astype(np.float64)

    def _log_b(self, scores_t: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        """[K, n_tok_states] observation row for the active tokens."""
        sen = self._senone[nodes]  # [K, Ns]
        log_b = np.where(sen >= 0, scores_t[np.clip(sen, 0, None)], NEG_INF)
        log_b[:, 0] = 0.0  # virtual entry (VirtualState(1.))
        return log_b

    def _step(self, deltas: np.ndarray, nodes: np.ndarray,
              scores_t: np.ndarray) -> np.ndarray:
        """One banded max-plus step for all tokens at once
        (``Token.viterbi``'s inner loop, ``Decoder.py:278-283``)."""
        k_w = self._bands.shape[-1]
        bands = self._bands[nodes]            # [K, Ns, W]
        n_s = deltas.shape[1]
        best = np.full_like(deltas, NEG_INF)
        for k in range(k_w):
            # contribution into state j from state j-k
            cand = deltas + bands[:, :, k]    # indexed by source state
            shifted = np.full_like(cand, NEG_INF)
            if k == 0:
                shifted = cand
            else:
                shifted[:, k:] = cand[:, :-k]
            best = np.maximum(best, shifted)
        return np.maximum(best + self._log_b(scores_t, nodes), NEG_INF)

    def _exit_scores(self, deltas: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        """Score of leaving each token's syllable HMM right now: the
        max-plus flow into the (virtual) exit state ``n_s - 1``."""
        k_w = self._bands.shape[-1]
        bands = self._bands[nodes]
        n_s = deltas.shape[1]
        out = np.full(len(nodes), NEG_INF)
        for k in range(1, k_w):
            r = n_s - 1 - k
            if r < 0:
                continue
            out = np.maximum(out, deltas[:, r] + bands[:, r, k])
        return out

    # ------------------------------------------------------------------
    def decode(self, feats: np.ndarray, n_frames: int | None = None,
               return_nbest: int = 5) -> list[Hypothesis]:
        """Decode one utterance.

        :param feats: ``[T, D]`` features
        :returns: n-best hypotheses (word tuples with scores)
        """
        t_total = int(n_frames) if n_frames is not None else len(feats)
        if t_total == 0:
            return []
        scores = self._frame_scores(np.asarray(feats[:t_total], np.float32))
        n_s = self.n_tok_states

        # --- seeding (generate_first_word): score each first-level node
        # on the first ~20 frames with a cheap forward sum, keep the best
        roots = self.lexicon.children(0)
        if len(roots) == 0:
            return []
        seed_t = min(20, t_total)
        seed_scores = []
        for nid in roots:
            delta = np.full(n_s, NEG_INF)
            delta[0] = 0.0
            for ti in range(seed_t):
                delta = self._step(delta[None], np.asarray([nid]),
                                   scores[ti])[0]
            seed_scores.append(delta.max())
        order = np.argsort(seed_scores)[::-1][: self.candidate]
        active_nodes = [int(roots[i]) for i in order]

        # token state: one token per (lexicon node, word history)
        tokens: dict[tuple[int, tuple], np.ndarray] = {}
        for nid in active_nodes:
            d = np.full(n_s, NEG_INF)
            d[0] = 0.0
            tokens[(nid, ())] = d

        def merge(store, key, delta):
            if key in store:
                store[key] = np.maximum(store[key], delta)
            else:
                store[key] = delta

        for ti in range(t_total):
            keys = list(tokens.keys())
            nodes = np.asarray([k[0] for k in keys], np.int32)
            deltas = np.stack([tokens[k] for k in keys])
            deltas = self._step(deltas, nodes, scores[ti])
            exits = self._exit_scores(deltas, nodes)

            new_tokens: dict[tuple[int, tuple], np.ndarray] = {}
            for i, (nid, hist) in enumerate(keys):
                merge(new_tokens, (nid, hist), deltas[i])
                if exits[i] <= NEG_INF / 2:
                    continue
                # word-internal propagation (passing_in_word): exit score
                # enters every child's entry state, keep-max recombined
                for child in self.lexicon.children(nid):
                    d = np.full(n_s, NEG_INF)
                    d[0] = exits[i]
                    merge(new_tokens, (int(child), hist), d)
                # word boundary (the finished passing_between_word):
                # close the word, apply the LM, re-enter the tree root
                for word in self.lexicon.node_words[nid]:
                    lm_score = -self.word_penalty
                    if self.lm is not None:
                        lm_score += self.lm_weight * self.lm.logprob(
                            word, list(hist)
                        )
                    new_hist = hist + (word,)
                    score = float(exits[i]) + lm_score
                    for child in self.lexicon.children(0):
                        d = np.full(n_s, NEG_INF)
                        d[0] = score
                        merge(new_tokens, (int(child), new_hist), d)

            # pruning (Decoder.py:159-167): drop the bottom (1 - beam)
            # fraction, then cap at max_tokens
            items = sorted(
                new_tokens.items(), key=lambda kv: kv[1].max(), reverse=True
            )
            n_keep = max(1, int(np.ceil(len(items) * self.beam)))
            tokens = dict(items[: min(n_keep, self.max_tokens)])

        # final transfer (Decoder.py:175-187): tokens whose syllable can
        # exit at the last frame emit their node's words
        finished: list[Hypothesis] = []
        keys = list(tokens.keys())
        nodes = np.asarray([k[0] for k in keys], np.int32)
        deltas = np.stack([tokens[k] for k in keys])
        exits = self._exit_scores(deltas, nodes)
        for i, (nid, hist) in enumerate(keys):
            if exits[i] <= NEG_INF / 2:
                continue
            for word in self.lexicon.node_words[nid]:
                lm_score = -self.word_penalty
                if self.lm is not None:
                    lm_score += self.lm_weight * self.lm.logprob(word, list(hist))
                finished.append(Hypothesis(
                    score=float(exits[i]) + lm_score,
                    words=hist + (word,),
                ))

        # best score per distinct word sequence
        best: dict[tuple, float] = {}
        for h in finished:
            if h.words not in best or h.score > best[h.words]:
                best[h.words] = h.score
        out = [Hypothesis(score=s, words=w) for w, s in best.items()]
        out.sort(reverse=True)
        return out[:return_nbest]
