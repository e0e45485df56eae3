"""Vectorized frame-synchronous beam decoder (port of
``poccala_tpu/decoder/vector.py``): the host tier the command line's
``decode`` uses by default, and the tables the device tier builds on.

Same algorithm as :mod:`poccala_tpu_torch.decoder.beam` (continuous token
passing over the lexicon tree), but the bookkeeping is arrays instead of
dicts, batched over *all utterances at once*: the token pool is a flat set
of ``(utterance, node, history)`` rows, histories are pointers into an
append-only traceback table, tokens recombine exactly on ``(utterance,
node, history)`` by ``np.unique`` + segment-max, and each frame is one
banded max-plus step over the whole pool plus vectorized expansion and
per-utterance top-k.  Word restarts are capped at :attr:`restart_top` per
utterance per frame.

The GMM scores of the whole ``[B, T]`` batch come from one call of
:meth:`BeamDecoder._frame_scores` (one launch of the CUDA kernel for a bank
on the card); the rest is host NumPy float64.  ``_prep_tables``,
``_lm_lookup`` and ``_step_rows`` are the JAX module's code, copied
verbatim; ``decode_batch`` differs only in taking its features as an
array or a tensor on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from poccala_tpu_torch.decoder.beam import BeamDecoder, Hypothesis
from poccala_tpu_torch.utils.logmath import NEG_INF


class VectorBeamDecoder(BeamDecoder):
    """Batched, vectorized token passing.  Construction arguments match
    :class:`BeamDecoder`."""

    #: word-boundary restarts kept per utterance per frame (strongest
    #: emissions first) — each restart fans out over every first-level
    #: node, so this bounds the pre-recombination pool at reference-
    #: scale lexicons; mirrors the device tier's top-16 LM emission rule
    restart_top = 16

    # ------------------------------------------------------------------
    def _prep_tables(self):
        """Padded child table + word table (once per decoder)."""
        if hasattr(self, "_child_tab"):
            return
        lex = self.lexicon
        n_nodes = lex.n_nodes
        c_max = max(
            (lex.child_ptr[i + 1] - lex.child_ptr[i] for i in range(n_nodes)),
            default=0,
        )
        child_tab = np.full((n_nodes, max(c_max, 1)), -1, np.int32)
        for i in range(n_nodes):
            c = lex.children(i)
            child_tab[i, : len(c)] = c
        self._child_tab = child_tab
        self._roots = np.asarray(lex.children(0), np.int32)
        # word table: word ids per node (W slots)
        vocab: list[str] = []
        self._word_of = {}
        w_max = max((len(w) for w in lex.node_words), default=0)
        word_tab = np.full((n_nodes, max(w_max, 1)), -1, np.int32)
        for i, words in enumerate(lex.node_words):
            for j, w in enumerate(words):
                if w not in self._word_of:
                    self._word_of[w] = len(vocab)
                    vocab.append(w)
                word_tab[i, j] = self._word_of[w]
        self._vocab = vocab
        self._word_tab = word_tab
        # LM tables over the lexicon vocabulary.  Ngram-style LMs
        # (anything exposing ``bigram_tables_backoff``) stay SPARSE —
        # unigram + per-row/column backoff vectors plus sorted
        # observed-bigram keys — so a full-vocabulary decode (37.5k
        # words from Mandarin.dat) never materializes the 5.8 GB dense
        # [V+1, V] table.  Foreign LM objects fall back to a dense
        # table via per-pair logprob calls.
        v = len(vocab)
        self._lm_tab = None
        self._lm_sparse = None
        if self.lm is not None and v:
            if hasattr(self.lm, "bigram_tables_backoff"):
                # per-row backoff form: unseen (p, q) scores
                # row_boff[p] + col_base[q].  Covers JM (row_boff = 0)
                # AND Witten-Bell (row_boff[p] = log(1-λ_p)), so the
                # better-smoothed LM attaches to the first pass
                # (Decoder.py:201-204 builds an Ngram per order for
                # exactly this; previously 'wb' was rescoring-only)
                uni, rboff, cbase, rows, cols, vals = \
                    self.lm.bigram_tables_backoff(vocab)
                keys = rows.astype(np.int64) * v + cols
                order = np.argsort(keys)
                keys = keys[order]
                vals = vals[order]
                if len(keys) == 0:  # sentinel: never matches (k >= 0)
                    keys = np.asarray([-1], np.int64)
                    vals = np.zeros(1)
                # row V (no-previous-word) never reaches the backoff
                # path (the uni branch wins) — pad with 0 so the gather
                # stays in bounds
                rboff = np.concatenate([rboff, [0.0]])
                self._lm_sparse = (
                    (self.lm_weight * uni - self.word_penalty)
                    .astype(np.float32),
                    (self.lm_weight * rboff).astype(np.float32),
                    (self.lm_weight * cbase - self.word_penalty)
                    .astype(np.float32),
                    keys,
                    (self.lm_weight * vals - self.word_penalty)
                    .astype(np.float32),
                )
            else:
                uni = np.array([self.lm.logprob(w, []) for w in vocab])
                bi = np.zeros((v + 1, v))
                bi[v] = uni  # "no previous word" row
                for p in range(v):
                    for q in range(v):
                        bi[p, q] = self.lm.logprob(vocab[q], [vocab[p]])
                self._lm_tab = self.lm_weight * bi - self.word_penalty

    def _lm_lookup(self, last_word, words):
        """Word-boundary score: sparse/dense LM lookup, or the constant
        insertion penalty when no LM is attached.  ``last_word == V``
        means no-previous-word (the unigram row)."""
        if self._lm_sparse is not None:
            uni, rboff, cbase, keys, vals = self._lm_sparse
            last_word = np.asarray(last_word)
            words = np.asarray(words)
            v = len(uni)
            k = last_word.astype(np.int64) * v + words
            idx = np.searchsorted(keys, k)
            idx_c = np.minimum(idx, len(keys) - 1)
            found = (idx < len(keys)) & (keys[idx_c] == k)
            val = np.where(found, vals[idx_c],
                           rboff[last_word] + cbase[words])
            return np.where(last_word == v, uni[words], val)
        if self._lm_tab is None:
            return np.full(np.broadcast(last_word, words).shape,
                           -self.word_penalty)
        return self._lm_tab[last_word, words]

    # ------------------------------------------------------------------
    def decode_batch(self, feats: np.ndarray, n_frames: np.ndarray,
                     return_nbest: int = 5) -> list[list[Hypothesis]]:
        """Decode ``[B, T, D]`` padded features (an array, or a tensor on
        any device; ``n_frames`` ``[B]`` likewise); returns per-utterance
        n-best lists."""
        self._prep_tables()
        b, t_pad, _ = feats.shape
        if isinstance(n_frames, torch.Tensor):
            n_frames = n_frames.cpu()
        n_frames = np.asarray(n_frames)
        if not isinstance(feats, torch.Tensor):
            feats = np.asarray(feats, np.float32)
        scores = self._frame_scores(
            feats.reshape(b * t_pad, -1)
        ).reshape(b, t_pad, -1)
        n_s = self.n_tok_states
        n_nodes = self.lexicon.n_nodes
        v = len(self._vocab)

        # --- seed: roots for every utterance
        roots = self._roots
        if len(roots) == 0:
            return [[] for _ in range(b)]
        utt = np.repeat(np.arange(b, dtype=np.int32), len(roots))
        nodes = np.tile(roots, b)
        deltas = np.full((len(nodes), n_s), NEG_INF)
        deltas[:, 0] = 0.0
        hist = np.full(len(nodes), -1, np.int32)     # traceback ptr
        last_word = np.full(len(nodes), v, np.int32)  # v = no word yet

        # traceback table (append-only)
        tb_prev: list[int] = []
        tb_word: list[int] = []

        c_max = self._child_tab.shape[1]
        w_max = self._word_tab.shape[1]
        final: list[list[Hypothesis]] = [[] for _ in range(b)]

        for ti in range(t_pad):
            active = ti < n_frames[utt]
            if not active.any():
                break
            # one banded step for the whole pool (frame row per token)
            frame_scores = scores[utt, np.minimum(ti, t_pad - 1)]  # [P, S]
            stepped = self._step_rows(deltas, nodes, frame_scores)
            deltas = np.where(active[:, None], stepped, deltas)
            exits = np.where(active, self._exit_scores(deltas, nodes), NEG_INF)

            pools = [(utt, nodes, deltas, hist, last_word)]

            has_exit = exits > NEG_INF / 2
            if has_exit.any():
                idx = np.where(has_exit)[0]
                # child expansions
                ch = self._child_tab[nodes[idx]]            # [E, C]
                src = np.repeat(idx, c_max)
                ch_flat = ch.reshape(-1)
                ok = ch_flat >= 0
                if ok.any():
                    src_ok = src[ok]
                    d = np.full((ok.sum(), n_s), NEG_INF)
                    d[:, 0] = exits[src_ok]
                    pools.append((utt[src_ok], ch_flat[ok], d,
                                  hist[src_ok], last_word[src_ok]))
                # word-boundary restarts
                wt = self._word_tab[nodes[idx]]             # [E, W]
                srcw = np.repeat(idx, w_max)
                w_flat = wt.reshape(-1)
                okw = w_flat >= 0
                if okw.any():
                    srcw = srcw[okw]
                    words = w_flat[okw]
                    lm = self._lm_lookup(last_word[srcw], words)
                    base = exits[srcw] + lm
                    # cap word restarts per utterance at the strongest
                    # emissions: each one fans out over every root
                    # (len(roots) can be 500+ at reference scale), so
                    # unbounded emissions made the pre-recombination
                    # pool quadratic-ish per frame.  The device tier
                    # applies the same idea (top-16 LM emissions).
                    cap = self.restart_top
                    if len(words) > cap:
                        o = np.lexsort((-base, utt[srcw]))
                        us = utt[srcw][o]
                        cnt = np.bincount(us, minlength=b)
                        st = np.concatenate(([0], np.cumsum(cnt)[:-1]))
                        rk = np.arange(len(us)) - st[us]
                        keep = o[rk < cap]
                        srcw, words, base = srcw[keep], words[keep], \
                            base[keep]
                    # new traceback entries
                    ptrs = np.arange(len(tb_prev),
                                     len(tb_prev) + len(words), dtype=np.int32)
                    tb_prev.extend(hist[srcw].tolist())
                    tb_word.extend(words.tolist())
                    # restart at every root child
                    rep = len(roots)
                    d = np.full((len(words) * rep, n_s), NEG_INF)
                    d[:, 0] = np.repeat(base, rep)
                    pools.append((
                        np.repeat(utt[srcw], rep),
                        np.tile(roots, len(words)),
                        d,
                        np.repeat(ptrs, rep),
                        np.repeat(words, rep).astype(np.int32),
                    ))

            utt = np.concatenate([p[0] for p in pools])
            nodes = np.concatenate([p[1] for p in pools])
            deltas = np.concatenate([p[2] for p in pools])
            hist = np.concatenate([p[3] for p in pools])
            last_word = np.concatenate([p[4] for p in pools])

            # exact recombination on (utt, node, history): elementwise max
            # of deltas per key — identical semantics to the dict
            # decoder's keep-max merge (beam.py).  Keys are packed into
            # one int64 so np.unique sorts scalars, not 2D rows (the
            # rowwise axis=0 unique ran a structured sort per frame)
            keys = ((utt.astype(np.int64) * n_nodes + nodes)
                    * (len(tb_prev) + 2) + (hist + 1))
            uniq, rep_idx, seg_of = np.unique(
                keys, return_index=True, return_inverse=True
            )
            n_seg = len(uniq)
            merged = np.full((n_seg, n_s), NEG_INF)
            np.maximum.at(merged, seg_of, deltas)
            utt, nodes, hist, last_word = (
                utt[rep_idx], nodes[rep_idx], hist[rep_idx],
                last_word[rep_idx],
            )
            deltas = merged

            # per-utterance beam pruning + cap: one segment-wise top-k
            # over the whole pool via lexsort on (utt, -score) — the
            # rank of each token within its utterance's descending
            # order decides survival (no per-utterance Python loop)
            tok_score = deltas.max(axis=1)
            order = np.lexsort((-tok_score, utt))
            utt_sorted = utt[order]
            counts = np.bincount(utt_sorted, minlength=b)
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            rank = np.arange(len(utt_sorted)) - starts[utt_sorted]
            n_keep = np.minimum(
                np.maximum(1, np.ceil(counts * self.beam)).astype(np.int64),
                self.max_tokens,
            )
            keep_mask = np.zeros(len(nodes), bool)
            keep_mask[order[rank < n_keep[utt_sorted]]] = True
            utt, nodes, deltas, hist, last_word = (
                utt[keep_mask], nodes[keep_mask], deltas[keep_mask],
                hist[keep_mask], last_word[keep_mask],
            )

        # --- final word emission
        exits = self._exit_scores(deltas, nodes)
        tb_prev_arr = np.asarray(tb_prev, np.int64)
        tb_word_arr = np.asarray(tb_word, np.int64)

        def words_of(ptr: int) -> tuple:
            out = []
            while ptr >= 0:
                out.append(self._vocab[tb_word_arr[ptr]])
                ptr = tb_prev_arr[ptr]
            return tuple(reversed(out))

        best: list[dict] = [dict() for _ in range(b)]
        for i in range(len(nodes)):
            if exits[i] <= NEG_INF / 2:
                continue
            for w_id in self._word_tab[nodes[i]]:
                if w_id < 0:
                    continue
                lm = self._lm_lookup(last_word[i], w_id)
                seq = words_of(hist[i]) + (self._vocab[w_id],)
                score = float(exits[i]) + float(lm)
                d = best[utt[i]]
                if seq not in d or score > d[seq]:
                    d[seq] = score
        for u in range(b):
            hyps = [Hypothesis(score=s, words=w) for w, s in best[u].items()]
            hyps.sort(reverse=True)
            final[u] = hyps[:return_nbest]
        return final

    # ------------------------------------------------------------------
    def decode(self, feats, n_frames=None, return_nbest: int = 5):
        """Single-utterance API parity with :class:`BeamDecoder`:
        ``decode_batch`` of ``feats[None, :n_frames]`` (an array, or a
        tensor on any device)."""
        if not isinstance(feats, torch.Tensor):
            feats = np.asarray(feats, np.float32)
        t = int(n_frames) if n_frames is not None else len(feats)
        out = self.decode_batch(feats[None, :t], np.asarray([t]),
                                return_nbest=return_nbest)
        return out[0]

    # ------------------------------------------------------------------
    def _step_rows(self, deltas, nodes, frame_scores):
        """Banded max-plus step where each token row has its own frame
        scores (multi-utterance pool)."""
        k_w = self._bands.shape[-1]
        bands = self._bands[nodes]
        best = np.full_like(deltas, NEG_INF)
        for k in range(k_w):
            cand = deltas + bands[:, :, k]
            if k == 0:
                shifted = cand
            else:
                shifted = np.full_like(cand, NEG_INF)
                shifted[:, k:] = cand[:, :-k]
            best = np.maximum(best, shifted)
        sen = self._senone[nodes]
        log_b = np.where(sen >= 0, np.take_along_axis(
            frame_scores, np.clip(sen, 0, None), axis=1), NEG_INF)
        log_b[:, 0] = 0.0
        return np.maximum(best + log_b, NEG_INF)
