"""Host decode tables (the part of ``poccala_tpu/decoder/vector.py`` the
device decoder needs: ``_prep_tables``, copied as host code because that
module's import chain loads jax, and the single-utterance ``decode``).

Builds, once per decoder, the padded child table, the vocabulary and the
per-node word table, and the LM tables over that vocabulary: sparse
(unigram + per-row/column backoff vectors + sorted observed-bigram keys)
for Ngram-style LMs, a dense ``[V+1, V]`` table for foreign LM objects.
The vectorized host token-passing tier waits for a later port.
"""

from __future__ import annotations

import numpy as np
import torch

from poccala_tpu_torch.decoder.beam import BeamDecoder


class VectorBeamDecoder(BeamDecoder):
    """Construction arguments match :class:`BeamDecoder`."""

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
