"""Count-based N-gram language model.

The reference *imports* ``LanguageModel.Ngram`` (``Decoder.py:17``) and
calls ``Ngram(n)``, ``.init_gram()`` and ``.ngram(word) -> {next: count}``
(``Decoder.py:201-204, 151-155``) — but the module is absent from the
repo.  This implements the missing component with the call surface the
decoder expects, plus standard scoring:

* ``train(sentences)`` — accumulate n-gram counts (with sentence
  boundary markers);
* ``ngram(context) -> dict`` — successor counts for a context (the
  decoder's word-transition candidate source);
* ``logprob(word, context)`` — interpolated (Jelinek-Mercer) backoff
  probability in log10 (the reference scores with ``math.log10``,
  ``Decoder.py:155``);
* ``save/init_gram`` — JSON persistence.

Scale: every stored k-gram also feeds a **successor (prefix) index**
``prefix -> {next: count}``, so ``ngram(context)`` is O(successors of
context) instead of a scan over every stored k-gram, and
``bigram_tables``/``bigram_matrix`` vectorize the decoder's
word-transition table build to O(#observed bigrams + V) numpy work
instead of V² ``logprob`` calls (the reference-scale Mandarin lexicon is
25,569 entries; V² Python calls would be ~650M).
"""

from __future__ import annotations

import json
import math
import os
from collections import defaultdict

import numpy as np

BOS = "<s>"
EOS = "</s>"


class Ngram:
    def __init__(self, n: int = 2, lambda_interp: float = 0.7,
                 smoothing: str = "jm"):
        """:param smoothing: ``'jm'`` — fixed-weight Jelinek-Mercer
        interpolation (``lambda_interp``), the decoder-table form;
        ``'wb'`` — Witten-Bell: per-context
        ``lambda(ctx) = c(ctx) / (c(ctx) + distinct_successors(ctx))``,
        so confident histories keep their high-order estimate while
        sparse ones defer to lower orders without JM's flat ``1-λ``
        penalty on every unseen continuation (measured: the structured-
        corpus trigram gain JM discards, tests/test_markov_corpus.py).
        Both modes attach to the first-pass decoder via the per-row-
        backoff tables (:meth:`bigram_tables_backoff`, r05); the legacy
        :meth:`bigram_tables` form still requires ``'jm'`` (its backoff
        column is context-independent)."""
        assert n >= 1
        assert smoothing in ("jm", "wb"), smoothing
        self.n = n
        self.smoothing = smoothing
        self.lambda_interp = lambda_interp
        # counts[k] maps "w1 w2 … wk" -> count, for k = 1..n
        self.counts: list[dict[str, int]] = [defaultdict(int) for _ in range(n)]
        self.total_unigrams = 0
        self.vocab: set[str] = set()
        self._rebuild_index()

    def _rebuild_index(self) -> None:
        # succ[k][prefix of k words] -> {next_word: count}; k = 0..n-1
        # (k = 0 is the unigram "empty prefix" row)
        self._succ: list[dict[str, dict[str, int]]] = [
            defaultdict(dict) for _ in range(self.n)
        ]
        for k in range(1, self.n + 1):
            for key, cnt in self.counts[k - 1].items():
                if k == 1:
                    prefix, word = "", key
                else:
                    prefix, word = key.rsplit(" ", 1)
                row = self._succ[k - 1][prefix]
                row[word] = row.get(word, 0) + cnt

    # ------------------------------------------------------------------
    def train(self, sentences: list[list[str]]) -> None:
        for sent in sentences:
            tokens = [BOS] * (self.n - 1) + list(sent) + [EOS]
            for i, tok in enumerate(tokens):
                self.vocab.add(tok)
                for k in range(1, self.n + 1):
                    if i + k <= len(tokens):
                        key = " ".join(tokens[i: i + k])
                        self.counts[k - 1][key] += 1
        self.total_unigrams = sum(self.counts[0].values())
        self._rebuild_index()

    # ------------------------------------------------------------------
    def ngram(self, context: str | list[str]) -> dict[str, int]:
        """Successor counts after ``context`` (the reference decoder's
        word-transition candidates, ``Decoder.py:151-155``).  Indexed:
        O(#successors), not a scan of the whole k-gram store."""
        if isinstance(context, str):
            context = context.split()
        context = context[-(self.n - 1):] if self.n > 1 else []
        prefix = " ".join(context)
        k = len(context) + 1
        if k > self.n:
            return {}
        return {
            w: c
            for w, c in self._succ[k - 1].get(prefix, {}).items()
            if w != BOS
        }

    def logprob(self, word: str, context: list[str] | None = None) -> float:
        """log10 P(word | context), interpolated with lower orders; add-1
        floor at the unigram level."""
        context = list(context or [])[-(self.n - 1):]
        v = max(len(self.vocab), 1)

        def order_prob(ctx: list[str]) -> float:
            if not ctx:
                c = self.counts[0].get(word, 0)
                return (c + 1.0) / (self.total_unigrams + v)
            key_den = " ".join(ctx)
            key_num = key_den + " " + word
            den = self.counts[len(ctx) - 1].get(key_den, 0)
            num = self.counts[len(ctx)].get(key_num, 0)
            if den == 0:
                return 0.0
            return num / den

        p = order_prob([])
        if self.smoothing == "wb":
            for k in range(1, len(context) + 1):
                ctx = context[-k:]
                prefix = " ".join(ctx)
                den = self.counts[k - 1].get(prefix, 0)
                if den == 0:
                    continue  # unseen history: full backoff, no penalty
                # successors of a k-word prefix live in _succ[k]
                # (context is clipped to n-1 words, so k <= n-1)
                distinct = len(self._succ[k].get(prefix, {}))
                lam_k = den / (den + max(distinct, 1))
                p = lam_k * order_prob(ctx) + (1 - lam_k) * p
        else:
            lam = self.lambda_interp
            for k in range(1, len(context) + 1):
                pk = order_prob(context[-k:])
                p = lam * pk + (1 - lam) * p if pk > 0 else (1 - lam) * p
        return math.log10(max(p, 1e-12))

    # ------------------------------------------------------------------
    # Vectorized decoder tables
    # ------------------------------------------------------------------

    def bigram_tables(self, vocab: list[str]):
        """Sparse bigram scores over ``vocab``, built in
        O(#observed bigrams + V) — numerically identical to per-pair
        :meth:`logprob` calls (property-tested).

        :returns: ``(uni, base, rows, cols, vals)`` — all log10:
            ``uni[q] = logprob(vocab[q], [])``;
            ``base[q] = logprob(vocab[q], [p])`` for any unobserved
            bigram (independent of ``p``: JM interpolation backs off to
            ``(1-λ)·P_uni``);
            ``(rows, cols, vals)`` the observed-bigram corrections,
            ``vals[i] = logprob(vocab[cols[i]], [vocab[rows[i]]])``.
        """
        if self.smoothing != "jm":
            raise ValueError(
                "bigram_tables requires smoothing='jm' (its backoff "
                "column is context-independent); 'wb' LMs are for "
                "rescoring (decoder/rescore.py)")
        v = max(len(self.vocab), 1)
        lam = self.lambda_interp
        c1 = np.array(
            [self.counts[0].get(w, 0) for w in vocab], dtype=np.float64
        )
        uni_p = (c1 + 1.0) / (self.total_unigrams + v)
        uni = np.log10(np.maximum(uni_p, 1e-12))
        base = np.log10(np.maximum((1 - lam) * uni_p, 1e-12))
        rows_l: list[int] = []
        cols_l: list[int] = []
        vals_l: list[float] = []
        if self.n >= 2:
            index = {w: i for i, w in enumerate(vocab)}
            for prefix, succ in self._succ[1].items():
                p_idx = index.get(prefix)
                if p_idx is None:
                    continue
                den = self.counts[0].get(prefix, 0)
                if den == 0:
                    continue
                for word, num in succ.items():
                    q_idx = index.get(word)
                    if q_idx is None or num == 0:
                        continue
                    p = lam * (num / den) + (1 - lam) * uni_p[q_idx]
                    rows_l.append(p_idx)
                    cols_l.append(q_idx)
                    vals_l.append(math.log10(max(p, 1e-12)))
        return (
            uni,
            base,
            np.asarray(rows_l, np.int64),
            np.asarray(cols_l, np.int64),
            np.asarray(vals_l, np.float64),
        )

    def bigram_tables_backoff(self, vocab: list[str]):
        """Sparse bigram scores over ``vocab`` in the per-row-backoff
        form the device decoder gathers from: an unseen pair (p, q)
        scores ``row_boff[p] + col_base[q]`` (one extra static-index
        gather per lookup), which is expressive enough for both
        smoothing modes:

        * ``'jm'``  — ``row_boff = 0``, ``col_base[q] =
          log10((1-λ)·P_uni(q))`` (the context-independent backoff
          column of :meth:`bigram_tables`);
        * ``'wb'``  — Witten-Bell per-context weights
          ``λ_p = c(p) / (c(p) + distinct_successors(p))``:
          ``row_boff[p] = log10(1-λ_p)`` (0 for unseen contexts, full
          backoff), ``col_base[q] = log10(P_uni(q))``.

        This is what lets the measurably better WB LM attach to the
        first-pass decoder (the reference builds an Ngram per order for
        exactly that use, ``Decoder.py:201-204``); previously 'wb' was
        rescoring-only (ROADMAP r04 item 3).

        :returns: ``(uni, row_boff, col_base, rows, cols, vals)`` — all
            log10; ``uni[q] = logprob(vocab[q], [])`` (the no-previous-
            word row); ``(rows, cols, vals)`` the observed-bigram
            corrections, numerically identical to per-pair
            :meth:`logprob` calls (property-tested).
        """
        v = max(len(self.vocab), 1)
        c1 = np.array(
            [self.counts[0].get(w, 0) for w in vocab], dtype=np.float64
        )
        uni_p = (c1 + 1.0) / (self.total_unigrams + v)
        uni = np.log10(np.maximum(uni_p, 1e-12))
        n_v = len(vocab)
        row_boff = np.zeros(n_v, np.float64)
        if self.smoothing == "jm":
            lam_of = np.full(n_v, self.lambda_interp)
            col_base = np.log10(
                np.maximum((1 - self.lambda_interp) * uni_p, 1e-12))
        else:  # wb
            col_base = uni.copy()
            lam_of = np.zeros(n_v, np.float64)
            for i, w in enumerate(vocab):
                den = self.counts[0].get(w, 0)
                if den == 0:
                    continue  # unseen history: full backoff, no penalty
                distinct = len(self._succ[1].get(w, {})) if self.n >= 2 \
                    else 0
                lam = den / (den + max(distinct, 1))
                lam_of[i] = lam
                row_boff[i] = math.log10(max(1.0 - lam, 1e-12))
        rows_l: list[int] = []
        cols_l: list[int] = []
        vals_l: list[float] = []
        if self.n >= 2:
            index = {w: i for i, w in enumerate(vocab)}
            for prefix, succ in self._succ[1].items():
                p_idx = index.get(prefix)
                if p_idx is None:
                    continue
                den = self.counts[0].get(prefix, 0)
                if den == 0:
                    continue
                lam = lam_of[p_idx]
                for word, num in succ.items():
                    q_idx = index.get(word)
                    if q_idx is None or num == 0:
                        continue
                    p = lam * (num / den) + (1 - lam) * uni_p[q_idx]
                    rows_l.append(p_idx)
                    cols_l.append(q_idx)
                    vals_l.append(math.log10(max(p, 1e-12)))
        return (
            uni,
            row_boff,
            col_base,
            np.asarray(rows_l, np.int64),
            np.asarray(cols_l, np.int64),
            np.asarray(vals_l, np.float64),
        )

    def bigram_matrix(self, vocab: list[str]) -> np.ndarray:
        """Dense ``[V+1, V]`` decoder LM table (row ``V`` = no-previous-
        word unigram row), materialized from
        :meth:`bigram_tables_backoff` — outer-sum the row/column backoff
        then scatter the observed bigrams.  Works for both smoothing
        modes; for very large vocabularies prefer the sparse form."""
        v_sz = len(vocab)
        uni, row_boff, col_base, rows, cols, vals = \
            self.bigram_tables_backoff(vocab)
        tab = np.empty((v_sz + 1, v_sz))
        tab[:v_sz] = row_boff[:, None] + col_base[None, :]
        tab[rows, cols] = vals
        tab[v_sz] = uni
        return tab

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "n": self.n,
                    # smoothing config must round-trip: a WB LM loaded
                    # into a default Ngram() would otherwise silently
                    # score with JM (same counts, different backoff)
                    "smoothing": self.smoothing,
                    "lambda_interp": self.lambda_interp,
                    "counts": [dict(c) for c in self.counts],
                    "vocab": sorted(self.vocab),
                },
                f,
            )

    def init_gram(self, path: str) -> None:
        """Load persisted counts (the reference's ``init_gram`` call
        surface, ``Decoder.py:201-204``)."""
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path) as f:
            data = json.load(f)
        self.n = data["n"]
        # older files predate the smoothing fields; keep their behavior
        # (constructor defaults) rather than guessing
        self.smoothing = data.get("smoothing", self.smoothing)
        self.lambda_interp = data.get("lambda_interp", self.lambda_interp)
        self.counts = [defaultdict(int, c) for c in data["counts"]]
        self.vocab = set(data["vocab"])
        self.total_unigrams = sum(self.counts[0].values())
        self._rebuild_index()
