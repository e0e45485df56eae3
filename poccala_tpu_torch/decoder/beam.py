"""Decoder base: hypotheses and the per-node HMM tables (the part of
``poccala_tpu/decoder/beam.py`` the device decoder needs — ``Hypothesis``,
the ``BeamDecoder`` constructor and ``_build_node_tables``, copied as host
code because that module imports the JAX scorer).

Each lexicon-tree node's acoustic model is the two-unit (initial+final)
embedded HMM of its syllable (``Token.__init__``, ``Decoder.py:224-237``),
stored as a banded transition table ``[n_nodes, n_tok_states, W]`` and a
senone map ``[n_nodes, n_tok_states]``.  The host token-passing tiers
(dict and vectorized) wait for a later port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from poccala_tpu_torch.lexicon.lexicon import FlatLexicon
from poccala_tpu_torch.models.senone_bank import SenoneBank
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
