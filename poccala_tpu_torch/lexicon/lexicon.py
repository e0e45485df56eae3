"""Pronunciation lexicon: prefix tree + flat arrayized form for decoding.

Host code copied from ``poccala_tpu/lexicon/lexicon.py`` (the JAX package's
import chain for it loads jax); ``tests/test_torch_lexicon.py`` pins the
copy to the original.

Reimplements ``Lexicon/PronunciationLexicon.py:24-94``: a nested-dict
prefix tree whose first level is keyed by the first syllable's initial
phoneme, deeper levels by full ``"initial,final+tone"`` syllables, with
``'word'`` leaf lists — built from word lists via the G2P, pickled for
reuse.

For TPU decoding the tree is additionally flattened
(:class:`FlatLexicon`) into integer arrays (SURVEY.md §7 step 7): CSR
child lists, per-node syllable unit pairs (ids into the acoustic unit
inventory), and per-node word lists — so the beam decoder indexes arcs
with array ops instead of dict walks.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field

import numpy as np

from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon.pinyin import PinYin


class PronunciationLexicon:
    """The reference-compatible nested-dict lexicon."""

    def __init__(self):
        self.lexicon: dict = {}
        self.size = 0

    # ------------------------------------------------------------------
    def generate(self, words: list[str], pinyin: PinYin | None = None) -> None:
        """Build the tree from a word list (``generate_lexicon``,
        ``PronunciationLexicon.py:45-77``): first level keyed by the
        first syllable's initial, nested levels by full syllables; words
        attach at their final node under ``'word'``."""
        pinyin = pinyin or PinYin()
        for word in words:
            p = pinyin.word2pinyin(word)
            if p is None:
                continue
            self.size += 1
            for reading in p[0]:
                initial = reading.split(",")[0]
                first_level = self.lexicon.setdefault(initial, {})
                node = first_level.setdefault(reading, {})
                self._create_tree(node, p[1:], 0, word)

    def _create_tree(self, node: dict, p: list, row: int, word: str) -> None:
        """``__create_tree`` (``PronunciationLexicon.py:79-94``)."""
        if row == len(p):
            node.setdefault("word", [])
            if word not in node["word"]:
                node["word"].append(word)
            return
        for reading in p[row]:
            child = node.setdefault(reading, {})
            self._create_tree(child, p, row + 1, word)

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.lexicon, f, protocol=pickle.HIGHEST_PROTOCOL)

    def load(self, path: str) -> None:
        """``init_lexicon`` (``PronunciationLexicon.py:29-39``)."""
        with open(path, "rb") as f:
            self.lexicon = pickle.load(f)


@dataclass
class FlatLexicon:
    """Array form of the lexicon tree for batched decoding.

    Node 0 is the virtual root.  Each non-root node carries one syllable
    = (initial unit id, final unit id) against the acoustic inventory.
    """

    child_ptr: np.ndarray      # [n_nodes + 1] CSR offsets into child_ids
    child_ids: np.ndarray      # [n_arcs] child node ids
    node_units: np.ndarray     # [n_nodes, 2] (initial id, final id); -1 at root
    node_syllable: list[str]   # [n_nodes] syllable labels ("" at root)
    node_words: list[list[str]]  # [n_nodes] words completing at the node

    @property
    def n_nodes(self) -> int:
        return len(self.node_syllable)

    def children(self, node: int) -> np.ndarray:
        return self.child_ids[self.child_ptr[node]: self.child_ptr[node + 1]]

    @classmethod
    def from_tree(cls, lexicon: dict, inventory: UnitInventory) -> "FlatLexicon":
        """Flatten the nested-dict tree.  Syllables whose units are
        missing from the acoustic inventory are skipped (with their
        subtrees)."""
        node_units: list[tuple[int, int]] = [(-1, -1)]
        node_syllable: list[str] = [""]
        node_words: list[list[str]] = [[]]
        children: list[list[int]] = [[]]

        def add_node(syllable: str) -> int | None:
            parts = syllable.split(",")
            if len(parts) != 2:
                return None
            ini, fin = parts
            if ini not in inventory.id_of or fin not in inventory.id_of:
                return None
            node_units.append((inventory.id_of[ini], inventory.id_of[fin]))
            node_syllable.append(syllable)
            node_words.append([])
            children.append([])
            return len(node_syllable) - 1

        def walk(subtree: dict, parent: int) -> None:
            for key, value in subtree.items():
                if key == "word":
                    node_words[parent] = list(value)
                    continue
                nid = add_node(key)
                if nid is None:
                    continue
                children[parent].append(nid)
                walk(value, nid)

        # first level: {initial: {syllable: subtree}} (PronunciationLexicon.py:64-70)
        for initial, syllables in lexicon.items():
            for syllable, subtree in syllables.items():
                nid = add_node(syllable)
                if nid is None:
                    continue
                children[0].append(nid)
                walk(subtree, nid)

        ptr = np.zeros(len(children) + 1, np.int32)
        for i, c in enumerate(children):
            ptr[i + 1] = ptr[i] + len(c)
        ids = np.concatenate([np.asarray(c, np.int32) for c in children]) \
            if ptr[-1] else np.zeros(0, np.int32)
        return cls(
            child_ptr=ptr,
            child_ids=ids,
            node_units=np.asarray(node_units, np.int32),
            node_syllable=node_syllable,
            node_words=node_words,
        )
