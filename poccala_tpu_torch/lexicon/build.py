"""Large lexicons for decoding at scale (port of
``poccala_tpu/lexicon/build.py``).

:func:`build_reference_lexicon` and :func:`reference_words` are copied
from the JAX module (its import chain loads jax;
``tests/test_torch_lexicon.py`` pins the copies): a deterministic
multi-thousand-word vocabulary straight from the reference's hanzi→pinyin
table ``Mandarin.dat`` — every single-hanzi word plus two-hanzi compounds
over a seeded pairing — so decoding exercises a tree at the scale the
reference designed for.

:func:`synthetic_lexicon` stands in while ``Mandarin.dat`` is not in the
repository.  It is test and benchmark scaffolding, not a feature: every
two-character word over the built-in G2P table, plus seeded
three-character words until the tree has at least ``min_nodes`` nodes
(21,588 by default, the full-vocabulary node count of
``benchmarks/decode_fullvocab.json``).
"""

from __future__ import annotations

import os

import numpy as np

from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon.builtin_table import BUILTIN_PINYIN
from poccala_tpu_torch.lexicon.lexicon import FlatLexicon, PronunciationLexicon
from poccala_tpu_torch.lexicon.pinyin import PinYin, load_mandarin_dat

# the table inside a checkout of the reference tree, named by the
# POCCALA_REFERENCE environment variable (default: ./reference)
DEFAULT_DAT = os.path.join(os.environ.get("POCCALA_REFERENCE", "reference"),
                           "Lexicon", "Mandarin.dat")
FULL_VOCAB_NODES = 21_588


def reference_words(
    dat_path: str = DEFAULT_DAT,
    n_single: int = 2500,
    n_multi: int = 1500,
    seed: int = 0,
) -> tuple[list[str], PinYin]:
    """A deterministic word list over the reference table: the first
    ``n_single`` transliterable hanzi (by codepoint order) as
    single-character words, plus ``n_multi`` two-character compounds
    from a seeded pairing.  Returns ``(words, PinYin over the table)``."""
    table = load_mandarin_dat(dat_path)
    py = PinYin(table)
    chars = [c for c in sorted(table.keys()) if py.word2pinyin(c)]
    singles = chars[:n_single]
    rng = np.random.default_rng(seed)
    pool = np.asarray(chars)
    pairs = rng.integers(0, len(pool), size=(n_multi, 2))
    multi = ["".join(pool[p] for p in pair) for pair in pairs]
    return singles + multi, py


def build_reference_lexicon(
    inventory: UnitInventory,
    dat_path: str = DEFAULT_DAT,
    n_single: int = 2500,
    n_multi: int = 1500,
    seed: int = 0,
) -> tuple[FlatLexicon, list[str], PinYin]:
    """Word list → prefix tree → :class:`FlatLexicon` against
    ``inventory`` (syllables with units outside the inventory are
    dropped by ``FlatLexicon.from_tree``)."""
    words, py = reference_words(dat_path, n_single, n_multi, seed)
    lex = PronunciationLexicon()
    lex.generate(words, py)
    flat = FlatLexicon.from_tree(lex.lexicon, inventory)
    return flat, words, py


def synthetic_lexicon(
    inventory: UnitInventory,
    min_nodes: int = FULL_VOCAB_NODES,
    n_chars: int | None = None,
    seed: int = 0,
) -> tuple[FlatLexicon, list[str], PinYin]:
    """Test and benchmark scaffolding for a large lexicon tree: every
    two-character word over the first ``n_chars`` characters of the
    built-in G2P table (all 122 by default: 14,884 words, 15,501 nodes
    against XIF_tone), then three-character words drawn from
    ``np.random.default_rng(seed)`` until the flattened tree has at least
    ``min_nodes`` nodes.  Returns ``(flat, words, PinYin)``, as
    :func:`build_reference_lexicon` does."""
    py = PinYin()
    chars = list(BUILTIN_PINYIN)[:n_chars]
    words = [a + b for a in chars for b in chars]
    lex = PronunciationLexicon()
    lex.generate(words, py)
    flat = FlatLexicon.from_tree(lex.lexicon, inventory)
    rng = np.random.default_rng(seed)
    seen = set(words)
    capacity = len(chars) ** 2 + len(chars) ** 3
    while flat.n_nodes < min_nodes and len(seen) < capacity:
        # a new three-character word adds at most one node per reading of
        # its last character; half the shortfall per pass rarely overshoots
        want = max(1, (min_nodes - flat.n_nodes) // 2)
        batch = []
        while len(batch) < want and len(seen) < capacity:
            w = "".join(rng.choice(chars, size=3))
            if w not in seen:
                seen.add(w)
                batch.append(w)
        lex.generate(batch, py)
        words += batch
        flat = FlatLexicon.from_tree(lex.lexicon, inventory)
    return flat, words, py
