"""A configuration made real: vocabulary, lexicon tree, state tying and a
GMM-HMM bank, all from the configuration's file and the run's seed.

These are inputs.  The benchmark makes them and hands the same to the
program under test and to the plain reference; neither side makes them
for the other.  The vocabulary and the lexicon tree are fixed by the
configuration (``lexicon.vocab_seed``); the tying of a context-dependent
configuration and every weight come from the run's seed, the weights on
the device in a few large calls.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEG_INF = -1e30          # the program's sentinel for an impossible log-score
SIL = "sil"


@dataclass
class Lexicon:
    """The decode graph: a prefix tree whose nodes are syllables (two bank
    units each).  Node 0 is the virtual root."""

    node_units: np.ndarray   # [N, 2] int32 bank-unit ids; -1 at the root
    parent: np.ndarray       # [N] int64; 0 for first-level nodes, -1 at root
    word_node: np.ndarray    # [V] int64, the node each word ends at

    @property
    def n_nodes(self) -> int:
        return len(self.parent)


def build_tree(word_units: list[np.ndarray]) -> Lexicon:
    """The prefix tree over words given as bank-unit id sequences (two
    units a syllable); two words share a node when their syllables up to
    it are equal."""
    key_of: dict = {}
    node_units = [(-1, -1)]
    parent = [-1]
    word_node = np.zeros(len(word_units), np.int64)
    for v, units in enumerate(word_units):
        at = 0
        for i in range(0, len(units), 2):
            k = (at, int(units[i]), int(units[i + 1]))
            nid = key_of.get(k)
            if nid is None:
                nid = key_of[k] = len(parent)
                node_units.append((k[1], k[2]))
                parent.append(at)
            at = nid
        word_node[v] = at
    return Lexicon(np.asarray(node_units, np.int32),
                   np.asarray(parent, np.int64), word_node)


@dataclass
class Model:
    """One configuration's structure (no weights)."""

    cfg: dict
    n_base: int                  # base (context-independent) units
    unit_base: np.ndarray        # [U] base unit of each bank unit
    senone_map: np.ndarray       # [U, emit] int32
    word_units: list             # per word: bank-unit ids, two a syllable
    lexicon: Lexicon
    sil_unit: int | None         # bank unit of the silence model

    @property
    def n_units(self) -> int:
        return len(self.unit_base)

    @property
    def n_senones(self) -> int:
        return int(self.senone_map.max()) + 1

    @property
    def emit(self) -> int:
        return self.cfg["state_num"] - 2


def _vocabulary(lex: dict, n_initials: int, n_finals: int) -> list:
    """Words as tuples of base-unit ids: ``syllables`` (initial, final)
    pairs drawn once; then every two-syllable word and three-syllable
    words until the tree has ``min_nodes`` nodes, or ``words`` distinct
    two-syllable words."""
    rng = np.random.default_rng(lex["vocab_seed"])
    pick = rng.choice(n_initials * n_finals, lex["syllables"], replace=False)
    syl = [(int(p // n_finals), n_initials + int(p % n_finals)) for p in pick]
    n = len(syl)
    if "min_nodes" in lex:
        words = [syl[a] + syl[b] for a in range(n) for b in range(n)]
        have = set(range(n * n))
        nodes = 1 + n + n * n
        while nodes < lex["min_nodes"]:
            a, b, c = (int(x) for x in rng.integers(0, n, 3))
            if (a, b, c) not in have:
                have.add((a, b, c))
                words.append(syl[a] + syl[b] + syl[c])
                nodes += 1
        return words
    drawn = set()
    words = []
    while len(words) < lex["words"]:
        a, b = (int(x) for x in rng.integers(0, n, 2))
        if (a, b) not in drawn:
            drawn.add((a, b))
            words.append(syl[a] + syl[b])
    return words


def _tie(unit_base: np.ndarray, emit: int, n_senones: int,
         rng: np.random.Generator) -> np.ndarray:
    """Tie the context-dependent units' states into ``n_senones`` senones,
    as a phonetic tree does: states tie only within one (base unit,
    position); every such group gets a leaf, the rest of the leaves go to
    the groups by their size, and members go to leaves at random."""
    keys = unit_base[:, None] * emit + np.arange(emit)[None]
    groups, inv = np.unique(keys.reshape(-1), return_inverse=True)
    size = np.bincount(inv)
    extra = n_senones - len(groups)
    if extra < 0 or extra > int((size - 1).sum()):
        raise ValueError(f"cannot tie {keys.size} states into {n_senones}")
    share = extra * (size - 1) / max(int((size - 1).sum()), 1)
    alloc = np.floor(share).astype(np.int64)
    left = extra - int(alloc.sum())
    alloc[np.argsort(-(share - alloc), kind="stable")[:left]] += 1
    leaves = 1 + alloc
    first = np.concatenate([[0], np.cumsum(leaves)[:-1]])
    out = np.zeros(keys.size, np.int64)
    for g in range(len(groups)):
        members = rng.permutation(np.nonzero(inv == g)[0])
        out[members] = first[g] + np.arange(len(members)) % leaves[g]
    return out.reshape(keys.shape).astype(np.int32)


def build_model(cfg: dict, seed: int) -> Model:
    """The configuration's units, vocabulary, tree and (context-dependent)
    tying; the tying draws from ``seed``."""
    u = cfg["units"]
    n_i, n_f = u["initials"], u["finals"]
    n_base = n_i + n_f + (1 if u.get("silence") else 0)
    emit = cfg["state_num"] - 2
    words = _vocabulary(cfg["lexicon"], n_i, n_f)
    if u.get("context") == "within_word_triples":
        sil = n_i + n_f
        triples = {(-1, sil, -1): 0}
        word_units = []
        for w in words:
            ids = []
            for i, b in enumerate(w):
                t = (w[i - 1] if i else -1, b, w[i + 1] if i + 1 < len(w) else -1)
                ids.append(triples.setdefault(t, len(triples)))
            word_units.append(np.asarray(ids, np.int64))
        unit_base = np.asarray([t[1] for t in triples], np.int64)
        rng = np.random.default_rng([seed, 1])
        senone_map = _tie(unit_base, emit, cfg["senones"], rng)
        sil_unit = 0
    else:
        word_units = [np.asarray(w, np.int64) for w in words]
        unit_base = np.arange(n_base, dtype=np.int64)
        senone_map = (unit_base[:, None] * emit
                      + np.arange(emit)[None]).astype(np.int32)
        sil_unit = None
    return Model(cfg, n_base, unit_base, senone_map, word_units,
                 build_tree(word_units), sil_unit)


def make_bank(model: Model, seed: int, device) -> dict:
    """The generating bank, drawn from ``seed`` on ``device``: means
    N(0, 1), variances U(0.5, 1.5), mixture weights a softmax of
    N(0, 0.25), and a left-to-right transition matrix a base unit (self
    loop U(0.4, 0.8)) that its context-dependent units share.  Arrays
    in the program's layout (``NEG_INF`` for impossible)."""
    cfg = model.cfg
    n, m, d = cfg["state_num"], cfg["mixtures"], cfg["dim"]
    s = model.n_senones
    g = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)
    means = torch.randn((s, m, d), generator=g, **f32)
    log_var = torch.log(torch.rand((s, m, d), generator=g, **f32) + 0.5)
    log_w = torch.log_softmax(
        0.5 * torch.randn((s, m), generator=g, **f32), dim=-1)
    stay = 0.4 + 0.4 * torch.rand((model.n_base, n - 2), generator=g, **f32)
    a = torch.full((model.n_base, n, n), NEG_INF, **f32)
    a[:, 0, 1] = 0.0
    rows = torch.arange(1, n - 1, device=device)
    a[:, rows, rows] = torch.log(stay)
    a[:, rows, rows + 1] = torch.log1p(-stay)
    ub = torch.as_tensor(model.unit_base, device=device)
    return dict(
        means=means, log_var=log_var, log_w=log_w, log_A=a[ub].contiguous(),
        log_pi=torch.full((model.n_units, n), -float(np.log(n)), **f32),
        mix_counts=torch.full((s,), m, dtype=torch.int32, device=device),
        senone_map=torch.as_tensor(model.senone_map, device=device))


def start_bank(model: Model, bank: dict, seed: int) -> dict:
    """The bank training starts from: the generating bank's means moved by
    N(0, 0.3²), its variances scaled by exp N(0, 0.3²), uniform mixture
    weights and the standard 0.5 / 0.5 transitions (the program's
    ``unit_transmat``), drawn from ``seed`` on the bank's device."""
    dev = bank["means"].device
    g = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x5EED)
    means = bank["means"] + 0.3 * torch.randn(bank["means"].shape,
                                              generator=g, device=dev)
    log_var = bank["log_var"] + 0.3 * torch.randn(bank["log_var"].shape,
                                                  generator=g, device=dev)
    m = bank["log_w"].shape[1]
    n = model.cfg["state_num"]
    a = torch.full_like(bank["log_A"], NEG_INF)
    a[:, 0, 1] = 0.0
    rows = torch.arange(1, n - 1, device=dev)
    a[:, rows, rows] = float(np.log(0.5))
    a[:, rows, rows + 1] = float(np.log(0.5))
    return dict(bank, means=means, log_var=log_var, log_A=a,
                log_w=torch.full_like(bank["log_w"], -float(np.log(m))))
