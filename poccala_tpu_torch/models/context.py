"""Context-dependent ("triphone-style") units with decision-tree tying
(port of ``poccala_tpu/models/context.py``: the host code is the
original's, so trees, sidecars and lexicons come out identical; the three
functions that build a bank go through :func:`senone_bank.replace` and keep
the input bank's device).

BASELINE config 3 reads "tied-state triphone-style units … ~2k senones".
The reference itself is strictly context-independent — its unit
inventory is the flat pinyin initial/final set loaded from the unit
files (``AcousticModel/AcousticModel.py:151-161``) and
every HMM is keyed by the bare unit name (``AcousticModel.py:164-226``)
— so this module is the capability that clause names but the reference
never built.  Design:

* a **CD unit** is a triple ``(left, unit, right)`` over the base
  (XIF_tone-style) inventory, with ``-1`` = word boundary.  Context is
  **within-word**: a word's unit sequence provides left/right neighbors
  for its interior units; word-edge units see the boundary marker.
  Units listed as *context-free* (the ``sil`` silence model) are always
  ``(-1, u, -1)`` and never appear as anyone's context (they break
  context like a boundary) — so training triples, where words may abut
  with or without an intervening pause, match decode triples exactly.
* **state tying** is one greedy phonetic decision tree per (base unit,
  emitting position), grown over the CD atoms of that pair with
  questions asked of the *left/right context* (the HTK ``QS``/``TB``
  recipe applied to contexts; question classes come from
  :func:`poccala_tpu_torch.models.questions.default_questions` on the base
  inventory, plus boundary questions).  Splits across all trees compete
  in one global priority queue, so ``target_senones`` is an exact
  budget, not a per-tree quota.  Every predicate is a deterministic
  function of the triple, so **unseen triples route down the trees**
  to a trained leaf — the standard back-off for contexts absent from
  training.
* the **CD bank** clones each leaf's GMM from the CI senone of its
  (base unit, position) — identical scores on day one, so the first
  CD forced alignment equals the CI alignment; Baum-Welch / scheme-1
  refits then differentiate leaves because each triple's frames scatter
  only onto its own leaf (``SenoneBank.senone_map`` keys every
  statistics scatter).

Everything downstream is unchanged: the bank's "unit" axis simply
becomes the CD-unit axis (``log_A``/``log_pi`` rows are copied from the
base unit), sentence HMMs build from CD label ids, and the decoder
consumes a lexicon whose node units are CD ids
(:func:`build_cd_lexicon`).
"""

from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field

import numpy as np
import torch

from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.models import questions as q_mod
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.models.senone_bank import SenoneBank

BOUNDARY = -1


# ----------------------------------------------------------------------
# CD inventory
# ----------------------------------------------------------------------

def word_triples(units: list[int]) -> list[tuple[int, int, int]]:
    """Within-word context expansion of one word's base-unit id
    sequence: interior units see their neighbors, edge units see the
    boundary marker."""
    n = len(units)
    return [
        (units[i - 1] if i > 0 else BOUNDARY,
         units[i],
         units[i + 1] if i < n - 1 else BOUNDARY)
        for i in range(n)
    ]


def reading_combos(py, word: str, id_of: dict, cap: int = 8):
    """All pronunciations of ``word`` as per-syllable ``[ini, fin]``
    base-unit id lists: the cross product of each character's readings
    (polyphones), deduplicated per syllable, capped at ``cap``
    combinations.  Readings that are not 2 units or use units outside
    ``id_of`` are dropped; returns ``[]`` when any syllable has no
    usable reading.  Shared by the CD lexicon compilers (CLI
    ``cd-expand`` and ``benchmarks/wer_run.py --cd``) so the measured
    system and the shipped one expand identically."""
    import itertools

    per_syl = py.units_of(word)
    if per_syl is None:
        return []
    per = []
    for readings in per_syl:
        opts, seen = [], set()
        for us in readings:
            if len(us) == 2 and all(u in id_of for u in us):
                o = (id_of[us[0]], id_of[us[1]])
                if o not in seen:
                    seen.add(o)
                    opts.append(o)
        if not opts:
            return []
        per.append(opts)
    return [[list(s) for s in c]
            for c in itertools.islice(itertools.product(*per), cap)]


@dataclass
class CDInventory:
    """The context-expanded unit set: seen/needed triples with id maps.

    :param base: the context-independent inventory the triples index
    :param triples: ``[n_cd, 3] int32`` — (left, unit, right) base ids,
        ``-1`` = boundary
    :param context_free: base ids that stay context-independent (e.g.
        the ``sil`` model) — registered as ``(-1, u, -1)`` and treated
        as boundaries by their neighbors
    """

    base: UnitInventory
    triples: np.ndarray
    context_free: frozenset = frozenset()
    id_of: dict = field(default_factory=dict)

    def __post_init__(self):
        self.id_of = {tuple(t): i for i, t in enumerate(self.triples)}
        self.base_of = self.triples[:, 1].astype(np.int32)

    def __len__(self):
        return len(self.triples)

    @classmethod
    def from_words(
        cls,
        word_unit_seqs: list[list[int]],
        base: UnitInventory,
        context_free: list[int] | None = None,
    ) -> "CDInventory":
        """Enumerate every triple any given word can produce, plus the
        context-free units.  Building from the *decode vocabulary*
        (a superset of the training words) guarantees training triples
        are registered; leaves for zero-occupancy triples are reached
        by tree routing and carry their (base, position) CI clone until
        data ever arrives."""
        cf = frozenset(context_free or ())
        seen: dict[tuple, None] = {}
        for u in sorted(cf):
            seen[(BOUNDARY, u, BOUNDARY)] = None
        for units in word_unit_seqs:
            units = list(units)
            if units and all(u in cf for u in units):
                continue  # all-context-free word (the <sil> filler)
            for t in word_triples(units):
                if t[1] in cf:
                    raise ValueError(
                        f"context-free unit {t[1]} inside a word")
                seen[t] = None
        arr = np.asarray(list(seen.keys()), np.int32).reshape(-1, 3)
        return cls(base=base, triples=arr, context_free=cf)

    def encode_word(self, units: list[int]) -> list[int]:
        """CI unit-id sequence of one word -> CD ids.  A word made
        entirely of context-free units (the ``<sil>`` filler) maps each
        unit to its ``(-1, u, -1)`` id; mixing is an error."""
        units = list(units)
        if all(u in self.context_free for u in units):
            return [self.id_of[(BOUNDARY, u, BOUNDARY)] for u in units]
        if any(u in self.context_free for u in units):
            raise ValueError("context-free unit inside a word")
        return [self.id_of[t] for t in word_triples(units)]


def expand_labels(
    labels: np.ndarray,
    label_lens: np.ndarray,
    word_unit_seqs: list[list[list[int]]],
    cd: CDInventory,
) -> np.ndarray:
    """CI label batch -> CD label batch.

    :param labels: ``[B, L]`` CI unit ids (the trainer's label format)
    :param word_unit_seqs: per utterance, the per-word CI unit id lists
        in transcript order (word boundaries are not recoverable from
        the flat label line when words abut without a pause, so the
        caller supplies them from the word-level transcript)
    :param cd: registered inventory; context-free units (``sil``) may
        appear between/around words in the label and pass through as
        their own CD id
    :returns: ``[B, L]`` CD unit ids (padding slots copied over)
    """
    labels = np.asarray(labels)
    out = labels.copy().astype(np.int32)
    cf_id = {u: cd.id_of[(BOUNDARY, u, BOUNDARY)] for u in cd.context_free}
    for b in range(len(labels)):
        i, n = 0, int(label_lens[b])
        words = list(word_unit_seqs[b])
        w = 0
        while i < n:
            u = int(labels[b, i])
            if u in cf_id:
                out[b, i] = cf_id[u]
                i += 1
                continue
            if w >= len(words):
                raise ValueError(
                    f"utterance {b}: label has units beyond its "
                    f"transcript's words at position {i}")
            units = list(words[w])
            # the last word may be truncated by the max_label_len cap
            # (Corpus._pack clips labels); contexts still come from the
            # full word, only the assignment stops at the label edge
            avail = min(len(units), n - i)
            got = labels[b, i: i + avail].tolist()
            if got != units[:avail]:
                raise ValueError(
                    f"utterance {b}: word {w} units {units} do not "
                    f"match label slice {got} at position {i}")
            cd_ids = cd.encode_word(units)
            for k in range(avail):
                out[b, i + k] = cd_ids[k]
            i += avail
            w += 1
    return out


# ----------------------------------------------------------------------
# Per-(triple, position) occupancy statistics from a CI alignment
# ----------------------------------------------------------------------

def collect_triple_stats(
    xs: np.ndarray,
    cd_labels: np.ndarray,
    label_pos: np.ndarray,
    n_cd: int,
    emit_states: int,
    utt_ok: np.ndarray | None = None,
):
    """Occupancy-weighted single-Gaussian statistics per (CD unit,
    emitting position) from a forced alignment — the tree-growing
    sufficient statistics.

    Frames of one aligned unit occurrence split equally over its
    emitting states, exactly like scheme-1 GMM data collection
    (``alignment.group_frames_by_senone``; reference ``__get_gmmdata``,
    ``AcousticModel.py:629-644``), so the trees see the same partition
    later training uses.

    :param xs: ``[B, T, D]`` features
    :param cd_labels: ``[B, L]`` CD label ids
    :param label_pos: ``[B, T]`` per-frame label position from
        :func:`poccala_tpu_torch.train.alignment.align_batch` (-1 = virtual)
    :returns: (occ ``[n_cd, E]``, mean ``[n_cd, E, D]``,
        ex2 ``[n_cd, E, D]`` — second raw moment)
    """
    b, t_pad, d = xs.shape
    lp = np.asarray(label_pos)
    ok = np.ones(b, bool) if utt_ok is None else np.asarray(utt_ok, bool)
    ui, ti = np.nonzero((lp >= 0) & ok[:, None])
    occ = np.zeros((n_cd, emit_states))
    s1 = np.zeros((n_cd, emit_states, d))
    s2 = np.zeros((n_cd, emit_states, d))
    if ui.size == 0:
        return occ, s1, s2
    pos = lp[ui, ti]
    new_run = np.ones(len(ui), bool)
    new_run[1:] = (ui[1:] != ui[:-1]) | (pos[1:] != pos[:-1])
    run_id = np.cumsum(new_run) - 1
    run_len = np.bincount(run_id)
    run_start = np.concatenate([[0], np.cumsum(run_len)[:-1]])
    pos_in_run = np.arange(len(ui)) - run_start[run_id]
    chunk = (run_len // emit_states)[run_id]
    e = np.where(
        chunk == 0,
        emit_states - 1,
        np.minimum(pos_in_run // np.maximum(chunk, 1), emit_states - 1),
    )
    cid = np.asarray(cd_labels)[ui, pos]
    key = cid * emit_states + e
    x = xs[ui, ti].astype(np.float64)
    n_key = n_cd * emit_states
    occ = np.bincount(key, minlength=n_key).astype(np.float64)
    s1 = np.zeros((n_key, d))
    s2 = np.zeros((n_key, d))
    np.add.at(s1, key, x)
    np.add.at(s2, key, x * x)
    occ = occ.reshape(n_cd, emit_states)
    denom = np.maximum(occ, 1e-12)[..., None]
    mean = s1.reshape(n_cd, emit_states, d) / denom
    ex2 = s2.reshape(n_cd, emit_states, d) / denom
    return occ, mean, ex2


class TripleStatsAccumulator:
    """Occupancy-weighted fold of :func:`collect_triple_stats` over
    batches (the tree-growing statistics, gathered corpus-wide)."""

    def __init__(self, n_cd: int, emit: int, dim: int):
        self.occ = np.zeros((n_cd, emit))
        self.mean = np.zeros((n_cd, emit, dim))
        self.ex2 = np.zeros((n_cd, emit, dim))

    def add(self, xs, cd_labels, label_pos, utt_ok=None) -> None:
        o, m, x2 = collect_triple_stats(
            xs, cd_labels, label_pos, self.occ.shape[0],
            self.occ.shape[1], utt_ok=utt_ok)
        tot = self.occ + o
        nz = tot > 0
        self.mean[nz] = ((self.mean * self.occ[..., None]
                          + m * o[..., None])[nz] / tot[nz][..., None])
        self.ex2[nz] = ((self.ex2 * self.occ[..., None]
                         + x2 * o[..., None])[nz] / tot[nz][..., None])
        self.occ = tot


# ----------------------------------------------------------------------
# Decision trees over contexts
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class ContextQuestion:
    """A deterministic predicate over triples: is the left (or right)
    context in a phonetic class / the word boundary?"""

    name: str
    side: int          # 0 = left, 2 = right (triple column)
    members: frozenset  # base ids answering yes; BOUNDARY handled below
    boundary: bool = False  # yes-set is exactly the boundary marker

    def answer(self, triple) -> bool:
        c = int(triple[self.side])
        if self.boundary:
            return c == BOUNDARY
        return c in self.members


def context_questions(base: UnitInventory) -> list[ContextQuestion]:
    """Left/right versions of the base phonetic question set, plus
    boundary questions.  Boundary contexts answer "no" to every class
    question (a class question splits {boundary, non-members} from
    members), matching HTK's treatment of word-edge triphones."""
    out = [
        ContextQuestion("L_boundary", 0, frozenset(), boundary=True),
        ContextQuestion("R_boundary", 2, frozenset(), boundary=True),
    ]
    for q in q_mod.default_questions(base.units):
        out.append(ContextQuestion(f"L_{q.name}", 0, q.members))
        out.append(ContextQuestion(f"R_{q.name}", 2, q.members))
    return out


@dataclass
class ContextTrees:
    """The grown trees: routing tables + audit trail.

    ``senone_of[cd_id, e]`` is the tied-senone routing for every
    registered triple; :meth:`route` answers for *unregistered* triples
    by walking the recorded splits (unseen-context back-off)."""

    senone_of: np.ndarray               # [n_cd, E] int32
    n_senones: int
    # per (base, e): list of (question, leaf_if_yes-subtree...) — stored
    # flat as nested dicts for routing; see _route_node
    nodes: dict                          # (base, e) -> node structure
    questions: list
    splits_log: list = field(default_factory=list)

    def route(self, triple, e: int) -> int:
        """Senone for any (possibly unseen) triple at position e."""
        node = self.nodes.get((int(triple[1]), e))
        if node is None:
            raise KeyError(f"no tree for base unit {triple[1]}")
        while isinstance(node, tuple):
            q_idx, yes_node, no_node = node
            node = yes_node if self.questions[q_idx].answer(triple) \
                else no_node
        return int(node)


def grow_context_trees(
    cd: CDInventory,
    occ: np.ndarray,
    mean: np.ndarray,
    ex2: np.ndarray,
    target_senones: int,
    min_occ: float = 8.0,
    min_gain: float = 0.0,
    var_floor: float = 1e-4,
) -> ContextTrees:
    """Grow all (base unit, position) trees with one global greedy
    queue: the split with the largest pooled-likelihood gain anywhere
    is applied next, until ``target_senones`` leaves exist or no split
    clears (``min_gain``, both-sides ``min_occ``).  The likelihood is
    the standard occupancy-weighted single-Gaussian objective
    (:func:`poccala_tpu_torch.models.tying._node_loglik`)."""
    from poccala_tpu_torch.models.tying import _node_loglik

    n_cd, e_num = occ.shape
    questions = context_questions(cd.base)
    triples = cd.triples

    # answers[a, q]: precomputed predicate matrix (atoms are triples)
    ans = np.zeros((n_cd, len(questions)), bool)
    for qi, q in enumerate(questions):
        if q.boundary:
            ans[:, qi] = triples[:, q.side] == BOUNDARY
        else:
            ans[:, qi] = np.isin(triples[:, q.side],
                                 np.fromiter(q.members, np.int64,
                                             len(q.members))
                                 if q.members else np.empty(0, np.int64))

    trees: dict[tuple, list] = {}
    leaves: list[list] = []   # leaf id -> [tree_key, atom ids, node ref]
    # tree node structure is built as we split: nodes[key] starts as a
    # leaf placeholder (int leaf idx) and becomes (q_idx, yes, no)
    heap: list = []
    counter = 0

    def leaf_stats(atoms, e):
        return _node_loglik(occ[:, e], mean[:, e], ex2[:, e], atoms,
                            var_floor)

    def best_split(atoms, e):
        """(gain, q_idx, yes_atoms, no_atoms) or None."""
        if len(atoms) < 2:
            return None
        l_parent, o_parent = leaf_stats(atoms, e)
        if o_parent < 2 * min_occ:
            return None
        best = None
        a_ans = ans[atoms]
        for qi in range(len(questions)):
            m = a_ans[:, qi]
            if not m.any() or m.all():
                continue
            yes, no = atoms[m], atoms[~m]
            l_yes, o_yes = leaf_stats(yes, e)
            l_no, o_no = leaf_stats(no, e)
            if o_yes < min_occ or o_no < min_occ:
                continue
            gain = l_yes + l_no - l_parent
            if gain > min_gain and (best is None or gain > best[0]):
                best = (gain, qi, yes, no)
        return best

    # roots: one per (base, e) over that base's triples
    for b in np.unique(triples[:, 1]):
        atoms_b = np.nonzero(triples[:, 1] == b)[0]
        for e in range(e_num):
            lid = len(leaves)
            leaves.append([(int(b), e), atoms_b, None])
            trees[(int(b), e)] = lid
            s = best_split(atoms_b, e)
            if s is not None:
                counter += 1
                heapq.heappush(heap, (-s[0], counter, lid, s))

    splits_log = []
    stale: set[int] = set()
    while len(leaves) - len(stale) < target_senones and heap:
        neg_gain, _, lid, (gain, qi, yes, no) = heapq.heappop(heap)
        if lid in stale:
            continue
        key, atoms, _ = leaves[lid]
        e = key[1]
        stale.add(lid)
        yid, nid = len(leaves), len(leaves) + 1
        leaves.append([key, yes, None])
        leaves.append([key, no, None])
        # rewrite the tree node: find + replace lid in the structure
        trees[key] = _replace_leaf(trees[key], lid, (qi, yid, nid))
        splits_log.append({
            "base": cd.base.units[key[0]], "position": e,
            "question": questions[qi].name, "gain": float(gain),
            "n_yes": int(len(yes)), "n_no": int(len(no)),
        })
        for nlid, natoms in ((yid, yes), (nid, no)):
            s = best_split(natoms, e)
            if s is not None:
                counter += 1
                heapq.heappush(heap, (-s[0], counter, nlid, s))

    # compact leaf ids -> senone ids
    live = [i for i in range(len(leaves)) if i not in stale]
    senone_id = {lid: si for si, lid in enumerate(live)}
    nodes = {k: _map_leaves(v, senone_id) for k, v in trees.items()}
    senone_of = np.zeros((n_cd, e_num), np.int32)
    tr = ContextTrees(senone_of=senone_of, n_senones=len(live),
                      nodes=nodes, questions=questions,
                      splits_log=splits_log)
    for i in range(n_cd):
        for e in range(e_num):
            senone_of[i, e] = tr.route(triples[i], e)
    return tr


def _replace_leaf(node, lid, repl):
    if isinstance(node, tuple):
        qi, y, n = node
        return (qi, _replace_leaf(y, lid, repl), _replace_leaf(n, lid, repl))
    return repl if node == lid else node


def _map_leaves(node, mapping):
    if isinstance(node, tuple):
        qi, y, n = node
        return (qi, _map_leaves(y, mapping), _map_leaves(n, mapping))
    return mapping[node]


# ----------------------------------------------------------------------
# CD bank construction
# ----------------------------------------------------------------------

def _ci_parent_of_leaves(ci_bank: SenoneBank, cd: CDInventory,
                         trees: ContextTrees) -> np.ndarray:
    """CI source senone of every tied leaf: for each leaf, the CI
    senone of the (base unit, position) of any triple routed to it —
    the clone source (`build_cd_bank`) and the MAP prior
    (`map_smooth_bank`) must agree on this derivation."""
    emit = ci_bank.emit_states
    s_new = trees.n_senones
    sen_of = np.asarray(trees.senone_of)
    ci_map = ci_bank.senone_map.cpu().numpy()
    src = np.zeros(s_new, np.int64)
    seen = np.zeros(s_new, bool)
    for i in range(len(cd)):
        b = int(cd.base_of[i])
        for e in range(emit):
            s = int(sen_of[i, e])
            if not seen[s]:
                src[s] = ci_map[b, e]
                seen[s] = True
    assert seen.all(), "unreachable tied senone"
    return src


def build_cd_bank(ci_bank: SenoneBank, cd: CDInventory,
                  trees: ContextTrees) -> SenoneBank:
    """Clone a CD bank from a trained CI bank: each tied senone starts
    as the CI senone of its (base unit, position); transition matrices
    and pi copy per base unit.  The clone scores identically to the CI
    model until retraining differentiates the leaves."""
    dev = ci_bank.means.device
    src = torch.as_tensor(_ci_parent_of_leaves(ci_bank, cd, trees),
                          device=dev)
    base_of = torch.as_tensor(cd.base_of.astype(np.int64), device=dev)
    return SenoneBank(
        means=ci_bank.means[src], log_var=ci_bank.log_var[src],
        log_w=ci_bank.log_w[src], log_A=ci_bank.log_A[base_of],
        log_pi=ci_bank.log_pi[base_of],
        mix_counts=ci_bank.mix_counts[src],
        senone_map=torch.as_tensor(trees.senone_of.astype(np.int32),
                                   device=dev),
    )


def cd_unit_names(cd: CDInventory) -> list[str]:
    """HTK-style display names for the CD unit axis: ``l-u+r`` with
    ``#`` for the word boundary (checkpoint unit lists, logs)."""
    base = cd.base.units
    out = []
    for l, u, r in cd.triples:
        ln = "#" if l == BOUNDARY else base[l]
        rn = "#" if r == BOUNDARY else base[r]
        out.append(f"{ln}-{base[u]}+{rn}")
    return out


def expand_labels_by_matching(
    labels: np.ndarray,
    label_lens: np.ndarray,
    word_lines: list[list[str]],
    combos_of: dict,
    cd: CDInventory,
):
    """CI label batch -> CD labels when per-word unit sequences are
    ambiguous (polyphonic readings): for each utterance walk the label,
    passing context-free units through, and match each transcript word
    against its reading combinations (first match wins — combinations
    share length, so matching is unambiguous per position).

    :param word_lines: per utterance, the word strings in order (the
        ``.trn`` word line)
    :param combos_of: word -> list of flattened CI unit-id sequences
    :returns: (cd_labels ``[B, L]``, ok ``[B]`` bool — utterances whose
        label could not be matched are flagged for exclusion)
    """
    labels = np.asarray(labels)
    out = labels.copy().astype(np.int32)
    ok = np.ones(len(labels), bool)
    cf_id = {u: cd.id_of[(BOUNDARY, u, BOUNDARY)] for u in cd.context_free}
    for b in range(len(labels)):
        i, n = 0, int(label_lens[b])
        words = list(word_lines[b])
        w = 0
        good = True
        while i < n and good:
            u = int(labels[b, i])
            if u in cf_id:
                out[b, i] = cf_id[u]
                i += 1
                continue
            if w >= len(words):
                good = False
                break
            matched = False
            for units in combos_of.get(words[w], ()):
                avail = min(len(units), n - i)
                if labels[b, i: i + avail].tolist() == \
                        list(units[:avail]):
                    cd_ids = cd.encode_word(list(units))
                    for k in range(avail):
                        out[b, i + k] = cd_ids[k]
                    i += avail
                    matched = True
                    break
            if not matched:
                good = False
                break
            w += 1
        ok[b] = good
    return out, ok


def cd_entries_from_flat(flat, max_entries_per_word: int = 64):
    """Recover ``(word, [per-syllable [ini, fin] CI unit ids])`` entries
    from a CI :class:`FlatLexicon` — every root-to-word-node path is
    one pronunciation.  This is how ``decode --cd`` reuses an existing
    CI lexicon pickle: the CD graph compiles from the same word set."""
    n = flat.n_nodes
    parent = np.full(n, -1, np.int64)
    for p in range(n):
        for c in flat.children(p):
            parent[c] = p
    entries = []
    count: dict[str, int] = {}
    for nid in range(1, n):
        for word in flat.node_words[nid]:
            if count.get(word, 0) >= max_entries_per_word:
                continue
            path = []
            at = nid
            while at > 0:
                path.append(at)
                at = int(parent[at])
            path.reverse()
            syls = [[int(flat.node_units[a][0]),
                     int(flat.node_units[a][1])] for a in path]
            entries.append((word, syls))
            count[word] = count.get(word, 0) + 1
    return entries


def map_smooth_bank(
    cd_bank: SenoneBank,
    ci_bank: SenoneBank,
    cd: CDInventory,
    trees: ContextTrees,
    occ: np.ndarray,
    tau: float = 64.0,
) -> SenoneBank:
    """MAP-smooth retrained CD leaves toward their CI parents (the
    standard HTK-style back-off for starved tied states): each leaf's
    GMM interpolates with the (base unit, position) CI senone it was
    cloned from, weighted ``w = n / (n + tau)`` by the leaf's aligned
    frame count — data-rich leaves keep their context-dependent fit,
    starved leaves shrink to the CI prior instead of over-fitting
    (measured failure: a 2,049-senone budget at 3,500 utts decodes
    WORSE than CI, ``WER_r05_cd2k.json``).

    Mixture components are blended slot-wise, which is justified
    because CD training refits by EM *from the clone* (no k-means
    re-seed on the CD path), so component correspondence with the
    parent is preserved.  Variances blend via second moments.

    :param occ: ``[n_cd, E]`` per-(triple, position) frame counts
        (``TripleStatsAccumulator.occ`` from the expansion alignment)
    :param tau: prior strength in frames (MAP relevance factor)
    """
    from poccala_tpu_torch.utils.logmath import masked_log

    s_cd = cd_bank.num_states
    sen_of = np.asarray(trees.senone_of)

    leaf_occ = np.zeros(s_cd)
    np.add.at(leaf_occ, sen_of.reshape(-1),
              np.asarray(occ, np.float64).reshape(-1))
    src = _ci_parent_of_leaves(ci_bank, cd, trees)

    w = (leaf_occ / (leaf_occ + float(tau))).astype(np.float32)
    w3 = w[:, None, None]
    cd_arrays, ci_arrays = sb.bank_to_numpy(cd_bank), sb.bank_to_numpy(ci_bank)
    m_cd = cd_arrays["means"]
    m_ci = ci_arrays["means"][src]
    v_cd = np.exp(cd_arrays["log_var"])
    v_ci = np.exp(ci_arrays["log_var"])[src]
    means = w3 * m_cd + (1 - w3) * m_ci
    ex2 = w3 * (v_cd + m_cd**2) + (1 - w3) * (v_ci + m_ci**2)
    var = np.maximum(ex2 - means**2, 1e-8)
    wt_cd = np.exp(cd_arrays["log_w"])
    wt_ci = np.exp(ci_arrays["log_w"])[src]
    wt = w[:, None] * wt_cd + (1 - w[:, None]) * wt_ci
    wt = wt / np.maximum(wt.sum(-1, keepdims=True), 1e-10)
    dev = cd_bank.means.device
    return sb.replace(
        cd_bank,
        means=torch.as_tensor(means.astype(np.float32), device=dev),
        log_var=torch.as_tensor(np.log(var).astype(np.float32), device=dev),
        log_w=masked_log(torch.as_tensor(wt.astype(np.float32), device=dev)),
    )


def filter_routable_entries(cd: CDInventory, trees: ContextTrees,
                            entries):
    """Split lexicon entries into (routable, skipped_words): a word is
    routable when every base unit it uses owns a tying tree (i.e.
    occurred somewhere in the cd-expand vocabulary) or is context-free.
    Unroutable words cannot get senones and must be dropped with a
    warning rather than crash decode startup."""
    known = {b for b, _ in trees.nodes} | set(cd.context_free)
    good, skipped = [], []
    for word, syls in entries:
        units = [u for s in syls for u in s]
        if all(u in known for u in units):
            good.append((word, syls))
        else:
            skipped.append(word)
    return good, skipped


def extend_for_lexicon(cd: CDInventory, trees: ContextTrees,
                       bank: SenoneBank, entries):
    """Register any lexicon triples the training expansion never saw
    and grow the bank's per-unit tables to match (decode-time back-off
    for out-of-expansion words): the new unit's senones come from tree
    routing (shared, trained leaves), its transitions/pi from an
    existing CD unit of the same base (or uniform-topology fallback).

    GMM tensors are untouched — only ``log_A``/``log_pi``/``senone_map``
    rows append.  Returns (cd', trees', bank'); inputs are not
    mutated."""
    emit = bank.emit_states
    seen = set(map(tuple, cd.triples.tolist()))
    missing: list[tuple] = []
    for _, syls in entries:
        units = [u for s in syls for u in s]
        if all(u in cd.context_free for u in units):
            continue
        for t in word_triples(units):
            if t not in seen:
                seen.add(t)
                missing.append(t)
    if not missing:
        return cd, trees, bank
    miss = np.asarray(missing, np.int32)
    new_triples = np.concatenate([cd.triples, miss], axis=0)
    cd2 = CDInventory(base=cd.base, triples=new_triples,
                      context_free=cd.context_free)
    add_map = np.asarray(
        [[trees.route(t, e) for e in range(emit)] for t in missing],
        np.int32)
    trees2 = dataclasses.replace(
        trees,
        senone_of=np.concatenate([trees.senone_of, add_map], axis=0))
    # transition/pi rows: borrow the first existing CD unit of the same
    # base (its retrained topology is the closest available)
    base_of = np.asarray(cd.triples[:, 1])
    first_of_base = {}
    for i, b in enumerate(base_of):
        first_of_base.setdefault(int(b), i)
    dev = bank.log_A.device
    src = torch.as_tensor(
        [first_of_base.get(int(t[1]), 0) for t in missing], device=dev)
    log_a = torch.cat([bank.log_A, bank.log_A[src]], dim=0)
    log_pi = torch.cat([bank.log_pi, bank.log_pi[src]], dim=0)
    sen_map = torch.cat(
        [bank.senone_map, torch.as_tensor(add_map, device=dev)], dim=0)
    # the GMM tensors are the input bank's own (no copy): a scoring pack
    # cached on them stays valid
    bank2 = sb.replace(bank, log_A=log_a, log_pi=log_pi, senone_map=sen_map)
    return cd2, trees2, bank2


# ----------------------------------------------------------------------
# Persistence (a CD system = bank checkpoint + this sidecar)
# ----------------------------------------------------------------------

def save_cd(path: str, cd: CDInventory, trees: ContextTrees) -> None:
    """Persist the CD inventory + trees next to a bank checkpoint (the
    bank itself saves through ``train/checkpoint.py`` unchanged — its
    unit axis is simply the CD-unit axis).  Questions are stored by
    name and rebuilt against the base inventory on load, so the file
    carries no code."""
    import json

    def enc(node):
        if isinstance(node, tuple):
            qi, y, n = node
            return [qi, enc(y), enc(n)]
        return int(node)

    with open(path, "w") as f:
        json.dump({
            "base_units": list(cd.base.units),
            "context_free": sorted(int(u) for u in cd.context_free),
            "triples": np.asarray(cd.triples).tolist(),
            "senone_of": np.asarray(trees.senone_of).tolist(),
            "n_senones": int(trees.n_senones),
            "question_names": [q.name for q in trees.questions],
            "nodes": {f"{b},{e}": enc(v)
                      for (b, e), v in trees.nodes.items()},
            "splits_log": trees.splits_log,
        }, f)


def load_cd(path: str) -> tuple[CDInventory, ContextTrees]:
    import json

    with open(path) as f:
        d = json.load(f)
    base = UnitInventory(d["base_units"])
    cd = CDInventory(
        base=base,
        triples=np.asarray(d["triples"], np.int32),
        context_free=frozenset(d["context_free"]),
    )
    questions = context_questions(base)
    by_name = {q.name: i for i, q in enumerate(questions)}
    names = d["question_names"]
    # remap stored question indices in case the generated order moved
    remap = [by_name[n] for n in names]

    def dec(node):
        if isinstance(node, list):
            qi, y, n = node
            return (remap[qi], dec(y), dec(n))
        return int(node)

    nodes = {}
    for key, v in d["nodes"].items():
        b, e = key.split(",")
        nodes[(int(b), int(e))] = dec(v)
    trees = ContextTrees(
        senone_of=np.asarray(d["senone_of"], np.int32),
        n_senones=int(d["n_senones"]),
        nodes=nodes,
        questions=questions,
        splits_log=d.get("splits_log", []),
    )
    return cd, trees


# ----------------------------------------------------------------------
# CD lexicon
# ----------------------------------------------------------------------

def build_cd_lexicon(
    word_entries: list[tuple[str, list[list[int]]]],
    cd: CDInventory,
    sil_word: tuple[str, int] | None = None,
):
    """Compile the decode graph whose arcs key on (left, unit, right).

    Structure mirrors :class:`poccala_tpu_torch.lexicon.lexicon.FlatLexicon`
    (node = one syllable = two units, CSR children, per-node word
    lists) so every decoder tier consumes it unchanged — but node
    identity includes the *CD ids* of its units, so two words share a
    prefix node only when the full context matches (a node's final unit
    carries its right context = the next syllable's initial, so shared
    nodes agree on the continuation class by construction).

    :param word_entries: ``(word, [per-syllable [ini_id, fin_id]])`` —
        base-unit ids; syllables must be 2 units (the FlatLexicon node
        shape; the reference lexicon has the same property,
        ``PronunciationLexicon.py:79-94``)
    :param sil_word: optional ``(word_label, sil_base_id)`` filler —
        one node of the context-free silence unit twice, as in the
        flagship run's ``<sil>`` filler
    :returns: a :class:`FlatLexicon` whose ``node_units`` hold **CD**
        ids
    """
    from poccala_tpu_torch.lexicon.lexicon import FlatLexicon

    node_units: list[tuple[int, int]] = [(-1, -1)]
    node_syllable: list[str] = [""]
    node_words: list[list[str]] = [[]]
    children: list[list[int]] = [[]]
    # child key: (cd_ini, cd_fin) under a parent node
    key_of: dict[tuple[int, tuple[int, int]], int] = {}

    def child(parent: int, cd_ini: int, cd_fin: int, syl: str) -> int:
        k = (parent, (cd_ini, cd_fin))
        nid = key_of.get(k)
        if nid is None:
            node_units.append((cd_ini, cd_fin))
            node_syllable.append(syl)
            node_words.append([])
            children.append([])
            nid = len(node_syllable) - 1
            children[parent].append(nid)
            key_of[k] = nid
        return nid

    base_names = cd.base.units
    for word, syls in word_entries:
        units = [u for s in syls for u in s]
        if any(len(s) != 2 for s in syls):
            continue  # non 2-unit syllable: same skip as FlatLexicon
        cd_ids = cd.encode_word(units)
        at = 0
        for si, s in enumerate(syls):
            syl = f"{base_names[s[0]]},{base_names[s[1]]}"
            at = child(0 if si == 0 else at, cd_ids[2 * si],
                       cd_ids[2 * si + 1], syl)
        if word not in node_words[at]:
            node_words[at].append(word)

    if sil_word is not None:
        label, sid = sil_word
        cid = cd.id_of[(BOUNDARY, sid, BOUNDARY)]
        nid = child(0, cid, cid, f"{base_names[sid]},{base_names[sid]}")
        if label not in node_words[nid]:
            node_words[nid].append(label)

    ptr = np.zeros(len(children) + 1, np.int32)
    for i, c in enumerate(children):
        ptr[i + 1] = ptr[i] + len(c)
    ids = np.concatenate([np.asarray(c, np.int32) for c in children]) \
        if ptr[-1] else np.zeros(0, np.int32)
    return FlatLexicon(
        child_ptr=ptr,
        child_ids=ids,
        node_units=np.asarray(node_units, np.int32),
        node_syllable=node_syllable,
        node_words=node_words,
    )
