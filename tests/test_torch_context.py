"""Context-dependent units of the port (``poccala_tpu_torch.models.context``)
against the JAX package's (``poccala_tpu.models.context``) on the CPU, on
the cases of ``tests/test_context.py``.

The host parts (inventory, label expansion, float64 statistics, tree
growing, lexicon compilation, the sidecar) are held exactly: same triples,
same labels, statistics within 1e-12, the same trees split for split, the
same lexicon tables, and a sidecar written by either package read by both.
The three functions that build a bank are held on their arrays
(``build_cd_bank`` and ``extend_for_lexicon`` exactly, ``map_smooth_bank``
within 1e-6: float32 blends of the same float32 inputs).  The slice as a
whole is the pipeline of ``test_train_expand_retrain_decode`` through both
packages: the same trees, the retrain loglik within 1e-4 relative (two
float32 trainings, as ``tests/test_torch_trainer.py`` holds them), the same
decoded words.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.config import Config, ModelConfig
from poccala_tpu.decoder.device import DeviceBeamDecoder as JaxDecoder
from poccala_tpu.io import corpus as jcorpus
from poccala_tpu.lexicon.lexicon import FlatLexicon as JaxFlatLexicon
from poccala_tpu.models import context as jctx
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu.models import tying as jtying
from poccala_tpu.train import alignment as jalign
from poccala_tpu.train.trainer import Trainer as JaxTrainer
from poccala_tpu_torch.decoder.device import (DeviceBeamDecoder,
                                              check_context_fits)
from poccala_tpu_torch.io import corpus as tcorpus
from poccala_tpu_torch.lexicon.build import synthetic_lexicon
from poccala_tpu_torch.lexicon.lexicon import FlatLexicon
from poccala_tpu_torch.models import context as tctx
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.models import tying as ttying
from poccala_tpu_torch.ops.cuda import gmm_score_cuda
from poccala_tpu_torch.train import alignment as talign
from poccala_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

UNITS = ["b", "a1", "d", "e4", "m", "sil"]
CI_TREE = {
    "b": {"b,a1": {"word": ["ba"], "d,e4": {"word": ["bade"]}}},
    "d": {"d,e4": {"word": ["de"]}},
    "m": {"m,a1": {"word": ["ma"]}},
    "sil": {"sil,sil": {"word": ["<sil>"]}},
}


def inventories():
    return jcorpus.UnitInventory(UNITS), tcorpus.UnitInventory(UNITS)


def word_entries(inv):
    """ba, bade, de, ma as (word, per-syllable unit ids)."""
    i = inv.id_of
    return [("ba", [[i["b"], i["a1"]]]),
            ("bade", [[i["b"], i["a1"]], [i["d"], i["e4"]]]),
            ("de", [[i["d"], i["e4"]]]),
            ("ma", [[i["m"], i["a1"]]])]


def cd_pair():
    """The same CD inventory in both packages."""
    jinv, tinv = inventories()
    seqs = [[u for s in syls for u in s] for _, syls in word_entries(tinv)]
    sil = [tinv.id_of["sil"]]
    return (jctx.CDInventory.from_words(seqs, jinv, context_free=sil),
            tctx.CDInventory.from_words(seqs, tinv, context_free=sil))


def to_torch_bank(jbank):
    return tsb.bank_from_numpy(
        {f: np.asarray(getattr(jbank, f)) for f in tsb.FIELDS}, device="cpu")


def assert_banks_equal(tbank, jbank, **tol):
    for f in tsb.FIELDS:
        got, want = getattr(tbank, f).numpy(), np.asarray(getattr(jbank, f))
        assert got.shape == want.shape and got.dtype == want.dtype, f
        if tol:
            np.testing.assert_allclose(got, want, err_msg=f, **tol)
        else:
            assert np.array_equal(got, want), f


def assert_trees_equal(t, j):
    assert t.n_senones == j.n_senones
    assert np.array_equal(t.senone_of, j.senone_of)
    assert t.senone_of.dtype == j.senone_of.dtype
    assert t.nodes == j.nodes
    assert t.splits_log == j.splits_log      # the gains too, bit for bit
    assert [dataclasses.astuple(q) for q in t.questions] == \
        [dataclasses.astuple(q) for q in j.questions]


def assert_flat_equal(t, j):
    for f in ("child_ptr", "child_ids", "node_units"):
        assert np.array_equal(getattr(t, f), getattr(j, f)), f
    assert t.node_syllable == j.node_syllable
    assert t.node_words == j.node_words


def seeded_stats(rng, n_cd, emit=3, d=4, occ=40.0, spread=3.0):
    mean = rng.normal(size=(n_cd, emit, d)) * spread
    return np.full((n_cd, emit), occ), mean, mean**2 + 1.0


def ci_world(rng, d=8):
    """A CI bank with distinct per-senone means, in both packages."""
    cfg = ModelConfig(state_num=5, mix_level=1, max_mix_level=1)
    jbank = jsb.create_bank(len(UNITS), cfg, d, differentiation=False)
    emb = rng.normal(size=(len(UNITS) * 3, d)).astype(np.float32) * 4
    jbank = dataclasses.replace(jbank, means=jnp.asarray(emb[:, None, :]))
    return jbank, to_torch_bank(jbank), emb


# ----------------------------------------------------------------------
# inventory and labels
# ----------------------------------------------------------------------

def test_inventory_equal():
    jcd, tcd = cd_pair()
    assert np.array_equal(tcd.triples, jcd.triples)
    assert tcd.triples.dtype == jcd.triples.dtype
    assert tcd.id_of == jcd.id_of and tcd.context_free == jcd.context_free
    assert np.array_equal(tcd.base_of, jcd.base_of)
    assert tctx.cd_unit_names(tcd) == jctx.cd_unit_names(jcd)
    assert tctx.word_triples([1, 2, 3]) == jctx.word_triples([1, 2, 3]) \
        == [(-1, 1, 2), (1, 2, 3), (2, 3, -1)]
    for units in ([0, 1], [0, 1, 2, 3], [5]):
        assert tcd.encode_word(units) == jcd.encode_word(units)
    i = tcd.base.id_of
    with pytest.raises(ValueError):
        tctx.CDInventory.from_words([[i["b"], i["sil"], i["a1"]]], tcd.base,
                                    context_free=[i["sil"]])


def test_reading_combos_equal():
    from poccala_tpu.lexicon.pinyin import PinYin as JaxPinYin
    from poccala_tpu_torch.lexicon.pinyin import PinYin

    table = {"你": ["ni3"], "好": ["hao3", "hao4"], "马": ["ma1"]}
    units = ["n", "i3", "h", "ao3", "ao4", "m", "a1"]
    id_of = {u: k for k, u in enumerate(units)}
    for word in ("你好", "马", "好好", "龙"):
        assert tctx.reading_combos(PinYin(table), word, id_of) == \
            jctx.reading_combos(JaxPinYin(table), word, id_of)
    assert len(tctx.reading_combos(PinYin(table), "好好", id_of)) == 4
    assert len(tctx.reading_combos(PinYin(table), "好好", id_of, cap=3)) == 3


def test_expand_labels_equal():
    jcd, tcd = cd_pair()
    i = tcd.base.id_of
    lab = np.array([[i["sil"], i["b"], i["a1"], i["b"], i["a1"], i["d"],
                     i["e4"], i["sil"]],
                    [i["b"], i["a1"], i["d"], 0, 0, 0, 0, 0]], np.int32)
    lens = np.array([8, 3])
    # the second utterance's "bade" is cut by the label budget
    seqs = [[[i["b"], i["a1"]], [i["b"], i["a1"], i["d"], i["e4"]]],
            [[i["b"], i["a1"], i["d"], i["e4"]]]]
    got = tctx.expand_labels(lab, lens, seqs, tcd)
    want = jctx.expand_labels(lab, lens, seqs, jcd)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got[0, 2] == tcd.id_of[(i["b"], i["a1"], -1)]
    assert got[0, 4] == tcd.id_of[(i["b"], i["a1"], i["d"])]
    with pytest.raises(ValueError):
        tctx.expand_labels(np.array([[i["b"], i["e4"]]], np.int32),
                           np.array([2]), [[[i["b"], i["a1"]]]], tcd)


def test_expand_labels_by_matching_equal():
    jcd, tcd = cd_pair()
    i = tcd.base.id_of
    combos = {"ba": [[i["b"], i["a1"]]],
              "bade": [[i["m"], i["a1"]],                  # a wrong reading
                       [i["b"], i["a1"], i["d"], i["e4"]]],
              "de": [[i["d"], i["e4"]]]}
    lab = np.array([[i["sil"], i["b"], i["a1"], i["d"], i["e4"], i["sil"]],
                    [i["d"], i["e4"], i["b"], i["a1"], 0, 0],
                    [i["m"], i["a1"], i["d"], i["e4"], 0, 0]], np.int32)
    lens = np.array([6, 4, 4])
    lines = [["bade"], ["de", "ba"], ["ma", "de"]]   # "ma" has no combos
    got, ok = tctx.expand_labels_by_matching(lab, lens, lines, combos, tcd)
    want, wok = jctx.expand_labels_by_matching(lab, lens, lines, combos, jcd)
    assert np.array_equal(got, want) and np.array_equal(ok, wok)
    assert ok.tolist() == [True, True, False]


# ----------------------------------------------------------------------
# statistics and trees
# ----------------------------------------------------------------------

def alignment_case(rng, n_cd, b=3, t=24, d=4):
    xs = rng.normal(size=(b, t, d)).astype(np.float32)
    cd_labels = rng.integers(0, n_cd, size=(b, 6)).astype(np.int32)
    label_pos = np.full((b, t), -1, np.int32)
    for u in range(b):
        for s, e, p in ((2, 6, 0), (6, 11, 1), (13, 15, 2), (16, 22, 3)):
            label_pos[u, s + u:e] = p
    return xs, cd_labels, label_pos


def test_collect_triple_stats_equal(rng):
    _, tcd = cd_pair()
    xs, cd_labels, label_pos = alignment_case(rng, len(tcd))
    for utt_ok in (None, np.array([True, False, True])):
        got = tctx.collect_triple_stats(xs, cd_labels, label_pos, len(tcd),
                                        3, utt_ok=utt_ok)
        want = jctx.collect_triple_stats(xs, cd_labels, label_pos, len(tcd),
                                         3, utt_ok=utt_ok)
        for g, w in zip(got, want):
            assert g.dtype == np.float64
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert got[0].sum() > 0
    empty = tctx.collect_triple_stats(xs, cd_labels,
                                      np.full_like(label_pos, -1),
                                      len(tcd), 3)
    assert not any(a.any() for a in empty)


def test_triple_stats_accumulator_equal(rng):
    _, tcd = cd_pair()
    tacc = tctx.TripleStatsAccumulator(len(tcd), 3, 4)
    jacc = jctx.TripleStatsAccumulator(len(tcd), 3, 4)
    for k in range(3):
        xs, cd_labels, label_pos = alignment_case(rng, len(tcd))
        ok = None if k else np.array([True, True, False])
        tacc.add(xs, cd_labels, label_pos, utt_ok=ok)
        jacc.add(xs, cd_labels, label_pos, utt_ok=ok)
    for f in ("occ", "mean", "ex2"):
        np.testing.assert_allclose(getattr(tacc, f), getattr(jacc, f),
                                   rtol=0, atol=1e-12)
    assert tacc.occ.sum() > 0


@pytest.mark.parametrize("target,min_occ", [(24, 4.0), (1, 8.0), (60, 1.0)])
def test_trees_identical(rng, target, min_occ):
    jcd, tcd = cd_pair()
    occ, mean, ex2 = seeded_stats(rng, len(tcd))
    got = tctx.grow_context_trees(tcd, occ, mean, ex2, target_senones=target,
                                  min_occ=min_occ)
    want = jctx.grow_context_trees(jcd, occ, mean, ex2, target_senones=target,
                                   min_occ=min_occ)
    assert_trees_equal(got, want)
    assert got.n_senones <= max(target, 6 * 3)
    i = tcd.base.id_of
    unseen = (i["m"], i["a1"], i["m"])
    assert unseen not in tcd.id_of
    for e in range(3):
        assert got.route(unseen, e) == want.route(unseen, e)
    for k in range(len(tcd)):
        for e in range(3):
            assert got.senone_of[k, e] == got.route(tcd.triples[k], e)


def test_trees_identical_on_uneven_occupancy(rng):
    """Occupancies from 0 to 200 and means of different spread: the global
    queue orders splits of different trees by gains that are close."""
    jcd, tcd = cd_pair()
    n = len(tcd)
    occ = rng.integers(0, 200, size=(n, 3)).astype(np.float64)
    mean = rng.normal(size=(n, 3, 5)) * rng.uniform(0.1, 3, size=(n, 1, 1))
    ex2 = mean**2 + rng.uniform(0.2, 2.0, size=(n, 3, 5))
    got = tctx.grow_context_trees(tcd, occ, mean, ex2, target_senones=40,
                                  min_occ=8.0)
    want = jctx.grow_context_trees(jcd, occ, mean, ex2, target_senones=40,
                                   min_occ=8.0)
    assert_trees_equal(got, want)
    assert len(got.splits_log) > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sidecar_cross_read(rng, tmp_path, writer):
    jcd, tcd = cd_pair()
    occ, mean, ex2 = seeded_stats(rng, len(tcd))
    jtrees = jctx.grow_context_trees(jcd, occ, mean, ex2, 24, min_occ=4.0)
    ttrees = tctx.grow_context_trees(tcd, occ, mean, ex2, 24, min_occ=4.0)
    path = str(tmp_path / "cd.json")
    if writer == "jax":
        jctx.save_cd(path, jcd, jtrees)
    else:
        tctx.save_cd(path, tcd, ttrees)
    other = str(tmp_path / "other.json")
    (tctx.save_cd(other, tcd, ttrees) if writer == "jax"
     else jctx.save_cd(other, jcd, jtrees))
    with open(path) as a, open(other) as b:
        assert a.read() == b.read()
    cd_t, trees_t = tctx.load_cd(path)
    cd_j, trees_j = jctx.load_cd(path)
    assert np.array_equal(cd_t.triples, tcd.triples)
    assert cd_t.base.units == UNITS and cd_t.context_free == tcd.context_free
    assert_trees_equal(trees_t, trees_j)
    assert_trees_equal(trees_t, jtrees)


# ----------------------------------------------------------------------
# banks
# ----------------------------------------------------------------------

def grown_pair(rng, target, min_occ=1.0, d=8):
    jcd, tcd = cd_pair()
    occ, mean, ex2 = seeded_stats(rng, len(tcd), d=d, occ=30.0, spread=1.0)
    return (jcd, tcd,
            jctx.grow_context_trees(jcd, occ, mean, ex2, target,
                                    min_occ=min_occ),
            tctx.grow_context_trees(tcd, occ, mean, ex2, target,
                                    min_occ=min_occ))


def test_build_cd_bank_equal_and_clone_decodes_as_ci(rng):
    jbank, tbank, emb = ci_world(rng)
    jcd, tcd, jtrees, ttrees = grown_pair(rng, target=len(cd_pair()[1]) * 3)
    before = tsb.bank_to_numpy(tbank)
    got = tctx.build_cd_bank(tbank, tcd, ttrees)
    assert_banks_equal(got, jctx.build_cd_bank(jbank, jcd, jtrees))
    assert got.num_units == len(tcd) and got.means.device.type == "cpu"
    for f, a in before.items():          # the input bank is not mutated
        assert np.array_equal(getattr(tbank, f).numpy(), a), f

    i = tcd.base.id_of
    cd_flat = tctx.build_cd_lexicon(word_entries(tcd.base), tcd,
                                    sil_word=("<sil>", i["sil"]))
    dec_ci = DeviceBeamDecoder(tbank, FlatLexicon.from_tree(CI_TREE, tcd.base))
    dec_cd = DeviceBeamDecoder(got, cd_flat)
    for seq in ([i["b"], i["a1"]], [i["b"], i["a1"], i["d"], i["e4"]],
                [i["d"], i["e4"], i["m"], i["a1"]],
                [i["sil"], i["b"], i["a1"], i["sil"]]):
        x = np.concatenate([emb[u * 3 + 1] + rng.normal(size=(7, 8)) * 0.4
                            for u in seq]).astype(np.float32)
        h_ci = dec_ci.decode(x, return_nbest=3)
        h_cd = dec_cd.decode(x, return_nbest=3)
        assert h_ci and [h.words for h in h_ci] == [h.words for h in h_cd]
        assert np.allclose([h.score for h in h_ci], [h.score for h in h_cd],
                           rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tau,occ", [(1e-9, 100.0), (16.0, 16.0),
                                     (1e12, 100.0), (8.0, 0.0)])
def test_map_smooth_bank_equal(rng, tau, occ):
    jbank, tbank, _ = ci_world(rng)
    jcd, tcd, jtrees, ttrees = grown_pair(rng, target=len(cd_pair()[1]) * 3)
    jclone = jctx.build_cd_bank(jbank, jcd, jtrees)
    jdrift = dataclasses.replace(jclone, means=jclone.means + 2.0,
                                 log_var=jclone.log_var + 0.5)
    tdrift = to_torch_bank(jdrift)
    occ_arr = np.full((len(tcd), 3), occ)
    got = tctx.map_smooth_bank(tdrift, tbank, tcd, ttrees, occ_arr, tau=tau)
    want = jctx.map_smooth_bank(jdrift, jbank, jcd, jtrees, occ_arr, tau=tau)
    assert_banks_equal(got, want, rtol=1e-6, atol=1e-6)
    assert_banks_equal(tdrift, jdrift)            # inputs not mutated
    target = jdrift if tau < 1e-6 else jclone
    if tau != 16.0:
        assert np.allclose(got.means.numpy(), np.asarray(target.means),
                           atol=1e-3)
    assert np.allclose(got.log_w.exp().sum(-1).numpy(), 1.0, atol=1e-4)


def test_lexicon_tables_equal(rng):
    """filter_routable_entries, extend_for_lexicon, build_cd_lexicon and
    cd_entries_from_flat give the JAX package's tables; the extended bank
    shares the input bank's GMM tensors."""
    jbank, tbank, emb = ci_world(rng)
    jcd, tcd, jtrees, ttrees = grown_pair(rng, target=40)
    jcd_bank = jctx.build_cd_bank(jbank, jcd, jtrees)
    tcd_bank = tctx.build_cd_bank(tbank, tcd, ttrees)
    i = tcd.base.id_of
    entries = word_entries(tcd.base) + [
        ("made", [[i["m"], i["a1"]], [i["d"], i["e4"]]])]
    jcd2, jtrees2, jbank2 = jctx.extend_for_lexicon(jcd, jtrees, jcd_bank,
                                                    entries)
    tcd2, ttrees2, tbank2 = tctx.extend_for_lexicon(tcd, ttrees, tcd_bank,
                                                    entries)
    assert len(tcd2) > len(tcd) and np.array_equal(tcd2.triples, jcd2.triples)
    assert_trees_equal(ttrees2, jtrees2)
    assert_banks_equal(tbank2, jbank2)
    assert tbank2.num_units == len(tcd2)
    assert tcd_bank.num_units == len(tcd)             # input not mutated
    for f in ("means", "log_var", "log_w"):
        assert getattr(tbank2, f) is getattr(tcd_bank, f), f
    # nothing to add: the inputs come back
    assert tctx.extend_for_lexicon(tcd2, ttrees2, tbank2, entries) == \
        (tcd2, ttrees2, tbank2)

    for sil in (None, ("<sil>", i["sil"])):
        assert_flat_equal(tctx.build_cd_lexicon(entries, tcd2, sil_word=sil),
                          jctx.build_cd_lexicon(entries, jcd2, sil_word=sil))
    flat = tctx.build_cd_lexicon(entries, tcd2)
    x = np.concatenate([emb[u * 3 + 1] + rng.normal(size=(7, 8)) * 0.4
                        for u in (i["m"], i["a1"], i["d"], i["e4"])]
                       ).astype(np.float32)
    hyps = DeviceBeamDecoder(tbank2, flat).decode(x, return_nbest=3)
    want = JaxDecoder(jbank2, jctx.build_cd_lexicon(entries, jcd2)).decode(
        x, return_nbest=3)
    assert [h.words for h in hyps] == [h.words for h in want]
    assert any("made" in h.words for h in hyps)

    for nodes in (ttrees.nodes, jtrees.nodes):
        for e in range(3):
            nodes.pop((i["m"], e))
    good, skipped = tctx.filter_routable_entries(tcd, ttrees, entries)
    assert (good, skipped) == jctx.filter_routable_entries(jcd, jtrees,
                                                           entries)
    assert sorted(skipped) == ["ma", "made"]

    ci_t = FlatLexicon.from_tree(CI_TREE, tcd.base)
    ci_j = JaxFlatLexicon.from_tree(CI_TREE, jcd.base)
    assert tctx.cd_entries_from_flat(ci_t) == jctx.cd_entries_from_flat(ci_j)
    assert dict(tctx.cd_entries_from_flat(ci_t))["bade"] == \
        [[i["b"], i["a1"]], [i["d"], i["e4"]]]


def test_scoring_pack_follows_the_bank_not_the_address(rng):
    """The GMM kernel's pack cache under the CD path: ``extend_for_lexicon``
    keeps the GMM tensors, so the CD bank's pack is found again; the CD
    clone's tensors are new ones, so the CI bank's pack is never served to
    it, even where the values are equal."""
    _, tbank, _ = ci_world(rng)
    _, tcd, _, ttrees = grown_pair(rng, target=40)
    cd_bank = tctx.build_cd_bank(tbank, tcd, ttrees)
    i = tcd.base.id_of
    entries = [("made", [[i["m"], i["a1"]], [i["d"], i["e4"]]])]
    _, _, bank2 = tctx.extend_for_lexicon(tcd, ttrees, cd_bank, entries)
    calls = []

    def packer(means, log_var, log_w, normalizer):
        calls.append(means.shape[0])
        return len(calls)

    def pack(bank):
        return gmm_score_cuda._cached(packer, bank.means, bank.log_var,
                                      bank.log_w, "textbook")

    kept = dict(gmm_score_cuda._packs)
    try:
        first = pack(cd_bank)
        assert pack(bank2) == first and len(calls) == 1   # a hit
        assert pack(tbank) != first                       # another bank
        assert calls == [cd_bank.num_states, tbank.num_states]
        assert pack(cd_bank) == first and len(calls) == 2
    finally:
        gmm_score_cuda._packs.clear()
        gmm_score_cuda._packs.update(kept)


def test_decoder_context_packing_at_the_cd_size():
    """The decoder packs (word, unit) contexts into int32: the CD unit
    axis runs past a thousand ids, over a lexicon of thousands of words."""
    inv = tcorpus.UnitInventory.standard("XIF_tone")
    _, words, _ = synthetic_lexicon(inv)
    n_words = len(words)
    for n_units in (1091, 1400, 5000):
        check_context_fits(n_words, n_units)
    with pytest.raises(ValueError):
        check_context_fits(2**20, 2**12)


# ----------------------------------------------------------------------
# tie_by_tree's default questions, and the slice as a whole
# ----------------------------------------------------------------------

def test_tie_by_tree_default_questions_match_jax(rng):
    units = ["b", "p", "m", "a1", "a4", "ai1", "ang2", "i1", "sil"]
    cfg = ModelConfig(state_num=5, mix_level=2, max_mix_level=2)
    jbank = jsb.create_bank(len(units), cfg, 5, differentiation=False)
    jbank = dataclasses.replace(
        jbank,
        means=jnp.asarray(rng.normal(size=jbank.means.shape)
                          .astype(np.float32) * 2),
        log_var=jnp.asarray(rng.normal(size=jbank.means.shape)
                            .astype(np.float32) * 0.3))
    occ = rng.uniform(1, 50, size=jbank.num_states)
    got, gtrees = ttying.tie_by_tree(to_torch_bank(jbank), units, 15,
                                     occupancy=occ, return_trees=True)
    want, wtrees = jtying.tie_by_tree(jbank, units, 15, occupancy=occ,
                                      return_trees=True)
    assert np.array_equal(got.senone_map.numpy(), np.asarray(want.senone_map))
    assert [[(s.question, s.yes_units) for s in v] for v in gtrees.values()] \
        == [[(s.question, s.yes_units) for s in v] for v in wtrees.values()]
    assert any(gtrees.values())
    assert_banks_equal(got, want, rtol=1e-6, atol=1e-6)


def pipeline_batch(rng, inv, d):
    """tests/test_context.py's corpus: 16 utterances of one or two words
    between silences, each unit 4-6 frames around its own mean."""
    i = inv.id_of
    entries = word_entries(inv)
    emb = rng.normal(size=(len(inv), d)).astype(np.float32) * 3
    n = 16
    feats = np.zeros((n, 96, d), np.float32)
    masks = np.zeros((n, 96), bool)
    labels = np.zeros((n, 12), np.int32)
    lens = np.zeros(n, np.int32)
    seqs = []
    for u in range(n):
        words = [entries[int(rng.integers(len(entries)))]
                 for _ in range(int(rng.integers(1, 3)))]
        units = [i["sil"]] + [x for _, syls in words for s in syls
                              for x in s] + [i["sil"]]
        t = 0
        for x in units:
            fp = int(rng.integers(4, 7))
            feats[u, t:t + fp] = emb[x] + rng.normal(size=(fp, d)).astype(
                np.float32) * 0.3
            t += fp
        masks[u, :t] = True
        labels[u, :len(units)] = units
        lens[u] = len(units)
        seqs.append([[x for s in syls for x in s] for _, syls in words])
    return (feats, masks, labels, lens), seqs


def test_train_expand_retrain_decode_matches_jax(rng):
    """CI training, alignment-driven statistics, trees, the clone, one CD
    retrain epoch and the CD decode through both packages."""
    jinv, tinv = inventories()
    cfg = Config()
    cfg.model.state_num = 5
    cfg.model.mix_level = 1
    cfg.model.max_mix_level = 2
    cfg.model.var_floor_scale = 0.01
    cfg.train.max_frames = 96
    cfg.train.max_label_len = 12
    d = cfg.frontend.feat_dim
    arrays, word_seqs = pipeline_batch(rng, tinv, d)
    jbatch, tbatch = jcorpus.Batch(*arrays), tcorpus.Batch(*arrays)
    jcd, tcd = cd_pair()
    i = tinv.id_of
    entries = word_entries(tinv)
    runs = {}
    for name in ("jax", "port"):
        port = name == "port"
        ctx, cd, batch = (tctx, tcd, tbatch) if port else (jctx, jcd, jbatch)
        tr = (Trainer(cfg, tinv, device="cpu") if port
              else JaxTrainer(cfg, jinv))
        if port:   # both start from the JAX trainer's flat start
            tr.bank = to_torch_bank(runs["jax"]["start"])
            tr._var_floor_vec = runs["jax"]["floor"]
        else:
            tr.flat_start([batch])
        start = tr.bank
        ci_lls = tr.auto([batch], t=2, mode=2, init=False)
        floor = tr._var_floor_vec
        ci_bank = tr.export_bank()
        cd_labels = ctx.expand_labels(batch.labels, batch.label_lens,
                                      word_seqs, cd)
        if port:
            _, lp = talign.align_batch(
                ci_bank, batch.labels, batch.label_lens, batch.feats,
                batch.t_masks, cfg.model.state_num, cfg.train.max_label_len)
            lp = lp.numpy()
        else:
            _, lp = jalign.align_batch(
                ci_bank, jnp.asarray(batch.labels),
                jnp.asarray(batch.label_lens), jnp.asarray(batch.feats),
                jnp.asarray(batch.t_masks), cfg.model.state_num,
                cfg.train.max_label_len)
            lp = np.asarray(lp)
        occ, mean, ex2 = ctx.collect_triple_stats(
            batch.feats, cd_labels, lp, len(cd), cfg.model.emit_states)
        trees = ctx.grow_context_trees(
            cd, occ, mean, ex2, target_senones=3 * ci_bank.num_states,
            min_occ=4.0)
        cd_bank = ctx.build_cd_bank(ci_bank, cd, trees)
        names = [f"cd{k}" for k in range(len(cd))]
        tr2 = (Trainer(cfg, tcorpus.UnitInventory(names), device="cpu")
               if port else JaxTrainer(cfg, jcorpus.UnitInventory(names)))
        tr2.bank = cd_bank
        tr2._var_floor_vec = tr._var_floor_vec
        ll = tr2.scheme2_epoch([dataclasses.replace(batch, labels=cd_labels)])
        flat = ctx.build_cd_lexicon(entries, cd, sil_word=("<sil>", i["sil"]))
        dec = (DeviceBeamDecoder if port else JaxDecoder)(tr2.export_bank(),
                                                          flat)
        nf = batch.t_masks[:6].sum(axis=1).astype(np.int32)
        out = dec.decode_batch(batch.feats[:6], nf)
        runs[name] = dict(start=start, floor=floor, ci_lls=ci_lls, lp=lp,
                          stats=(occ, mean, ex2), trees=trees, ll=float(ll),
                          cd_bank=cd_bank, flat=flat,
                          words=[[list(h.words) for h in hyps]
                                 for hyps in out])
    j, t = runs["jax"], runs["port"]
    np.testing.assert_allclose(t["ci_lls"], j["ci_lls"], rtol=1e-4)
    assert np.array_equal(t["lp"], j["lp"])            # the alignment
    for g, w in zip(t["stats"], j["stats"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert t["stats"][0].sum() > 0
    assert_trees_equal(t["trees"], j["trees"])
    assert t["cd_bank"].num_states >= len(UNITS) * 3
    assert np.isfinite(t["ll"])
    np.testing.assert_allclose(t["ll"], j["ll"], rtol=1e-4)
    assert_flat_equal(t["flat"], j["flat"])
    assert all(w for w in t["words"]) and t["words"] == j["words"]
