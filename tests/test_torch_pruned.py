"""Block-pruned device decode (``active_blocks``) in the port against the
JAX decoder, and the decoder's constructor and ``decode()`` against the
JAX signature.

The world is ``tests/test_block_pruned.py``'s with the reference's
``Mandarin.dat`` replaced by :func:`poccala_tpu_torch.lexicon.build.
synthetic_lexicon` at ~1,500 nodes (two- and three-character words over
the built-in G2P table; 24 blocks of 64): a separable random bank over
the XIF_tone units and utterances of words drawn from the lexicon.  The
port must reproduce JAX's DFS permutation, parent remap and padding
exactly, and JAX's pruned 1-best words with scores at rtol 1e-4, with and
without an LM, on clean and noisy utterances; a pruned search never
scores above the exact one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.config import Config, ModelConfig
from poccala_tpu.decoder.device import DeviceBeamDecoder as JaxDecoder
from poccala_tpu.io.corpus import UnitInventory as JaxInventory
from poccala_tpu.lexicon import FlatLexicon as JaxFlat
from poccala_tpu.lexicon import PinYin as JaxPinYin
from poccala_tpu.lexicon import PronunciationLexicon as JaxLexicon
from poccala_tpu.lm.ngram import Ngram
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon.build import synthetic_lexicon
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.utils.logmath import NEG_INF

torch.set_num_threads(1)

D = 8
T_PAD = 36          # three syllables of two units at 6 frames each
PRUNE = dict(block_size=64, active_blocks=2)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    inv = UnitInventory.standard("XIF_tone")
    flat, words, py = synthetic_lexicon(inv, min_nodes=1500, n_chars=12)
    jl = JaxLexicon()
    jl.generate(words, JaxPinYin())
    jflat = JaxFlat.from_tree(jl.lexicon, JaxInventory.standard("XIF_tone"))
    cfg = ModelConfig(state_num=5, mix_level=1, max_mix_level=1)
    jbank = jsb.create_bank(len(inv), cfg, D, differentiation=False)
    emb = rng.normal(size=(len(inv), D)).astype(np.float32) * 4
    means = np.repeat(emb, cfg.state_num - 2, axis=0)[:, None, :]
    jbank = dataclasses.replace(jbank, means=jnp.asarray(means))
    tbank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                 for f in tsb.FIELDS}, device="cpu")
    return dict(inv=inv, flat=flat, jflat=jflat, words=words, py=py,
                jbank=jbank, tbank=tbank, emb=emb)


def decodable(w, n, rng):
    """``tests/test_block_pruned.py:_decodable``: words whose first
    reading lies inside the inventory, with their unit ids."""
    out = []
    for i in rng.permutation(len(w["words"])):
        word = w["words"][i]
        us = w["py"].units_of(word)
        if us is None:
            continue
        units = [u for ch in us for u in ch[0]]
        if all(u in w["inv"].id_of for u in units):
            out.append((word, [w["inv"].id_of[u] for u in units]))
        if len(out) >= n:
            break
    return out


def batch(w, n, seed, noise):
    """``n`` utterances of lexicon words, padded to ``T_PAD`` frames."""
    rng = np.random.default_rng(seed)
    chosen = decodable(w, n, rng)
    feats = np.zeros((len(chosen), T_PAD, D), np.float32)
    nf = np.zeros(len(chosen), np.int32)
    for i, (_, uids) in enumerate(chosen):
        x = np.concatenate([w["emb"][u] + rng.normal(size=(6, D)) * noise
                            for u in uids]).astype(np.float32)[:T_PAD]
        feats[i, : len(x)] = x
        nf[i] = len(x)
    return [c[0] for c in chosen], feats, nf


def pair(w, lm=None, **kw):
    extra = dict(lm=lm, lm_weight=4.0) if lm is not None else {}
    return (JaxDecoder(w["jbank"], w["jflat"], **extra, **kw),
            DeviceBeamDecoder(w["tbank"], w["flat"], **extra, **kw))


def test_lexicon_matches_jax(world):
    jf, tf = world["jflat"], world["flat"]
    assert 1400 <= tf.n_nodes <= 1600
    for f in ("child_ptr", "child_ids", "node_units"):
        assert np.array_equal(getattr(tf, f), getattr(jf, f))
    assert tf.node_words == jf.node_words


def test_permutation_and_padding_match_jax(world):
    jd, td = pair(world, **PRUNE)
    jd._prep_device()
    tabs = td._prep_device()
    assert td._prune_on and jd._prune_on
    n_nodes = world["flat"].n_nodes
    assert np.array_equal(td._perm, jd._perm)
    assert sorted(td._perm) == list(range(n_nodes)) and td._perm[0] == 0
    par = np.asarray(jd._j_parent)
    assert np.array_equal(np.where(tabs.has_parent.numpy(),
                                   tabs.parent.numpy(), -1), par)
    sen = np.asarray(jd._j_senone)
    assert np.array_equal(np.where(tabs.emitting.numpy(),
                                   tabs.senone.numpy(), -1), sen)
    jw = np.asarray(jd._j_word)
    node_slot, col = np.nonzero(jw >= 0)
    assert np.array_equal(tabs.node_slot.numpy(), node_slot)
    assert np.array_equal(tabs.word_slot.numpy(), jw[node_slot, col])
    assert np.array_equal(tabs.bands.numpy(), np.asarray(jd._j_bands))
    assert np.array_equal(tabs.is_root_child.numpy(),
                          np.asarray(jd._j_is_root_child))
    # the padding: a block multiple of dead rows
    n_pad = tabs.bands.shape[0]
    assert n_pad % 64 == 0 and n_pad - n_nodes < 64 and n_pad > n_nodes
    assert td._n_blocks == jd._n_blocks == n_pad // 64
    assert not tabs.emitting[n_nodes:].any()
    assert not tabs.has_parent[n_nodes:].any()
    assert not tabs.is_root_child[n_nodes:].any()
    assert bool((tabs.bands[n_nodes:] <= NEG_INF / 2).all())
    assert int(tabs.node_slot.max()) < n_nodes


@pytest.mark.parametrize("noise", [0.3, 0.8], ids=["clean", "noisy"])
@pytest.mark.parametrize("with_lm", [False, True], ids=["no_lm", "bigram"])
def test_pruned_matches_jax(world, noise, with_lm):
    words, feats, nf = batch(world, 10, seed=int(noise * 10) + with_lm,
                             noise=noise)
    lm = None
    if with_lm:
        lm = Ngram(2)
        rng = np.random.default_rng(13)
        lm.train([list(rng.choice(words, size=2)) for _ in range(30)])
    jd, td = pair(world, lm=lm, **PRUNE)
    want = jd.decode_batch(feats, nf, return_nbest=2)
    got = td.decode_batch(feats, nf, return_nbest=2)
    assert td._prune_on
    for g, wv in zip(got, want):
        assert g and wv
        assert g[0].words == wv[0].words
        assert np.isclose(g[0].score, wv[0].score, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("noise", [0.3, 1.2], ids=["clean", "noisy"])
def test_pruned_never_beats_exact(world, noise):
    """The pruned search explores a subset of the exact search's paths.
    On separable utterances 3 of 24 active blocks find the exact 1-best
    (2 blocks missed 3 of 10 three-syllable words in a measurement: the
    pruning is an approximation)."""
    _, feats, nf = batch(world, 10, seed=21, noise=noise)
    exact = DeviceBeamDecoder(world["tbank"], world["flat"])
    out_ex = exact.decode_batch(feats, nf)
    for k in (2, 3):
        pruned = DeviceBeamDecoder(world["tbank"], world["flat"],
                                   block_size=64, active_blocks=k)
        for he, hp in zip(out_ex, pruned.decode_batch(feats, nf)):
            assert he and hp
            assert hp[0].score <= he[0].score + 1e-4 * abs(he[0].score)
            if noise < 0.5 and k == 3:
                assert hp[0].words == he[0].words
                assert np.isclose(hp[0].score, he[0].score, rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(block_size=4096, active_blocks=8),
                                dict(block_size=64, active_blocks=24)],
                         ids=["one_block", "all_blocks"])
def test_noop_below_block_count(world, kw):
    """Pruning falls back to the exact search when the lexicon fits one
    block or every block is active; in the second case the permuted,
    padded tables stay, as in JAX, and decode to JAX's result."""
    jd, td = pair(world, **kw)
    jd._prep_device()
    td._prep_device()
    assert not td._prune_on and not jd._prune_on
    assert (td._perm is None) == (jd._perm is None) == (kw["block_size"]
                                                        == 4096)
    _, feats, nf = batch(world, 4, seed=5, noise=0.3)
    want = jd.decode_batch(feats, nf, return_nbest=3)
    got = td.decode_batch(feats, nf, return_nbest=3)
    for g, wv in zip(got, want):
        assert [h.words for h in g] == [h.words for h in wv]
        assert np.allclose([h.score for h in g], [h.score for h in wv],
                           rtol=1e-4, atol=0.0)


def test_pruned_stream_equals_pruned_one_shot(world):
    _, feats, nf = batch(world, 2, seed=7, noise=0.3)
    jd, td = pair(world, **PRUNE)
    one_shot = td.decode_batch(feats, nf, return_nbest=2)
    st = td.stream_init(batch=2, max_frames=T_PAD)
    for lo in range(0, T_PAD, 10):
        st = td.stream_feed(st, feats[:, lo:lo + 10],
                            n_valid=np.clip(nf - lo, 0, 10))
    streamed = td.stream_result(st, return_nbest=2)
    jst = jd.stream_init(batch=2, max_frames=T_PAD)
    for lo in range(0, T_PAD, 10):
        jst = jd.stream_feed(jst, feats[:, lo:lo + 10],
                             n_valid=np.clip(nf - lo, 0, 10))
    want = jd.stream_result(jst, return_nbest=2)
    for s, o, wv in zip(streamed, one_shot, want):
        assert [h.words for h in s] == [h.words for h in o] \
            == [h.words for h in wv]
        assert np.allclose([h.score for h in s], [h.score for h in o],
                           rtol=1e-6, atol=0.0)
        assert np.allclose([h.score for h in s], [h.score for h in wv],
                           rtol=1e-4, atol=0.0)


# ----------------------------------------------------------------------
# the constructor and decode(): the JAX decoder's API
# ----------------------------------------------------------------------

def test_jax_keywords_build_a_port_decoder(world):
    """Every keyword the JAX CLI hands the device decoder
    (``poccala_tpu/cli.py:195-203, 404-409, 474-479``) builds a port
    decoder, with JAX's clamps."""
    cfg = Config()
    kw = dict(beam=0.85, lm=None, normalizer="textbook",
              score_dtype=cfg.model.score_dtype, emit_top=4, max_words=64,
              block_size=cfg.decoder.block_size,
              active_blocks=cfg.decoder.active_blocks or None,
              prune_hysteresis=cfg.decoder.prune_hysteresis)
    jd = JaxDecoder(world["jbank"], world["jflat"], **kw)
    td = DeviceBeamDecoder(world["tbank"], world["flat"], **kw)
    for f in ("emit_top", "max_words", "block_size", "active_blocks",
              "prune_hysteresis", "beam", "normalizer", "score_dtype"):
        assert getattr(td, f) == getattr(jd, f), f
    small = dict(emit_top=0, max_words=1, block_size=3, active_blocks=0)
    jd = JaxDecoder(world["jbank"], world["jflat"], **small)
    td = DeviceBeamDecoder(world["tbank"], world["flat"], **small)
    assert (td.emit_top, td.max_words, td.block_size, td.active_blocks) \
        == (jd.emit_top, jd.max_words, jd.block_size, jd.active_blocks) \
        == (1, 2, 8, 1)


@pytest.mark.parametrize("kw", [{}, PRUNE], ids=["exact", "pruned"])
def test_decode_equals_decode_batch(world, kw):
    """``decode(feats, n_frames=None, return_nbest=5)``
    (``poccala_tpu/decoder/vector.py:323-329``) is the batch of one."""
    jd, td = pair(world, **kw)
    _, feats, nf = batch(world, 1, seed=9, noise=0.3)
    x = feats[0]
    got = td.decode(x, n_frames=nf[0])
    assert len(got) == min(5, len(got)) and got
    want = td.decode_batch(x[None, : nf[0]], nf, return_nbest=5)[0]
    assert [h.words for h in got] == [h.words for h in want]
    assert [h.score for h in got] == [h.score for h in want]
    jax_got = jd.decode(x, n_frames=nf[0])
    assert [h.words for h in got] == [h.words for h in jax_got]
    full = td.decode(torch.as_tensor(x[: nf[0]]))
    assert [h.words for h in full] == [h.words for h in got]
