"""Host code the PyTorch port copies from the JAX package, pinned to the
original.

The JAX package's lexicon, unit-inventory and decoder-table code is
NumPy, but every import path to it loads jax, so the port carries copies.
These tests hold each copy to its original: function sources that were
copied verbatim must stay identical, and the tables they build — the
``FlatLexicon`` arrays, the node band/senone tables, the vocabulary, word
table and LM tables — must be equal on the built-in lexicon.
"""

import inspect
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from poccala_tpu.config import ModelConfig
from poccala_tpu.decoder.beam import BeamDecoder as JaxBeamDecoder
from poccala_tpu.decoder.device import DeviceBeamDecoder as JaxDevice
from poccala_tpu.decoder.vector import VectorBeamDecoder as JaxVector
from poccala_tpu.io import corpus as jcorpus
from poccala_tpu.lexicon import build as jbuild
from poccala_tpu.lexicon import builtin_table as jtable
from poccala_tpu.lexicon import lexicon as jlex
from poccala_tpu.lexicon import pinyin as jpinyin
from poccala_tpu.lm.ngram import Ngram
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu.ops import frontend as jfrontend
from poccala_tpu_torch.decoder.beam import BeamDecoder as TorchBeamDecoder
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder as TorchDevice
from poccala_tpu_torch.decoder.vector import VectorBeamDecoder as TorchVector
from poccala_tpu_torch.io import corpus as tcorpus
from poccala_tpu_torch.lexicon import build as tbuild
from poccala_tpu_torch.lexicon import builtin_table as ttable
from poccala_tpu_torch.lexicon import lexicon as tlex
from poccala_tpu_torch.lexicon import pinyin as tpinyin
from poccala_tpu_torch.models.senone_bank import FIELDS, bank_from_numpy
from poccala_tpu_torch.ops import frontend as tfrontend

torch.set_num_threads(1)

VERBATIM = {
    "PinYin._convert": (jpinyin.PinYin._convert, tpinyin.PinYin._convert),
    "PinYin.word2pinyin": (jpinyin.PinYin.word2pinyin,
                           tpinyin.PinYin.word2pinyin),
    "load_mandarin_dat": (jpinyin.load_mandarin_dat,
                          tpinyin.load_mandarin_dat),
    "PronunciationLexicon": (jlex.PronunciationLexicon,
                             tlex.PronunciationLexicon),
    "FlatLexicon": (jlex.FlatLexicon, tlex.FlatLexicon),
    "standard_inventory": (jcorpus.standard_inventory,
                           tcorpus.standard_inventory),
    "UnitInventory": (jcorpus.UnitInventory, tcorpus.UnitInventory),
    "mel_filterbank_matrix": (jfrontend.mel_filterbank_matrix,
                              tfrontend.mel_filterbank_matrix),
    "dct_matrix": (jfrontend.dct_matrix, tfrontend.dct_matrix),
    "VectorBeamDecoder._prep_tables": (JaxVector._prep_tables,
                                       TorchVector._prep_tables),
    "BeamDecoder.__init__": (JaxBeamDecoder.__init__,
                             TorchBeamDecoder.__init__),
    "DeviceBeamDecoder._to_hypotheses": (JaxDevice._to_hypotheses,
                                         TorchDevice._to_hypotheses),
    "reference_words": (jbuild.reference_words, tbuild.reference_words),
    "build_reference_lexicon": (jbuild.build_reference_lexicon,
                                tbuild.build_reference_lexicon),
}


@pytest.mark.parametrize("name", list(VERBATIM))
def test_copied_source_is_verbatim(name):
    orig, copy = VERBATIM[name]
    assert inspect.getsource(copy) == inspect.getsource(orig)


def test_tables_and_inventories_equal():
    assert ttable.BUILTIN_PINYIN == jtable.BUILTIN_PINYIN
    assert Path(tbuild.DEFAULT_DAT).parts[-2:] == \
        Path(jbuild.DEFAULT_DAT).parts[-2:]
    assert tpinyin.EXTEND_DICT == jpinyin.EXTEND_DICT
    assert tpinyin.SYLLABLE_INITIALS == jpinyin.SYLLABLE_INITIALS
    for kind in ("IF", "XIF", "XIF_tone"):
        assert tcorpus.standard_inventory(kind) == \
            jcorpus.standard_inventory(kind)


def test_unit_file_roundtrip(tmp_path):
    path = str(tmp_path / "units.txt")
    jcorpus.UnitInventory.standard("XIF").save(path)
    assert tcorpus.UnitInventory.from_file(path).units == \
        jcorpus.UnitInventory.from_file(path).units


def test_g2p_equal_on_every_builtin_reading():
    jp, tp = jpinyin.PinYin(), tpinyin.PinYin()
    for ch in jtable.BUILTIN_PINYIN:
        for kw in ({}, dict(show_tone_mark=False), dict(extend=False)):
            assert tp.word2pinyin(ch, **kw) == jp.word2pinyin(ch, **kw)


def flat_pair(words=None):
    words = words or list(jtable.BUILTIN_PINYIN)
    jl, tl = jlex.PronunciationLexicon(), tlex.PronunciationLexicon()
    jl.generate(words, jpinyin.PinYin())
    tl.generate(words, tpinyin.PinYin())
    inv = "XIF_tone"
    return (jlex.FlatLexicon.from_tree(jl.lexicon,
                                       jcorpus.UnitInventory.standard(inv)),
            tlex.FlatLexicon.from_tree(tl.lexicon,
                                       tcorpus.UnitInventory.standard(inv)))


def test_flat_lexicon_arrays_equal():
    jf, tfl = flat_pair()
    assert tfl.n_nodes == jf.n_nodes == 125
    for f in ("child_ptr", "child_ids", "node_units"):
        a, b = getattr(tfl, f), getattr(jf, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tfl.node_syllable == jf.node_syllable
    assert tfl.node_words == jf.node_words


class _ForeignLM:
    """An LM object without ``bigram_tables_backoff``: the decoders build
    the dense ``[V+1, V]`` table through ``logprob`` calls."""

    def __init__(self, lm):
        self.lm = lm

    def logprob(self, word, context):
        return self.lm.logprob(word, context)


def decoder_pair(lm=None):
    cfg = ModelConfig(state_num=5, mix_level=2, max_mix_level=2)
    inv = jcorpus.UnitInventory.standard("XIF_tone")
    jbank = jsb.create_bank(len(inv), cfg, 13, key=jax.random.PRNGKey(2))
    tbank = bank_from_numpy({f: np.asarray(getattr(jbank, f))
                             for f in FIELDS}, device="cpu")
    jf, tfl = flat_pair()
    kw = dict(lm=lm, lm_weight=2.0, word_penalty=0.5)
    return JaxVector(jbank, jf, **kw), TorchVector(tbank, tfl, **kw)


def bigram():
    rng = np.random.default_rng(3)
    words = list(jtable.BUILTIN_PINYIN)
    lm = Ngram(2)
    lm.train([list(rng.choice(words, size=5)) for _ in range(60)])
    return lm


@pytest.mark.parametrize("lm_kind", ["none", "sparse", "dense"])
def test_decoder_tables_equal(lm_kind):
    lm = {"none": None, "sparse": bigram(),
          "dense": _ForeignLM(bigram())}[lm_kind]
    jd, td = decoder_pair(lm)
    jd._prep_tables()
    td._prep_tables()
    assert np.array_equal(td._bands, jd._bands)
    assert np.array_equal(td._senone, jd._senone)
    assert td._vocab == jd._vocab
    for f in ("_word_tab", "_child_tab", "_roots"):
        assert np.array_equal(getattr(td, f), getattr(jd, f))
    if lm_kind == "sparse":
        assert td._lm_tab is None and jd._lm_tab is None
        for a, b in zip(td._lm_sparse, jd._lm_sparse):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    elif lm_kind == "dense":
        assert td._lm_sparse is None
        assert np.array_equal(td._lm_tab, jd._lm_tab)
    else:
        assert td._lm_sparse is None and td._lm_tab is None


def test_reference_lexicon_from_a_dat_table(tmp_path):
    """``build_reference_lexicon`` on a small ``Mandarin.dat``-format
    table: the port's copy builds the JAX lexicon."""
    dat = tmp_path / "Mandarin.dat"
    dat.write_text("".join(f"{ord(c):X}\t{r[0]}\n"
                           for c, r in jtable.BUILTIN_PINYIN.items()))
    kw = dict(dat_path=str(dat), n_single=40, n_multi=60, seed=2)
    jf, jw, _ = jbuild.build_reference_lexicon(
        jcorpus.UnitInventory.standard("XIF_tone"), **kw)
    tf, tw, _ = tbuild.build_reference_lexicon(
        tcorpus.UnitInventory.standard("XIF_tone"), **kw)
    assert tw == jw and len(tw) == 100
    for f in ("child_ptr", "child_ids", "node_units"):
        assert np.array_equal(getattr(tf, f), getattr(jf, f))
    assert tf.node_words == jf.node_words and tf.n_nodes > 40
