"""The port's copy of ``poccala_tpu/decoder/rescore.py`` (host NumPy whose
JAX import chain loads jax), pinned to the original: every function's
source is verbatim, and fixed n-best lists rescore to the same words and
scores through both."""

import inspect

import numpy as np
import pytest

from poccala_tpu.decoder import rescore as jr
from poccala_tpu.decoder.beam import Hypothesis as JaxHypothesis
from poccala_tpu.lexicon import FlatLexicon as JaxFlat
from poccala_tpu.lexicon import PinYin as JaxPinYin
from poccala_tpu.lexicon import PronunciationLexicon as JaxLexicon
from poccala_tpu.io.corpus import UnitInventory as JaxInventory
from poccala_tpu.lm.ngram import Ngram
from poccala_tpu_torch.decoder import rescore as tr
from poccala_tpu_torch.decoder.beam import Hypothesis
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon

FUNCS = ["decode_lm_score", "rescore_hyps", "rescore_nbest",
         "homophone_groups", "best_homophone_path", "rescore_sausage"]
# homophones: 他/她/它 share ta1; 是/市 share shi4
TABLE = {"他": ["ta1"], "她": ["ta1"], "它": ["ta1"], "是": ["shi4"],
         "市": ["shi4"], "马": ["ma1"], "好": ["hao3"]}
WORDS = ["他", "她", "它", "是", "市", "马", "好", "他是", "马市"]


@pytest.mark.parametrize("name", FUNCS)
def test_copied_source_is_verbatim(name):
    assert inspect.getsource(getattr(tr, name)) == \
        inspect.getsource(getattr(jr, name))


def lms():
    sents = [["他", "是", "马"], ["她", "是", "好"], ["马市", "好"],
             ["他是", "马"], ["它", "是", "马"]] * 2
    decode_lm, rescore_lm = Ngram(2), Ngram(3, smoothing="wb")
    decode_lm.train(sents)
    rescore_lm.train(sents + [["她", "市", "好"]])
    return decode_lm, rescore_lm


def nbest(cls):
    return [[cls(score=-120.5, words=("他", "是", "马")),
             cls(score=-121.0, words=("他是", "马")),
             cls(score=-125.25, words=("它", "市"))],
            [cls(score=-80.0, words=("马市", "好")),
             cls(score=-80.0, words=("马", "是", "好"))]]


def as_tuples(lists):
    return [[(h.words, h.score) for h in hyps] for hyps in lists]


@pytest.mark.parametrize("decode_lm_on", [False, True])
def test_rescore_nbest_equals_original(decode_lm_on):
    decode_lm, rescore_lm = lms()
    dlm = decode_lm if decode_lm_on else None
    got = tr.rescore_nbest(nbest(Hypothesis), dlm, rescore_lm, 4.0, 1.5)
    want = jr.rescore_nbest(nbest(JaxHypothesis), dlm, rescore_lm, 4.0, 1.5)
    assert as_tuples(got) == as_tuples(want)
    assert all(isinstance(h, Hypothesis) for hyps in got for h in hyps)
    for words in (("他", "是", "马"), ("马市", "好")):
        assert tr.decode_lm_score(dlm, words, 4.0, 1.5) == \
            jr.decode_lm_score(dlm, words, 4.0, 1.5)


def test_rescore_sausage_equals_original():
    decode_lm, rescore_lm = lms()
    tl, jl = PronunciationLexicon(), JaxLexicon()
    tl.generate(WORDS, PinYin(TABLE))
    jl.generate(WORDS, JaxPinYin(TABLE))
    units = ["t", "a1", "sh", "i4", "m", "h", "ao3"]
    tflat = FlatLexicon.from_tree(tl.lexicon, UnitInventory(units))
    jflat = JaxFlat.from_tree(jl.lexicon, JaxInventory(units))
    groups = tr.homophone_groups(tflat)
    assert groups == jr.homophone_groups(jflat)
    assert set(groups["他"]) == {"他", "她", "它"}
    assert tr.best_homophone_path(("他", "是", "马"), groups, rescore_lm,
                                  3.0) == \
        jr.best_homophone_path(("他", "是", "马"), groups, rescore_lm, 3.0)
    got = tr.rescore_sausage(nbest(Hypothesis), groups, decode_lm,
                             rescore_lm, 4.0, 1.5)
    want = jr.rescore_sausage(nbest(JaxHypothesis), groups, decode_lm,
                              rescore_lm, 4.0, 1.5)
    assert as_tuples(got) == as_tuples(want)
