"""The port's host decoder tiers against the JAX package's.

``BeamDecoder`` (dict token passing, one utterance at a time) and
``VectorBeamDecoder`` (array token passing, batched) of both packages
decode the same features with one bank: the bank that
``tests/test_lexicon_decoder.py:_trained_setup`` trains with the JAX
trainer, carried into the port through the numpy weight converter.  The
host bookkeeping is the same NumPy float64 code in both packages; only the
GMM scores differ (XLA against PyTorch's plain version, both float32), so
the n-best words must be equal and the scores within rtol 1e-4, the
tolerance the device tier is held to (``tests/test_torch_decoder.py``).

Covered: no LM, a word penalty alone, a sparse ``Ngram`` bigram and a
foreign LM object (the dense table), with the penalty; ragged ``n_frames``
with an empty utterance in the batch; a 120-root lexicon where the vector
tier's ``restart_top`` caps the word restarts; an empty utterance and an
empty lexicon; and, inside the port, the agreement between tiers that the
JAX tests hold (``tests/test_vector_decoder.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.config import ModelConfig
from poccala_tpu.decoder import BeamDecoder as JaxBeam
from poccala_tpu.decoder.device import DeviceBeamDecoder as JaxDevice
from poccala_tpu.decoder.vector import VectorBeamDecoder as JaxVector
from poccala_tpu.io.corpus import UnitInventory as JaxInventory
from poccala_tpu.lexicon import FlatLexicon as JaxFlat
from poccala_tpu.lexicon import PinYin as JaxPinYin
from poccala_tpu.lexicon import PronunciationLexicon as JaxLexicon
from poccala_tpu.lm.ngram import Ngram
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu_torch.decoder import BeamDecoder, DeviceBeamDecoder
from poccala_tpu_torch.decoder.vector import VectorBeamDecoder
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.models import senone_bank as tsb

from .test_lexicon_decoder import _trained_setup
from .test_torch_lexicon import _ForeignLM

torch.set_num_threads(1)

TABLE = {"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}
WORDS = ["你好", "你", "马"]
SEQS = ([0, 1, 2, 3], [4, 5], [0, 1], [0, 1, 2, 3, 4, 5])  # test_vector_decoder.py:31
RTOL = 1e-4


def to_port(jbank):
    return tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                for f in tsb.FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    tr, inv, _, utt = _trained_setup(rng)
    jl, tl = JaxLexicon(), PronunciationLexicon()
    jl.generate(WORDS, JaxPinYin(TABLE))
    tl.generate(WORDS, PinYin(TABLE))
    feats = [utt(s, frames_per_unit=10)[0] for s in SEQS]
    lm = Ngram(2)
    lm.train([["你好"]] * 10 + [["马"]] + [["你", "马"]] * 3)
    return dict(jbank=tr.bank, tbank=to_port(tr.bank),
                jflat=JaxFlat.from_tree(jl.lexicon, inv),
                tflat=FlatLexicon.from_tree(tl.lexicon,
                                            UnitInventory(inv.units)),
                feats=feats, lm=lm)


def lm_kwargs(world, kind):
    return {"none": {},
            "penalty": dict(word_penalty=1.5),
            "sparse": dict(lm=world["lm"], lm_weight=5.0, word_penalty=0.5),
            "dense": dict(lm=_ForeignLM(world["lm"]), lm_weight=5.0,
                          word_penalty=0.5)}[kind]


def assert_same_nbest(got, want, what):
    assert [h.words for h in got] == [h.words for h in want], what
    np.testing.assert_allclose([h.score for h in got],
                               [h.score for h in want], rtol=RTOL, atol=0.0,
                               err_msg=str(what))


LM_KINDS = ["none", "penalty", "sparse", "dense"]


@pytest.mark.parametrize("lm_kind", LM_KINDS)
@pytest.mark.parametrize("tier", ["simple", "vector"])
def test_decode_matches_jax(world, tier, lm_kind):
    jcls, tcls = {"simple": (JaxBeam, BeamDecoder),
                  "vector": (JaxVector, VectorBeamDecoder)}[tier]
    kw = dict(candidate=3, **lm_kwargs(world, lm_kind))
    jd = jcls(world["jbank"], world["jflat"], **kw)
    td = tcls(world["tbank"], world["tflat"], **kw)
    for seq, x in zip(SEQS, world["feats"]):
        want = jd.decode(x)
        got = td.decode(x)
        assert got, seq
        assert_same_nbest(got, want, seq)


@pytest.mark.parametrize("lm_kind", LM_KINDS)
def test_decode_batch_ragged_matches_jax(world, lm_kind):
    """One batch of the four utterances and an empty one, padded to the
    longest: each row's n-best is JAX's, and the empty row has none."""
    kw = dict(candidate=3, **lm_kwargs(world, lm_kind))
    jd = JaxVector(world["jbank"], world["jflat"], **kw)
    td = VectorBeamDecoder(world["tbank"], world["tflat"], **kw)
    xs = world["feats"] + [world["feats"][1][:0]]
    t_max = max(len(x) for x in xs)
    feats = np.zeros((len(xs), t_max, xs[0].shape[1]), np.float32)
    for i, x in enumerate(xs):
        feats[i, : len(x)] = x
    n_frames = np.array([len(x) for x in xs])
    want = jd.decode_batch(feats, n_frames, return_nbest=3)
    got = td.decode_batch(feats, n_frames, return_nbest=3)
    assert len(got) == len(want) == len(xs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same_nbest(g, w, i)
    assert all(got[:-1]) and got[-1] == []
    # the features and lengths as tensors give the same answer
    again = td.decode_batch(torch.as_tensor(feats), torch.as_tensor(n_frames),
                            return_nbest=3)
    assert [[(h.words, h.score) for h in r] for r in again] == \
        [[(h.words, h.score) for h in r] for r in got]


class _CountingVector(VectorBeamDecoder):
    """Records the most word restarts one frame proposed before the
    ``restart_top`` cap."""

    most_restarts = 0

    def _lm_lookup(self, last_word, words):
        self.most_restarts = max(self.most_restarts, int(np.size(words)))
        return super()._lm_lookup(last_word, words)


def many_roots(rng):
    """``tests/test_vector_decoder.py:113-176``'s world: 22 units, a bank
    whose senone means are per-unit embeddings, and 120 single-syllable
    words -> 120 first-level nodes.  Returns (JAX bank, port bank, JAX
    lexicon, port lexicon, embeddings)."""
    n_ini, n_fin = 12, 10
    initials = [f"b{i}" for i in range(n_ini)]
    finals = [f"a{i}1" for i in range(n_fin)]
    units = initials + finals
    cfg = ModelConfig(state_num=5, mix_level=1, max_mix_level=1)
    jbank = jsb.create_bank(len(units), cfg, 8, differentiation=False)
    emb = rng.normal(size=(len(units), 8)).astype(np.float32) * 4
    jbank = dataclasses.replace(
        jbank, means=jnp.asarray(np.repeat(emb, 3, axis=0)[:, None, :]))
    flats = []
    for lex_cls, flat_cls, inv_cls in (
            (JaxLexicon, JaxFlat, JaxInventory),
            (PronunciationLexicon, FlatLexicon, UnitInventory)):
        lex = lex_cls()
        for i in range(n_ini):
            for j in range(n_fin):
                syl = f"{initials[i]},{finals[j]}"
                node = lex.lexicon.setdefault(initials[i], {}) \
                    .setdefault(syl, {})
                node.setdefault("word", []).append(chr(0x4E00 + i * n_fin + j))
        flats.append(flat_cls.from_tree(lex.lexicon, inv_cls(units)))
    return jbank, to_port(jbank), *flats, emb, n_ini, n_fin


def test_restart_cap_on_120_roots_matches_jax():
    rng = np.random.default_rng(4)
    jbank, tbank, jflat, tflat, emb, n_ini, n_fin = many_roots(rng)
    assert len(tflat.children(0)) == n_ini * n_fin
    kw = dict(max_tokens=48, candidate=12)
    jd = JaxVector(jbank, jflat, **kw)
    td = _CountingVector(tbank, tflat, **kw)
    for i, j in ((5, 3), (0, 0), (11, 9)):
        x = np.concatenate([
            emb[i] + rng.normal(size=(8, 8)) * 0.3,
            emb[n_ini + j] + rng.normal(size=(8, 8)) * 0.3,
        ]).astype(np.float32)
        want, got = jd.decode(x), td.decode(x)
        assert got and got[0].words == (chr(0x4E00 + i * n_fin + j),)
        assert_same_nbest(got, want, (i, j))
    assert td.most_restarts > VectorBeamDecoder.restart_top == 16


def test_empty_utterance_and_empty_lexicon(world):
    """The simple tier answers ``n_frames = 0`` with no hypothesis (the
    vector tier's empty row is in the ragged batch above); no lexicon
    word gives none either."""
    x = world["feats"][0]
    assert BeamDecoder(world["tbank"], world["tflat"]).decode(x, n_frames=0) \
        == JaxBeam(world["jbank"], world["jflat"]).decode(x, n_frames=0) == []
    jempty = JaxFlat.from_tree({}, JaxInventory(["n", "i3"]))
    tempty = FlatLexicon.from_tree({}, UnitInventory(["n", "i3"]))
    assert tempty.n_nodes == jempty.n_nodes == 1
    assert BeamDecoder(world["tbank"], tempty).decode(x) \
        == JaxBeam(world["jbank"], jempty).decode(x) == []
    batch = np.stack([x, x])
    assert VectorBeamDecoder(world["tbank"], tempty).decode_batch(
        batch, [len(x), 4]) == [[], []]


def test_tiers_agree_in_the_port(world):
    """What the JAX tests hold between its tiers: vector and simple give
    one 1-best (scores rtol 1e-5), vector and device one 1-best (rtol
    1e-4)."""
    simple = BeamDecoder(world["tbank"], world["tflat"], candidate=3)
    vector = VectorBeamDecoder(world["tbank"], world["tflat"], candidate=3)
    device = DeviceBeamDecoder(world["tbank"], world["tflat"], candidate=3)
    for seq, x in zip(SEQS, world["feats"]):
        h_vec, h_ref, h_dev = vector.decode(x), simple.decode(x), \
            device.decode(x)
        assert h_vec and h_ref and h_dev, seq
        assert h_vec[0].words == h_ref[0].words == h_dev[0].words, seq
        assert np.isclose(h_vec[0].score, h_ref[0].score, rtol=1e-5), seq
        assert np.isclose(h_dev[0].score, h_vec[0].score, rtol=1e-4), seq


def test_frame_scores_are_host_float64(world):
    """``_frame_scores`` returns JAX's float64 score matrix from an array
    or a tensor."""
    x = world["feats"][3]
    jd = JaxBeam(world["jbank"], world["jflat"])
    td = BeamDecoder(world["tbank"], world["tflat"])
    want = jd._frame_scores(x)
    for feats in (x, torch.as_tensor(x)):
        got = td._frame_scores(feats)
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_device_tier_inherits_the_host_step():
    """As in JAX, the device tier keeps the host tiers' ``_step``; its own
    frame step has another name."""
    assert DeviceBeamDecoder._step is BeamDecoder._step
    assert JaxDevice._step is JaxBeam._step
    assert DeviceBeamDecoder._frame_step is not BeamDecoder._step
