"""A model trained by the port recognises: WAV corpus -> train -> decode
-> WER, PyTorch port vs JAX package, and the port's ``eval`` copy against
the original.

The corpus is that of ``tests/test_full_loop_wer.py``: 20 utterances of one
or two of three words, every unit a separable two-harmonic signature
(``synth_unit_signal``).  Each package loads the same WAVs with its own
``Corpus``, trains its own ``Trainer.auto(t=4, mode=2, init=True)`` (the
port through the plain versions of its DP kernels, on the CPU) and decodes
with its own ``DeviceBeamDecoder`` over ``export_bank()``.  The port's WER
is 0.0, as the JAX test asserts of the JAX pipeline, and both pipelines
give the same words for every utterance (words, not scores: two float32
trainings of four epochs are not held to each other here,
``tests/test_torch_trainer.py`` does that with CMVN).

``edit_distance`` / ``wer`` / ``evaluate_decoder`` of the port's copy equal
the original's on seeded random token lists (integers: exact).
"""

import importlib
import os

import numpy as np
import pytest
import torch

from poccala_tpu.config import Config
from poccala_tpu.decoder.device import DeviceBeamDecoder as JaxDecoder
from poccala_tpu.io import corpus as jcorpus
from poccala_tpu.lexicon import FlatLexicon as JaxFlatLexicon
from poccala_tpu.lexicon import PinYin as JaxPinYin
from poccala_tpu.lexicon import PronunciationLexicon as JaxLexicon
from poccala_tpu.train.trainer import Trainer as JaxTrainer
from poccala_tpu_torch import eval as teval
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.io import corpus as tcorpus
from poccala_tpu_torch.io import wav as wav_io
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

# the packages' ``eval`` export the function ``wer`` over the module's name
jwer = importlib.import_module("poccala_tpu.eval.wer")
twer = importlib.import_module("poccala_tpu_torch.eval.wer")

TABLE = {"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}
WORDS = ["你好", "你", "马"]
WORD_SYLLABLES = {"你好": ["ni3", "hao3"], "你": ["ni3"], "马": ["ma1"]}
UNITS = ["n", "i3", "h", "ao3", "m", "a1"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The WAVs, their labels, the reference words and the config."""
    root = str(tmp_path_factory.mktemp("torch_wer"))
    audio_dir = os.path.join(root, "record")
    label_dir = os.path.join(root, "label")
    os.makedirs(audio_dir)
    os.makedirs(label_dir)
    inv = tcorpus.UnitInventory(UNITS)
    pinyin = PinYin(TABLE)
    rng = np.random.default_rng(11)
    rate, n_unit = 16000, int(0.3 * 16000)
    refs = []
    for i in range(20):
        words = [WORDS[w] for w in rng.integers(0, 3, size=rng.integers(1, 3))]
        syllables = [s for w in words for s in WORD_SYLLABLES[w]]
        unit_ids = inv.encode([u for s in syllables
                               for u in pinyin.syllable_to_units(s)])
        sig = np.concatenate([tcorpus.synth_unit_signal(u, n_unit, rate, rng)
                              for u in unit_ids])
        name = f"utt{i:04d}"
        wav_io.write_wav(os.path.join(audio_dir, name + ".wav"), sig, rate)
        with open(os.path.join(label_dir, name + ".wav.trn"), "w") as f:
            f.write(" ".join(syllables) + "\n")
        refs.append(words)

    cfg = Config()
    cfg.paths.audio_file_path = audio_dir
    cfg.paths.label_file_path = label_dir
    cfg.train.load_line = 0
    cfg.train.label_format = "pinyin"
    cfg.frontend.vad = False
    cfg.model.mix_level = cfg.model.max_mix_level = 2
    cfg.train.batch_size = 10
    cfg.train.max_frames = 256
    cfg.train.max_label_len = 8
    cfg.train.proportion = 1.0
    cfg.train.step = 4
    return cfg, refs


def utterances(batches, refs):
    utts, n_frames = [], []
    for batch in batches:
        for i in range(len(batch.feats)):
            utts.append((batch.feats[i], refs[len(utts)]))
            n_frames.append(int(batch.t_masks[i].sum()))
    return utts, n_frames


def decoded_words(dec, utts, n_frames):
    out = []
    for (feats, _), n in zip(utts, n_frames):
        hyps = dec.decode(feats, n_frames=n, return_nbest=1)
        out.append(list(hyps[0].words) if hyps else [])
    return out


@pytest.fixture(scope="module")
def port(world):
    cfg, refs = world
    inv = tcorpus.UnitInventory(UNITS)
    batches = list(tcorpus.Corpus(cfg, inv, device="cpu").batches())
    tr = Trainer(cfg, inv, device="cpu")
    lls = tr.auto(batches, t=4, mode=2, init=True)
    lex = PronunciationLexicon()
    lex.generate(WORDS, PinYin(TABLE))
    dec = DeviceBeamDecoder(tr.export_bank(),
                            FlatLexicon.from_tree(lex.lexicon, inv))
    utts, n_frames = utterances(batches, refs)
    return dec, utts, n_frames, lls


@pytest.fixture(scope="module")
def jax_words(world):
    cfg, refs = world
    inv = jcorpus.UnitInventory(UNITS)
    batches = list(jcorpus.Corpus(cfg, inv).batches())
    tr = JaxTrainer(cfg, inv)
    tr.auto(batches, t=4, mode=2, init=True)
    lex = JaxLexicon()
    lex.generate(WORDS, JaxPinYin(TABLE))
    dec = JaxDecoder(tr.export_bank(),
                     JaxFlatLexicon.from_tree(lex.lexicon, inv))
    return decoded_words(dec, *utterances(batches, refs))


def test_port_trained_model_has_zero_wer(world, port):
    dec, utts, n_frames, lls = port
    assert len(utts) == 20
    assert np.isfinite(lls).all() and lls[-1] > lls[0]
    result = teval.evaluate_decoder(dec, utts, n_frames)
    # separable synthetic units, fixed seeds: decoding is perfect
    assert result.wer == 0.0, (
        f"WER {result.wer:.2f} (S={result.substitutions} "
        f"D={result.deletions} I={result.insertions} / {result.ref_tokens})")
    assert result.sentences == 20 and result.sentence_errors == 0
    assert result.ref_tokens == sum(len(r) for r in world[1])


def test_port_pipeline_gives_the_jax_pipelines_words(world, port, jax_words):
    dec, utts, n_frames, _ = port
    got = decoded_words(dec, utts, n_frames)
    assert got == jax_words
    assert got == [list(r) for r in world[1]]


def token_lists(seed):
    """Reference / hypothesis pairs: hypotheses are references with random
    substitutions, deletions and insertions, plus empty and equal ones."""
    rng = np.random.default_rng(seed)
    refs, hyps = [], []
    for _ in range(12):
        ref = [f"w{v}" for v in rng.integers(0, 6, size=rng.integers(0, 9))]
        hyp = []
        for tok in ref:
            roll = rng.uniform()
            if roll < 0.15:
                continue
            hyp.append(f"w{rng.integers(0, 6)}" if roll < 0.35 else tok)
            if roll > 0.85:
                hyp.append(f"w{rng.integers(0, 6)}")
        refs.append(ref)
        hyps.append(hyp)
    refs += [[], ["w1", "w2"]]
    hyps += [["w0"], ["w1", "w2"]]
    return refs, hyps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edit_distance_equals_original(seed):
    for ref, hyp in zip(*token_lists(seed)):
        got = twer.edit_distance(ref, hyp)
        assert got == jwer.edit_distance(ref, hyp)
        assert got[3] == sum(got[:3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wer_equals_original(seed):
    refs, hyps = token_lists(seed)
    got, want = twer.wer(refs, hyps), jwer.wer(refs, hyps)
    assert got == twer.WerResult(**vars(want))
    assert got.ser == want.ser and 0.0 < got.wer


class ListDecoder:
    """Answers utterance i (features ``[[i]]``) with a fixed word list."""

    class Hyp:
        def __init__(self, words):
            self.words = words

    def __init__(self, hyps):
        self.hyps = hyps

    def decode(self, feats, n_frames=None, return_nbest=1):
        words = self.hyps[int(feats[0, 0])]
        return [self.Hyp(words)] if words else []


def test_evaluate_decoder_equals_original():
    refs, hyps = token_lists(5)
    utts = [(np.full((3, 2), i, np.float32), r) for i, r in enumerate(refs)]
    n_frames = [3] * len(utts)
    got = teval.evaluate_decoder(ListDecoder(hyps), utts, n_frames)
    want = jwer.evaluate_decoder(ListDecoder(hyps), utts, n_frames)
    assert vars(got) == vars(want)
    assert got == twer.wer(refs, hyps)
    assert teval.evaluate_decoder(ListDecoder(hyps), utts) == got
