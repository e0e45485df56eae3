"""The port's native batch loader (``Corpus.batches(use_native=True)``):
WAVs decoded by the port's own copy of the C++ loader
(``poccala_tpu_torch.native``), then the port's batched frontend and VAD.

Its batches equal the port's per-utterance batches (masks and labels
exactly, features at the frontend parity tolerance of
``tests/test_torch_frontend.py``) and the JAX package's native batches.
As in ``tests/test_native.py``, the toolchain is expected: no skip.
"""

import numpy as np
import pytest
import torch

from poccala_tpu_torch import native
from poccala_tpu.config import Config
from poccala_tpu.io import corpus as jcorpus
from poccala_tpu_torch.io import corpus as tcorpus

torch.set_num_threads(1)

TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_torch_frontend.py


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    inv = tcorpus.UnitInventory(["aa", "bb", "cc"])
    return inv, tcorpus.generate_synthetic_corpus(
        str(tmp_path_factory.mktemp("native")), inv, num_utts=7, seed=3)


def config(audio, label, vad):
    cfg = Config()
    cfg.paths.audio_file_path = audio
    cfg.paths.label_file_path = label
    cfg.frontend.vad = vad
    cfg.train.load_line = 0
    cfg.train.batch_size = 4
    cfg.train.max_frames = 128
    cfg.train.max_label_len = 5
    return cfg


def test_native_toolchain_present():
    assert native.available(), "native toolchain expected in this image"


def same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a.labels, b.labels)
        assert np.array_equal(a.label_lens, b.label_lens)
        assert np.array_equal(a.t_masks, b.t_masks)
        assert a.feats.shape == b.feats.shape
        np.testing.assert_allclose(a.feats, b.feats, **TOL)


@pytest.mark.parametrize("vad", [False, True], ids=["no_vad", "vad"])
def test_native_batches_match_per_utterance_and_jax(corpus_dir, vad):
    inv, (audio, label) = corpus_dir
    cfg = config(audio, label, vad)
    corpus = tcorpus.Corpus(cfg, inv, device="cpu")
    nat = list(corpus.batches(use_native=True))
    assert [len(b.labels) for b in nat] == [4, 3]
    same_batches(nat, list(corpus.batches(use_native=False)))
    # use_native=None picks the native loader when it builds, as in JAX
    same_batches(list(corpus.batches()), nat)
    jinv = jcorpus.UnitInventory(inv.units)
    same_batches(nat, list(jcorpus.Corpus(cfg, jinv).batches(
        use_native=True)))


def test_native_drop_last_and_bad_labels(corpus_dir, tmp_path):
    """A label naming an unknown unit drops its utterance from the batch,
    and ``drop_last`` drops the short final batch — as the per-utterance
    path does for the bad label."""
    import shutil

    inv, (audio, label) = corpus_dir
    bad = tmp_path / "label"
    shutil.copytree(label, bad)
    with open(bad / "utt00001.wav.trn", "w") as f:
        f.write("zz aa\n")
    cfg = config(audio, str(bad), vad=False)
    corpus = tcorpus.Corpus(cfg, inv, device="cpu")
    nat = list(corpus.batches(use_native=True))
    assert [len(b.labels) for b in nat] == [3, 3]
    py = list(corpus.batches(use_native=False))
    assert np.array_equal(nat[0].labels, py[0].labels[:3])
    assert [len(b.labels) for b in corpus.batches(use_native=True,
                                                  drop_last=True)] == [3]
