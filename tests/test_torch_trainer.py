"""Scheme-2 training end to end, PyTorch port vs JAX package, and the
checkpoint format both packages share.

A synthetic corpus (XIF units) is loaded by both packages' ``Corpus``:
features agree within the frontend tolerance, masks and labels exactly.
Then JAX's ``Trainer`` flat-starts, its bank is carried across, and both
trainers run ``auto(mode=2, t=3, init=False)`` on the same batches: the
per-epoch logliks agree at rtol 1e-5 and the final banks at rtol 1e-3,
atol 2e-3 (three EM steps of float32 statistics summed in another order;
the absolute part covers values near zero and log variances, where 2e-3
is 0.2% of a variance), and the logliks rise.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from poccala_tpu.config import Config
from poccala_tpu.io import corpus as jcorpus
from poccala_tpu.train import checkpoint as jckpt
from poccala_tpu.train.trainer import Trainer as JaxTrainer
from poccala_tpu_torch.io import corpus as tcorpus
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.train import checkpoint as tckpt
from poccala_tpu_torch.train.trainer import Trainer
from poccala_tpu_torch.utils.errors import ModeError

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_corpus"))
    inv = jcorpus.UnitInventory.standard("XIF")
    # the utterances use 6 of the 62 units, so each of their senones sees
    # ~80 frames: 39-dim variances stay well above the 1e-6 floor, where
    # float32 EM is well conditioned (an unseen senone keeps its values)
    audio, label = jcorpus.generate_synthetic_corpus(
        root, jcorpus.UnitInventory(inv.units[20:26]), num_utts=20,
        units_per_utt=(2, 4), unit_seconds=0.2, seed=3)
    cfg = Config()
    cfg.paths.audio_file_path = audio
    cfg.paths.label_file_path = label
    cfg.frontend.vad = False
    # per-utterance CMVN keeps |x| of order 1: the synthetic tones' raw c0
    # (~25) at flat-start variances (~1e-4) puts x²/σ² terms at 1e7, where
    # one float32 ulp is whole nats and two summation orders disagree
    cfg.frontend.cmvn = cfg.frontend.cmvn_var = True
    cfg.model.state_num = 5
    cfg.model.mix_level = cfg.model.max_mix_level = 2
    cfg.train.batch_size = 8
    cfg.train.max_frames = 96
    cfg.train.max_label_len = 4
    cfg.train.step = 2
    cfg.train.proportion = 1.0
    jb = list(jcorpus.Corpus(cfg, inv).batches(use_native=False))
    tinv = tcorpus.UnitInventory.standard("XIF")
    tb = list(tcorpus.Corpus(cfg, tinv,
                             device="cpu").batches(use_native=False))
    return cfg, inv, tinv, jb, tb


def test_corpus_batches_match_jax(corpus):
    cfg, inv, tinv, jb, tb = corpus
    assert [len(b.labels) for b in tb] == [8, 8, 4]
    for g, w in zip(tb, jb):
        assert np.array_equal(g.t_masks, w.t_masks)
        assert np.array_equal(g.labels, w.labels)
        assert np.array_equal(g.label_lens, w.label_lens)
        np.testing.assert_allclose(g.feats, w.feats, rtol=2e-3, atol=2e-3)
    # the native loader gives the same batches (tests/test_torch_native.py)
    for g, w in zip(tcorpus.Corpus(cfg, tinv,
                                   device="cpu").batches(use_native=True), tb):
        assert np.array_equal(g.t_masks, w.t_masks)
        assert np.array_equal(g.labels, w.labels)
        np.testing.assert_allclose(g.feats, w.feats, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("var_floor_scale", [0.0, 0.3])
def test_scheme2_auto_matches_jax(corpus, var_floor_scale):
    cfg, inv, tinv, batches, _ = corpus
    cfg.model.var_floor_scale = var_floor_scale
    try:
        jtr = JaxTrainer(cfg, inv, key=jax.random.PRNGKey(0))
        jtr.flat_start(batches)
        tr = Trainer(cfg, tinv, device="cpu")
        tr.bank = tsb.bank_from_numpy({f: np.asarray(getattr(jtr.bank, f))
                                       for f in tsb.FIELDS}, device="cpu")
        want = jtr.auto(batches, t=3, mode=2, init=False)
        got = tr.auto(batches, t=3, mode=2, init=False)
    finally:
        cfg.model.var_floor_scale = 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[1] > got[0]
    if var_floor_scale:
        np.testing.assert_allclose(tr.var_floor, jtr.var_floor, rtol=1e-6)
        # the relative floor binds somewhere
        assert np.any(np.isclose(np.exp(tr.bank.log_var.numpy()),
                                 tr.var_floor, rtol=1e-5))
    for f in tsb.FIELDS:
        np.testing.assert_allclose(getattr(tr.bank, f).numpy(),
                                   np.asarray(getattr(jtr.bank, f)),
                                   rtol=1e-3, atol=2e-3, err_msg=f)
    assert [h["round"] for h in tr.history] == [0, 1, 2]


def test_auto_with_flat_start(corpus):
    """init=True flat-starts from the corpus with the trainer's generator:
    the same seed gives the same model."""
    cfg, inv, tinv, batches, _ = corpus
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, tinv, generator=torch.Generator().manual_seed(4),
                     device="cpu")
        lls = tr.auto(batches, t=2, mode=2, init=True)
        runs.append((lls, tr.bank.means.clone()))
        assert lls[1] > lls[0]
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


def test_unported_parts_raise(corpus):
    cfg, inv, tinv, batches, _ = corpus
    with pytest.raises(NotImplementedError, match="Queue 1"):
        Trainer(cfg, tinv, mesh=object(), device="cpu")
    tr = Trainer(cfg, tinv, device="cpu")
    with pytest.raises(ModeError):
        tr.auto(batches, mode=3)


def test_checkpoint_roundtrip_and_interop(corpus, tmp_path):
    cfg, inv, tinv, batches, _ = corpus
    tr = Trainer(cfg, tinv, device="cpu")
    tr.auto(batches, t=1, mode=2, init=True)
    path = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(path, tr.bank, manifest={"round": 1},
                          units=tinv.units)
    bank, man = tckpt.load_checkpoint(path, device="cpu")
    for f in tsb.FIELDS:
        a, b = getattr(bank, f), getattr(tr.bank, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert man["round"] == 1 and man["units"] == tinv.units
    assert man["format"] == "npz"
    # the JAX package reads the port's checkpoint, and writes the same
    # manifest for the same bank
    jbank, jman = jckpt.load_checkpoint(path)
    for f in tsb.FIELDS:
        assert np.array_equal(np.asarray(getattr(jbank, f)),
                              getattr(tr.bank, f).numpy()), f
    jpath = str(tmp_path / "jax_ckpt")
    jckpt.save_checkpoint(jpath, jbank, manifest={"round": 1},
                          units=tinv.units, sharded=False)
    with open(os.path.join(jpath, "manifest.json")) as fj, \
            open(os.path.join(path, "manifest.json")) as ft:
        assert json.load(fj) == json.load(ft)
    with pytest.raises(NotImplementedError):
        tckpt.save_checkpoint(str(tmp_path / "o"), tr.bank, sharded=True)


def test_export_bank_is_the_reference_api(corpus, tmp_path):
    """Code written against the JAX trainer calls ``export_bank()`` on
    unsharded trainers too (``poccala_tpu/cli.py:138``): the port's returns
    its bank, as JAX's does without shard padding, and a checkpoint written
    from it is the bank's."""
    cfg, inv, tinv, _, batches = corpus
    tr = Trainer(cfg, tinv, device="cpu")
    jt = JaxTrainer(cfg, inv)
    assert tr.export_bank() is tr.bank and jt.export_bank() is jt.bank
    tr.auto(batches, t=1, mode=2, init=True)
    assert tr.export_bank() is tr.bank
    path = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(path, tr.export_bank(), units=tinv.units)
    bank, _ = tckpt.load_checkpoint(path, device="cpu")
    for f in tsb.FIELDS:
        assert torch.equal(getattr(bank, f), getattr(tr.bank, f)), f
