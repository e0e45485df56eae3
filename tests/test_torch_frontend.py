"""MFCC frontend and VAD in the PyTorch port vs the JAX package.

Features are held to the JAX ``Frontend`` at rtol = atol = 2e-3 (the
tolerance of ``tests/test_frontend.py:61``) for every flag the decode
slice can set, on a ragged zero-padded batch; the ``reference_quirks``
pipeline is also held to the fp64 oracle ``tests/oracles.py:mfcc_quirk``.
VAD masks must be identical to JAX's and to ``oracles.vad_keep_mask`` on
features built away from the threshold.
"""

import numpy as np
import pytest
import torch

from poccala_tpu.config import FrontendConfig
from poccala_tpu.ops import vad as jax_vad
from poccala_tpu.ops.frontend import Frontend as JaxFrontend
from poccala_tpu.ops.frontend import dct_matrix as jax_dct
from poccala_tpu.ops.frontend import mel_filterbank_matrix as jax_mel
from poccala_tpu_torch.ops import frontend as tf
from poccala_tpu_torch.ops import vad as tvad

from . import oracles
from .test_frontend import synth_speechlike

torch.set_num_threads(1)

TOL = dict(rtol=2e-3, atol=2e-3)

CONFIGS = {
    "default": {},
    "reference_quirks": dict(reference_quirks=True),
    "cmvn_var": dict(cmvn=True, cmvn_var=True),
    "spectral_subtraction": dict(spectral_subtraction=True),
    "pitch": dict(pitch=True),
    "rfft": dict(matmul_dft=False),
}


def ragged_batch():
    n = np.array([16000, 12345, 7001])
    sigs = np.zeros((3, 16000), np.float32)
    for i, k in enumerate(n):
        sigs[i, :k] = synth_speechlike(int(k), seed=i)
    return sigs, n


class TestFeatures:
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_batch_matches_jax(self, name):
        cfg = FrontendConfig(**CONFIGS[name])
        sigs, n = ragged_batch()
        want, want_mask = JaxFrontend(cfg).mfcc_batch(sigs, n)
        got, got_mask = tf.Frontend(cfg).mfcc_batch(sigs, n)
        assert got.shape == want.shape == (3, 79, cfg.feat_dim)
        assert np.array_equal(got_mask.numpy(), np.asarray(want_mask))
        assert np.allclose(got.numpy(), np.asarray(want), **TOL)

    def test_quirks_match_reference_oracle(self):
        sig = synth_speechlike(16000)
        feats, mask = tf.Frontend(FrontendConfig(reference_quirks=True)) \
            .mfcc(sig)
        want = oracles.mfcc_quirk(sig.astype(np.float64), log_eps=1e-10)
        assert bool(mask.all())
        assert feats.shape == want.shape
        assert np.allclose(feats.numpy(), want, **TOL)

    def test_single_matches_jax_single(self):
        cfg = FrontendConfig()
        padded = np.zeros(9000, np.float32)
        padded[:8000] = synth_speechlike(8000, seed=7)
        want, wm = JaxFrontend(cfg).mfcc(padded, n_samples=8000)
        got, gm = tf.Frontend(cfg).mfcc(padded, n_samples=8000)
        assert np.array_equal(gm.numpy(), np.asarray(wm))
        assert np.allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("quirks", [False, True])
    def test_host_matrices_equal(self, quirks):
        cfg = FrontendConfig(reference_quirks=quirks)
        assert np.array_equal(tf.mel_filterbank_matrix(cfg), jax_mel(cfg))
        assert np.array_equal(tf.dct_matrix(cfg), jax_dct(cfg))

    def test_reduced_dot_precision_raises(self):
        with pytest.raises(ValueError):
            tf.Frontend(FrontendConfig(dot_precision="high"))


def vad_features(rng, t=120, d=39, speech=((30, 60), (80, 100))):
    """Digital-silence frames (exact zeros, so the noise template and
    their distances are exactly 0 and the threshold is exactly 0) with
    speech frames far from them: every smoothed distance is either 0 or
    far above the threshold."""
    f = np.zeros((t, d), np.float32)
    for lo, hi in speech:
        f[lo:hi] = rng.normal(3.0, 1.0, size=(hi - lo, d))
    return f


class TestVad:
    def test_matches_jax_and_oracle(self, rng):
        feats = vad_features(rng)
        mask = np.ones(len(feats), bool)
        got = tvad.vad_mask(torch.from_numpy(feats),
                            torch.from_numpy(mask)).numpy()
        want = np.asarray(jax_vad.vad_mask(feats, mask))
        oracle = oracles.vad_keep_mask(feats.astype(np.float64))
        assert 0 < got.sum() < len(got)
        assert np.array_equal(got, want)
        assert np.array_equal(got, oracle)

    def test_batch_with_padding_matches_jax(self, rng):
        feats = np.stack([vad_features(rng),
                          vad_features(rng, speech=((20, 50),)),
                          vad_features(rng, speech=((5, 15),))])
        t_true = np.array([120, 90, 25])
        mask = np.arange(120)[None] < t_true[:, None]
        feats = np.where(mask[..., None], feats, 0.0).astype(np.float32)
        got = tvad.vad_mask_batch(torch.from_numpy(feats),
                                  torch.from_numpy(mask)).numpy()
        want = np.asarray(jax_vad.vad_mask_batch(feats, mask))
        assert np.array_equal(got, want)
        assert np.array_equal(got[2], mask[2])  # short: keep all valid

    def test_apply_mask_matches_jax(self, rng):
        feats = rng.normal(size=(10, 3)).astype(np.float32)
        keep = rng.uniform(size=10) < 0.5
        for max_frames in (None, 3):
            got = tvad.apply_mask(torch.from_numpy(feats),
                                  torch.from_numpy(keep), max_frames)
            want = jax_vad.apply_mask(feats, keep, max_frames)
            assert got[1] == want[1]
            assert np.array_equal(got[0], want[0])
