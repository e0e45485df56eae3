"""MFCC frontend and VAD in the PyTorch port vs the JAX package.

Features are held to the JAX ``Frontend`` at rtol = atol = 2e-3 (the
tolerance of ``tests/test_frontend.py:61``) for every flag the decode
slice can set, on a ragged zero-padded batch; the ``reference_quirks``
pipeline is also held to the fp64 oracle ``tests/oracles.py:mfcc_quirk``.
VAD masks must be identical to JAX's and to ``oracles.vad_keep_mask`` on
features built away from the threshold.

``dot_precision`` ``'high'`` (bf16_3x) and ``'default'`` (one bf16 pass):
each dot against a float64 evaluation of the same bf16 split (NumPy's own
round-to-nearest-even) within float32 accumulation error; the features
against a float64 NumPy pipeline with the same split, within that error
carried through the pipeline to first order; and against JAX's features
(whose CPU run ignores the precision: ``'highest'``) within the same
propagation of bf16's unit roundoff ``u = 2⁻⁸``: a worst case of ``4u²``
of each product's magnitude for bf16_3x, and for one pass, whose worst
case exceeds the low-energy mel bins, six standard deviations of
independent roundings (``u·sqrt(2/3)`` for the two operands of a
product), both on top of the 2e-3 that holds at ``'highest'``.
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
        got, got_mask = tf.Frontend(cfg, device="cpu").mfcc_batch(sigs, n)
        assert got.shape == want.shape == (3, 79, cfg.feat_dim)
        assert np.array_equal(got_mask.numpy(), np.asarray(want_mask))
        assert np.allclose(got.numpy(), np.asarray(want), **TOL)

    def test_quirks_match_reference_oracle(self):
        sig = synth_speechlike(16000)
        feats, mask = tf.Frontend(FrontendConfig(reference_quirks=True),
                                  device="cpu") \
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
        got, gm = tf.Frontend(cfg, device="cpu").mfcc(padded, n_samples=8000)
        assert np.array_equal(gm.numpy(), np.asarray(wm))
        assert np.allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("quirks", [False, True])
    def test_host_matrices_equal(self, quirks):
        cfg = FrontendConfig(reference_quirks=quirks)
        assert np.array_equal(tf.mel_filterbank_matrix(cfg), jax_mel(cfg))
        assert np.array_equal(tf.dct_matrix(cfg), jax_dct(cfg))

    def test_reduced_dot_precision_raises(self):
        """JAX's three names build a frontend; any other raises KeyError
        where JAX looks it up (with ``matmul_dft``; without it JAX never
        reads the field, and neither does the port)."""
        for name in ("highest", "high", "default"):
            tf.Frontend(FrontendConfig(dot_precision=name), device="cpu")
        with pytest.raises(KeyError):
            tf.Frontend(FrontendConfig(dot_precision="bf16"), device="cpu")
        tf.Frontend(FrontendConfig(dot_precision="bf16", matmul_dft=False),
                    device="cpu")


# ----------------------------------------------------------------------
# dot_precision 'high' and 'default'

U_BF16 = 2.0 ** -8      # bf16's unit roundoff (8 significant bits)
U_F32 = 2.0 ** -24
REDUCED = ("high", "default")
SPLIT = {"highest": None, "high": ((0, 0), (0, 1), (1, 0)),
         "default": ((0, 0),)}


def bf16_round(x) -> np.ndarray:
    """float32 ``x`` rounded to bf16 (nearest, ties to even), as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def split_dot64(x, w, precision) -> np.ndarray:
    """``x @ w`` of float32 operands at ``precision``, each product of the
    bf16 split and their sum in float64."""
    x, w = np.asarray(x, np.float32), np.asarray(w, np.float32)
    if SPLIT[precision] is None:
        return x.astype(np.float64) @ w.astype(np.float64)
    parts = []
    for v in (x, w):
        hi = bf16_round(v)
        parts.append((hi.astype(np.float64),
                      bf16_round(v - hi).astype(np.float64)))
    return sum(parts[0][i] @ parts[1][j] for i, j in SPLIT[precision])


def dft_basis(cfg) -> np.ndarray:
    k = (np.arange(cfg.nfft)[:, None] * np.arange(cfg.nfft // 2 + 1)[None]
         * 2.0 * np.pi / cfg.nfft)[: cfg.frame_size]
    return np.concatenate([np.cos(k).astype(np.float32),
                           np.sin(k).astype(np.float32)], axis=1)


def pipeline64(sigs, n, cfg, dot, on_dot=None):
    """The default (textbook) MFCC + Δ + ΔΔ pipeline in float64 with the
    port's float32 constants, each of its three dots through ``dot(x, w,
    name)``; ``on_dot(name, x, w)`` sees each dot's operands.  Returns
    ``[B, T, 39]``."""
    fs, st = cfg.frame_size, cfg.frame_step
    window = ((1 - cfg.hamming_alpha) - cfg.hamming_alpha * np.cos(
        2 * np.pi * np.arange(fs) / (fs - 1))).astype(np.float32)
    mats = dict(dft=dft_basis(cfg), mel=tf.mel_filterbank_matrix(cfg),
                dct=tf.dct_matrix(cfg))
    t_pad = tf.num_frames(sigs.shape[1], fs, st)

    def run(name, x):
        if on_dot is not None:
            on_dot(name, x, mats[name])
        return dot(x, mats[name], name)

    out = []
    for sig, n_u in zip(sigs.astype(np.float64), n):
        pe = np.append(sig[1:] - cfg.pre_emphasis * sig[:-1], 0.0)
        pe[n_u - 1] = 0.0
        pe = np.pad(pe, (0, (t_pad - 1) * st + fs - len(pe)))
        win = np.stack([pe[i * st: i * st + fs] for i in range(t_pad)])
        cs = run("dft", win * window)
        k = cs.shape[1] // 2
        spec = np.hypot(cs[:, :k], cs[:, k:])
        fbank = run("mel", spec)
        ceps = run("dct", np.log(np.maximum(fbank, 1e-10)))
        ceps[:, 0] = np.log(np.maximum((spec * spec).sum(-1), 1e-10))
        t_true = int(np.clip(1 + np.ceil((n_u - fs) / st), 1, t_pad))
        w_delta = tf.delta_matrix(t_pad, cfg.delta_n).astype(np.float64)

        def delta(f):
            g = f.copy()
            g[t_true:] = f[t_true - 1]
            return w_delta @ g
        d1 = delta(ceps)
        feats = np.concatenate([ceps, d1, delta(d1)], axis=-1)
        feats[t_true:] = 0.0
        out.append(feats)
    return np.stack(out)


def feature_bound(sigs, n, cfg, c_abs, c_rms=0.0):
    """Each feature's error, to first order, when every dot's error is at
    most ``c_abs[name]·(|x| @ |w|) + c_rms·sqrt(x² @ w²)``: carried through
    ``|spec|`` (the modulus moves by at most the parts' error), the
    energy, the log (the interval ``[log max(f - e, 1e-10), log(f + e)]``
    around ``log f``), the DCT and the Δ regressions (their ``|W|``)."""
    found = {}

    def dot(x, w, name):
        x64, w64 = x.astype(np.float64), w.astype(np.float64)
        found[name] = (x64 @ w64, c_abs[name] * (np.abs(x64) @ np.abs(w64))
                       + c_rms * np.sqrt((x64 * x64) @ (w64 * w64)))
        return found[name][0]

    fs, st = cfg.frame_size, cfg.frame_step
    t_pad = tf.num_frames(sigs.shape[1], fs, st)
    out = []
    for u in range(len(sigs)):
        found.clear()
        mats = {}
        pipeline64(sigs[u:u + 1], n[u:u + 1], cfg, dot,
                   on_dot=lambda name, x, w: mats.setdefault(name, w))
        cs, e_cs = found["dft"]
        k = cs.shape[1] // 2
        spec = np.hypot(cs[:, :k], cs[:, k:])
        e_spec = np.hypot(e_cs[:, :k], e_cs[:, k:])
        energy = (spec * spec).sum(-1)
        e_energy = (2 * spec * e_spec + e_spec * e_spec).sum(-1)
        mel = mats["mel"].astype(np.float64)
        fbank = spec @ mel
        e_fbank = e_spec @ mel + c_abs["mel"] * ((spec + e_spec) @ mel) \
            + c_rms * np.sqrt((spec + e_spec) ** 2 @ mel ** 2)

        def log_err(f, e):
            lo = np.log(np.maximum(f - e, 1e-10))
            return np.maximum(np.log(np.maximum(f + e, 1e-10))
                              - np.log(np.maximum(f, 1e-10)),
                              np.log(np.maximum(f, 1e-10)) - lo)
        e_log = log_err(fbank, e_fbank)
        dct = np.abs(mats["dct"].astype(np.float64))
        log_f = np.abs(np.log(np.maximum(fbank, 1e-10)))
        e_ceps = e_log @ dct + c_abs["dct"] * ((log_f + e_log) @ dct) \
            + c_rms * np.sqrt((log_f + e_log) ** 2 @ dct ** 2)
        e_ceps[:, 0] = log_err(energy, e_energy)
        t_true = int(np.clip(1 + np.ceil((n[u] - fs) / st), 1, t_pad))
        w_abs = np.abs(tf.delta_matrix(t_pad, cfg.delta_n)).astype(np.float64)

        def delta(f):
            g = f.copy()
            g[t_true:] = f[t_true - 1]
            return w_abs @ g
        e1 = delta(e_ceps)
        e = np.concatenate([e_ceps, e1, delta(e1)], axis=-1)
        e[t_true:] = 0.0
        out.append(e)
    return np.stack(out)


def accumulation(precision, cfg) -> dict:
    """Each dot's float32 accumulation error over ``|x| @ |w|``: ``(K + 4)
    u_f32`` for its K summed products (three a product term at bf16_3x),
    with room for the rounding of the operands that feed it."""
    terms = len(SPLIT[precision] or ((0, 0),))
    return {name: (terms * k + 4) * U_F32 for name, k in (
        ("dft", cfg.frame_size), ("mel", cfg.nfft // 2 + 1),
        ("dct", cfg.num_filters))}


class TestDotPrecision:
    @pytest.mark.parametrize("precision", ["highest", *REDUCED])
    def test_dot_is_the_bf16_split(self, precision):
        """``precision_dot`` against the float64 sum of the same split's
        products: within the float32 accumulation of ``3K`` (bf16_3x) or
        ``K`` terms, ``γ·Σ|terms|``, and the split's parts are NumPy's
        bf16 rounding."""
        cfg = FrontendConfig()
        rng = np.random.default_rng(2)
        x = (rng.normal(size=(64, cfg.frame_size)) * 1000).astype(np.float32)
        w = dft_basis(cfg)
        parts = tf._PRECISION_PARTS[precision]
        got = tf.precision_dot(torch.as_tensor(x),
                               tf.split_rhs(torch.as_tensor(w), parts),
                               parts).numpy()
        want = split_dot64(x, w, precision)
        k = cfg.frame_size * len(parts or ((0, 0),))
        gamma = k * U_F32 / (1 - k * U_F32)
        scale = np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64)
        assert (np.abs(got - want) <= gamma * 1.02 * scale).all()
        hi, lo = tf.bf16_parts(torch.as_tensor(x))
        assert np.array_equal(hi.numpy(), bf16_round(x))
        assert np.array_equal(lo.numpy(), bf16_round(x - bf16_round(x)))

    @pytest.mark.parametrize("precision", REDUCED)
    def test_features_match_float64_split(self, precision):
        cfg = FrontendConfig(dot_precision=precision)
        sigs, n = ragged_batch()
        got, _ = tf.Frontend(cfg, device="cpu").mfcc_batch(sigs, n)
        want = pipeline64(sigs, n, cfg, lambda x, w, name: split_dot64(
            x.astype(np.float32), w, precision))
        bound = feature_bound(sigs, n, cfg, accumulation(precision, cfg)) \
            + 1e-5 + 1e-6 * np.abs(want)
        assert got.shape == want.shape
        assert (np.abs(got.numpy() - want) <= bound).all()

    @pytest.mark.parametrize("precision", REDUCED)
    def test_features_near_jax_highest(self, precision):
        cfg = FrontendConfig(dot_precision=precision)
        sigs, n = ragged_batch()
        want, _ = JaxFrontend(cfg).mfcc_batch(sigs, n)   # 'highest' on CPU
        got, _ = tf.Frontend(cfg, device="cpu").mfcc_batch(sigs, n)
        acc = accumulation(precision, cfg)
        if precision == "high":
            bound = feature_bound(sigs, n, cfg, {
                k: v + 4 * U_BF16 ** 2 for k, v in acc.items()})
        else:
            bound = feature_bound(sigs, n, cfg, acc,
                                  6 * U_BF16 * np.sqrt(2 / 3))
        want = np.asarray(want)
        err = np.abs(got.numpy() - want)
        assert (err <= bound + TOL["atol"] + TOL["rtol"] * np.abs(want)).all()
        highest, _ = tf.Frontend(FrontendConfig(), device="cpu").mfcc_batch(
            sigs, n)
        assert not torch.equal(got, highest)   # the reduced precision shows

    def test_without_matmul_dft_the_small_dots_stay_highest(self):
        sigs, n = ragged_batch()
        want, _ = tf.Frontend(FrontendConfig(matmul_dft=False),
                              device="cpu").mfcc_batch(sigs, n)
        for precision in REDUCED:
            got, _ = tf.Frontend(FrontendConfig(matmul_dft=False,
                                                dot_precision=precision),
                                 device="cpu").mfcc_batch(sigs, n)
            assert torch.equal(got, want)


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
