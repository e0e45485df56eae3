"""The decode-serving slice end to end, PyTorch port vs JAX package.

The composition of ``cli.py:cmd_serve`` — WAV -> ``load_wav`` /
``preprocess_signal`` -> ``Frontend.mfcc`` -> ``vad_mask`` ->
``apply_mask`` -> ``DecodeService`` around ``DeviceBeamDecoder`` — runs
once with each package on the same WAV files and the same bank (XIF_tone,
2 mixtures, the built-in lexicon): the VAD-kept frame counts must be
equal, the packed features within the frontend tolerance (2e-3), and
every request's n-best words equal with scores within rtol 1e-4.
"""

import jax
import numpy as np
import torch

from poccala_tpu.config import Config
from poccala_tpu.decoder.device import DeviceBeamDecoder as JaxDecoder
from poccala_tpu.io import wav as wav_io
from poccala_tpu.io.corpus import UnitInventory as JaxInventory
from poccala_tpu.lexicon import FlatLexicon as JaxFlat
from poccala_tpu.lexicon import PinYin as JaxPinYin
from poccala_tpu.lexicon import PronunciationLexicon as JaxLexicon
from poccala_tpu.lexicon.builtin_table import BUILTIN_PINYIN
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu.ops import vad as jax_vad
from poccala_tpu.ops.frontend import Frontend as JaxFrontend
from poccala_tpu.serve import DecodeService
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.ops import vad as torch_vad
from poccala_tpu_torch.ops.frontend import Frontend

torch.set_num_threads(1)


def synthetic_speech(rng, rate, seconds):
    """A quiet lead-in (the VAD's noise window), then voiced bursts of
    harmonics at varying pitch separated by short pauses."""
    n_lead = int(0.3 * rate)
    out = [rng.normal(size=n_lead) * 30.0]
    total = n_lead
    while total < seconds * rate:
        n = int(rng.uniform(0.15, 0.35) * rate)
        t = np.arange(n) / rate
        f0 = rng.uniform(100, 250)
        burst = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / h
                    for h in range(1, 8)) * 3000.0 * np.hanning(n)
        gap = rng.normal(size=int(0.05 * rate)) * 30.0
        out += [burst + rng.normal(size=n) * 30.0, gap]
        total += n + len(gap)
    return np.concatenate(out)[: int(seconds * rate)]


def serve(paths, cfg, frontend, vad_mask, apply_mask, decoder):
    """``cli.py:cmd_serve``'s feature function and service loop."""
    def features(path):
        data, _ = wav_io.load_wav(path)
        sig = wav_io.preprocess_signal(
            data, drop_zeros=cfg.frontend.reference_quirks)
        feats, mask = frontend.mfcc(sig)
        keep = vad_mask(feats, mask) if cfg.frontend.vad else mask
        packed, n = apply_mask(feats, keep)
        return np.asarray(packed)[: int(n)]

    feats = [features(p) for p in paths]
    with DecodeService(decoder, batch_size=4, return_nbest=3) as svc:
        results = [f.result(timeout=300)
                   for f in [svc.submit(x) for x in feats]]
    assert svc.stats.requests == len(paths)
    return feats, results


def test_serving_slice_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    cfg = Config()
    cfg.model.mix_level = cfg.model.max_mix_level = 2
    rate = cfg.frontend.sample_rate
    paths = []
    for i in range(4):
        p = str(tmp_path / f"u{i}.wav")
        wav_io.write_wav(p, synthetic_speech(rng, rate, 1.0), rate)
        paths.append(p)

    jinv = JaxInventory.standard("XIF_tone")
    jbank = jsb.create_bank(len(jinv), cfg.model, cfg.frontend.feat_dim,
                            key=jax.random.PRNGKey(3))
    tbank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                 for f in tsb.FIELDS})
    words = list(BUILTIN_PINYIN)
    jl, tl = JaxLexicon(), PronunciationLexicon()
    jl.generate(words, JaxPinYin())
    tl.generate(words, PinYin())

    want_feats, want = serve(
        paths, cfg, JaxFrontend(cfg.frontend), jax_vad.vad_mask,
        jax_vad.apply_mask,
        JaxDecoder(jbank, JaxFlat.from_tree(jl.lexicon, jinv)))
    got_feats, got = serve(
        paths, cfg, Frontend(cfg.frontend), torch_vad.vad_mask,
        torch_vad.apply_mask,
        DeviceBeamDecoder(tbank, FlatLexicon.from_tree(
            tl.lexicon, UnitInventory.standard("XIF_tone"))))

    for g, w in zip(got_feats, want_feats):
        assert 20 < len(g) == len(w) < 99  # VAD kept the speech only
        assert np.allclose(g, w, rtol=2e-3, atol=2e-3)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        assert [h.words for h in g] == [h.words for h in w]
        assert np.allclose([h.score for h in g], [h.score for h in w],
                           rtol=1e-4, atol=0.0)
