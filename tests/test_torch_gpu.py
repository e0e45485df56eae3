"""The PyTorch port on a CUDA device: the hand-written GMM kernel against
its plain version, and the GPU frontend and decoder against the CPU.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no jax, so it also runs where jax is absent, without the
suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from poccala_tpu.config import Config, ModelConfig
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.lexicon.builtin_table import BUILTIN_PINYIN
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.ops import gmm_score as tg
from poccala_tpu_torch.ops.cuda import gmm_score_cuda as gk
from poccala_tpu_torch.ops.frontend import Frontend

pytestmark = pytest.mark.gpu

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1e-3, atol=5e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def scoring_inputs(rng, s, m, d, t, floor=False):
    """MFCC-scale inputs; ``floor`` makes the last two dims degenerate
    (half the mixtures at the 1e-6 covariance floor, values at the
    floor's scale; see tests/test_torch_gmm_score.py:make_inputs)."""
    offset = np.zeros(d, np.float32)
    offset[0] = 60.0
    centers = rng.normal(size=(s, 1, d)) * 3
    means = offset + centers + rng.normal(size=(s, m, d))
    log_var = rng.uniform(0.5, 2.5, size=(s, m, d))
    x = offset + centers[rng.integers(0, s, size=t), 0] \
        + rng.normal(size=(t, d)) * 2
    if floor:
        hit = rng.uniform(size=(s, m, 1)) < 0.5
        log_var[..., -2:] = np.where(hit, np.log(1e-6), log_var[..., -2:])
        means[..., -2:] = rng.normal(size=(s, m, 2)) * 1e-3
        x[:, -2:] = rng.normal(size=(t, 2)) * 1e-3
    w = rng.uniform(0.1, 1, size=(s, m))
    log_w = np.log(w / w.sum(1, keepdims=True))
    return [torch.tensor(a, dtype=torch.float32)
            for a in (x, means, log_var, log_w)]


@pytest.mark.parametrize("score_dtype,normalizer,floor,tol", [
    ("float32", "textbook", False, F32),
    ("float32", "reference", False, F32),
    ("float32", "textbook", True, F32),
    ("bfloat16", "textbook", False, BF16),
])
@pytest.mark.parametrize("t,s", [(131, 45), (1000, 606)])
def test_kernel_matches_plain(cuda, t, s, score_dtype, normalizer, floor,
                              tol):
    rng = np.random.default_rng(t + s)
    args = [a.to(cuda) for a in scoring_inputs(rng, s, 8, 39, t, floor)]
    kw = dict(normalizer=normalizer, score_dtype=score_dtype)
    before = gk.gmm_log_scores_cuda.launches
    got = gk.gmm_log_scores_fast(*args, **kw)
    want = tg.gmm_log_scores(*args, **kw)
    torch.cuda.synchronize()
    assert gk.gmm_log_scores_cuda.launches == before + 1
    assert got.shape == (t, s) and bool(torch.isfinite(got).all())
    assert torch.allclose(got, want, **tol)


def test_kernel_handles_empty_and_wide_inputs(cuda):
    rng = np.random.default_rng(0)
    x, means, log_var, log_w = [a.to(cuda) for a in
                                scoring_inputs(rng, 70, 2, 42, 5)]
    assert gk.gmm_log_scores_cuda(x[:0], means, log_var, log_w).shape \
        == (0, 70)
    got = gk.gmm_log_scores_cuda(x, means, log_var, log_w)
    assert torch.allclose(got, tg.gmm_log_scores(x, means, log_var, log_w),
                          **F32)


def test_frontend_gpu_matches_cpu(cuda):
    cfg = Config().frontend
    rng = np.random.default_rng(1)
    sigs = (rng.normal(size=(3, 16000)) * 2000).astype(np.float32)
    n = np.array([16000, 11000, 5000])
    got, gm = Frontend(cfg, device=cuda).mfcc_batch(sigs, n)
    want, wm = Frontend(cfg).mfcc_batch(sigs, n)
    assert torch.equal(gm.cpu(), wm)
    assert torch.allclose(got.cpu(), want, rtol=2e-3, atol=2e-3)


def test_decoder_gpu_matches_cpu(cuda):
    cfg = ModelConfig(state_num=5, mix_level=2, max_mix_level=2)
    inv = UnitInventory.standard("XIF_tone")
    bank = sb.create_bank(len(inv), cfg, 13,
                          generator=torch.Generator().manual_seed(2))
    lex = PronunciationLexicon()
    lex.generate(list(BUILTIN_PINYIN), PinYin())
    flat = FlatLexicon.from_tree(lex.lexicon, inv)
    feats = (np.random.default_rng(2).normal(size=(4, 40, 13)) * 2
             ).astype(np.float32)
    n = np.array([40, 33, 20, 12])
    want = DeviceBeamDecoder(bank, flat).decode_batch(feats, n, 3)
    got = DeviceBeamDecoder(bank.to(cuda), flat).decode_batch(feats, n, 3)
    for g, w in zip(got, want):
        assert np.allclose([h.score for h in g], [h.score for h in w],
                           rtol=1e-4, atol=0.0)
        # the 1-best words agree wherever the CPU's ranking is not a
        # near-tie that kernel rounding could reorder
        if len(w) > 1 and w[0].score - w[1].score > 0.01:
            assert g[0].words == w[0].words
