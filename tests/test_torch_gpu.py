"""The PyTorch port on a CUDA device: the hand-written kernels (GMM
scoring in float32 and bfloat16, banded HMM forward / backward / Viterbi,
the decoder's scans and n-best, the (logsumexp, +) product of
``forward_log_assoc``) against their plain versions, the GPU frontend (at
every ``dot_precision``), decoders (the device tier, with and without the
sticky block selection, and the host tiers) and Baum-Welch statistics
against the CPU, the sentence kernel of the E-step and the alignment
against the plain scoring, the statistics kernel against the plain
moments (at the training cell's shape, from ``asrbench``'s own traffic),
the pack cache, the profiling ledger and the default device.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no jax, so it also runs where jax is absent, without the
suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import functools

import numpy as np
import pytest
import torch

from poccala_tpu_torch.config import Config, ModelConfig
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.lexicon.builtin_table import BUILTIN_PINYIN
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.ops import gmm_score as tg
from poccala_tpu_torch.ops import hmm as thmm
from poccala_tpu_torch.ops.cuda import gmm_score_cuda as gk
from poccala_tpu_torch.ops.cuda import hmm_banded_cuda as hk
from poccala_tpu_torch.ops.frontend import Frontend
from poccala_tpu_torch.train import accumulators as acc

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


RAGGED = [dict(t=1, s=1, m=1, d=39), dict(t=130, s=65, m=1, d=39),
          dict(t=333, s=607, m=3, d=39), dict(t=200, s=606, m=8, d=13),
          dict(t=5000, s=100, m=2, d=7), dict(t=9000, s=130, m=4, d=40),
          dict(t=77, s=64, m=5, d=26)]


@pytest.mark.parametrize("score_dtype,tol", [("float32", F32),
                                             ("bfloat16", BF16)])
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "t{t}s{s}m{m}d{d}"
                         .format(**s))
def test_kernel_ragged_shapes(cuda, shape, score_dtype, tol):
    """T and S off the tiles (S odd, even, a multiple of 4), one mixture,
    a mixture slot at weight -1e30, feature widths other than 39 (the
    run-time K), both tile sizes of the float32 kernel."""
    rng = np.random.default_rng(7)
    x, means, log_var, log_w = scoring_inputs(rng, shape["s"], shape["m"],
                                              shape["d"], shape["t"])
    if shape["m"] > 1:
        log_w[:, -1] = -1e30
    args = [a.to(cuda) for a in (x, means, log_var, log_w)]
    got = gk.gmm_log_scores_cuda(*args, score_dtype=score_dtype)
    torch.cuda.synchronize()
    want = tg.gmm_log_scores(*args, score_dtype=score_dtype)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert torch.allclose(got, want, **tol)


@pytest.mark.parametrize("score_dtype,tol", [("float32", F32),
                                             ("bfloat16", BF16)])
def test_kernel_takes_unaligned_frames(cuda, score_dtype, tol):
    """Frames that start off a 16-byte boundary (a row slice of a larger
    tensor: 39 floats a row) score as their aligned copy does."""
    rng = np.random.default_rng(10)
    x, means, log_var, log_w = [a.to(cuda) for a in
                                scoring_inputs(rng, 70, 4, 39, 301)]
    view = x[1:]
    assert view.is_contiguous() and view.data_ptr() % 16
    got = gk.gmm_log_scores_cuda(view, means, log_var, log_w,
                                 score_dtype=score_dtype)
    want = tg.gmm_log_scores(view.clone(), means, log_var, log_w,
                             score_dtype=score_dtype)
    assert torch.allclose(got, want, **tol)


def test_pack_cache_invalidates_on_in_place_update(cuda):
    """The packed bank is reused while the bank stands and rebuilt after
    an in-place update, for both kernels."""
    rng = np.random.default_rng(8)
    x, means, log_var, log_w = [a.to(cuda) for a in
                                scoring_inputs(rng, 70, 4, 39, 50)]
    for dtype, tol in (("float32", F32), ("bfloat16", BF16)):
        packs = []
        real = {n: getattr(gk, n) for n in ("pack_f32", "pack_bf16_static")}

        def counted(name):
            def packer(*a):
                packs.append(name)
                return real[name](*a)
            packer.__name__ = name
            return packer

        try:
            for n in real:
                setattr(gk, n, counted(n))
            kw = dict(score_dtype=dtype)
            first = gk.gmm_log_scores_cuda(x, means, log_var, log_w, **kw)
            again = gk.gmm_log_scores_cuda(x, means, log_var, log_w, **kw)
            assert len(packs) == 1 and torch.equal(first, again)
            means.add_(0.25)                    # an M-step writing in place
            log_w[:, -1] = -1e30                # a slot switched off
            moved = gk.gmm_log_scores_cuda(x, means, log_var, log_w, **kw)
            assert len(packs) == 2
            assert not torch.allclose(moved, first, **tol)
            assert torch.allclose(moved, tg.gmm_log_scores(
                x, means, log_var, log_w, **kw), **tol)
        finally:
            for n, fn in real.items():
                setattr(gk, n, fn)


def test_bf16_operands_kernel_matches_torch_pack(cuda):
    """The small kernel that builds the frame-dependent bfloat16 operands
    on the card against :func:`pack_bf16`: weights bit-equal, bias to
    float32 rounding of a sum taken in another order."""
    rng = np.random.default_rng(9)
    x, means, log_var, log_w = [a.to(cuda) for a in
                                scoring_inputs(rng, 75, 3, 39, 40)]
    static = gk.pack_bf16_static(means, log_var, log_w, "textbook")
    center = x.mean(0)
    want_w, want_b = gk.pack_bf16(static, means, center)
    w_x, bias = torch.empty_like(want_w), torch.empty_like(want_b)
    out = torch.empty(40, 75, device=cuda)
    rc = gk._lib().gmm_score_bf16(
        x.data_ptr(), center.data_ptr(), means.data_ptr(),
        static["prec"].data_ptr(), static["const"].data_ptr(),
        static["w_x2"].data_ptr(), w_x.data_ptr(), bias.data_ptr(),
        out.data_ptr(), 40, 75, want_w.shape[2], 3, 39,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(w_x.view(torch.int16), want_w.view(torch.int16))
    assert torch.allclose(bias, want_b, rtol=1e-5, atol=1e-4)


def test_defaults_land_on_the_card(cuda, tmp_path):
    """``device=None`` is the card for every entry point that places
    state."""
    from poccala_tpu_torch.io.corpus import Corpus
    from poccala_tpu_torch.train import checkpoint as ckpt
    from poccala_tpu_torch.train.trainer import Trainer

    cfg = Config()
    cfg.model.mix_level = cfg.model.max_mix_level = 1
    inv = UnitInventory(["a", "o"])
    tr = Trainer(cfg, inv)
    assert tr.device.type == "cuda" and tr.bank.means.is_cuda
    assert Frontend(cfg.frontend).device.type == "cuda"
    assert Corpus(cfg, inv, pairs=[]).frontend.device.type == "cuda"
    bank = sb.create_bank(2, cfg.model, 4)
    assert all(getattr(bank, f).is_cuda for f in sb.FIELDS)
    assert sb.bank_from_numpy(sb.bank_to_numpy(bank)).means.is_cuda
    ckpt.save_checkpoint(str(tmp_path / "c"), bank, units=inv.units)
    assert ckpt.load_checkpoint(str(tmp_path / "c"))[0].means.is_cuda
    ckpt.export_reference_layout(str(tmp_path / "r"), bank, inv, "XIF")
    assert ckpt.import_reference_layout(
        str(tmp_path / "r"), inv, "XIF", cfg.model.state_num, 1).means.is_cuda
    stats = {f: np.zeros((2, 2), np.float32) for f in acc.STATS_FIELDS}
    assert acc.stats_from_numpy(stats).loglik.is_cuda
    assert sb.create_bank(2, cfg.model, 4, device="cpu").means.device.type \
        == "cpu"


def test_frontend_gpu_matches_cpu(cuda):
    cfg = Config().frontend
    rng = np.random.default_rng(1)
    sigs = (rng.normal(size=(3, 16000)) * 2000).astype(np.float32)
    n = np.array([16000, 11000, 5000])
    got, gm = Frontend(cfg, device=cuda).mfcc_batch(sigs, n)
    want, wm = Frontend(cfg, device="cpu").mfcc_batch(sigs, n)
    assert torch.equal(gm.cpu(), wm)
    assert torch.allclose(got.cpu(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_frontend_reduced_precision_gpu_matches_cpu(cuda, precision):
    """``dot_precision`` 'high' (bf16_3x) and 'default' (one bf16 pass) on
    the card: float32 matmuls of the bf16 parts with TF32 off, held to the
    CPU's at the frontend's tolerance, and apart from 'highest'."""
    cfg = Config().frontend
    cfg.dot_precision = precision
    rng = np.random.default_rng(1)
    sigs = (rng.normal(size=(3, 16000)) * 2000).astype(np.float32)
    n = np.array([16000, 11000, 5000])
    got, gm = Frontend(cfg, device=cuda).mfcc_batch(sigs, n)
    want, wm = Frontend(cfg, device="cpu").mfcc_batch(sigs, n)
    assert torch.equal(gm.cpu(), wm)
    assert torch.allclose(got.cpu(), want, rtol=2e-3, atol=2e-3)
    highest, _ = Frontend(Config().frontend, device=cuda).mfcc_batch(sigs, n)
    assert not torch.equal(got, highest)


def assoc_case(rng, n, t, banded):
    """``log_A [N, N]`` (a band of width 5 made dense, NEG_INF off it, or
    dense), ``log_pi`` and ``log_b [T, N]``, float32 on the CPU."""
    if banded:
        band = np.log(rng.uniform(0.05, 1.0, size=(n, 5)))
        band = np.where(np.arange(n)[:, None] + np.arange(5) < n, band,
                        -1e30)
        log_a = thmm.band_to_dense(torch.tensor(band, dtype=torch.float32))
        log_pi = torch.full((n,), -1e30)
        log_pi[0] = 0.0
    else:
        a = rng.uniform(0.1, 1.0, size=(n, n))
        log_a = torch.tensor(np.log(a / a.sum(1, keepdims=True)),
                             dtype=torch.float32)
        log_pi = torch.full((n,), -float(np.log(n)))
    log_b = torch.tensor(rng.normal(size=(t, n)) * 3 - 5, dtype=torch.float32)
    return log_a, log_pi, log_b


@pytest.mark.parametrize("n,t,banded", [(6, 40, False), (50, 319, True),
                                        (98, 200, True), (33, 1, False),
                                        (33, 2, False), (20, 77, False)])
def test_forward_log_assoc_gpu_matches_cpu(cuda, n, t, banded):
    """``forward_log_assoc`` on the card (the semiring product kernel, one
    launch a level's products and one for the tail) against the plain
    version on the CPU: ``loglik`` at rtol 1e-5, the finite masks equal,
    ``log_alpha`` within 1e-5 of max(|value|, 1); the card's peak memory
    a few copies of the ``[T-1, N, N]`` operators, never the ``[P, N, N,
    N]`` sums."""
    from poccala_tpu_torch.ops.cuda import hmm_assoc_cuda as ak

    rng = np.random.default_rng(n + t)
    args = assoc_case(rng, n, t, banded)
    want_a, want_ll = thmm.forward_log_assoc(*args)
    before = (ak.lse_product_cuda.launches, ak.lse_rows_cuda.launches)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got_a, got_ll = thmm.forward_log_assoc(*(x.to(cuda) for x in args))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    levels, m = 0, t - 1
    while m >= 2:
        levels, m = levels + 1, m // 2
    products = ak.lse_product_cuda.launches - before[0]
    assert products <= 2 * levels and products >= levels
    assert ak.lse_rows_cuda.launches - before[1] == (1 if t > 1 else 0)
    assert peak <= 6 * max(t - 1, 1) * n * n * 4 + (1 << 20), peak
    assert got_a.is_cuda and got_a.shape == (t, n)
    assert np.isclose(float(got_ll), float(want_ll), rtol=1e-5, atol=0)
    got_a, want_a = got_a.cpu().numpy(), want_a.numpy()
    fin = want_a > -1e30 / 2
    assert np.array_equal(got_a > -1e30 / 2, fin)
    err = np.abs(got_a - want_a)[fin] / np.maximum(np.abs(want_a[fin]), 1)
    assert err.max(initial=0.0) <= 1e-5


@pytest.mark.parametrize("p,m,k,n", [(3, 37, 45, 50), (5, 98, 98, 98),
                                     (2, 1, 70, 65), (2, 139, 139, 139),
                                     (2, 140, 140, 140)])
def test_lse_product_kernel_matches_plain(cuda, p, m, k, n):
    """The product and row kernels against the plain product on the card:
    ragged tiles, NEG_INF rows and columns, a strided operand and output,
    both sides of the shared-memory route's limit (N = 139 fits a CTA, 140
    takes k-tiles); 2e-6 relative and 1e-5 absolute."""
    from poccala_tpu_torch.ops.cuda import hmm_assoc_cuda as ak

    rng = np.random.default_rng(p + m)
    a = torch.tensor(rng.normal(size=(2 * p, m, k)) * 4, dtype=torch.float32,
                     device=cuda)
    b = torch.tensor(rng.normal(size=(p, k, n)) * 4, dtype=torch.float32,
                     device=cuda)
    a[:, 0] = -1e30
    b[:, :, 1 % n] = -1e30
    out = torch.full((2 * p, m, n), float("nan"), device=cuda)
    ak.lse_product_cuda(a[0::2], b, out[1::2])
    want = thmm._lse_product_plain(a[0::2], b)
    assert torch.allclose(out[1::2], want, rtol=2e-6, atol=1e-5)
    assert torch.isnan(out[0::2]).all()
    rows = torch.empty((p, n), device=cuda)
    ak.lse_rows_cuda(a[0, 0], b, rows)
    want_rows = torch.empty_like(rows)
    thmm._rows_into_plain(a[0, 0], b, want_rows)
    assert torch.allclose(rows, want_rows, rtol=2e-6, atol=1e-5)


@pytest.mark.parametrize("n", [98, 140])
def test_lse_product_kernel_all_dead(cuda, n):
    """An all-dead product (NEG_INF and -inf operands) on each route of the
    product kernel (shared memory at N = 98, k-tiles at 140) and through
    the row kernel: every output exactly NEG_INF, as the plain version's."""
    from poccala_tpu_torch.ops.cuda import hmm_assoc_cuda as ak

    a = torch.full((3, n, n), -1e30, device=cuda)
    a[:, ::2] = -float("inf")
    b = torch.full((3, n, n), -1e30, device=cuda)
    out = torch.full((3, n, n), float("nan"), device=cuda)
    ak.lse_product_cuda(a, b, out)
    assert torch.equal(out, thmm._lse_product_plain(a, b))
    assert (out == -1e30).all()
    rows = torch.full((3, n), float("nan"), device=cuda)
    ak.lse_rows_cuda(a[0, 1], b, rows)
    assert (rows == -1e30).all()


@pytest.mark.parametrize("n", [98, 122, 140])
def test_lse_product_kernel_nan(cuda, n):
    """NaN operands where the other operand is dead (a band's outside) on
    each route of the product kernel (two buffers at N = 98, one at 122,
    k-tiles at 140) and through the row kernel: NaN wherever the plain
    version's output is NaN (a row of ``a``, a column of ``b``), the rest
    within 2e-6 relative and 1e-5 absolute."""
    from poccala_tpu_torch.ops.cuda import hmm_assoc_cuda as ak

    rng = np.random.default_rng(n)
    d = np.arange(n)[None, :] - np.arange(n)[:, None]
    a = np.where((d >= 0) & (d < 9), rng.normal(size=(2, n, n)) * 3, -1e30)
    b = np.where((d >= 0) & (d < 5), rng.normal(size=(2, n, n)) * 3, -1e30)
    a[:, n // 2, n - 3] = np.nan
    b[:, n // 4, n - 2] = b[:, n - 1, 3] = np.nan
    a, b = (torch.tensor(x, dtype=torch.float32, device=cuda) for x in (a, b))
    out = torch.empty((2, n, n), device=cuda)
    ak.lse_product_cuda(a, b, out)
    want = thmm._lse_product_plain(a, b)
    assert torch.isnan(out[:, n // 2]).all()
    assert torch.isnan(out[:, :, n - 2]).all()
    assert torch.allclose(out, want, rtol=2e-6, atol=1e-5, equal_nan=True)
    rows = torch.empty((2, n), device=cuda)
    ak.lse_rows_cuda(a[0, 0], b, rows)
    want_rows = torch.empty_like(rows)
    thmm._rows_into_plain(a[0, 0], b, want_rows)
    assert torch.isnan(rows[:, [3, n - 2]]).all()
    assert torch.allclose(rows, want_rows, rtol=2e-6, atol=1e-5,
                          equal_nan=True)


def test_decoder_gpu_matches_cpu(cuda):
    cfg = ModelConfig(state_num=5, mix_level=2, max_mix_level=2)
    inv = UnitInventory.standard("XIF_tone")
    bank = sb.create_bank(len(inv), cfg, 13,
                          generator=torch.Generator().manual_seed(2),
                          device="cpu")
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


def decode_world(seed, state_num=5):
    """A random XIF_tone bank (13 dims, 2 mixtures) and noise features."""
    cfg = ModelConfig(state_num=state_num, mix_level=2, max_mix_level=2)
    inv = UnitInventory.standard("XIF_tone")
    bank = sb.create_bank(len(inv), cfg, 13,
                          generator=torch.Generator().manual_seed(seed),
                          device="cpu")
    feats = (np.random.default_rng(seed).normal(size=(2, 60, 13)) * 2
             ).astype(np.float32)
    return inv, bank, feats


def test_stream_gpu_matches_one_shot(cuda):
    """Chunked decode on the card (the GMM kernel on every 25-frame chunk)
    equals the one-shot decode on the card."""
    inv, bank, feats = decode_world(4)
    lex = PronunciationLexicon()
    lex.generate(list(BUILTIN_PINYIN), PinYin())
    dec = DeviceBeamDecoder(bank.to(cuda), FlatLexicon.from_tree(lex.lexicon,
                                                                  inv))
    one_shot = dec.decode_batch(feats, [60, 60], 3)
    before = gk.gmm_log_scores_cuda.launches
    st = dec.stream_init(batch=2, max_frames=75)
    for lo in range(0, 75, 25):
        chunk = np.zeros((2, 25, 13), np.float32)
        part = feats[:, lo:lo + 25]
        chunk[:, : part.shape[1]] = part
        st = dec.stream_feed(st, chunk, n_valid=[part.shape[1]] * 2)
    streamed = dec.stream_result(st, 3)
    assert gk.gmm_log_scores_cuda.launches == before + 3
    assert st.carry[0].is_cuda and st.tb_prev[0].is_cuda
    for s, o in zip(streamed, one_shot):
        assert [h.words for h in s] == [h.words for h in o]
        assert np.allclose([h.score for h in s], [h.score for h in o],
                           rtol=1e-5, atol=0.0)


def test_pruned_gpu_matches_cpu(cuda):
    """The block-pruned search on the card against the CPU: the same
    words wherever the CPU's ranking is not a near-tie, scores at 1e-4."""
    from poccala_tpu_torch.lexicon.build import synthetic_lexicon

    inv, bank, feats = decode_world(5)
    flat, _, _ = synthetic_lexicon(inv, min_nodes=1500, n_chars=12)
    kw = dict(block_size=64, active_blocks=2)
    want = DeviceBeamDecoder(bank, flat, **kw).decode_batch(feats, [60, 41], 3)
    gdec = DeviceBeamDecoder(sb.bank_from_numpy(sb.bank_to_numpy(bank),
                                                device=cuda), flat, **kw)
    got = gdec.decode_batch(feats, [60, 41], 3)
    assert gdec._prune_on
    for g, w in zip(got, want):
        assert np.allclose([h.score for h in g], [h.score for h in w],
                           rtol=1e-4, atol=0.0)
        if len(w) > 1 and w[0].score - w[1].score > 0.01:
            assert g[0].words == w[0].words


def banded_inputs(rng, b, t_pad, n, w):
    """Left-to-right bands with dead edges and pruned long skips, log_b at
    GMM-score scale with an impossible last state, ragged masks with one
    full, one all-padded and one single-frame utterance."""
    band = np.log(rng.dirichlet(np.ones(w), size=(b, n)))
    col = np.arange(n)[:, None] + np.arange(w)[None, :]
    band = np.where(col[None] < n, band, -1e30)
    band[:, :, 3:] = np.where(rng.uniform(size=(b, n, w - 3)) < 0.5, -1e30,
                              band[:, :, 3:])
    log_pi = np.log(rng.dirichlet(np.ones(n), size=b))
    log_b = rng.normal(size=(b, t_pad, n)) * 20 - 60
    log_b[:, :, -1] = -1e30
    lens = rng.integers(1, t_pad + 1, size=b)
    lens[-1] = 1
    lens[0] = t_pad        # a batch of one is the full utterance
    masks = np.arange(t_pad)[None] < lens[:, None]
    if b > 1:
        masks[1] = False
    f32 = [torch.tensor(a, dtype=torch.float32)
           for a in (band, log_pi, log_b)]
    return f32 + [torch.tensor(masks)]


# Forward and backward: a lane of the warp kernels owns K = ceil(N / 32)
# states and log_b runs 7 frames ahead through a ring of 8; N > 128 or a
# band width outside 3..7 goes to the block route (the same design over a
# CTA's warps, past 2,048 places over a thread-block cluster).  Viterbi's
# warp kernel takes the same shapes as long as T - 1 frames of backpointers
# fit the block's shared memory.
HMM_SHAPES = [
    (3, 1, 11, 5), (6, 37, 26, 5), (64, 319, 50, 5),    # K = 1, 1, 2
    (4, 60, 300, 7),                                    # block: N > 128
    (1, 2, 32, 3), (4, 23, 32, 7),                      # K = 1, full register
    (5, 3, 33, 7), (6, 7, 33, 4),                       # K = 2, T < 8
    (1, 319, 50, 5), (1, 1, 50, 5), (2, 2, 50, 6),      # B = 1, T = 1, 2
    (4, 23, 65, 3),                                     # K = 3
    (5, 3, 98, 7), (9, 41, 98, 5), (1, 60, 98, 6),      # K = 4, partial
    (6, 29, 128, 7), (4, 2, 128, 3),                    # K = 4, full
    (3, 19, 129, 5), (2, 9, 1024, 16),                  # block: N > 128
    (4, 23, 50, 9), (3, 6, 26, 16),                     # block: W > 7
    (5, 31, 266, 5), (3, 17, 602, 5),                   # block: L = 88, 200
    (2, 9, 8402, 5),                                    # block: a cluster
]


@pytest.mark.parametrize("b,t_pad,n,w", HMM_SHAPES)
def test_hmm_kernels_match_plain(cuda, b, t_pad, n, w):
    rng = np.random.default_rng(b * t_pad + n)
    band, log_pi, log_b, masks = [a.to(cuda) for a in
                                  banded_inputs(rng, b, t_pad, n, w)]
    before = {k: f.launches for k, f in hk.KERNELS.items()}
    la, ll = thmm.forward_log_banded_batch(band, log_pi, log_b, masks, w)
    lb = thmm.backward_log_banded_batch(band, log_b, masks, w)
    want_a, want_ll = thmm.forward_log_banded_plain(band, log_pi, log_b,
                                                    masks, w)
    want_b = thmm.backward_log_banded_plain(band, log_b, masks, w)
    torch.cuda.synchronize()
    assert hk.takes_warp(n, w) == (n <= 128 and 3 <= w <= 7)
    assert torch.allclose(la, want_a, rtol=1e-5, atol=1e-5)
    assert torch.allclose(ll, want_ll, rtol=1e-5, atol=1e-5)
    assert torch.allclose(lb, want_b, rtol=1e-5, atol=1e-5)
    for end_states in (0, 3):
        sc, path, delta = thmm.viterbi_log_banded_batch(
            band, log_pi, log_b, masks, w, end_states)
        wsc, wpath, wdelta = thmm.viterbi_log_banded_plain(
            band, log_pi, log_b, masks, w, end_states)
        torch.cuda.synchronize()
        assert torch.equal(path, wpath)
        assert torch.allclose(sc, wsc, rtol=1e-6, atol=0.0)
        assert torch.allclose(delta, wdelta, rtol=1e-6, atol=0.0)
        old = hk.viterbi_banded_cuda(band, log_pi, log_b, masks, w,
                                     end_states, block=True)
        torch.cuda.synchronize()
        assert all(torch.equal(g, o) for g, o in zip((sc, path, delta), old))
    assert hk.viterbi_takes_warp(t_pad, n, w) == hk.takes_warp(n, w)
    after = {k: f.launches for k, f in hk.KERNELS.items()}
    assert after == {"forward": before["forward"] + 1,
                     "backward": before["backward"] + 1,
                     "viterbi": before["viterbi"] + 4}
    # both kernels do a step's arithmetic in one order: equal bit for bit;
    # loglik sums over the states in another order (float32 rounding)
    old_a, old_ll = hk.forward_banded_cuda(band, log_pi, log_b, masks, w,
                                           block=True)
    old_b = hk.backward_banded_cuda(band, log_b, masks, w, block=True)
    torch.cuda.synchronize()
    assert torch.equal(la, old_a) and torch.equal(lb, old_b)
    assert torch.allclose(ll, old_ll, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("b,t_pad,n,w", [
    (5, 40, 31, 3), (4, 33, 50, 5), (6, 64, 65, 4), (3, 41, 98, 7),
    (4, 39, 128, 6), (1, 2, 97, 5)], ids=lambda v: str(v))
def test_block_route_is_the_warp_kernels(cuda, b, t_pad, n, w):
    """Every shape the warp kernels take, on tied scores and ragged frames,
    through ``block=True`` (the block route: more warps, fewer places a
    lane, edges between warps): alpha and beta equal the default route's
    bit for bit; loglik, reduced over the CTA, at float32 rounding."""
    rng = np.random.default_rng(7 * n + w)
    band, log_pi, log_b, masks = [a.to(cuda) for a in
                                  banded_inputs(rng, b, t_pad, n, w)]
    log_b = torch.where(log_b > -1e29, torch.round(log_b / 8) * 8, log_b)
    assert hk.takes_warp(n, w)
    la, ll = hk.forward_banded_cuda(band, log_pi, log_b, masks, w)
    lb = hk.backward_banded_cuda(band, log_b, masks, w)
    ba, bll = hk.forward_banded_cuda(band, log_pi, log_b, masks, w,
                                     block=True)
    bb = hk.backward_banded_cuda(band, log_b, masks, w, block=True)
    torch.cuda.synchronize()
    assert torch.equal(la, ba) and torch.equal(lb, bb)
    assert torch.allclose(ll, bll, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("n,w", [(29056, 16), (29056, 5), (16385, 9)],
                         ids=lambda v: str(v))
def test_block_route_at_its_limit(cuda, n, w):
    """The most states the kernels take (``hmm_banded_max_n()``), at the
    runtime band width's widest and at W = 5, and just past 16,384 (K = 4
    places a lane): forward, backward and Viterbi on the block route over
    a cluster of CTAs, against the plain versions, one launch each."""
    assert n <= hk._lib().hmm_banded_max_n()
    block_route_once(cuda, n, w)


def block_route_once(cuda, n, w):
    """Forward, backward and Viterbi at B = 2, T = 5 on the block route
    over a cluster of CTAs (each on its own plan), against the plain
    versions (Viterbi bit for bit), one launch each."""
    rng = np.random.default_rng(n + w)
    band, log_pi, log_b, masks = [a.to(cuda) for a in
                                  banded_inputs(rng, 2, 5, n, w)]
    for plan in (hk.block_plan(2, n, w), hk.viterbi_block_plan(2, 5, n, w)):
        assert plan["cluster"] > 1 and plan["active_clusters"] > 0, plan
    before = {k: f.launches for k, f in hk.KERNELS.items()}
    la, ll = hk.forward_banded_cuda(band, log_pi, log_b, masks, w)
    lb = hk.backward_banded_cuda(band, log_b, masks, w)
    got = hk.viterbi_banded_cuda(band, log_pi, log_b, masks, w, 3)
    want_a, want_ll = thmm.forward_log_banded_plain(band, log_pi, log_b,
                                                    masks, w)
    want_b = thmm.backward_log_banded_plain(band, log_b, masks, w)
    want = thmm.viterbi_log_banded_plain(band, log_pi, log_b, masks, w, 3)
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in hk.KERNELS.items()} == \
        {"forward": 1, "backward": 1, "viterbi": 1}
    assert torch.allclose(la, want_a, rtol=1e-5, atol=1e-5)
    assert torch.allclose(ll, want_ll, rtol=1e-5, atol=1e-5)
    assert torch.allclose(lb, want_b, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


def test_block_route_after_a_smaller_plan(cuda):
    """A shape's launch does not depend on what ran before it: (16,385, 9)
    plans the runtime-width instantiations at less shared memory than
    (29,056, 16) takes, and (29,056, 16) then launches again."""
    for n, w in [(29056, 16), (16385, 9), (29056, 16)]:
        block_route_once(cuda, n, w)


def viterbi_three_ways(band, log_pi, log_b, masks, w, end_states):
    """Warp (or whatever the dispatch picks), block and plain Viterbi: the
    two kernels equal bit for bit, paths equal to the plain version's."""
    before = hk.viterbi_banded_cuda.launches
    got = thmm.viterbi_log_banded_batch(band, log_pi, log_b, masks, w,
                                        end_states)
    old = hk.viterbi_banded_cuda(band, log_pi, log_b, masks, w, end_states,
                                 block=True)
    want = thmm.viterbi_log_banded_plain(band, log_pi, log_b, masks, w,
                                         end_states)
    torch.cuda.synchronize()
    assert hk.viterbi_banded_cuda.launches == before + 2
    assert all(torch.equal(g, o) for g, o in zip(got, old))
    assert torch.equal(got[1], want[1])
    assert torch.allclose(got[0], want[0], rtol=1e-6, atol=0.0)
    assert torch.allclose(got[2], want[2], rtol=1e-6, atol=0.0)
    return got


@pytest.mark.parametrize("b,t_pad,n,w", [
    (5, 40, 31, 3), (4, 33, 50, 5), (6, 64, 65, 4), (3, 41, 98, 7),
    (4, 39, 128, 6), (3, 1600, 98, 5), (3, 41, 1100, 5)],
    ids=lambda v: str(v))
@pytest.mark.parametrize("end_states", [0, 1, "n"])
def test_viterbi_ties_and_degenerate_utterances(cuda, b, t_pad, n, w,
                                                end_states):
    """Quantised scores tie in every step and at the end (the first maximum
    must win in both routes as in the plain version); one utterance has
    dead self-loops and every delta at the sentinel, and backtraces below
    state 0 (JAX's wrap-once-then-clamp indexing).  T = 1,600 at N = 98
    and N = 1,100 take the block route either way (its backtrace over 50
    and 2 windows)."""
    rng = np.random.default_rng(n * w)
    band, log_pi, log_b, masks = banded_inputs(rng, b, t_pad, n, w)
    band = torch.where(band > -1e29, torch.round(band), band)
    log_b = torch.where(log_b > -1e29, torch.round(log_b / 16) * 16, log_b)
    log_pi = torch.round(log_pi)
    log_pi[2], log_b[2], band[2, :, 0] = -1e30, -1e30, -1e30
    masks[2] = True
    end = n if end_states == "n" else end_states
    _, path, _ = viterbi_three_ways(
        *(a.to(cuda) for a in (band, log_pi, log_b, masks)), w, end)
    if end_states != 1:
        assert int((path[2] < 0).sum()) > 0


@pytest.mark.parametrize("t_pad,n,w,warp", [
    (330, 50, 5, True),     # backpointers + rings pass 48 KB: the opt-in
    (1700, 50, 5, True),    # near the block's 227 KB at K = 2
    (1900, 50, 5, False),   # past it: the block route
    (800, 98, 5, True), (1000, 98, 5, False),      # K = 4: 16 bits a lane
    (1600, 98, 5, False),   # 20 s at the default label budget
    (64, 300, 5, False), (64, 50, 9, False), (64, 1100, 5, False)])
def test_viterbi_dispatch_routes(cuda, t_pad, n, w, warp):
    """One launch either way: the warp kernel while T - 1 frames of
    backpointers fit shared memory, else the block route, which alone
    takes a scratch."""
    rng = np.random.default_rng(t_pad + n)
    ops = [a.to(cuda) for a in banded_inputs(rng, 5, t_pad, n, w)]
    assert hk.viterbi_takes_warp(t_pad, n, w) == warp
    assert (hk.viterbi_scratch_bytes(5, t_pad, n, w) == 0) == warp
    viterbi_three_ways(*ops, w, 0)


def test_gmm_kernel_at_the_cd_bank_shape(cuda):
    """S = 2,049 (odd: a ragged last tile in both kernels), M = 6 of a
    mixture axis padded to 8 (two dead slots), D = 39."""
    rng = np.random.default_rng(2049)
    x, means, log_var, log_w = scoring_inputs(rng, 2049, 8, 39, 700)
    log_w[:, 6:] = -1e30
    args = [a.to(cuda) for a in (x, means, log_var, log_w)]
    six = [a.to(cuda) for a in (x, means[:, :6], log_var[:, :6],
                                log_w[:, :6])]
    for score_dtype, tol in (("float32", F32), ("bfloat16", BF16)):
        # the plain version in the same operand type
        want = tg.gmm_log_scores(*args, score_dtype=score_dtype)
        for operands in (args, six):     # dead slots score as no slots
            got = gk.gmm_log_scores_cuda(*operands, score_dtype=score_dtype)
            torch.cuda.synchronize()
            assert got.shape == (700, 2049) and torch.isfinite(got).all()
            assert torch.allclose(got, want, **tol), score_dtype


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_batch_stats_gpu_matches_cpu(cuda, score_dtype):
    """The E-step on the card (CUDA DP kernels, cuBLAS moments, atomic
    index_add_) against the CPU (plain DP, sequential scatter): float32
    sums of up to T·N_s terms in another order, so every field within
    rtol 1e-4 plus an absolute 1e-4 of the field's largest magnitude."""
    rng = np.random.default_rng(3)
    cfg = ModelConfig(state_num=5, mix_level=4, max_mix_level=4)
    bank = sb.create_bank(20, cfg, 13,
                          generator=torch.Generator().manual_seed(3),
                          device="cpu")
    arrays = sb.bank_to_numpy(bank)
    arrays["means"] = rng.normal(size=arrays["means"].shape).astype(
        np.float32)
    bank = sb.bank_from_numpy(arrays, device="cpu")
    b, t_pad, max_l = 12, 50, 6
    labels = rng.integers(0, 20, size=(b, max_l)).astype(np.int32)
    lens = rng.integers(1, max_l + 1, size=b).astype(np.int32)
    lens[-1] = 0
    xs = (rng.normal(size=(b, t_pad, 13)) * 1.5).astype(np.float32)
    masks = np.arange(t_pad)[None] < rng.integers(10, t_pad + 1, size=b)[:, None]
    kw = dict(count_final_exit=True, bw_inner_iters=3,
              score_dtype=score_dtype)
    want, wll = acc.batch_stats(bank, labels, lens, xs, masks, 5, max_l, **kw)
    before = hk.forward_banded_cuda.launches
    got, gll = acc.batch_stats(bank.to(cuda), labels, lens, xs, masks, 5,
                               max_l, **kw)
    torch.cuda.synchronize()
    assert hk.forward_banded_cuda.launches > before
    assert torch.allclose(gll.cpu(), wll, rtol=1e-5, atol=1e-5)
    for f, g in acc.stats_to_numpy(got).items():
        w = acc.stats_to_numpy(want)[f]
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert np.allclose(g, w, rtol=1e-4, atol=1e-4 * scale), (f, err,
                                                                  scale)


# the sentence kernel: each utterance against its own sentence states.
# Tolerance F32, as the shared-bank kernel's: the same float32 terms summed
# in another order than the plain version's two matmuls, and __expf /
# __logf (absolute errors below 1e-6) in the fold.
SENTENCE_SHAPES = [
    # the training cell's shape on a reduced batch: 2,049 senones x 16
    dict(b=4, t=960, n=266, s=2049, m=16, d=39),
    # N off the 8-state group, M padded to 8 in the pack, T off the tiles
    dict(b=3, t=131, n=45, s=70, m=5, d=39),
    # dead (NEG_INF) slots among 8, another D (run-time K)
    dict(b=5, t=200, n=61, s=90, m=8, d=13, dead=2),
    # M a multiple of 4 and not of 8, wide D
    dict(b=2, t=300, n=130, s=300, m=12, d=40),
    # B = 1 and a short T (the small tile)
    dict(b=1, t=25, n=50, s=606, m=16, d=39),
    # variances at the 1e-6 floor
    dict(b=6, t=319, n=98, s=606, m=8, d=39, floor=True),
]


@pytest.mark.parametrize("shape", SENTENCE_SHAPES, ids=lambda s: (
    "b{b}t{t}n{n}m{m}d{d}".format(**s) + ("floor" if s.get("floor") else "")))
def test_sentence_kernel_matches_plain(cuda, shape):
    """Scores and components of the sentence kernel against the plain
    ``sentence_scores`` arithmetic; without the components, the same
    scores bit for bit."""
    b, t, n, s, m, d = (shape[k] for k in "btnsmd")
    rng = np.random.default_rng(b * t + n)
    x, means, log_var, log_w = scoring_inputs(rng, s, m, d, b * t,
                                              shape.get("floor", False))
    if shape.get("dead"):
        log_w[:, -shape["dead"]:] = -1e30
    x = x.reshape(b, t, d)
    sen = torch.as_tensor(rng.integers(0, s, size=(b, n)))
    args = [a.to(cuda) for a in (x, sen, means, log_var, log_w)]
    before = gk.sentence_scores_cuda.launches
    scores, comp = gk.sentence_scores_cuda(*args)
    alone, none = gk.sentence_scores_cuda(*args, components=False)
    torch.cuda.synchronize()
    assert gk.sentence_scores_cuda.launches == before + 2
    assert none is None and torch.equal(alone, scores)
    xg, seng, mg, lvg, lwg = args
    want = tg.gmm_component_logpdf(xg, mg[seng], lvg[seng]) \
        + lwg[seng][:, None]
    assert comp.shape == (b, t, n, m) and torch.isfinite(scores).all()
    assert torch.allclose(comp, want, **F32)
    assert torch.allclose(scores, torch.logsumexp(want, dim=-1), **F32)


def test_sentence_kernel_launches_once_a_batch(cuda):
    """One launch in ``batch_stats`` and one in ``align_batch`` (one each
    at B = 1), none with the bfloat16 scoring, which keeps the plain
    version."""
    from poccala_tpu_torch.train import alignment as align

    rng = np.random.default_rng(11)
    cfg = ModelConfig(state_num=5, mix_level=4, max_mix_level=4)
    bank = sb.create_bank(20, cfg, 13,
                          generator=torch.Generator().manual_seed(11),
                          device=cuda)
    b, t_pad, max_l = 6, 40, 5
    labels = rng.integers(0, 20, size=(b, max_l)).astype(np.int32)
    lens = rng.integers(1, max_l + 1, size=b).astype(np.int32)
    xs = (rng.normal(size=(b, t_pad, 13)) * 1.5).astype(np.float32)
    masks = np.ones((b, t_pad), bool)
    calls = [
        (1, lambda dt: acc.batch_stats(bank, labels, lens, xs, masks, 5,
                                       max_l, score_dtype=dt)),
        (1, lambda dt: align.align_batch(bank, labels, lens, xs, masks, 5,
                                         max_l, score_dtype=dt)),
        (1, lambda dt: acc.utterance_stats(bank, labels[0], lens[0], xs[0],
                                           masks[0], 5, max_l,
                                           score_dtype=dt)),
        (1, lambda dt: align.align_utterance(bank, labels[0], lens[0], xs[0],
                                             masks[0], 5, max_l,
                                             score_dtype=dt))]
    for n_launch, call in calls:
        for dtype, want in (("float32", n_launch), ("bfloat16", 0)):
            before = gk.sentence_scores_cuda.launches
            call(dtype)
            torch.cuda.synchronize()
            assert gk.sentence_scores_cuda.launches == before + want, dtype


# the statistics kernel: the E-step's GMM moments over the live posteriors,
# held to the plain lines (acc._mixture_moments) on the card at F32, on
# batches of the training cell (chip_smoke.cell_lattice: asrbench's own
# generator, the posteriors of a forward-backward).

def test_stats_kernel_at_the_cell_shape(cuda):
    """B = 256, T up to 960 (the batch's longest), N = 266, M = 16, D = 39,
    the posteriors of a real forward-backward: the kernel's sums against
    the plain lines, every sum finite, and its tally of live tiles read
    right."""
    import chip_smoke

    _, _, lattice = chip_smoke.cell_lattice(2400000001)
    comp, scores, gamma, emitting, xs = lattice
    b, t, n, m = comp.shape
    assert (b, n, m, xs.shape[2]) == (256, 266, 16, 39) and 900 < t <= 960
    before = gk.sentence_stats_cuda.launches
    tally = gk.stats_tile_tally()
    got = gk.sentence_stats_cuda(*lattice)
    torch.cuda.synchronize()
    assert gk.sentence_stats_cuda.launches == before + 1
    live, total = gk.stats_tiles_plain(gamma, emitting).sum(dim=0).tolist()
    assert 0 < live < total // 4
    after = gk.stats_tile_tally()
    assert (after[0] - tally[0], after[1] - tally[1]) == (live, total)
    want = acc._mixture_moments(*lattice)
    for name, g, w in zip(("c_r", "cx_r", "cxx_r"), got, want):
        assert torch.isfinite(g).all(), name
        assert torch.allclose(g, w, **F32), (name,
                                             float((g - w).abs().max()))


def test_batch_stats_kernel_route_matches_plain_route(cuda, monkeypatch):
    """``batch_stats``'s whole ``BwStats`` through the kernel against the
    same call with the plain lines in its place, on 64 utterances of the
    training cell: every field within rtol 1e-4 plus an absolute 1e-4 of
    the field's largest magnitude (the index_add_ scatters add in no
    fixed order on either side)."""
    import chip_smoke

    bank, (labels, lens, xs, masks, max_l), _ = chip_smoke.cell_lattice(
        2400000002, n_utts=64)
    before = gk.sentence_stats_cuda.launches
    got, gll = acc.batch_stats(bank, labels, lens, xs, masks, 5, max_l)
    torch.cuda.synchronize()
    assert gk.sentence_stats_cuda.launches == before + 1
    monkeypatch.setattr(gk, "sentence_stats_cuda", acc._mixture_moments)
    want, wll = acc.batch_stats(bank, labels, lens, xs, masks, 5, max_l)
    assert torch.equal(gll, wll)
    for f, g in acc.stats_to_numpy(got).items():
        w = acc.stats_to_numpy(want)[f]
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert np.allclose(g, w, rtol=1e-4, atol=1e-4 * scale), (f, err,
                                                                  scale)


def test_stats_kernel_launches_once_a_batch(cuda):
    """One launch in each float32 ``batch_stats`` and ``utterance_stats``
    on the card, none with the bfloat16 scoring (the plain lines); the
    tally grows by the batch's tiles."""
    rng = np.random.default_rng(12)
    cfg = ModelConfig(state_num=5, mix_level=4, max_mix_level=4)
    bank = sb.create_bank(20, cfg, 13,
                          generator=torch.Generator().manual_seed(12),
                          device=cuda)
    b, t_pad, max_l = 6, 40, 5
    labels = rng.integers(0, 20, size=(b, max_l)).astype(np.int32)
    lens = rng.integers(1, max_l + 1, size=b).astype(np.int32)
    xs = (rng.normal(size=(b, t_pad, 13)) * 1.5).astype(np.float32)
    masks = np.ones((b, t_pad), bool)
    n_s = 2 + 3 * max_l
    calls = [
        (b, lambda dt: acc.batch_stats(bank, labels, lens, xs, masks, 5,
                                       max_l, score_dtype=dt)),
        (1, lambda dt: acc.utterance_stats(bank, labels[0], lens[0], xs[0],
                                           masks[0], 5, max_l,
                                           score_dtype=dt))]
    for utts, call in calls:
        for dtype, want in (("float32", 1), ("bfloat16", 0)):
            before = gk.sentence_stats_cuda.launches
            tally = gk.stats_tile_tally()
            stats, _ = call(dtype)
            torch.cuda.synchronize()
            assert float(stats.c.sum()) > 0
            assert gk.sentence_stats_cuda.launches == before + want, dtype
            after = gk.stats_tile_tally()
            assert after[1] - tally[1] == want * utts * -(-n_s // 8) * 2
            assert 0 < after[0] - tally[0] <= after[1] - tally[1] or not want


# ----------------------------------------------------------------------
# scheme 1: k-means, EM, SMEM and fit_gmms on the card
# ----------------------------------------------------------------------

def blob_groups(rng, g=6, f=200, d=4):
    """Per group three blobs with ragged masks and one all-masked group.
    The blobs sit near the origin (|μ|²/σ² ≲ 40): Σγx²/n − μ² then loses
    little to cancellation, and float32 EM stays within 2e-5 of float64."""
    centers = rng.normal(size=(g, 3, d)) * 2
    x = centers[np.arange(g)[:, None], rng.integers(0, 3, size=(g, f))] \
        + rng.normal(size=(g, f, d)) * 0.6
    mask = rng.uniform(size=(g, f)) < 0.85
    mask[2] = False
    return (torch.tensor(x, dtype=torch.float32), torch.tensor(mask))


def test_kmeans_em_gpu_matches_cpu(cuda):
    """The same inputs and generator seed on both devices: the same
    assignments and EM iteration counts, parameters at 1e-4."""
    from poccala_tpu_torch.ops import em as tem
    from poccala_tpu_torch.ops import kmeans as tkm

    x, mask = blob_groups(np.random.default_rng(4))
    want = tkm.kmeans_grouped(torch.Generator().manual_seed(3), x, mask, 3)
    got = tkm.kmeans_grouped(torch.Generator().manual_seed(3), x.to(cuda),
                             mask.to(cuda), 3)
    assert torch.equal(got["assign"].cpu(), want["assign"])
    assert torch.equal(got["counts"].cpu(), want["counts"])
    for f in ("means", "variances", "alpha"):
        assert torch.allclose(got[f].cpu(), want[f], **F32), f

    g, m = x.shape[0], 4
    mix_mask = torch.arange(m)[None].expand(g, m) < 3
    params = (nn_pad(want["means"], m), nn_pad(torch.log(want["variances"]), m),
              torch.log(torch.clamp(nn_pad(want["alpha"][..., None], m)[..., 0],
                                    min=1e-30)))
    floor = np.full(4, 1e-3, np.float32)
    wp, wq, wit = tem.em_fit_grouped(*params, x, mask, mix_mask,
                                     c_covariance=floor)
    gp, gq, git = tem.em_fit_grouped(*(p.to(cuda) for p in params),
                                     x.to(cuda), mask.to(cuda),
                                     mix_mask.to(cuda), c_covariance=floor)
    assert torch.equal(git.cpu(), wit)
    assert torch.allclose(gq.cpu(), wq, rtol=1e-5, atol=1e-3)
    for a, b in zip(gp, wp):
        assert torch.allclose(a.cpu(), b, **F32)


def nn_pad(a, m):
    """Pad the mixture axis (dim 1) of ``a`` with zeros up to ``m``."""
    return torch.nn.functional.pad(a, (0, 0, 0, m - a.shape[1]))


class _SmemTrainer:
    def __init__(self, bank, cfg):
        self.bank, self.cfg, self.mix_level = bank, cfg, 3
        self.generator = torch.Generator().manual_seed(7)


def smem_world():
    """tests/test_smem_batched.py's world without jax: six senones of
    three mixtures on three blobs; the even ones are EM-converged from
    the classic SMEM local optimum, the odd ones from the truth."""
    from poccala_tpu_torch.ops import em as tem

    rng = np.random.default_rng(0)
    cfg = Config()
    cfg.model.state_num, cfg.model.mix_level = 5, 3
    cfg.model.max_mix_level = 4
    bank = sb.create_bank(2, cfg.model, 2, differentiation=False, device="cpu")
    s, cap, d = 6, 360, 2
    frames = np.zeros((s, cap, d), np.float32)
    means0 = np.zeros((s, 4, d), np.float32)
    for i in range(s):
        blob = rng.normal(size=(cap // 3, d)) * 0.3
        pts = np.concatenate([blob + [0, 0], blob + [6, 0], blob + [0, 6]])
        frames[i] = pts[rng.permutation(cap)]
        means0[i, :3] = ([[0.1, 0.0], [-0.1, 0.0], [3.0, 3.0]] if i % 2 == 0
                         else [[0, 0], [6, 0], [0, 6]])
    log_w0 = np.full((s, 4), -1e30, np.float32)
    log_w0[:, :3] = np.log(1 / 3)
    mask = np.ones((s, cap), bool)
    p, _, _ = tem.em_fit_grouped(
        torch.tensor(means0), torch.zeros(s, 4, d), torch.tensor(log_w0),
        torch.tensor(frames), torch.tensor(mask),
        torch.arange(4)[None].expand(s, 4) < 3, max_iters=30)
    return sb.replace(bank, means=p.means, log_var=p.log_var,
                      log_w=p.log_w), cfg, frames, mask


def test_smem_batched_gpu_makes_world_decisions(cuda):
    from poccala_tpu_torch.train import smem as tsmem

    bank, cfg, frames, mask = smem_world()
    means0 = bank.means.clone()
    tr = _SmemTrainer(bank.to(cuda), cfg)       # Module.to moves in place
    new, n = tsmem.smem_pass_batched(tr, frames, mask, np.ones(6, bool))
    changed = (new.means.cpu() != means0).any(-1).any(-1).numpy()
    assert n == 3
    assert np.array_equal(changed, [1, 0, 1, 0, 1, 0])
    assert all(getattr(new, f).is_cuda for f in sb.FIELDS)


def test_fit_gmms_keeps_bank_on_gpu(cuda):
    from poccala_tpu_torch.io.corpus import UnitInventory as Inv
    from poccala_tpu_torch.train.trainer import Trainer

    cfg = Config()
    cfg.model.state_num, cfg.model.mix_level = 5, 3
    cfg.model.max_mix_level = 4
    tr = Trainer(cfg, Inv(["a", "o", "e", "i"]), device=cuda)
    rng = np.random.default_rng(5)
    frames = rng.normal(size=(12, 120, 39)).astype(np.float32)
    mask = rng.uniform(size=(12, 120)) < 0.9
    mask[3] = False                      # a senone without data
    tr.fit_gmms(frames, mask, reinit=True, smem=True)
    assert all(getattr(tr.bank, f).is_cuda for f in sb.FIELDS)
    assert torch.isfinite(tr.bank.means).all()
    assert tr.round_info["em_iters"] >= 1 and "smem_accepted" in tr.round_info


# ----------------------------------------------------------------------
# the host decoder tiers, batched scoring, the profiling ledger
# ----------------------------------------------------------------------

def separable_world(seed=6, d=8):
    """Six units whose senone means are per-unit embeddings, the lexicon
    你好 / 你 / 马 over them, and three utterances drawn around the
    embeddings (tests/test_streaming_decode.py's world)."""
    rng = np.random.default_rng(seed)
    units = ["n", "i3", "h", "ao3", "m", "a1"]
    inv = UnitInventory(units)
    cfg = ModelConfig(state_num=5, mix_level=1, max_mix_level=1)
    emb = rng.normal(size=(len(units), d)).astype(np.float32) * 4
    arrays = sb.bank_to_numpy(sb.create_bank(len(units), cfg, d,
                                             differentiation=False,
                                             device="cpu"))
    arrays["means"] = np.repeat(emb, 3, axis=0)[:, None, :]
    lex = PronunciationLexicon()
    lex.generate(["你好", "你", "马"],
                 PinYin({"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}))
    flat = FlatLexicon.from_tree(lex.lexicon, inv)
    utts = [np.concatenate([emb[u] + rng.normal(size=(10, d)) * 0.4
                            for u in seq]).astype(np.float32)
            for seq in ([0, 1, 2, 3], [4, 5], [0, 1, 2, 3, 4, 5])]
    feats = np.zeros((3, 60, d), np.float32)
    for i, x in enumerate(utts):
        feats[i, : len(x)] = x
    return arrays, flat, feats, np.array([len(x) for x in utts])


def same_nbest(got, want):
    assert [h.words for h in got] == [h.words for h in want]
    assert np.allclose([h.score for h in got], [h.score for h in want],
                       rtol=1e-4, atol=0.0)


def test_host_tiers_gpu_match_cpu(cuda):
    """The vector and simple tiers with the bank on the card: the CPU's
    n-best (words, scores at 1e-4), one GMM launch per ``decode_batch``
    and per simple ``decode``, for features given as an array or as a
    tensor on the card."""
    from poccala_tpu_torch.decoder import BeamDecoder
    from poccala_tpu_torch.decoder.vector import VectorBeamDecoder

    arrays, flat, feats, n = separable_world()
    gbank = sb.bank_from_numpy(arrays, device=cuda)
    cbank = sb.bank_from_numpy(arrays, device="cpu")
    want = VectorBeamDecoder(cbank, flat).decode_batch(feats, n)
    gvec = VectorBeamDecoder(gbank, flat)
    for x in (feats, torch.as_tensor(feats, device=cuda)):
        before = gk.gmm_log_scores_cuda.launches
        got = gvec.decode_batch(x, n)
        assert gk.gmm_log_scores_cuda.launches == before + 1
        assert [g[0].words for g in got] == [("你好",), ("马",),
                                             ("你好", "马")]
        for g, w in zip(got, want):
            same_nbest(g, w)
    gsim = BeamDecoder(gbank, flat, candidate=3)
    csim = BeamDecoder(cbank, flat, candidate=3)
    for i in range(3):
        before = gk.gmm_log_scores_cuda.launches
        got = gsim.decode(feats[i, : n[i]])
        assert gk.gmm_log_scores_cuda.launches == before + 1
        same_nbest(got, csim.decode(feats[i, : n[i]]))


def test_gmm_log_scores_batch_launches_once(cuda):
    rng = np.random.default_rng(8)
    x, means, log_var, log_w = scoring_inputs(rng, 70, 4, 13, 3 * 40)
    x = x.reshape(3, 40, 13)
    mask = torch.ones(3, 40, dtype=torch.bool)
    before = gk.gmm_log_scores_cuda.launches
    got, gmask = tg.gmm_log_scores_batch(
        x.to(cuda), mask, means.to(cuda), log_var.to(cuda), log_w.to(cuda))
    assert gk.gmm_log_scores_cuda.launches == before + 1
    want, _ = tg.gmm_log_scores_batch(x, mask, means, log_var, log_w)
    assert gmask is mask and got.shape == (3, 40, 70)
    assert torch.allclose(got.cpu(), want, **F32)


def test_optimer_timeit_synchronises(cuda, monkeypatch):
    """``timeit`` waits for the card after the warm-up and after the timed
    calls, and returns with the work done."""
    from poccala_tpu_torch.utils.profiling import OpTimer

    synced = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: (synced.append(device),
                                             real(device))[1])
    a = torch.randn(2048, 2048, device=cuda)
    timer = OpTimer()
    out, dt = timer.timeit("mm", torch.matmul, a, a, iters=5,
                           flops=2 * 2048.0 ** 3)
    assert len(synced) == 2 and all(d == a.device for d in synced)
    assert torch.cuda.current_stream(cuda).query() and dt > 0
    assert timer.records["mm"]["calls"] == 5 and "TFLOP/s" in timer.report()


def test_optimer_measure_synchronises(cuda, monkeypatch):
    """``measure`` waits for the card at the block's end, so its time
    covers the block's device work and not only the enqueue."""
    from poccala_tpu_torch.utils.profiling import OpTimer

    synced = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: (synced.append(device),
                                             real(device))[1])
    a = torch.randn(2048, 2048, device=cuda)
    (a @ a).sum().item()
    timer = OpTimer()
    with timer.measure("mm", flops=10 * 2 * 2048.0 ** 3):
        for _ in range(10):
            b = a @ a
        assert not torch.cuda.current_stream(cuda).query()
    assert synced == [None] and torch.cuda.current_stream(cuda).query()
    assert b.is_cuda and timer.records["mm"]["calls"] == 1
    assert timer.records["mm"]["seconds"] > 1e-4


# ----------------------------------------------------------------------
# the parallel tier on the card
# ----------------------------------------------------------------------

def test_one_rank_nccl_mesh_matches_unsharded(cuda):
    """``--distributed`` on one card: a one-rank NCCL mesh.  The sharded
    E-step, alignment and decode launch the kernels and equal the
    unsharded calls (statistics to float32 rounding: both sum with
    atomics)."""
    import torch.distributed as dist

    from poccala_tpu_torch.parallel import mesh as pmesh
    from poccala_tpu_torch.train import alignment as align

    rng = np.random.default_rng(4)
    cfg = ModelConfig(state_num=5, mix_level=4, max_mix_level=4)
    arrays = sb.bank_to_numpy(sb.create_bank(
        20, cfg, 13, generator=torch.Generator().manual_seed(4),
        device="cpu"))
    arrays["means"] = rng.normal(size=arrays["means"].shape).astype(
        np.float32)
    bank = sb.bank_from_numpy(arrays, device=cuda)
    b, t_pad, max_l = 12, 50, 6
    batch = (rng.integers(0, 20, size=(b, max_l)).astype(np.int32),
             rng.integers(1, max_l + 1, size=b).astype(np.int32),
             (rng.normal(size=(b, t_pad, 13)) * 1.5).astype(np.float32),
             np.arange(t_pad)[None] < rng.integers(10, t_pad + 1,
                                                   size=b)[:, None])
    assert not dist.is_initialized()
    try:
        mesh = pmesh.make_mesh(device=cuda)
        assert dist.get_backend() == "nccl"
        for k in hk.KERNELS.values():
            k.launches = 0
        for make in (pmesh.make_parallel_estep,
                     pmesh.make_state_sharded_estep):
            got, gll = make(mesh, 5, max_l)(bank, *batch)
            want, wll = acc.batch_stats(bank, *batch, 5, max_l)
            torch.testing.assert_close(gll, wll, rtol=1e-5, atol=1e-5)
            for f in acc.STATS_FIELDS:
                torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                           **F32, msg=f)
        scores, lp = pmesh.make_state_sharded_align(mesh, 5, max_l)(
            bank, *batch)
        wscores, wlp = align.align_batch(bank, *batch, 5, max_l)
        assert torch.equal(lp, wlp) and torch.equal(scores, wscores)
        assert all(k.launches > 0 for k in hk.KERNELS.values())

        inv, dbank, feats = decode_world(5)
        lex = PronunciationLexicon()
        lex.generate(list(BUILTIN_PINYIN), PinYin())
        dec = DeviceBeamDecoder(dbank.to(cuda),
                                FlatLexicon.from_tree(lex.lexicon, inv))
        before = gk.gmm_log_scores_cuda.launches
        got = dec.decode_batch(feats, [60, 45], return_nbest=3, mesh=mesh)
        assert gk.gmm_log_scores_cuda.launches == before + 1
        want = dec.decode_batch(feats, [60, 45], return_nbest=3)
        assert [[(h.words, h.score) for h in u] for u in got] == \
            [[(h.words, h.score) for h in u] for u in want]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_gloo_ranks_with_cuda_tensors(cuda, tmp_path):
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    GPU): a state-sharded train step equals the one-rank step at 1e-4, the
    sharded alignment the unsharded one exactly, and each rank launched
    every DP kernel."""
    import json

    from .test_torch_parallel_worker import run_world

    run_world("cuda_step", 2, "-", str(tmp_path), 300)
    for r in range(2):
        out = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert int(out["rows"]) == 32     # 63 senones padded to 64, 2 shards
        np.testing.assert_allclose(out["ll"][0], out["ll"][1], rtol=1e-5)
        for f in sb.FIELDS:
            np.testing.assert_allclose(out[f"got_{f}"], out[f"want_{f}"],
                                       rtol=1e-4, atol=1e-4, err_msg=f)
        assert bool(out["align_equal"])
        launches = json.loads(str(out["launches"]))
        assert all(n > 0 for n in launches.values()), launches


# ----------------------------------------------------------------------
# the device decoder's frame scan (csrc/decoder_scan.cu) against its plain
# version, the loop of DeviceBeamDecoder._frame_step, on the same card:
# bit for bit in the carry, the traceback rows and the n-best


class _TableLM:
    """An LM object without ``bigram_tables_backoff``: the decoder builds
    the flat ``[(V+1) V]`` table through ``logprob`` calls."""

    def __init__(self, lm):
        self.lm = lm

    def logprob(self, word, context):
        return self.lm.logprob(word, context)


def scan_decoder(cuda, lm_kind="none", flat=None, seed=7, penalty=0.0,
                 state_num=5, bank_fn=None, **kw):
    """A random XIF_tone bank on the card over ``flat`` (the built-in
    lexicon by default) with no LM, a flat or a sparse bigram LM;
    ``bank_fn`` rewrites the bank's arrays first."""
    from poccala_tpu_torch.lm.ngram import Ngram

    inv, bank, _ = decode_world(seed, state_num)
    if bank_fn is not None:
        bank = sb.bank_from_numpy(bank_fn(sb.bank_to_numpy(bank)),
                                  device="cpu")
    words = list(BUILTIN_PINYIN)
    if flat is None:
        lex = PronunciationLexicon()
        lex.generate(words, PinYin())
        flat = FlatLexicon.from_tree(lex.lexicon, inv)
    rng = np.random.default_rng(seed)
    ngram = Ngram(2)
    ngram.train([list(rng.choice(words, size=6)) for _ in range(200)])
    lm = {"none": None, "flat": _TableLM(ngram), "sparse": ngram}[lm_kind]
    return DeviceBeamDecoder(bank.to(cuda), flat, lm=lm, lm_weight=3.0,
                             word_penalty=penalty, **kw)


def scan_both(dec, scores, n_valid, t0=0, carry=None, rows_before=None):
    """The kernel's and the plain loop's ``_scan`` of ``scores`` from
    ``carry`` (the seed by default), held equal bit for bit, and the n-best
    each carry gives over ``rows_before`` (the earlier frames' traceback
    rows, ``(tb_prev, tb_word)``; none when ``t0`` is 0) and the new rows;
    returns the kernel's."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    tabs = dec._prep_device()
    if carry is None:
        carry = dec._seed(tabs, scores.shape[0])
    before = dk.decoder_scan_cuda.launches
    got = dec._scan(tabs, carry, scores, t0, n_valid)
    assert dk.decoder_scan_cuda.launches == before + 1
    want = dec._scan_plain(tabs, carry, scores, t0, n_valid)
    for name, g, w in zip(("deltas", "ctx"), got[0], want[0]):
        assert torch.equal(g, w), name
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert (rows_before is None) == (t0 == 0)

    def nbest(out):
        carry, prev, word = out
        if rows_before is not None:
            prev = torch.cat([rows_before[0], prev], 1)
            word = torch.cat([rows_before[1], word], 1)
        return dec._finalize(tabs, carry, prev, word, 8)

    (g_seqs, g_sc), (w_seqs, w_sc) = nbest(got), nbest(want)
    assert torch.equal(g_seqs, w_seqs) and torch.equal(g_sc, w_sc)
    return got


@pytest.mark.parametrize("b", [1, 7, 256])
@pytest.mark.parametrize("lm_kind", ["none", "flat", "sparse"])
def test_decoder_scan_matches_plain_loop(cuda, lm_kind, b):
    """The 125-node built-in lexicon, 64 frames, rows frozen from random
    frame counts (one at 0 where B > 1): one CTA an utterance."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    dec = scan_decoder(cuda, lm_kind, penalty=1.5)
    tabs = dec._prep_device()
    assert dk.scan_plan(tabs, dec.bank.num_states,
                        dec._r_top(tabs))["route"] == "smem"
    rng = np.random.default_rng(b)
    feats = torch.tensor((rng.normal(size=(b, 64, 13)) * 2)
                         .astype(np.float32), device=cuda)
    n_valid = rng.integers(1, 65, size=b)
    n_valid[0] = 64
    if b > 1:
        n_valid[1] = 0
    _, tb_prev, tb_word = scan_both(dec, dec._scores(feats), n_valid)
    assert (tb_word[0] >= 0).any()
    for u, n in enumerate(n_valid):
        assert (tb_prev[u, n:] == -1).all() and (tb_word[u, n:] == -1).all()


@pytest.mark.parametrize("lm_kind", ["none", "flat", "sparse"])
def test_decoder_scan_ties(cuda, lm_kind):
    """Scores rounded to multiples of 8: paths, exits and word emissions
    tie everywhere, and the kernel must break every tie as the plain loop
    does (the smaller band offset, the lower slot, the first candidate)."""
    dec = scan_decoder(cuda, lm_kind)
    rng = np.random.default_rng(3)
    feats = torch.tensor((rng.normal(size=(5, 48, 13)) * 2)
                         .astype(np.float32), device=cuda)
    scores = torch.round(dec._scores(feats) / 8) * 8
    scan_both(dec, scores, np.array([48, 48, 40, 31, 9]))


def test_decoder_scan_stream_chunks(cuda):
    """Three 25-frame chunks (t0 = 0, 25, 50; some rows end inside a
    chunk) through the kernel equal the one-shot scan of the 75 frames,
    each chunk held to the plain loop from the same carry."""
    dec = scan_decoder(cuda, "sparse", seed=8)
    rng = np.random.default_rng(8)
    feats = torch.tensor((rng.normal(size=(3, 75, 13)) * 2)
                         .astype(np.float32), device=cuda)
    scores = dec._scores(feats)
    n = np.array([75, 60, 33])
    whole = scan_both(dec, scores, n)
    carry, prev, word = None, [], []
    for t0 in (0, 25, 50):
        before = (torch.cat(prev, 1), torch.cat(word, 1)) if t0 else None
        carry, p, w = scan_both(dec, scores[:, t0:t0 + 25].contiguous(),
                                np.clip(n - t0, 0, 25), t0, carry, before)
        prev.append(p)
        word.append(w)
    assert torch.equal(carry[0], whole[0][0])
    assert torch.equal(carry[1], whole[0][1])
    assert torch.equal(torch.cat(prev, 1), whole[1])
    assert torch.equal(torch.cat(word, 1), whole[2])


@pytest.mark.parametrize("min_nodes,n_chars,state_num,route", [
    (875, 12, 5, "smem"), (3514, 56, 5, "cluster"), (None, None, 5, "cluster"),
    (None, None, 10, "global")])
def test_decoder_scan_large_lexicons(cuda, min_nodes, n_chars, state_num,
                                     route):
    """An 875-node lexicon (the CD graph's size: the carry in one CTA's
    shared memory past the 48 KB a block gets unasked), the reference
    lexicon's 3,514 nodes and the 21,589-node synthetic lexicon (each
    carry split over a thread-block cluster), and the 21,589 nodes at 18
    token states (a carry no cluster of 16 holds: device memory)."""
    from poccala_tpu_torch.lexicon.build import FULL_VOCAB_NODES, \
        synthetic_lexicon
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    inv = UnitInventory.standard("XIF_tone")
    flat, _, _ = synthetic_lexicon(
        inv, min_nodes=min_nodes or FULL_VOCAB_NODES, n_chars=n_chars)
    dec = scan_decoder(cuda, "sparse", flat=flat, seed=9,
                       state_num=state_num)
    tabs = dec._prep_device()
    plan = dk.scan_plan(tabs, dec.bank.num_states, dec._r_top(tabs))
    assert plan["route"] == route, plan
    assert route != "cluster" or plan["active_clusters"] >= 1
    rng = np.random.default_rng(9)
    feats = torch.tensor((rng.normal(size=(3, 40, 13)) * 2)
                         .astype(np.float32), device=cuda)
    scan_both(dec, dec._scores(feats), np.array([40, 27, 40]))


# ----------------------------------------------------------------------
# the frame scan past its registers (18 token states, band width 10)
# and past shared memory (29,500 senones); the DP kernels past 1,024
# states

def with_skips(arrays, seed=10):
    """Every left-to-right transition of each unit live: the decoder's band
    is ``state_num`` wide."""
    rng = np.random.default_rng(seed)
    log_a = arrays["log_A"].copy()
    n = log_a.shape[1]
    for row in range(n - 1):
        lo = max(row, 1)
        log_a[:, row] = -1e30
        log_a[:, row, lo:] = np.log(rng.dirichlet(np.ones(n - lo),
                                                  size=log_a.shape[0]))
    return dict(arrays, log_A=log_a.astype(np.float32))


def widened(arrays, n_senones=29500, seed=11):
    """The bank's senones spread over ``n_senones`` (the rest random
    copies): each frame's scores row no longer fits the scan's shared
    memory, and the senones in use reach past it."""
    rng = np.random.default_rng(seed)
    s = arrays["means"].shape[0]
    ids = np.sort(rng.choice(n_senones, size=s, replace=False))
    ids[-1] = n_senones - 1
    src = rng.integers(0, s, size=n_senones)
    src[ids] = np.arange(s)
    out = {f: arrays[f][src] for f in ("means", "log_var", "log_w",
                                        "mix_counts")}
    return dict(arrays, **out, senone_map=ids[arrays["senone_map"]]
                .astype(np.int32))


@pytest.mark.parametrize("skips,lm_kind", [(False, "none"), (False, "sparse"),
                                           (True, "flat")])
def test_decoder_scan_at_state_num_10(cuda, skips, lm_kind):
    """18 token states a node (band width 2, or 10 with skips): the
    kernel's in-place instantiation against the plain loop, bit for bit,
    in one call and in three stream chunks."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    dec = scan_decoder(cuda, lm_kind, seed=10, penalty=1.5, state_num=10,
                       bank_fn=with_skips if skips else None)
    tabs = dec._prep_device()
    assert tuple(tabs.bands.shape[1:]) == (18, 10 if skips else 2)
    assert not dk.states_in_regs(18, tabs.bands.shape[2])
    rng = np.random.default_rng(10)
    feats = torch.tensor((rng.normal(size=(7, 75, 13)) * 2)
                         .astype(np.float32), device=cuda)
    scores = torch.round(dec._scores(feats) / 8) * 8
    n = rng.integers(1, 76, size=7)
    n[0] = 75
    whole = scan_both(dec, scores, n)
    carry, prev, word = None, [], []
    for t0 in (0, 25, 50):
        before = (torch.cat(prev, 1), torch.cat(word, 1)) if t0 else None
        carry, p, w = scan_both(dec, scores[:, t0:t0 + 25].contiguous(),
                                np.clip(n - t0, 0, 25), t0, carry, before)
        prev.append(p)
        word.append(w)
    assert torch.equal(carry[0], whole[0][0])
    assert torch.equal(torch.cat(word, 1), whole[2])
    hyps = dec.decode_batch(feats, n, 2)
    assert len(hyps) == 7 and len(hyps[0]) >= 1


def chunked_scan_both(dec, scores, n, chunk=25):
    """``scores`` through ``scan_both`` in chunks of ``chunk`` frames (each
    held to the plain loop from the same carry, the n-best over the rows so
    far), equal to the one-shot scan of all of them."""
    whole = scan_both(dec, scores, n)
    carry, prev, word = None, [], []
    for t0 in range(0, scores.shape[1], chunk):
        before = (torch.cat(prev, 1), torch.cat(word, 1)) if t0 else None
        carry, p, w = scan_both(dec, scores[:, t0:t0 + chunk].contiguous(),
                                np.clip(n - t0, 0, chunk), t0, carry, before)
        prev.append(p)
        word.append(w)
    for g, w in zip((*carry, torch.cat(prev, 1), torch.cat(word, 1)),
                    (*whole[0], whole[1], whole[2])):
        assert torch.equal(g, w)


def test_decoder_scan_past_shared_memory(cuda):
    """A bank of 29,500 senones: each frame's scores row is read from
    device memory, bit for bit with the plain loop, and a decode runs the
    GMM kernel and the scan on it.  Then carries past every on-chip
    cluster (the device-memory route, each utterance over a cluster all
    the same): 18 token states over the 21,589-node lexicon at B = 1 and
    8, in one call and in three 25-frame chunks, and the default topology
    over 40,000 nodes at B = 8."""
    from poccala_tpu_torch.lexicon.build import synthetic_lexicon
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    dec = scan_decoder(cuda, "sparse", seed=12, penalty=1.5,
                       bank_fn=widened)
    tabs = dec._prep_device()
    assert dec.bank.num_states == 29500
    assert int(tabs.senone.max()) == 29499
    plan = dk.scan_plan(tabs, 29500, dec._r_top(tabs))
    assert not plan["rows_smem"] and plan["route"] == "smem"
    rng = np.random.default_rng(12)
    feats = torch.tensor((rng.normal(size=(3, 40, 13)) * 2)
                         .astype(np.float32), device=cuda)
    scan_both(dec, dec._scores(feats), np.array([40, 31, 12]))
    before = dk.decoder_scan_cuda.launches
    assert all(len(h) >= 1 for h in dec.decode_batch(feats, [40, 31, 12]))
    assert dk.decoder_scan_cuda.launches == before + 1

    inv = UnitInventory.standard("XIF_tone")
    feats = torch.tensor((rng.normal(size=(8, 75, 13)) * 2)
                         .astype(np.float32), device=cuda)
    n = rng.integers(30, 76, size=8)
    n[0] = 75
    for state_num, min_nodes in ((10, None), (5, 40_000)):
        flat, _, _ = synthetic_lexicon(
            inv, **({} if min_nodes is None else dict(min_nodes=min_nodes)))
        dec = scan_decoder(cuda, "sparse", flat=flat, seed=12, penalty=1.5,
                           state_num=state_num)
        tabs = dec._prep_device()
        scores = torch.round(dec._scores(feats) / 8) * 8
        for b in ((1, 8) if min_nodes is None else (8,)):
            plan = dk.scan_plan(tabs, dec.bank.num_states, dec._r_top(tabs),
                                batch=b)
            assert plan["route"] == "global" and plan["cluster"] > 1, plan
            chunked_scan_both(dec, scores[:b].contiguous(), n[:b])


@functools.lru_cache(maxsize=1)
def cd_fullvocab_decoder():
    """6,000 senones x 32 mixtures tied from within-word triples over the
    full vocabulary (``tests/cd_world.py``: a 30,237-node tree of some
    18,000 groups) on the card, answers of up to 64 words."""
    from .cd_world import cd_decoder

    return cd_decoder(6000, 32, seed=31, device="cuda", max_words=64)


def test_decoder_scan_at_the_cd_fullvocab_cell(cuda):
    """The full-vocabulary tied-triphone configuration at its full size:
    at a batch of 128 the scan takes the device-memory route over
    clusters, the scores rows in shared memory, the group tables in device
    memory.  On three utterances the kernel equals the plain loop bit for
    bit (carry, rows, n-best), and a decode call gives the plain versions'
    words."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    from .cd_world import cd_frames

    dec = cd_fullvocab_decoder()
    tabs = dec._prep_device()
    assert tuple(tabs.bands.shape) == (30237, 8, 2)
    assert dk.n_groups(tabs) > 15000
    plan = dk.scan_plan(tabs, 6000, dec._r_top(tabs), batch=128)
    assert (plan["route"], plan["rows_smem"], plan["groups_smem"]) == \
        ("global", True, False) and plan["cluster"] > 1, plan
    feats = cd_frames(dec, 3, 80, seed=31)
    n = np.array([80, 64, 72])
    scores = dec._scores(feats)
    scan_both(dec, scores, n)
    got = dec.decode_batch(feats, n)
    carry, prev, word = dec._scan_plain(tabs, dec._seed(tabs, 3), scores, 0,
                                        n)
    seqs, sc = dec._finalize_plain(tabs, carry, prev, word, dec._n_cand(1))
    want = dec._to_hypotheses(seqs.cpu().numpy(), sc.cpu().numpy(), 3, 1)
    assert all(got) and [[h.words for h in u] for u in got] == \
        [[h.words for h in u] for u in want]


def test_launches_global_counts_the_device_memory_route(cuda):
    """``decoder_scan_cuda.launches`` counts every launch of the frame
    scan and ``launches_global`` only those on the device-memory route:
    the built-in lexicon's carry stays on chip (+0), the full-vocabulary
    CD tree's goes to device memory (+1); both equal the plain loop."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    from .cd_world import cd_frames

    small = scan_decoder(cuda)
    rng = np.random.default_rng(13)
    x = torch.tensor((rng.normal(size=(2, 40, 13)) * 2).astype(np.float32),
                     device=cuda)
    cd = cd_fullvocab_decoder()
    scan = dk.decoder_scan_cuda
    for dec, feats, on_chip in ((small, x, True),
                                (cd, cd_frames(cd, 2, 40, seed=13), False)):
        tabs = dec._prep_device()
        plan = dk.scan_plan(tabs, dec.bank.num_states, dec._r_top(tabs),
                            batch=2)
        assert plan["onchip"] == on_chip, plan
        before = (scan.launches, scan.launches_global)
        scan_both(dec, dec._scores(feats), np.array([40, 33]))
        assert (scan.launches, scan.launches_global) == \
            (before[0] + 1, before[1] + (not on_chip))


@pytest.mark.parametrize("b,t_pad", [(3, 41), (1, 2)])
def test_hmm_kernels_past_1024_states(cuda, b, t_pad):
    """N = 1,100 sentence states (past the 1,024 of a CTA's threads):
    forward, backward and Viterbi on the block route; alpha, beta and
    Viterbi's outputs against the plain versions (Viterbi bit for bit,
    tied scores), one launch each."""
    rng = np.random.default_rng(1100 + b)
    n, w = 1100, 5
    band, log_pi, log_b, masks = [a.to(cuda) for a in
                                  banded_inputs(rng, b, t_pad, n, w)]
    log_b = torch.where(log_b > -1e29, torch.round(log_b / 8) * 8, log_b)
    assert hk._lib().hmm_banded_max_n() == 29056
    before = {k: f.launches for k, f in hk.KERNELS.items()}
    la, ll = thmm.forward_log_banded_batch(band, log_pi, log_b, masks, w)
    lb = thmm.backward_log_banded_batch(band, log_b, masks, w)
    got = thmm.viterbi_log_banded_batch(band, log_pi, log_b, masks, w, 3)
    want_a, want_ll = thmm.forward_log_banded_plain(band, log_pi, log_b,
                                                    masks, w)
    want_b = thmm.backward_log_banded_plain(band, log_b, masks, w)
    want = thmm.viterbi_log_banded_plain(band, log_pi, log_b, masks, w, 3)
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in hk.KERNELS.items()} == \
        {"forward": 1, "backward": 1, "viterbi": 1}
    assert torch.allclose(la, want_a, rtol=1e-5, atol=1e-5)
    assert torch.allclose(ll, want_ll, rtol=1e-5, atol=1e-5)
    assert torch.allclose(lb, want_b, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


# ----------------------------------------------------------------------
# the device decoder's n-best (decoder_finalize in csrc/decoder_scan.cu)
# against its plain version, DeviceBeamDecoder._finalize_plain, bit for bit

def finalize_both(dec, carry, prev, word, n_cand):
    """``dec._finalize`` (one kernel launch) against ``_finalize_plain`` on
    the same carry and rows; returns the kernel's ``(seqs, scores)``."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    tabs = dec._prep_device()
    before = dk.decoder_finalize_cuda.launches
    got = dec._finalize(tabs, carry, prev, word, n_cand)
    assert dk.decoder_finalize_cuda.launches == before + 1
    want = dec._finalize_plain(tabs, carry, prev, word, n_cand)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.parametrize("nbest", [1, 5])
@pytest.mark.parametrize("b", [1, 7, 256])
@pytest.mark.parametrize("lm_kind", ["none", "flat", "sparse"])
def test_decoder_finalize_matches_plain(cuda, lm_kind, b, nbest):
    """The 125-node built-in lexicon, 64 frames of tied scores, one row with
    no frame where B > 1 (no valid candidate)."""
    dec = scan_decoder(cuda, lm_kind, penalty=1.5)
    tabs = dec._prep_device()
    rng = np.random.default_rng(b + nbest)
    feats = torch.tensor((rng.normal(size=(b, 64, 13)) * 2)
                         .astype(np.float32), device=cuda)
    n = rng.integers(1, 65, size=b)
    n[0] = 64
    if b > 1:
        n[1] = 0
    scores = torch.round(dec._scores(feats) / 8) * 8
    carry, prev, word = dec._scan(tabs, dec._seed(tabs, b), scores, 0, n)
    seqs, sc = finalize_both(dec, carry, prev, word, dec._n_cand(nbest))
    assert (sc[0] > -1e30 / 2).any()
    if b > 1:
        assert (sc[1] <= -1e30 / 2).all() and (seqs[1] == -1).all()


def test_decoder_finalize_cuts_chains(cuda):
    """``max_words = 3`` under a word bonus: chains cut at three words."""
    dec = scan_decoder(cuda, "sparse", penalty=-20.0, max_words=3)
    tabs = dec._prep_device()
    rng = np.random.default_rng(3)
    feats = torch.tensor((rng.normal(size=(5, 48, 13)) * 2)
                         .astype(np.float32), device=cuda)
    carry, prev, word = dec._scan(tabs, dec._seed(tabs, 5),
                                  dec._scores(feats), 0, [48] * 5)
    seqs, _ = finalize_both(dec, carry, prev, word, 8)
    assert seqs.shape[2] == 3 and bool((seqs >= 0).all(dim=2).any())


def test_decoder_finalize_after_stream_chunks(cuda):
    """``stream_result`` after three 25-frame chunks: the kernel over the
    concatenated rows against the plain version, and against the one-shot
    decode's words."""
    dec = scan_decoder(cuda, "sparse", seed=8, penalty=1.5)
    tabs = dec._prep_device()
    rng = np.random.default_rng(8)
    feats = (rng.normal(size=(3, 75, 13)) * 2).astype(np.float32)
    n = np.array([75, 60, 33])
    st = dec.stream_init(batch=3, max_frames=75)
    for t0 in (0, 25, 50):
        dec.stream_feed(st, feats[:, t0:t0 + 25], np.clip(n - t0, 0, 25))
    for nbest in (1, 5):
        finalize_both(dec, st.carry, torch.cat(st.tb_prev, 1),
                      torch.cat(st.tb_word, 1), dec._n_cand(nbest))
    got = dec.stream_result(st, 3)
    want = dec.decode_batch(feats, n, 3)
    for g, w in zip(got, want):
        assert [h.words for h in g] == [h.words for h in w]


@pytest.mark.parametrize("min_nodes", [875, None, 40_000])
def test_decoder_finalize_large_lexicons(cuda, min_nodes):
    """The 875-node lexicon (the CD graph's size), the 21,589-node
    synthetic one (22,989 slots), exact and block-pruned (the compact carry
    is expanded in PyTorch, then one launch), and 40,000 nodes, at
    ``return_nbest`` 1 and 5."""
    from poccala_tpu_torch.lexicon.build import FULL_VOCAB_NODES, \
        synthetic_lexicon

    inv = UnitInventory.standard("XIF_tone")
    flat, _, _ = synthetic_lexicon(
        inv, min_nodes=min_nodes or FULL_VOCAB_NODES,
        n_chars=12 if min_nodes == 875 else None)
    rng = np.random.default_rng(9)
    feats = torch.tensor((rng.normal(size=(3, 40, 13)) * 2)
                         .astype(np.float32), device=cuda)
    n = np.array([40, 27, 40])
    kws = [{}] if min_nodes else [{}, dict(block_size=256, active_blocks=4)]
    for kw in kws:
        dec = scan_decoder(cuda, "sparse", flat=flat, seed=9, penalty=1.5,
                           **kw)
        tabs = dec._prep_device()
        assert dec._prune_on == bool(kw)
        carry, prev, word = dec._scan(tabs, dec._seed(tabs, 3),
                                      dec._scores(feats), 0, n)
        for nbest in (1, 5):
            finalize_both(dec, carry, prev, word, dec._n_cand(nbest))


# ----------------------------------------------------------------------
# the block-pruned search's frame scan (decoder_scan_pruned in
# csrc/decoder_scan.cu) against its plain loop, DeviceBeamDecoder.
# _scan_plain with _step_pruned, bit for bit

PRUNED_NAMES = ("kb", "d_act", "c_act", "entry", "entry_ctx")


def pruned_decoder(cuda, lm_kind="none", min_nodes=1500, seed=7, **kw):
    """:func:`scan_decoder` over a synthetic lexicon (``min_nodes`` nodes;
    None: the 21,589-node one) with block pruning (64-node blocks, 2 active
    unless ``kw`` says otherwise)."""
    from poccala_tpu_torch.lexicon.build import FULL_VOCAB_NODES, \
        synthetic_lexicon

    inv = UnitInventory.standard("XIF_tone")
    flat, _, _ = synthetic_lexicon(
        inv, min_nodes=min_nodes or FULL_VOCAB_NODES,
        n_chars=12 if min_nodes else None)
    dec = scan_decoder(cuda, lm_kind, flat=flat, seed=seed, penalty=1.5,
                       **{"block_size": 64, "active_blocks": 2, **kw})
    dec._prep_device()
    assert dec._prune_on
    return dec


def pruned_both(dec, scores, n_valid, t0=0, carry=None, rows_before=None):
    """The kernel's ``_scan`` (one pruned launch, no exact one) against the
    plain loop from the same carry: the carry's five fields and the rows
    equal bit for bit, and so the n-best each gives over ``rows_before``
    and the new rows; returns the kernel's."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    tabs = dec._prep_device()
    if carry is None:
        carry = dec._seed(tabs, scores.shape[0])
    before = (dk.decoder_scan_pruned_cuda.launches,
              dk.decoder_scan_cuda.launches)
    got = dec._scan(tabs, carry, scores, t0, n_valid)
    assert (dk.decoder_scan_pruned_cuda.launches,
            dk.decoder_scan_cuda.launches) == (before[0] + 1, before[1])
    want = dec._scan_plain(tabs, carry, scores, t0, n_valid)
    for name, g, w in zip(PRUNED_NAMES, got[0], want[0]):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])

    def nbest(out):
        carry, prev, word = out
        if rows_before is not None:
            prev = torch.cat([rows_before[0], prev], 1)
            word = torch.cat([rows_before[1], word], 1)
        return dec._finalize(tabs, carry, prev, word, 8)

    (g_seqs, g_sc), (w_seqs, w_sc) = nbest(got), nbest(want)
    assert torch.equal(g_seqs, w_seqs) and torch.equal(g_sc, w_sc)
    return got


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("lm_kind", ["none", "flat", "sparse"])
def test_decoder_scan_pruned_matches_plain_loop(cuda, lm_kind, tied):
    """~1,500 nodes in 24 blocks of 64, 2 active, B = 7, 48 frames (scores
    rounded to multiples of 8 where ``tied``), rows frozen from random
    frame counts, one at 0: everything in shared memory."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    dec = pruned_decoder(cuda, lm_kind)
    assert all(dk.tables_placement(dec._tabs, dec.bank.num_states, 2,
                                   64, dec._r_top(dec._tabs)).values())
    rng = np.random.default_rng(11)
    feats = torch.tensor((rng.normal(size=(7, 48, 13)) * 2)
                         .astype(np.float32), device=cuda)
    scores = dec._scores(feats)
    if tied:
        scores = torch.round(scores / 8) * 8
    n = rng.integers(1, 49, size=7)
    n[0], n[1] = 48, 0
    _, prev, word = pruned_both(dec, scores, n)
    assert (word[0] >= 0).any()
    for u, k in enumerate(n):
        assert (prev[u, k:] == -1).all() and (word[u, k:] == -1).all()


@pytest.mark.parametrize("lm_kind", ["none", "sparse"])
def test_decoder_scan_pruned_stream_chunks(cuda, lm_kind):
    """Three 16-frame chunks (t0 = 0, 16, 32; rows that end inside a chunk)
    through the kernel, each held to the plain loop from the same carry,
    equal the one-shot scan of the 48 frames; then ``stream_feed`` and
    ``stream_result`` launch one pruned scan a chunk and give the one-shot
    decode's words."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    dec = pruned_decoder(cuda, lm_kind, seed=8, active_blocks=3)
    rng = np.random.default_rng(8)
    feats = (rng.normal(size=(3, 48, 13)) * 2).astype(np.float32)
    scores = dec._scores(torch.tensor(feats, device=cuda))
    n = np.array([48, 37, 20])
    whole = pruned_both(dec, scores, n)
    carry, prev, word = None, [], []
    for t0 in (0, 16, 32):
        before = (torch.cat(prev, 1), torch.cat(word, 1)) if t0 else None
        carry, p, w = pruned_both(dec, scores[:, t0:t0 + 16].contiguous(),
                                  np.clip(n - t0, 0, 16), t0, carry, before)
        prev.append(p)
        word.append(w)
    for name, g, w in zip(PRUNED_NAMES, carry, whole[0]):
        assert torch.equal(g, w), name
    assert torch.equal(torch.cat(prev, 1), whole[1])
    assert torch.equal(torch.cat(word, 1), whole[2])
    launches = dk.decoder_scan_pruned_cuda.launches
    st = dec.stream_init(batch=3, max_frames=48)
    for t0 in (0, 16, 32):
        dec.stream_feed(st, feats[:, t0:t0 + 16], np.clip(n - t0, 0, 16))
    assert dk.decoder_scan_pruned_cuda.launches == launches + 3
    for g, w in zip(dec.stream_result(st, 3), dec.decode_batch(feats, n, 3)):
        assert [h.words for h in g] == [h.words for h in w]


@pytest.mark.parametrize("lm_kind", ["none", "sparse"])
def test_decode_batch_pruned_launches_once(cuda, lm_kind, monkeypatch):
    """A pruned ``decode_batch`` on the card: one pruned scan launch, no
    exact one, ``_step_pruned`` never."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    dec = pruned_decoder(cuda, lm_kind)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain pruned step ran on the card")

    monkeypatch.setattr(dec, "_step_pruned", refuse)
    feats = (np.random.default_rng(4).normal(size=(4, 40, 13)) * 2
             ).astype(np.float32)
    before = (dk.decoder_scan_pruned_cuda.launches,
              dk.decoder_scan_cuda.launches)
    hyps = dec.decode_batch(feats, [40, 33, 20, 12], 3)
    assert (dk.decoder_scan_pruned_cuda.launches,
            dk.decoder_scan_cuda.launches) == (before[0] + 1, before[1])
    # noise may end inside a word: some utterance decodes to words
    assert len(hyps) == 4 and any(len(h) >= 1 for h in hyps)


@pytest.mark.parametrize("block_size,k_act,lm_kind,out", [
    (256, 8, "sparse", set()), (256, 8, "none", set()),
    (256, 4, "sparse", set()), (256, 4, "none", set()),
    (1024, 4, "sparse", {"carry"})])
def test_decoder_scan_pruned_at_21k_nodes(cuda, block_size, k_act, lm_kind,
                                          out):
    """The 21,589-node synthetic lexicon with and without a sparse bigram
    LM: 8 or 4 of 85 blocks of 256 (every part in shared memory) and the
    config's default 4 blocks of 1,024 (the carry in device memory); one
    call, and three 16-frame chunks equal to it."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    dec = pruned_decoder(cuda, lm_kind, min_nodes=None, seed=9,
                         block_size=block_size, active_blocks=k_act)
    place = dk.tables_placement(dec._tabs, dec.bank.num_states, k_act,
                                block_size, dec._r_top(dec._tabs))
    assert {k for k, v in place.items() if not v} == out
    rng = np.random.default_rng(9)
    feats = torch.tensor((rng.normal(size=(3, 48, 13)) * 2)
                         .astype(np.float32), device=cuda)
    scores = dec._scores(feats)
    n = np.array([48, 27, 40])
    whole = pruned_both(dec, scores, n)
    carry, prev, word = None, [], []
    for t0 in (0, 16, 32):
        before = (torch.cat(prev, 1), torch.cat(word, 1)) if t0 else None
        carry, p, w = pruned_both(dec, scores[:, t0:t0 + 16].contiguous(),
                                  np.clip(n - t0, 0, 16), t0, carry, before)
        prev.append(p)
        word.append(w)
    for name, g, w in zip(PRUNED_NAMES, carry, whole[0]):
        assert torch.equal(g, w), name
    assert torch.equal(torch.cat(word, 1), whole[2])


@pytest.mark.parametrize("hyst", [4.0, 8.0])
@pytest.mark.parametrize("lm_kind", ["none", "sparse"])
def test_decoder_scan_pruned_with_hysteresis(cuda, lm_kind, hyst):
    """The sticky selection (``prune_hysteresis``) at 4 of 24 blocks: the
    kernel against the plain loop bit for bit on tied and untied scores,
    in one call and in three chunks equal to it; the decode's words and
    scores those of a CPU decoder."""
    dec = pruned_decoder(cuda, lm_kind, seed=12, active_blocks=4,
                         prune_hysteresis=hyst)
    assert dec.prune_hysteresis == hyst
    rng = np.random.default_rng(12)
    feats = (rng.normal(size=(5, 48, 13)) * 2).astype(np.float32)
    n = np.array([48, 48, 35, 20, 0])
    scores = dec._scores(torch.tensor(feats, device=cuda))
    for sc in (scores, torch.round(scores / 8) * 8):
        whole = pruned_both(dec, sc, n)
        carry, prev, word = None, [], []
        for t0 in (0, 16, 32):
            before = (torch.cat(prev, 1), torch.cat(word, 1)) if t0 else None
            carry, p, w = pruned_both(dec, sc[:, t0:t0 + 16].contiguous(),
                                      np.clip(n - t0, 0, 16), t0, carry,
                                      before)
            prev.append(p)
            word.append(w)
        for name, g, w in zip(PRUNED_NAMES, carry, whole[0]):
            assert torch.equal(g, w), name
        assert torch.equal(torch.cat(word, 1), whole[2])
    cpu = DeviceBeamDecoder(sb.bank_from_numpy(sb.bank_to_numpy(dec.bank),
                                               device="cpu"), dec.lexicon,
                            lm=dec.lm, lm_weight=dec.lm_weight,
                            word_penalty=dec.word_penalty, block_size=64,
                            active_blocks=4, prune_hysteresis=hyst)
    for g, w in zip(dec.decode_batch(feats[:4], n[:4], 3),
                    cpu.decode_batch(feats[:4], n[:4], 3)):
        assert np.allclose([h.score for h in g], [h.score for h in w],
                           rtol=1e-4, atol=0.0)
        if len(w) > 1 and w[0].score - w[1].score > 0.01:
            assert g[0].words == w[0].words


@pytest.mark.parametrize("skips", [False, True])
def test_decoder_scan_pruned_at_state_num_10(cuda, skips):
    """18 token states a node (band width 2, or 10 with skips) over the
    built-in lexicon in 16 blocks of 8, 3 active."""
    dec = scan_decoder(cuda, "sparse", state_num=10, penalty=1.5,
                       bank_fn=with_skips if skips else None,
                       block_size=8, active_blocks=3)
    tabs = dec._prep_device()
    assert dec._prune_on and tuple(tabs.bands.shape[1:]) == (
        18, 10 if skips else 2)
    rng = np.random.default_rng(10)
    feats = torch.tensor((rng.normal(size=(5, 48, 13)) * 2)
                         .astype(np.float32), device=cuda)
    pruned_both(dec, torch.round(dec._scores(feats) / 8) * 8,
                np.array([48, 48, 40, 31, 9]))
