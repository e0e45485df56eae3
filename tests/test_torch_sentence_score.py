"""The sentence kernel (``csrc/gmm_score.cu`` ``sentence_score_f32_kernel``):
each utterance's frames against its own sentence states, the training
E-step's and the alignment's scoring on the card.

On the CPU: ``sentence_scores`` takes the plain version and launches
nothing; the wrapper refuses CPU tensors, other dtypes and mismatched
shapes; the sentence pack reproduces the plain components under the
kernel's arithmetic; and the kernel's source, compiled with g++ against
``tests/cuda_emu/cuda_runtime.h`` (one thread per CUDA thread, the blocks
in turn), is held to the plain version at both tiles (the small one, and
the large one with several state groups a block when the emulated card
has one SM), at D = 39 (K a template constant) and other widths, M a
multiple of 8, of 4 and neither (padded mixtures), ragged T and N, bank
rows out of range (clamped), and without the components.  On the card:
``tests/test_torch_gpu.py``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.models.topology import build_embedded_batch
from poccala_tpu_torch.config import ModelConfig
from poccala_tpu_torch.ops import gmm_score as tg
from poccala_tpu_torch.ops.cuda import gmm_score_cuda as gk
from poccala_tpu_torch.train import accumulators as acc
from poccala_tpu_torch.train import alignment as align

torch.set_num_threads(1)

# float32 sums of 2D products in another order than the plain version's
# two matmuls, and std::exp / std::log for the fold: the float32 scoring
# tolerance of tests/test_torch_gpu.py (F32)
F32 = dict(rtol=1e-4, atol=1e-4)

REPO = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"


def bank_and_frames(rng, s, m, d, b, t, dead=0):
    """MFCC-scale bank and frames (tests/test_torch_gpu.py's
    ``scoring_inputs``): ``[B, T, D]`` frames, ``[S, M, D]`` means and log
    variances, ``[S, M]`` log weights, the last ``dead`` slots at -1e30."""
    offset = np.zeros(d, np.float32)
    offset[0] = 60.0
    centers = rng.normal(size=(s, 1, d)) * 3
    means = offset + centers + rng.normal(size=(s, m, d))
    log_var = rng.uniform(0.5, 2.5, size=(s, m, d))
    x = offset + centers[rng.integers(0, s, size=(b, t)), 0] \
        + rng.normal(size=(b, t, d)) * 2
    w = rng.uniform(0.1, 1, size=(s, m))
    log_w = np.log(w / w.sum(1, keepdims=True))
    if dead:
        log_w[:, -dead:] = -1e30
    return [torch.tensor(a, dtype=torch.float32)
            for a in (x, means, log_var, log_w)]


def plain(x, sen, means, log_var, log_w, normalizer="textbook"):
    """The plain version of ``sentence_scores``: ``(scores, comp)``."""
    sen = sen.clamp(0, means.shape[0] - 1)
    comp = tg.gmm_component_logpdf(x, means[sen], log_var[sen],
                                   normalizer=normalizer)
    comp = comp + log_w[sen][:, None]
    return torch.logsumexp(comp, dim=-1), comp


# ----------------------------------------------------------------------
# the dispatch and the wrapper


def small_training_batch(rng):
    cfg = ModelConfig(state_num=5, mix_level=4, max_mix_level=4)
    bank = sb.create_bank(20, cfg, 13,
                          generator=torch.Generator().manual_seed(3),
                          device="cpu")
    b, t_pad, max_l = 4, 30, 5
    labels = rng.integers(0, 20, size=(b, max_l)).astype(np.int32)
    lens = rng.integers(1, max_l + 1, size=b).astype(np.int32)
    xs = (rng.normal(size=(b, t_pad, 13)) * 1.5).astype(np.float32)
    masks = np.arange(t_pad)[None] < rng.integers(10, t_pad + 1,
                                                  size=b)[:, None]
    return bank, labels, lens, xs, masks, max_l


def test_cpu_sentence_scores_take_the_plain_path():
    """CPU tensors score through the plain version, with or without the
    components asked for, and the kernel's counter stays where it was
    through an E-step and an alignment."""
    rng = np.random.default_rng(5)
    bank, labels, lens, xs, masks, max_l = small_training_batch(rng)
    before = gk.sentence_scores_cuda.launches
    ehmm = build_embedded_batch(bank, torch.as_tensor(labels),
                                torch.as_tensor(lens), 5, max_l)
    x = torch.as_tensor(xs)
    sen, _ = acc.local_senones(bank, ehmm)
    want_scores, want_comp = plain(x, sen, bank.means, bank.log_var,
                                   bank.log_w)
    for components in (True, False):
        comp, scores, log_b = acc.sentence_scores(bank, ehmm, x,
                                                  components=components)
        assert torch.equal(scores, want_scores)
        assert torch.equal(comp, want_comp)
        assert log_b.shape == scores.shape
    acc.batch_stats(bank, labels, lens, xs, masks, 5, max_l)
    align.align_batch(bank, labels, lens, xs, masks, 5, max_l)
    assert gk.sentence_scores_cuda.launches == before


def wrapper_operands(rng):
    x, means, log_var, log_w = bank_and_frames(rng, 7, 3, 5, 2, 6)
    sen = torch.tensor([[0, 3, 6], [1, 1, 2]])
    return x, sen, means, log_var, log_w


@pytest.mark.parametrize("fault", ["cpu", "bf16_frames", "int32_rows",
                                   "frames_width", "rows_batch",
                                   "log_w_shape", "rows_rank"])
def test_wrapper_refuses(fault):
    """CPU tensors, frames other than float32, rows other than int64 and
    mismatched shapes raise before any launch."""
    x, sen, means, log_var, log_w = wrapper_operands(
        np.random.default_rng(6))
    change = {"cpu": {},
              "bf16_frames": dict(x=x.to(torch.bfloat16)),
              "int32_rows": dict(sen=sen.to(torch.int32)),
              "frames_width": dict(x=x[..., :4]),
              "rows_batch": dict(sen=sen[:1]),
              "log_w_shape": dict(log_w=log_w[:, :2]),
              "rows_rank": dict(sen=sen[0])}[fault]
    args = dict(xs=x, sen=sen, means=means, log_var=log_var, log_w=log_w)
    args.update({("xs" if k == "x" else k): v for k, v in change.items()})
    before = gk.sentence_scores_cuda.launches
    with pytest.raises(ValueError):
        gk.sentence_scores_cuda(**args)
    assert gk.sentence_scores_cuda.launches == before


def sentence_arithmetic(x, sen, packed, m):
    """The kernel's arithmetic on the sentence pack ``[S, Mg, 2D + 1, 8]``
    in plain torch: ``[x², x] · W + bias`` a state and mixture, then the
    logsumexp over the ``m`` real mixtures."""
    s, mg, k1, _ = packed.shape
    w = packed.transpose(2, 3).reshape(s, mg * 8, k1)[:, :m]   # [S, M, K+1]
    ws = w[sen]                                                # [B, N, M, K+1]
    rows = torch.cat([x * x, x], dim=-1)                       # [B, T, K]
    comp = (torch.einsum("btk,bnmk->btnm", rows, ws[..., :-1])
            + ws[..., -1][:, None])
    return torch.logsumexp(comp, dim=-1), comp


@pytest.mark.parametrize("m,dead", [(16, 0), (5, 0), (12, 2)])
@pytest.mark.parametrize("normalizer", ["textbook", "reference"])
def test_sentence_pack_reproduces_the_plain_components(m, dead, normalizer):
    """The pack's rows, groups of 8 mixtures and padded slots, evaluated
    as the kernel does, give the plain components and scores."""
    rng = np.random.default_rng(m + dead)
    x, means, log_var, log_w = bank_and_frames(rng, 9, m, 6, 3, 11, dead)
    sen = torch.as_tensor(rng.integers(0, 9, size=(3, 7)))
    packed = gk.pack_sentence_f32(means, log_var, log_w, normalizer)
    assert packed.shape == (9, -(-m // 8), 13, 8)
    assert bool((packed[:, -1, -1, m % 8 or 8:] == -1e30).all())
    got_scores, got_comp = sentence_arithmetic(x, sen, packed, m)
    want_scores, want_comp = plain(x, sen, means, log_var, log_w,
                                   normalizer)
    assert torch.allclose(got_comp, want_comp, **F32)
    assert torch.allclose(got_scores, want_scores, **F32)


# ----------------------------------------------------------------------
# the kernel's source on the CPU

EMU_PRELUDE = """#include "cuda_runtime.h"
inline float __expf(float x) { return std::exp(x); }
inline float __logf(float x) { return std::log(x); }
inline void __stcs(float* p, float v) { *p = v; }
inline void __stcs(float4* p, float4 v) { *p = v; }
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  std::memcpy(smem, gmem, 16);
}
__device__ __forceinline__ void cp_async_commit() {}
template <int N>
__device__ __forceinline__ void cp_async_wait() {}
"""


def emulated_sentence_source() -> str:
    """The sentence kernel's section of ``csrc/gmm_score.cu`` for g++, with
    what it uses of the file's first part (the constants, ``lse_fold``,
    ``sm_count``): ``cp.async`` a plain copy, the streaming stores plain
    stores, the dynamic shared memory the emulation's per-block buffer, the
    ``<<<...>>>`` launch a call of ``emu_launch``."""
    src = (REPO / gk.SOURCE).read_text()
    consts = re.findall(r"constexpr int (?:SMEM_MAX|STAGE|K_UNROLL) = [^;]*;",
                        src)
    assert len(consts) == 3
    fold = src[src.index("// One mixture folded"):
               src.index("// A finished TT x TS tile")]
    a = src.index("int sm_count() {")
    sm = src[a:src.index("\n}\n", a) + 3]
    section = src[src.index("// sentence scoring: each utterance"):
                  src.index("// sentence statistics: the E-step")]
    section = section.replace(
        "extern __shared__ __align__(16) float sq_smem[];",
        "float* sq_smem = reinterpret_cast<float*>(emu_dyn_smem);")
    section, n = re.subn(r"(\b\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\(",
                         r"emu_launch(\1, \2, ", section)
    assert n == 1
    return (EMU_PRELUDE + "namespace {\n" + "\n".join(consts) + "\n" + fold
            + sm + "}  // namespace\n" + section)


@pytest.fixture(scope="module")
def emulated_sentence(tmp_path_factory):
    """The sentence kernel's library on the CPU as an H100 of 132 SMs sees
    it (the small tile and one state group a block at these sizes) and as
    a card of one SM (the large tile, several groups a block)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    tmp = tmp_path_factory.mktemp("sentence_emu")
    cpp = tmp / "sentence.cpp"
    cpp.write_text(emulated_sentence_source())
    procs = {}
    for name, sms in (("h100", 132), ("one_sm", 1)):
        so = tmp / f"lib{name}.so"
        procs[name] = so, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             f"-DEMU_SMS={sms}", f"-I{EMU}", "-o", str(so), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err.decode()[-3000:]
        libs[name] = gk.bind_sentence(ctypes.CDLL(str(so)))
    return libs


def emulated_call(lib, x, sen, means, log_var, log_w, components=True):
    """The C entry on CPU tensors: ``(scores, comp or None)``."""
    b, t, d = x.shape
    n = sen.shape[1]
    s, m, _ = means.shape
    packed = gk.pack_sentence_f32(means, log_var, log_w, "textbook")
    scores = torch.full((b, t, n), float("nan"))
    comp = torch.full((b, t, n, m), float("nan")) if components else None
    rc = lib.sentence_score_f32(
        x.data_ptr(), sen.data_ptr(), packed.data_ptr(), scores.data_ptr(),
        None if comp is None else comp.data_ptr(), b, t, n, s, m, d, None)
    assert rc == 0
    return scores, comp


SHAPES = [dict(b=2, t=45, n=13, m=16, d=5), dict(b=1, t=7, n=9, m=5, d=39),
          dict(b=3, t=140, n=20, m=12, d=6, dead=2),
          dict(b=2, t=33, n=8, m=8, d=39), dict(b=1, t=130, n=3, m=1, d=2),
          dict(b=4, t=20, n=9, m=16, d=39)]


@pytest.mark.parametrize("card", ["h100", "one_sm"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "b{b}t{t}n{n}m{m}d{d}".format(**s))
def test_kernel_source_on_cpu_matches_plain(emulated_sentence, card, shape):
    """Scores and components against the plain version at ragged T and N,
    M off the group of 8 (padded slots), dead slots, D = 39 and others;
    rows out of the bank's range score as the clamped rows."""
    shape = dict(shape)
    b, t, n = shape.pop("b"), shape.pop("t"), shape.pop("n")
    rng = np.random.default_rng(b * t + n)
    s = 11
    x, means, log_var, log_w = bank_and_frames(
        rng, s, shape["m"], shape["d"], b, t, shape.get("dead", 0))
    sen = torch.as_tensor(rng.integers(0, s, size=(b, n)))
    sen[0, 0], sen[-1, -1] = -1, s + 3
    scores, comp = emulated_call(emulated_sentence[card], x, sen, means,
                                 log_var, log_w)
    want_scores, want_comp = plain(x, sen, means, log_var, log_w)
    assert torch.isfinite(scores).all()
    assert torch.allclose(comp, want_comp, **F32)
    assert torch.allclose(scores, want_scores, **F32)
    alone, none = emulated_call(emulated_sentence[card], x, sen, means,
                                log_var, log_w, components=False)
    assert none is None and torch.equal(alone, scores)


def test_kernel_source_on_cpu_takes_an_e_step(emulated_sentence):
    """A training batch's sentence rows (entry and exit states clamped to
    row 0, padded states) through the emulated kernel give the plain
    ``sentence_scores``' components and state scores."""
    rng = np.random.default_rng(9)
    bank, labels, lens, xs, _, max_l = small_training_batch(rng)
    ehmm = build_embedded_batch(bank, torch.as_tensor(labels),
                                torch.as_tensor(lens), 5, max_l)
    x = torch.as_tensor(xs)
    want_comp, want_scores, _ = acc.sentence_scores(bank, ehmm, x)
    sen, _ = acc.local_senones(bank, ehmm)
    scores, comp = emulated_call(emulated_sentence["h100"], x,
                                 sen.contiguous(), bank.means, bank.log_var,
                                 bank.log_w)
    assert torch.allclose(comp, want_comp, **F32)
    assert torch.allclose(scores, want_scores, **F32)
