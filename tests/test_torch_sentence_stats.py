"""The statistics kernel (``csrc/gmm_score.cu`` ``sentence_stats_f32_kernel``):
the training E-step's GMM moments over the lattice's live posteriors.

On the CPU: ``batch_stats`` takes the plain lines (``_mixture_moments``)
and launches nothing; the wrapper refuses CPU tensors, other dtypes and
mismatched shapes; and the kernel's source, compiled with g++ against
``tests/cuda_emu/cuda_runtime.h`` (one thread per CUDA thread, the blocks
in turn), is held to the plain lines at ragged T and N, M of 16, padded
and past one block's 16, D = 39, other widths and past one block's 64,
B = 1, over several chunks of posteriors, with posteriors banded as a
sentence HMM's are and from a real forward-backward; tiles with no live
posterior, a state whose frames cross a tile's edge, a tile live in one
frame, non-emitting rows (zeros), and posteriors that are all subnormal,
which are terms: a build that skips posteriors below 1e-30 must fail
there.  Its tally of live tiles is held to a count over the posteriors.
On the card: ``tests/test_torch_gpu.py``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from poccala_tpu_torch.models.topology import build_embedded_batch
from poccala_tpu_torch.ops.cuda import gmm_score_cuda as gk
from poccala_tpu_torch.train import accumulators as acc
from tests.test_torch_sentence_score import small_training_batch

torch.set_num_threads(1)

# float32 sums of the same terms in another order than the plain lines'
# matmuls and reduction, and std::exp: the float32 tolerance of the
# sentence kernel's tests (tests/test_torch_sentence_score.py F32)
F32 = dict(rtol=1e-4, atol=1e-4)
# all-subnormal posteriors, against float64 sums of the same float32
# inputs: each subnormal weight w rounds to a multiple of 2^-149, an error
# that w·x and w·x² carry scaled by |x| and x²; 64 such errors a sum
SUBNORMAL_RTOL = 1e-3
SUBNORMAL_ULPS = 64 * 2.0 ** -149

REPO = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
STATS_MARK = "// sentence statistics: the E-step"
DEAD_TEST = "gl != 0.0f"
# the mutant: posteriors under 1e-30 (every subnormal) skipped as dead
THRESHOLD_MUTANT = "gl > 1e-30f"


def emulated_stats_source(mutant: bool = False) -> str:
    """The statistics section of ``csrc/gmm_score.cu`` for g++: the
    ``<<<...>>>`` launch a call of ``emu_launch``; with ``mutant``, the
    dead test replaced by a 1e-30 threshold."""
    src = (REPO / gk.SOURCE).read_text()
    section = src[src.index(STATS_MARK):]
    if mutant:
        assert section.count(DEAD_TEST) == 1
        section = section.replace(DEAD_TEST, THRESHOLD_MUTANT)
    section, n = re.subn(r"(\b\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\(",
                         r"emu_launch(\1, \2, ", section)
    assert n == 1
    return '#include "cuda_runtime.h"\n' + section


@pytest.fixture(scope="module")
def emulated_stats(tmp_path_factory):
    """The statistics kernel's library on the CPU, and its threshold
    mutant's."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    tmp = tmp_path_factory.mktemp("stats_emu")
    procs = {}
    for name, mutant in (("kernel", False), ("mutant", True)):
        cpp = tmp / f"{name}.cpp"
        cpp.write_text(emulated_stats_source(mutant))
        so = tmp / f"lib{name}.so"
        procs[name] = so, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             f"-I{EMU}", "-o", str(so), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err.decode()[-3000:]
        libs[name] = gk.bind_stats(ctypes.CDLL(str(so)))
    return libs


def emulated_call(lib, comp, scores, gamma, emitting, xs):
    """The C entry on CPU tensors: ``(c_r, cx_r, cxx_r, tiles)``, the
    outputs filled with NaN first so that a sum left unwritten shows."""
    b, t, n, m = comp.shape
    d = xs.shape[2]
    c = torch.full((b, n, m), float("nan"))
    cx = torch.full((b, n, m, d), float("nan"))
    cxx = torch.full((b, n, m, d), float("nan"))
    tiles = torch.full((b * -(-n // 8), 2), -1, dtype=torch.int32)
    rc = lib.sentence_stats_f32(
        comp.data_ptr(), scores.data_ptr(), gamma.data_ptr(),
        emitting.data_ptr(), xs.data_ptr(), c.data_ptr(), cx.data_ptr(),
        cxx.data_ptr(), tiles.data_ptr(), b, t, n, m, d, None)
    assert rc == 0
    return c, cx, cxx, tiles


def banded_gamma(rng, b, t, n, widths=(1, 12)):
    """State posteriors as a left-to-right sentence HMM gives them: each
    state alive over a short run of frames around its place in the
    utterance, exactly 0 elsewhere."""
    g = np.zeros((b, t, n), np.float32)
    for i in range(b):
        centers = np.sort(rng.uniform(0, t, size=n))
        for r in range(n):
            w = int(rng.integers(widths[0], widths[1] + 1))
            lo = int(np.clip(centers[r] - w // 2, 0, t - 1))
            hi = min(t, lo + w)
            g[i, lo:hi, r] = rng.uniform(0.05, 1.0, size=hi - lo)
    return torch.as_tensor(g)


def lattice(rng, b, t, n, m, d):
    """Weighted component log-probs ``[B, T, N, M]`` at the scale of the
    training cell's, their logsumexp, MFCC-scale frames (c0 near 60) and
    the emitting mask (entry state and the last state not emitting)."""
    comp = torch.as_tensor(rng.normal(-60.0, 12.0, size=(b, t, n, m)),
                           dtype=torch.float32)
    scores = torch.logsumexp(comp, dim=-1)
    xs = torch.as_tensor(rng.normal(0.0, 2.0, size=(b, t, d)),
                         dtype=torch.float32)
    xs[..., 0] += 60.0
    emitting = torch.ones((b, n), dtype=torch.bool)
    emitting[:, 0] = False
    emitting[:, -1] = False
    return comp, scores, xs, emitting


def held_to_plain(lib, comp, scores, gamma, emitting, xs, tol=F32):
    """The emulated kernel against ``_mixture_moments``, every sum written;
    its tally against ``stats_tiles_plain``.  Returns the kernel's sums."""
    got = emulated_call(lib, comp, scores, gamma, emitting, xs)
    want = acc._mixture_moments(comp, scores, gamma, emitting, xs)
    for name, g, w in zip(("c_r", "cx_r", "cxx_r"), got, want):
        assert torch.isfinite(g).all(), name
        assert torch.allclose(g, w, **tol), (
            name, float((g - w).abs().max()))
    assert torch.equal(got[3], gk.stats_tiles_plain(gamma, emitting))
    return got[:3]


CASES = [
    # ragged T and N, the training cell's M and D
    dict(b=2, t=45, n=13, m=16, d=39),
    # B = 1, a padded M, another D, two chunks of posteriors
    dict(b=1, t=300, n=9, m=5, d=6),
    # two mixture passes (M past one block's 16)
    dict(b=2, t=70, n=8, m=20, d=39),
    # two dims passes (D past one block's 64), three mixtures
    dict(b=1, t=40, n=11, m=3, d=70),
    # a batch-padding utterance: no live posterior at all
    dict(b=3, t=33, n=17, m=16, d=13, empty=1),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    "b{b}t{t}n{n}m{m}d{d}".format(**c) + ("empty" if c.get("empty") else "")))
def test_kernel_source_on_cpu_matches_plain(emulated_stats, case):
    """Banded posteriors (most tiles dead, states crossing tiles) against
    the plain lines, and the tally of live tiles."""
    b, t, n, m, d = (case[k] for k in "btnmd")
    rng = np.random.default_rng(b * t + n + m + d)
    comp, scores, xs, emitting = lattice(rng, b, t, n, m, d)
    gamma = banded_gamma(rng, b, t, n)
    if case.get("empty"):
        gamma[case["empty"]] = 0.0
    held_to_plain(emulated_stats["kernel"], comp, scores, gamma, emitting, xs)


def test_kernel_source_on_cpu_at_tile_edges(emulated_stats):
    """A state whose live frames cross a tile's edge (30..34) and a chunk's
    (250..260), a tile live in one frame only, a tile with no live
    posterior between live ones, and non-emitting rows with posteriors,
    which give zeros."""
    rng = np.random.default_rng(17)
    b, t, n, m, d = 2, 290, 10, 16, 39
    comp, scores, xs, emitting = lattice(rng, b, t, n, m, d)
    gamma = torch.zeros((b, t, n))
    gamma[0, 30:35, 1] = torch.tensor([0.2, 0.9, 1.0, 0.7, 0.1])
    gamma[0, 250:261, 2] = 0.5
    gamma[0, 100, 3] = 0.25           # tile 3 (frames 96..127): one frame
    gamma[0, 200:203, 4] = 1.0        # tiles 4 and 5 dead between
    gamma[1, :, 0] = 1.0              # entry state: not emitting
    gamma[1, 40:50, 5] = 0.75
    emitting[1, 5] = False            # a non-emitting row with posteriors
    gamma[1, 5:9, 8] = 0.5            # the group's second, ragged, state
    c, cx, cxx = held_to_plain(emulated_stats["kernel"], comp, scores, gamma,
                               emitting, xs)
    for r in ((1, 0), (1, 5), (0, 0), (0, 9)):
        assert not c[r].any() and not cx[r].any() and not cxx[r].any(), r
    assert bool((c[0, 3] > 0).any()) and bool((c[0, 1] > 0).any())


def subnormal_case():
    rng = np.random.default_rng(23)
    b, t, n, m, d = 1, 64, 8, 16, 39
    comp, scores, xs, emitting = lattice(rng, b, t, n, m, d)
    # |x| >= 1, so no product of a live term is lost below 2^-149
    xs = torch.sign(xs) * (1.0 + xs.abs())
    gamma = banded_gamma(rng, b, t, n) * 1e-39
    assert bool((gamma[gamma != 0] < torch.finfo(torch.float32).tiny).all())
    want = acc._mixture_moments(*(a.double() if a.is_floating_point() else a
                                  for a in (comp, scores, gamma, emitting,
                                            xs)))
    return (comp, scores, gamma, emitting, xs), want


def subnormal_sums_match(lib) -> bool:
    """The kernel's sums of :func:`subnormal_case` against the float64
    ones: ``c``, ``cx`` and ``cxx`` within 64 subnormal spacings times 1,
    max |x| and max x², and 1e-3 relative."""
    args, want = subnormal_case()
    got = emulated_call(lib, *args)
    x_max = float(args[4].abs().max())
    return all(torch.allclose(g.double(), w, rtol=SUBNORMAL_RTOL,
                              atol=SUBNORMAL_ULPS * x_max ** k)
               for k, (g, w) in enumerate(zip(got[:3], want)))


def test_kernel_source_on_cpu_counts_subnormal_posteriors(emulated_stats):
    """Posteriors that are all subnormal are terms: the sums follow the
    float64 sums of the same inputs (up to float32's subnormal spacing),
    and the tiles they live in are tallied live."""
    args, want = subnormal_case()
    x_max = float(args[4].abs().max())
    for k, w in enumerate(want):      # far above the tolerance
        assert float(w.abs().max()) > 1e3 * SUBNORMAL_ULPS * x_max ** k
    assert subnormal_sums_match(emulated_stats["kernel"])
    tiles = emulated_call(emulated_stats["kernel"], *args)[3]
    assert torch.equal(tiles, gk.stats_tiles_plain(args[2], args[3]))
    assert int(tiles[:, 0].sum()) > 0


def test_threshold_mutant_is_rejected(emulated_stats):
    """A build that skips posteriors under 1e-30 as dead passes a case of
    normal posteriors and fails the subnormal case."""
    rng = np.random.default_rng(41)
    comp, scores, xs, emitting = lattice(rng, 1, 64, 8, 16, 39)
    held_to_plain(emulated_stats["mutant"], comp, scores,
                  banded_gamma(rng, 1, 64, 8), emitting, xs)
    assert not subnormal_sums_match(emulated_stats["mutant"])


def test_kernel_source_on_cpu_takes_real_posteriors(emulated_stats):
    """A training batch's posteriors from the plain forward-backward, with
    its sentence states' entry, exit and padded rows, against the plain
    lines."""
    rng = np.random.default_rng(29)
    bank, labels, lens, xs, masks, max_l = small_training_batch(rng)
    labels, lens = torch.as_tensor(labels), torch.as_tensor(lens)
    xs, masks = torch.as_tensor(xs), torch.as_tensor(masks)
    ehmm = build_embedded_batch(bank, labels, lens, 5, max_l)
    comp, scores, log_b = acc.sentence_scores(bank, ehmm, xs)
    log_alpha, log_beta, loglik = acc._forward_backward(ehmm, log_b, masks,
                                                        5, 1, 0.64)
    gamma = acc._posterior(log_alpha + log_beta - loglik[:, None, None],
                           masks[:, :, None] & ehmm.state_mask[:, None, :])
    assert 0 < int((gamma != 0).sum()) < gamma.numel() // 2
    held_to_plain(emulated_stats["kernel"], comp, scores, gamma,
                  ehmm.senone_idx >= 0, xs)


# ----------------------------------------------------------------------
# the dispatch and the wrapper


def test_cpu_statistics_take_the_plain_lines():
    """CPU tensors sum the moments in the plain lines: ``batch_stats``
    launches nothing and adds nothing to the tally."""
    rng = np.random.default_rng(31)
    bank, labels, lens, xs, masks, max_l = small_training_batch(rng)
    before = gk.sentence_stats_cuda.launches
    tally = gk.stats_tile_tally()
    stats, _ = acc.batch_stats(bank, labels, lens, xs, masks, 5, max_l)
    assert float(stats.c.sum()) > 0
    assert gk.sentence_stats_cuda.launches == before
    assert gk.stats_tile_tally() == tally


def wrapper_operands():
    rng = np.random.default_rng(37)
    comp, scores, xs, emitting = lattice(rng, 2, 6, 9, 3, 5)
    return dict(comp=comp, scores=scores,
                gamma=banded_gamma(rng, 2, 6, 9), emitting=emitting, xs=xs)


@pytest.mark.parametrize("fault", ["cpu", "f64_comp", "bf16_gamma",
                                   "uint8_emitting", "f64_frames",
                                   "scores_frames", "emitting_states",
                                   "frames_batch", "comp_rank"])
def test_wrapper_refuses(fault):
    """CPU tensors, operands other than float32 (a bool mask), and
    mismatched shapes raise before any launch."""
    args = wrapper_operands()
    change = {"cpu": {},
              "f64_comp": dict(comp=args["comp"].double()),
              "bf16_gamma": dict(gamma=args["gamma"].to(torch.bfloat16)),
              "uint8_emitting": dict(emitting=args["emitting"].to(
                  torch.uint8)),
              "f64_frames": dict(xs=args["xs"].double()),
              "scores_frames": dict(scores=args["scores"][:, :5]),
              "emitting_states": dict(emitting=args["emitting"][:, :8]),
              "frames_batch": dict(xs=args["xs"][:1]),
              "comp_rank": dict(comp=args["comp"][0])}[fault]
    args.update(change)
    before = gk.sentence_stats_cuda.launches
    with pytest.raises(ValueError):
        gk.sentence_stats_cuda(**args)
    assert gk.sentence_stats_cuda.launches == before
