"""Fused diagonal-GMM scoring: the CUDA kernels' wrapper and the dispatcher
(port of ``poccala_tpu/ops/pallas/gmm_score_tpu.py``).

Math, with precision ``p = 1/σ²``:

    logp[t, s, m] = -0.5·Σx²p + Σx·(μp) + (-0.5·Σμ²p + const + log w)

i.e. rows ``[x², x]`` against columns ``[-0.5p ; μp]`` plus a per-(s, m)
bias, folded over m by an online logsumexp inside the kernel
(``csrc/gmm_score.cu``).  The kernels form ``[x², x]`` themselves from the
frames; this module packs the bank, in plain torch, into the layouts they
copy to shared memory unchanged:

* float32 (:func:`pack_f32`): ``[M, 2D + 1, S_pad]``, row ``2D`` the bias,
  ``S`` padded with zeros to a multiple of :data:`S_TILE`.  It depends on
  the bank and the normalizer alone, so it is cached per bank
  (:func:`_cached`): a stream chunk costs one launch and no packing.
* bfloat16: the operands are centred on the mean of the frames given
  (``ops/gmm_score.py``), so ``(μ - c)p`` and the bias change with every
  call.  :func:`pack_bf16_static` caches what does not — ``p``, the packed
  ``-0.5p`` half of the weights and ``const + log w``; the rest is built
  per call, on the card by a small kernel of ``csrc/gmm_score.cu`` ahead
  of the scoring kernel, and by :func:`pack_bf16` in plain torch for the
  tests that hold that kernel to it.  Each half of the weights is
  ``[M, Dp/8, S_pad, 8]`` bfloat16 (``Dp`` = D rounded up to 8; k = d the
  ``x²`` rows, k = Dp + d the ``x`` rows): 8-row by 16-byte core matrices
  of the tensor cores' shared-memory operand.
* sentence scoring (:func:`pack_sentence_f32`): senone-major,
  ``[S, ceil(M/8), 2D + 1, 8]``, the same rows for each group of 8
  mixtures, so that the kernel gathers a sentence state's weights as one
  contiguous run; cached like the float32 pack.

:func:`gmm_log_scores_fast` is the dispatcher the decoder calls: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the plain
version :func:`poccala_tpu_torch.ops.gmm_score.gmm_log_scores`.

:func:`sentence_scores_cuda` scores each utterance of a batch against its
own sentence states (rows of the bank) in one launch, the state scores
and, if asked, the weighted components; the trainer's
:func:`~poccala_tpu_torch.train.accumulators.sentence_scores` calls it for
float32 CUDA tensors.  :func:`sentence_stats_cuda` sums the E-step's GMM
moments from those components and the state posteriors in one launch,
skipping the posteriors that are exactly zero.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from collections import OrderedDict

import torch
import torch.nn.functional as F

from poccala_tpu_torch.ops.cuda import build
from poccala_tpu_torch.ops.gmm_score import gmm_log_scores, normalizer_const
from poccala_tpu_torch.utils.logmath import NEG_INF

SOURCE = "poccala_tpu_torch/csrc/gmm_score.cu"
REPLACES = "poccala_tpu/ops/pallas/gmm_score_tpu.py:105"
S_TILE = 64          # senones per block in both kernels
SENTENCE_MIX = 8     # mixtures a group in the sentence kernel's pack
_CACHE_SIZE = 8      # packed banks kept


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_f32(means, log_var, log_w, normalizer: str) -> torch.Tensor:
    """The float32 kernel's bank operand ``[M, 2D + 1, S_pad]``: per
    mixture the rows ``-0.5p`` (D), ``μp`` (D) and the bias."""
    s = means.shape[0]
    prec = torch.exp(-log_var)
    bias = (-0.5 * torch.sum(means * means * prec, dim=-1)
            + normalizer_const(log_var, normalizer)
            + torch.clamp(log_w, min=NEG_INF))             # [S, M]
    rows = torch.cat([-0.5 * prec, means * prec, bias[..., None]], dim=2)
    return F.pad(rows.permute(1, 2, 0),
                 (0, _pad_to(s, S_TILE) - s)).contiguous()


def pack_sentence_f32(means, log_var, log_w, normalizer: str) -> torch.Tensor:
    """The sentence kernel's bank operand ``[S, ceil(M/8), 2D + 1, 8]``:
    per senone and group of 8 mixtures the rows ``-0.5p`` (D), ``μp`` (D)
    and the bias, as :func:`pack_f32`; padded mixtures have zero weights
    and the bias ``NEG_INF``."""
    s, m, d = means.shape
    prec = torch.exp(-log_var)
    bias = (-0.5 * torch.sum(means * means * prec, dim=-1)
            + normalizer_const(log_var, normalizer)
            + torch.clamp(log_w, min=NEG_INF))             # [S, M]
    rows = torch.cat([-0.5 * prec, means * prec, bias[..., None]], dim=2)
    mp = _pad_to(m, SENTENCE_MIX)
    pad = torch.zeros((s, mp - m, 2 * d + 1), dtype=rows.dtype,
                      device=rows.device)
    pad[..., -1] = NEG_INF
    rows = torch.cat([rows, pad], dim=1)                   # [S, Mp, 2D + 1]
    return (rows.reshape(s, mp // SENTENCE_MIX, SENTENCE_MIX, 2 * d + 1)
            .transpose(2, 3).contiguous())


def _core_matrices(a: torch.Tensor) -> torch.Tensor:
    """``[S, M, D]`` float32 -> ``[M, Dp/8, S_pad, 8]`` bfloat16."""
    s, m, d = a.shape
    dp = _pad_to(d, 8)
    a = F.pad(a.to(torch.bfloat16), (0, dp - d)).reshape(s, m, dp // 8, 8)
    return F.pad(a.permute(1, 2, 0, 3),
                 (0, 0, 0, _pad_to(s, S_TILE) - s)).contiguous()


def pack_bf16_static(means, log_var, log_w, normalizer: str) -> dict:
    """The frame-independent part of the bfloat16 operands."""
    prec = torch.exp(-log_var)
    return dict(prec=prec, w_x2=_core_matrices(-0.5 * prec),
                const=(normalizer_const(log_var, normalizer)
                       + torch.clamp(log_w, min=NEG_INF)).contiguous())


def pack_bf16(static: dict, means, center):
    """The frame-dependent bfloat16 operands for frames of mean ``center``,
    in plain torch: the ``(μ - c)p`` half of the weights
    ``[M, Dp/8, S_pad, 8]`` bfloat16 and the bias ``[M, S_pad]``."""
    s = means.shape[0]
    prec = static["prec"]
    mc = means - center[None, None]
    bias = -0.5 * torch.sum(mc * mc * prec, dim=-1) + static["const"]
    return (_core_matrices(mc * prec),
            F.pad(bias.T, (0, _pad_to(s, S_TILE) - s)).contiguous())


_packs: OrderedDict = OrderedDict()


def _cached(packer, means, log_var, log_w, normalizer: str):
    """``packer(means, log_var, log_w, normalizer)``, kept per bank.  An
    entry is the packer, the normalizer and the three tensors themselves
    (held weakly: a new tensor at a freed one's address is another bank)
    at their ``_version``, which every in-place update raises."""
    bank = (means, log_var, log_w)
    key = (packer.__name__, normalizer, *(id(a) for a in bank))
    state = tuple((a.data_ptr(), a._version) for a in bank)
    hit = _packs.get(key)
    if hit is not None:
        refs, kept_state, packed = hit
        if kept_state == state and all(r() is a for r, a in zip(refs, bank)):
            _packs.move_to_end(key)
            return packed
    packed = packer(means, log_var, log_w, normalizer)
    _packs[key] = (tuple(weakref.ref(a) for a in bank), state, packed)
    _packs.move_to_end(key)
    while len(_packs) > _CACHE_SIZE:
        _packs.popitem(last=False)
    return packed


def bind_sentence(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the sentence kernel's C interface (``sentence_score_f32``,
    ``sentence_score_max_d``) of a library built from ``gmm_score.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sentence_score_f32.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.sentence_score_max_d.argtypes = []
    for fn in (lib.sentence_score_f32, lib.sentence_score_max_d):
        fn.restype = i
    return lib


def bind_stats(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the statistics kernel's C interface (``sentence_stats_f32``)
    of a library built from ``gmm_score.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sentence_stats_f32.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.sentence_stats_f32.restype = i
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = bind_stats(bind_sentence(build.load("gmm_score")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gmm_score_f32.argtypes = [p] * 3 + [i] * 5 + [p]
    lib.gmm_score_bf16.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.gmm_score_max_d.argtypes = [i]
    for fn in (lib.gmm_score_f32, lib.gmm_score_bf16, lib.gmm_score_max_d):
        fn.restype = i
    lib.gmm_score_error_string.argtypes = [i]
    lib.gmm_score_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, a: torch.Tensor, device, dtype, shape) -> None:
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, expected {device}")
    if a.dtype != dtype:
        raise ValueError(f"{name} has dtype {a.dtype}, expected {dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                         f"expected {tuple(shape)}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gmm_log_scores_cuda(x, means, log_var, log_w, normalizer="textbook",
                        score_dtype="float32"):
    """State scores ``[T, S]`` through the CUDA kernel; CUDA tensors only.

    :param x: ``[T, D]`` float32 frames
    :param means, log_var: ``[S, M, D]`` float32
    :param log_w: ``[S, M]`` float32 log mixture weights
    """
    if not x.is_cuda:
        raise ValueError("gmm_log_scores_cuda takes CUDA tensors; "
                         "call gmm_log_scores_fast for the CPU")
    if score_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown score_dtype: {score_dtype!r}")
    dev = x.device
    t, d = x.shape
    s, m, _ = means.shape
    for name, a, shape in (("x", x, (t, d)), ("means", means, (s, m, d)),
                           ("log_var", log_var, (s, m, d)),
                           ("log_w", log_w, (s, m))):
        _check(name, a, dev, torch.float32, shape)
    if m < 1:
        raise ValueError("the bank has no mixture slots")
    out = torch.empty((t, s), dtype=torch.float32, device=dev)
    if t == 0 or s == 0:
        return out
    lib = _lib()
    bf16 = score_dtype == "bfloat16"
    if bf16 and x.data_ptr() % 16:
        x = x.clone()   # the kernel copies x in whole 16-byte runs
    if d > lib.gmm_score_max_d(int(bf16)):
        raise ValueError(f"feature dim {d} too large for the kernel's "
                         "shared-memory tiles "
                         f"(D <= {lib.gmm_score_max_d(int(bf16))})")
    s_pad = _pad_to(s, S_TILE)
    with torch.cuda.device(dev):
        if bf16:
            static = _cached(pack_bf16_static, means, log_var, log_w,
                             normalizer)
            w_x2 = static["w_x2"]
            _check("w_x2", w_x2, dev, torch.bfloat16,
                   (m, _pad_to(d, 8) // 8, s_pad, 8))
            _check("prec", static["prec"], dev, torch.float32, (s, m, d))
            _check("const", static["const"], dev, torch.float32, (s, m))
            center = torch.mean(x, dim=0)
            w_x = torch.empty_like(w_x2)
            bias = torch.empty((m, s_pad), dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gmm_score_bf16(
                x.data_ptr(), center.data_ptr(), means.data_ptr(),
                static["prec"].data_ptr(), static["const"].data_ptr(),
                w_x2.data_ptr(), w_x.data_ptr(), bias.data_ptr(),
                out.data_ptr(), t, s, s_pad, m, d, stream)
        else:
            weight = _cached(pack_f32, means, log_var, log_w, normalizer)
            _check("weight", weight, dev, torch.float32,
                   (m, 2 * d + 1, s_pad))
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gmm_score_f32(x.data_ptr(), weight.data_ptr(),
                                   out.data_ptr(), t, s, s_pad, m, d, stream)
    if rc != 0:
        raise RuntimeError("gmm_score kernel launch failed: "
                           + lib.gmm_score_error_string(rc).decode())
    gmm_log_scores_cuda.launches += 1
    gmm_log_scores_cuda.launches_bf16 += bf16
    return out


gmm_log_scores_cuda.launches = 0        # both kernels
gmm_log_scores_cuda.launches_bf16 = 0   # the bfloat16 kernel's share


def sentence_scores_cuda(xs, sen, means, log_var, log_w,
                         normalizer="textbook", components=True):
    """Each utterance's frames against its own sentence states, float32, in
    one launch of the sentence kernel; CUDA tensors only.

    :param xs: ``[B, T, D]`` float32 frames (every frame is scored)
    :param sen: ``[B, N]`` int64 bank rows of the sentence states (the
        kernel clamps them to the bank)
    :param means, log_var: ``[S, M, D]`` float32; :param log_w: ``[S, M]``
    :param components: also return the weighted component log-probs
    :returns: (state scores ``[B, T, N]``, components ``[B, T, N, M]`` or
        None), as ``logsumexp_m(log w + log N)`` of
        :func:`~poccala_tpu_torch.ops.gmm_score.gmm_component_logpdf`
    """
    if xs.dim() != 3 or sen.dim() != 2 or means.dim() != 3:
        raise ValueError("expected xs [B, T, D], sen [B, N], means [S, M, D]")
    b, t, d = xs.shape
    n = sen.shape[1]
    s, m, _ = means.shape
    operands = (("xs", xs, torch.float32, (b, t, d)),
                ("sen", sen, torch.int64, (b, n)),
                ("means", means, torch.float32, (s, m, d)),
                ("log_var", log_var, torch.float32, (s, m, d)),
                ("log_w", log_w, torch.float32, (s, m)))
    for name, a, dtype, shape in operands:
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"{name} is {a.dtype} {tuple(a.shape)}, "
                             f"expected {dtype} {shape}")
    if not xs.is_cuda:
        raise ValueError("sentence_scores_cuda takes CUDA tensors; the "
                         "plain version serves the CPU")
    dev = xs.device
    for name, a, dtype, shape in operands:
        _check(name, a, dev, dtype, shape)
    if m < 1 or s < 1:
        raise ValueError("the bank has no senones or no mixture slots")
    lib = _lib()
    if d > lib.sentence_score_max_d():
        raise ValueError(f"feature dim {d} too large for the sentence "
                         "kernel's shared-memory tiles "
                         f"(D <= {lib.sentence_score_max_d()})")
    scores = torch.empty((b, t, n), dtype=torch.float32, device=dev)
    comp = (torch.empty((b, t, n, m), dtype=torch.float32, device=dev)
            if components else None)
    if b == 0 or t == 0 or n == 0:
        return scores, comp
    with torch.cuda.device(dev):
        weight = _cached(pack_sentence_f32, means, log_var, log_w,
                         normalizer)
        _check("weight", weight, dev, torch.float32,
               (s, _pad_to(m, SENTENCE_MIX) // SENTENCE_MIX, 2 * d + 1,
                SENTENCE_MIX))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sentence_score_f32(
            xs.data_ptr(), sen.data_ptr(), weight.data_ptr(),
            scores.data_ptr(), None if comp is None else comp.data_ptr(),
            b, t, n, s, m, d, stream)
    if rc != 0:
        raise RuntimeError("sentence_score kernel launch failed: "
                           + lib.gmm_score_error_string(rc).decode())
    sentence_scores_cuda.launches += 1
    return scores, comp


sentence_scores_cuda.launches = 0


def sentence_stats_cuda(comp, scores, gamma, emitting, xs):
    """The E-step's GMM moments of each utterance's sentence states, float32,
    in one launch of the statistics kernel; CUDA tensors only.  With
    ``w = gamma · exp(min(comp - scores, 0))`` on the emitting states (0 on
    the others), the sums over the frames of ``w``, ``w·x`` and ``w·x²``;
    the terms whose ``gamma`` is exactly 0 are skipped, which leaves every
    sum as it is.

    :param comp: ``[B, T, N, M]`` weighted component log-probs and
        :param scores: ``[B, T, N]`` their logsumexp over M, as
        :func:`sentence_scores_cuda` writes them
    :param gamma: ``[B, T, N]`` state posteriors; :param emitting:
        ``[B, N]`` bool; :param xs: ``[B, T, D]`` frames
    :returns: (``c_r [B, N, M]``, ``cx_r [B, N, M, D]``, ``cxx_r [B, N, M,
        D]``), as :func:`~poccala_tpu_torch.train.accumulators._mixture_moments`

    Each launch adds its (live, all) tiles of 32 frames × 8 states to a tally
    on the device, read by :func:`stats_tile_tally`."""
    if comp.dim() != 4 or xs.dim() != 3:
        raise ValueError("expected comp [B, T, N, M] and xs [B, T, D]")
    b, t, n, m = comp.shape
    d = xs.shape[2]
    operands = (("comp", comp, torch.float32, (b, t, n, m)),
                ("scores", scores, torch.float32, (b, t, n)),
                ("gamma", gamma, torch.float32, (b, t, n)),
                ("emitting", emitting, torch.bool, (b, n)),
                ("xs", xs, torch.float32, (b, t, d)))
    for name, a, dtype, shape in operands:
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"{name} is {a.dtype} {tuple(a.shape)}, "
                             f"expected {dtype} {shape}")
    if not comp.is_cuda:
        raise ValueError("sentence_stats_cuda takes CUDA tensors; the "
                         "plain version serves the CPU")
    dev = comp.device
    for name, a, dtype, shape in operands:
        _check(name, a, dev, dtype, shape)
    c = torch.empty((b, n, m), dtype=torch.float32, device=dev)
    cx = torch.empty((b, n, m, d), dtype=torch.float32, device=dev)
    cxx = torch.empty_like(cx)
    if b == 0 or n == 0 or m == 0:
        return c, cx, cxx
    tiles = torch.empty((b * -(-n // 8), 2), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sentence_stats_f32(
            comp.data_ptr(), scores.data_ptr(), gamma.data_ptr(),
            emitting.data_ptr(), xs.data_ptr(), c.data_ptr(), cx.data_ptr(),
            cxx.data_ptr(), tiles.data_ptr(), b, t, n, m, d, stream)
    if rc != 0:
        raise RuntimeError("sentence_stats kernel launch failed: "
                           + lib.gmm_score_error_string(rc).decode())
    sentence_stats_cuda.launches += 1
    tally = sentence_stats_cuda.tiles
    if dev in tally:
        tally[dev] += tiles.sum(dim=0)
    else:
        tally[dev] = tiles.sum(dim=0)
    return c, cx, cxx


sentence_stats_cuda.launches = 0
sentence_stats_cuda.tiles = {}   # device -> int64 [2]: (live, all) tiles


def stats_tiles_plain(gamma, emitting) -> torch.Tensor:
    """The statistics kernel's tally, plain: for each utterance's group of
    8 sentence states ``[B * ceil(N / 8), 2]`` int32, its tiles of 32
    frames that an emitting state of the group is live in (a posterior
    other than 0), and all of its tiles."""
    b, t, n = gamma.shape
    groups, frames = -(-n // 8), -(-t // 32)
    hit = F.pad((gamma != 0) & emitting[:, None, :],
                (0, groups * 8 - n, 0, frames * 32 - t))
    live = hit.reshape(b, frames, 32, groups, 8).any(dim=4).any(dim=2)
    all_ = torch.full((b, groups), frames, device=gamma.device)
    return torch.stack([live.sum(dim=1), all_], dim=-1).reshape(
        b * groups, 2).to(torch.int32)


def stats_tile_tally() -> tuple[int, int]:
    """The statistics kernel's (live, all) tiles of 32 frames × 8 states
    over its launches so far, on every device; waits for them (for tests
    and ``chip_smoke.py``: the launches themselves never synchronise)."""
    live = total = 0
    for counts in sentence_stats_cuda.tiles.values():
        a, t = counts.tolist()
        live, total = live + a, total + t
    return live, total


def gmm_log_scores_fast(x, means, log_var, log_w, normalizer="textbook",
                        score_dtype="float32"):
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU one
    (``gmm_score_tpu.py:176-186``).  There is no fallback: a kernel that
    does not build or launch raises."""
    if x.is_cuda:
        return gmm_log_scores_cuda(x, means, log_var, log_w,
                                   normalizer=normalizer,
                                   score_dtype=score_dtype)
    return gmm_log_scores(x, means, log_var, log_w, normalizer=normalizer,
                          score_dtype=score_dtype)
