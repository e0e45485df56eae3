"""Fused diagonal-GMM scoring: the CUDA kernel's wrapper and the dispatcher
(port of ``poccala_tpu/ops/pallas/gmm_score_tpu.py``).

:func:`gmm_log_scores_cuda` packs the operands in plain torch, as the JAX
package packs them outside ``pallas_call`` (``_pack_params``,
``gmm_score_tpu.py:36-65``), then launches ``csrc/gmm_score.cu`` on the
current CUDA stream.  Math, with precision ``p = 1/σ²``:

    logp[t, s, m] = -0.5·Σx²p + Σx·(μp) + (-0.5·Σμ²p + const + log w)

i.e. rows ``[x², x]`` against columns ``[-0.5p ; μp]`` plus a per-(s, m)
bias, folded over m by an online logsumexp inside the kernel.

:func:`gmm_log_scores_fast` is the dispatcher the decoder calls: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the plain
version :func:`poccala_tpu_torch.ops.gmm_score.gmm_log_scores`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from poccala_tpu_torch.ops.cuda import build
from poccala_tpu_torch.ops.gmm_score import gmm_log_scores, normalizer_const
from poccala_tpu_torch.utils.logmath import NEG_INF

SOURCE = "poccala_tpu_torch/csrc/gmm_score.cu"
REPLACES = "poccala_tpu/ops/pallas/gmm_score_tpu.py:105"


def _pack_params(means, log_var, log_w, normalizer: str,
                 score_dtype: str = "float32", center=None):
    """Per-mixture weights ``[M, 2D, S]`` (operand dtype), bias ``[M, S]``
    (fp32) and the per-dim centering offset ``[D]`` (zero in fp32; the
    frame mean for bf16, see ``ops/gmm_score.py``)."""
    s, m, d = means.shape
    prec = torch.exp(-log_var)
    const = normalizer_const(log_var, normalizer)
    if score_dtype == "bfloat16":
        if center is None:
            center = torch.mean(means.reshape(s * m, d), dim=0)
        means = means - center[None, None]
        op = torch.bfloat16
    elif score_dtype == "float32":
        center = torch.zeros((d,), dtype=torch.float32, device=means.device)
        op = torch.float32
    else:
        raise ValueError(f"unknown score_dtype: {score_dtype!r}")
    w_x2 = (-0.5 * prec).permute(1, 2, 0)               # [M, D, S]
    w_x = (means * prec).permute(1, 2, 0)               # [M, D, S]
    weight = torch.cat([w_x2, w_x], dim=1).to(op).contiguous()
    mu2p = torch.sum(means * means * prec, dim=-1)      # [S, M]
    bias = (-0.5 * mu2p + const
            + torch.clamp(log_w, min=NEG_INF)).T.contiguous()  # [M, S]
    return weight, bias, center


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("gmm_score")
    for fn in (lib.gmm_score_f32, lib.gmm_score_bf16):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.gmm_score_max_k.argtypes = []
    lib.gmm_score_max_k.restype = ctypes.c_int
    lib.gmm_score_error_string.argtypes = [ctypes.c_int]
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
    dev = x.device
    t, d = x.shape
    s, m, _ = means.shape
    for name, a, shape in (("x", x, (t, d)), ("means", means, (s, m, d)),
                           ("log_var", log_var, (s, m, d)),
                           ("log_w", log_w, (s, m))):
        _check(name, a, dev, torch.float32, shape)
    if m < 1:
        raise ValueError("the bank has no mixture slots")
    center = torch.mean(x, dim=0) if score_dtype == "bfloat16" else None
    weight, bias, center = _pack_params(means, log_var, log_w, normalizer,
                                        score_dtype, center=center)
    xc = x - center[None]
    xa = torch.cat([xc * xc, xc], dim=1).to(weight.dtype).contiguous()
    out = torch.empty((t, s), dtype=torch.float32, device=dev)
    if t == 0 or s == 0:
        return out
    k = 2 * d
    _check("xa", xa, dev, weight.dtype, (t, k))
    _check("weight", weight, dev, weight.dtype, (m, k, s))
    _check("bias", bias, dev, torch.float32, (m, s))
    lib = _lib()
    if k > lib.gmm_score_max_k():
        raise ValueError(f"feature dim {d} too large for the kernel's "
                         f"shared-memory tiles (2D <= {lib.gmm_score_max_k()})")
    fn = lib.gmm_score_bf16 if score_dtype == "bfloat16" else lib.gmm_score_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(xa.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                out.data_ptr(), t, s, m, k, stream)
    if rc != 0:
        raise RuntimeError("gmm_score kernel launch failed: "
                           + lib.gmm_score_error_string(rc).decode())
    gmm_log_scores_cuda.launches += 1
    return out


gmm_log_scores_cuda.launches = 0


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
