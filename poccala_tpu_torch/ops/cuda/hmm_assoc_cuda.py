"""The (logsumexp, +) semiring product on the GPU: the wrappers of
``csrc/hmm_assoc.cu``.

The kernels replace the combine of ``poccala_tpu/ops/hmm.py``'s
``forward_log_assoc`` (:163) under ``jax.lax.associative_scan``, and its
tail, the row ``alpha_0`` through every prefix product — not Pallas
kernels; the JAX package leaves them to XLA.  :func:`lse_product_cuda`
writes ``out[p] = clamp(LSE_k(a[p, :, k] + b[p, k, :]))`` for a batch of
matrices, :func:`lse_rows_cuda` the same for one row per ``p``; each checks
its operands, launches one kernel on the current CUDA stream, counts the
launch and raises if the launch fails.  Operands and output may be strided
views along their first axis (a level's ``[0:-1:2]`` slices, the
interleaved output's ``[1::2]``), each matrix row-major and contiguous.
CUDA tensors only: :func:`poccala_tpu_torch.ops.hmm.forward_log_assoc`
routes a CPU tensor to the plain version instead.  ``lib`` runs another
build of the C interface (:func:`bind`) with the same checks, its launches
not counted: the kernels the redesign replaced, timed beside it on the
card, or a host build of the source that the tests run on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from poccala_tpu_torch.ops.cuda import build

SOURCE = "poccala_tpu_torch/csrc/hmm_assoc.cu"
REPLACES = "poccala_tpu/ops/hmm.py:163"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``hmm_assoc.cu``."""
    lib.hmm_lse_product.argtypes = [_P, _L, _P, _L, _P, _L, _L, _I, _I, _I,
                                    _P]
    lib.hmm_lse_rows.argtypes = [_P, _L, _P, _L, _P, _L, _L, _I, _I, _P]
    for fn in (lib.hmm_lse_product, lib.hmm_lse_rows):
        fn.restype = ctypes.c_int
    lib.hmm_assoc_error_string.argtypes = [_I]
    lib.hmm_assoc_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("hmm_assoc"))


def _stride(name: str, x: torch.Tensor, device, shape: tuple) -> int:
    """``x``'s stride along its first axis, after checking that it is a
    float32 tensor on ``device`` of ``shape`` whose matrices (or rows) are
    row-major and contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {x.dtype}, expected float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    inner = [1]
    for n in reversed(shape[2:]):
        inner.insert(0, inner[0] * n)
    if any(n > 1 and st != want for n, st, want in
           zip(shape[1:], x.stride()[1:], inner)):
        raise ValueError(f"{name} has strides {x.stride()}: expected "
                         "contiguous rows")
    return int(x.stride(0))


def _require_cuda(dev: torch.device, lib) -> None:
    if dev.type != "cuda" and lib is None:
        raise ValueError("the semiring product's kernels take CUDA tensors; "
                         "poccala_tpu_torch.ops.hmm.forward_log_assoc runs "
                         "the plain version on the CPU")


def _launch(lib, fn, *args) -> None:
    """``fn`` of ``lib`` (the port's build where None) on the arguments'
    device: its current CUDA stream, or none for a host build."""
    dev = args[0].device
    lib = lib or _lib()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            rc = getattr(lib, fn)(*ptrs,
                                  torch.cuda.current_stream(dev).cuda_stream)
    else:
        rc = getattr(lib, fn)(*ptrs, None)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.hmm_assoc_error_string(rc).decode())


def lse_product_cuda(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                     lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """``out[p, i, j] = max(LSE_k(a[p, i, k] + b[p, k, j]), NEG_INF)``
    (JAX's logsumexp: the max first, 0 where it is not finite, the sum in
    ascending ``k``): ``a [P, M, K]``, ``b [P, K, N]``, ``out [P, M, N]``,
    float32 on one card.  One launch (none at ``P = 0``), counted where
    ``lib`` is None; returns ``out``."""
    if a.ndim != 3 or b.ndim != 3 or out.ndim != 3:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}, out "
                         f"{tuple(out.shape)}: expected (P, M, K), (P, K, N) "
                         "and (P, M, N)")
    p, m, k = a.shape
    n = b.shape[2]
    dev = a.device
    _require_cuda(dev, lib)
    strides = [_stride("a", a, dev, (p, m, k)),
               _stride("b", b, dev, (p, k, n)),
               _stride("out", out, dev, (p, m, n))]
    if p == 0:
        return out
    _launch(lib, "hmm_lse_product", a, strides[0], b, strides[1], out,
            strides[2], p, m, k, n)
    if lib is None:
        lse_product_cuda.launches += 1
    return out


lse_product_cuda.launches = 0


def lse_rows_cuda(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                  lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """``out[p, j] = max(LSE_k(a[k] + b[p, k, j]), NEG_INF)``, the row form
    of :func:`lse_product_cuda` with one row ``a [K]`` for every ``p`` (or
    ``a [P, K]``, a row each): ``b [P, K, N]``, ``out [P, N]``.  One launch
    (none at ``P = 0``), counted where ``lib`` is None; returns ``out``."""
    if a.ndim not in (1, 2) or b.ndim != 3 or out.ndim != 2:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}, out "
                         f"{tuple(out.shape)}: expected (K,) or (P, K), "
                         "(P, K, N) and (P, N)")
    p, k, n = b.shape
    dev = b.device
    _require_cuda(dev, lib)
    if a.ndim == 1:
        _stride("a", a[None], dev, (1, k))
        sa = 0
    else:
        sa = _stride("a", a, dev, (p, k))
    strides = [_stride("b", b, dev, (p, k, n)),
               _stride("out", out, dev, (p, n))]
    if p == 0:
        return out
    _launch(lib, "hmm_lse_rows", a, sa, b, strides[0], out, strides[1], p, k,
            n)
    if lib is None:
        lse_rows_cuda.launches += 1
    return out


lse_rows_cuda.launches = 0
