"""Banded HMM forward / backward / Viterbi on the GPU: the wrappers of
``csrc/hmm_banded.cu``.

The kernels replace the three ``lax.scan`` recursions of
``poccala_tpu/ops/hmm.py`` (``forward_log_banded`` :237,
``backward_log_banded`` :263, ``viterbi_log_banded`` :288) — not Pallas
kernels; the JAX package leaves them to XLA.  Each wrapper checks its
operands, allocates the outputs, launches one kernel on the current CUDA
stream, counts the launch and raises if the launch fails.  CUDA tensors
only: :mod:`poccala_tpu_torch.ops.hmm`'s ``*_batch`` dispatchers route a
CPU tensor to the plain version instead.

Each recursion has two kernels, chosen by shape inside the library: a
warp per utterance with the carry in registers where ``N <= 128`` and
``3 <= W <= 7`` (:func:`takes_warp`), a block per utterance with the carry
in shared memory elsewhere.  The warp Viterbi kernel also keeps its
backpointers in shared memory, so an utterance too long for that goes to
the block kernel too (:func:`viterbi_takes_warp`).  ``block=True`` sends a
call to the block kernel whatever its shape, to hold one kernel against
the other; both give the same ``alpha`` / ``beta`` and the same Viterbi
``score``, ``path`` and final ``delta`` bit for bit, and ``loglik`` to
float32 rounding (the warp kernel sums by shuffles).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from poccala_tpu_torch.ops.cuda import build

SOURCE = "poccala_tpu_torch/csrc/hmm_banded.cu"
REPLACES = {
    "forward": "poccala_tpu/ops/hmm.py:237",
    "backward": "poccala_tpu/ops/hmm.py:263",
    "viterbi": "poccala_tpu/ops/hmm.py:288",
}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("hmm_banded")
    lib.hmm_forward_banded.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    lib.hmm_backward_banded.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    lib.hmm_forward_banded_block.argtypes = lib.hmm_forward_banded.argtypes
    lib.hmm_backward_banded_block.argtypes = lib.hmm_backward_banded.argtypes
    lib.hmm_viterbi_banded.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.hmm_viterbi_banded_block.argtypes = lib.hmm_viterbi_banded.argtypes
    lib.hmm_banded_takes_warp.argtypes = [_I, _I]
    lib.hmm_viterbi_takes_warp.argtypes = [_I, _I, _I]
    for fn in (lib.hmm_forward_banded, lib.hmm_backward_banded,
               lib.hmm_forward_banded_block, lib.hmm_backward_banded_block,
               lib.hmm_viterbi_banded, lib.hmm_viterbi_banded_block,
               lib.hmm_banded_max_w, lib.hmm_banded_max_n,
               lib.hmm_banded_takes_warp, lib.hmm_viterbi_takes_warp):
        fn.restype = ctypes.c_int
    lib.hmm_banded_max_w.argtypes = []
    lib.hmm_banded_max_n.argtypes = []
    lib.hmm_banded_error_string.argtypes = [_I]
    lib.hmm_banded_error_string.restype = ctypes.c_char_p
    return lib


def takes_warp(n: int, w: int) -> bool:
    """Whether forward and backward run ``n`` states at band width ``w``
    on the warp kernels (else on the block kernels)."""
    return bool(_lib().hmm_banded_takes_warp(n, w))


def viterbi_takes_warp(t: int, n: int, w: int) -> bool:
    """Whether Viterbi runs ``t`` frames of ``n`` states at band width
    ``w`` on the warp kernel: :func:`takes_warp`, and ``t - 1`` frames of
    backpointers fit the block's shared memory."""
    return bool(_lib().hmm_viterbi_takes_warp(t, n, w))


def _operands(bands, log_bs, t_masks, w: int, log_pis=None):
    """Check shapes and devices; return contiguous operands and sizes."""
    if not log_bs.is_cuda:
        raise ValueError("the hmm_banded kernels take CUDA tensors; call "
                         "poccala_tpu_torch.ops.hmm.*_batch for the CPU")
    b, t, n = log_bs.shape
    dev = log_bs.device
    if bands.shape[:2] != (b, n) or bands.shape[2] < w:
        raise ValueError(f"bands has shape {tuple(bands.shape)}, expected "
                         f"({b}, {n}, >= {w})")
    if tuple(t_masks.shape) != (b, t):
        raise ValueError(f"t_masks has shape {tuple(t_masks.shape)}, "
                         f"expected ({b}, {t})")
    if log_pis is not None and tuple(log_pis.shape) != (b, n):
        raise ValueError(f"log_pis has shape {tuple(log_pis.shape)}, "
                         f"expected ({b}, {n})")
    for name, a in (("bands", bands), ("t_masks", t_masks),
                    ("log_pis", log_pis)):
        if a is not None and a.device != dev:
            raise ValueError(f"{name} is on {a.device}, expected {dev}")
    lib = _lib()
    if not 1 <= w <= lib.hmm_banded_max_w():
        raise ValueError(f"band width {w} outside [1, "
                         f"{lib.hmm_banded_max_w()}]")
    if n > lib.hmm_banded_max_n():
        raise ValueError(f"{n} sentence states exceed the kernel's "
                         f"{lib.hmm_banded_max_n()} threads per block")
    if t < 1:
        raise ValueError("the kernels need at least one frame")
    f32 = torch.float32
    ops = dict(
        band=bands[..., :w].to(f32).contiguous(),
        log_b=log_bs.to(f32).contiguous(),
        # a bool tensor is one byte (0 or 1) per element: no copy
        mask=(t_masks.view(torch.uint8) if t_masks.dtype == torch.bool
              else t_masks.to(torch.uint8)).contiguous(),
        log_pi=None if log_pis is None else log_pis.to(f32).contiguous(),
    )
    return lib, ops, (b, t, n)


def _launch(lib, fn, name: str, dev, *args) -> None:
    """Launch on ``dev``'s current stream; raise if the launch failed."""
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hmm_banded {name} kernel launch failed: "
                           + lib.hmm_banded_error_string(rc).decode())


def forward_banded_cuda(bands, log_pis, log_bs, t_masks, w: int, *,
                        block: bool = False):
    """(``log_alpha [B, T, N]``, ``loglik [B]``) through the kernel."""
    lib, o, (b, t, n) = _operands(bands, log_bs, t_masks, w, log_pis)
    dev = log_bs.device
    alpha = torch.empty((b, t, n), dtype=torch.float32, device=dev)
    loglik = torch.empty((b,), dtype=torch.float32, device=dev)
    if b:
        fn = lib.hmm_forward_banded_block if block else lib.hmm_forward_banded
        _launch(lib, fn, "forward", dev,
                o["band"].data_ptr(), o["log_pi"].data_ptr(),
                o["log_b"].data_ptr(), o["mask"].data_ptr(),
                alpha.data_ptr(), loglik.data_ptr(), b, t, n, w)
        forward_banded_cuda.launches += 1
    return alpha, loglik


def backward_banded_cuda(bands, log_bs, t_masks, w: int, *,
                         block: bool = False):
    """``log_beta [B, T, N]`` through the kernel."""
    lib, o, (b, t, n) = _operands(bands, log_bs, t_masks, w)
    dev = log_bs.device
    beta = torch.empty((b, t, n), dtype=torch.float32, device=dev)
    if b:
        fn = lib.hmm_backward_banded_block if block else \
            lib.hmm_backward_banded
        _launch(lib, fn, "backward", dev,
                o["band"].data_ptr(), o["log_b"].data_ptr(),
                o["mask"].data_ptr(), beta.data_ptr(), b, t, n, w)
        backward_banded_cuda.launches += 1
    return beta


def viterbi_banded_cuda(bands, log_pis, log_bs, t_masks, w: int,
                        end_states: int = 0, *, block: bool = False):
    """(score ``[B]``, path ``[B, T]`` int32, final delta ``[B, N]``)
    through the kernel; the backtrace runs inside it."""
    lib, o, (b, t, n) = _operands(bands, log_bs, t_masks, w, log_pis)
    if not 0 <= end_states <= n:
        raise ValueError(f"end_states={end_states} outside [0, {n}]")
    dev = log_bs.device
    score = torch.empty((b,), dtype=torch.float32, device=dev)
    path = torch.empty((b, t), dtype=torch.int32, device=dev)
    delta = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b:
        # only the block kernel keeps its backpointers in device memory
        offs = None
        if block or not lib.hmm_viterbi_takes_warp(t, n, w):
            offs = torch.empty((max(b * (t - 1) * n, 1),), dtype=torch.uint8,
                               device=dev)
        fn = lib.hmm_viterbi_banded_block if block else lib.hmm_viterbi_banded
        _launch(lib, fn, "viterbi", dev,
                o["band"].data_ptr(), o["log_pi"].data_ptr(),
                o["log_b"].data_ptr(), o["mask"].data_ptr(),
                None if offs is None else offs.data_ptr(),
                score.data_ptr(), path.data_ptr(),
                delta.data_ptr(), b, t, n, w, end_states)
        viterbi_banded_cuda.launches += 1
    return score, path, delta


forward_banded_cuda.launches = 0
backward_banded_cuda.launches = 0
viterbi_banded_cuda.launches = 0

KERNELS = {"forward": forward_banded_cuda, "backward": backward_banded_cuda,
           "viterbi": viterbi_banded_cuda}
