"""The device decoder's exact frame scan on the GPU: the wrapper of
``csrc/decoder_scan.cu``.

The kernel replaces ``step`` of ``DeviceBeamDecoder._build_step``
(``poccala_tpu/decoder/device.py:423``) under the ``lax.scan`` of
``_build_run`` and ``_chunk_fn`` — not a Pallas kernel; the JAX package
traces the scan into one XLA program.  One launch runs every frame of a
decode call or a stream chunk for every utterance of the batch; its plain
version is :meth:`poccala_tpu_torch.decoder.device.DeviceBeamDecoder.
_frame_step` in a loop over frames, which ``DeviceBeamDecoder._scan``
runs for a CPU tensor.  The two agree bit for bit.

The decoder's tables (``_Tables``) are packed once per table object
(:func:`pack_tables`, cached with weak references): int32 indices, the
emitting mask folded into ``senone`` (-1 where not emitting) and
``has_parent`` into ``parent`` (-1 where none).  CUDA tensors only: the
wrapper raises on a CPU tensor and on an operand of the wrong dtype, and
when the kernel does not launch.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from collections import OrderedDict

import numpy as np
import torch

from poccala_tpu_torch.ops.cuda import build

SOURCE = "poccala_tpu_torch/csrc/decoder_scan.cu"
REPLACES = "poccala_tpu/decoder/device.py:423"
LM_NONE, LM_FLAT, LM_SPARSE = 0, 1, 2
_CACHE_SIZE = 8      # packed table sets kept

_P = ctypes.c_void_p
_I = ctypes.c_int


class _ScanTables(ctypes.Structure):
    """``struct ScanTables`` of ``csrc/decoder_scan.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "bands", "senone", "parent", "root_child", "node_slot", "word_slot",
        "slot_valid", "lm_flat", "lm_uni", "lm_rboff", "lm_cbase", "lm_keys",
        "lm_vals")] + [(name, ctypes.c_int32) for name in (
            "n_nodes", "n_states", "band_w", "n_slots", "n_vocab", "r_top",
            "lm_mode", "lm_n_keys")] + [("penalty", ctypes.c_float)]


def pack_tables(tabs, n_vocab: int, r_top: int, penalty: float) -> dict:
    """The kernel's operands from the decoder's ``_Tables``, in plain torch
    on the tables' device: contiguous tensors, int32 indices and uint8
    flags, the LM in its form (``lm_mode``), ``r_top`` candidates and the
    constant LM term ``penalty`` (``-word_penalty``) as float32."""
    i32, u8, f32 = torch.int32, torch.uint8, torch.float32
    packed = dict(
        bands=tabs.bands.to(f32).contiguous(),
        senone=torch.where(tabs.emitting, tabs.senone, -1).to(i32)
        .contiguous(),
        parent=torch.where(tabs.has_parent, tabs.parent, -1).to(i32)
        .contiguous(),
        root_child=tabs.is_root_child.to(u8).contiguous(),
        node_slot=tabs.node_slot.to(i32).contiguous(),
        word_slot=tabs.word_slot.to(i32).contiguous(),
        slot_valid=tabs.slot_valid.to(u8).contiguous(),
        n_vocab=int(n_vocab), r_top=int(r_top),
        penalty=float(np.float32(penalty)), lm_mode=LM_NONE,
    )
    if tabs.lm_sparse is not None:
        uni, rboff, cbase, keys, vals = tabs.lm_sparse
        packed.update(lm_mode=LM_SPARSE, lm_uni=uni.to(f32).contiguous(),
                      lm_rboff=rboff.to(f32).contiguous(),
                      lm_cbase=cbase.to(f32).contiguous(),
                      lm_keys=keys.to(i32).contiguous(),
                      lm_vals=vals.to(f32).contiguous())
    elif tabs.lm_flat is not None:
        packed.update(lm_mode=LM_FLAT,
                      lm_flat=tabs.lm_flat.to(f32).contiguous())
    return packed


def _struct(p: dict) -> _ScanTables:
    def ptr(name):
        a = p.get(name)
        return None if a is None else a.data_ptr()

    n, ns, w = p["bands"].shape
    keys = p.get("lm_keys")
    return _ScanTables(
        *(ptr(name) for name, _ in _ScanTables._fields_[:13]),
        n, ns, w, p["node_slot"].shape[0], p["n_vocab"], p["r_top"],
        p["lm_mode"], 0 if keys is None else keys.shape[0], p["penalty"])


_packs: OrderedDict = OrderedDict()


def _cached(tabs, n_vocab: int, r_top: int, penalty: float):
    """``(pack_tables(...), its _ScanTables)``, kept per table object: an
    entry holds ``tabs`` weakly (a new object at a freed one's address is
    another decoder) with the scalars it was packed for."""
    key = (id(tabs), int(n_vocab), int(r_top), float(penalty))
    hit = _packs.get(key)
    if hit is not None and hit[0]() is tabs:
        _packs.move_to_end(key)
        return hit[1], hit[2]
    packed = pack_tables(tabs, n_vocab, r_top, penalty)
    entry = (weakref.ref(tabs), packed, _struct(packed))
    _packs[key] = entry
    _packs.move_to_end(key)
    while len(_packs) > _CACHE_SIZE:
        _packs.popitem(last=False)
    return entry[1], entry[2]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``decoder_scan.cu``."""
    lib.decoder_scan_exact.argtypes = [ctypes.POINTER(_ScanTables)] \
        + [_P] * 10 + [_I] * 4 + [_P]
    lib.decoder_scan_carry_in_smem.argtypes = [_I, _I, _I]
    for fn in (lib.decoder_scan_exact, lib.decoder_scan_carry_in_smem,
               lib.decoder_scan_max_states, lib.decoder_scan_max_w,
               lib.decoder_scan_max_r):
        fn.restype = ctypes.c_int
    for fn in (lib.decoder_scan_max_states, lib.decoder_scan_max_w,
               lib.decoder_scan_max_r):
        fn.argtypes = []
    lib.decoder_scan_error_string.argtypes = [_I]
    lib.decoder_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("decoder_scan"))


def carry_in_smem(n_nodes: int, n_states: int, n_senones: int) -> bool:
    """Whether the kernel keeps the carry of this lexicon in shared memory
    (else it runs the device-memory instantiation)."""
    return bool(_lib().decoder_scan_carry_in_smem(n_nodes, n_states,
                                                  n_senones))


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


def decoder_scan_cuda(tabs, carry, scores: torch.Tensor, t0: int, n_valid,
                      *, n_vocab: int, r_top: int, penalty: float):
    """Every frame of ``scores`` ``[B, Tc, S]`` (float32; the first frame's
    absolute index is ``t0``) through the exact search, from ``carry`` =
    ``(deltas [B, N, Ns] float32, ctx [B, N, Ns] int32)``; frames at or past
    ``n_valid`` ``[B]`` are frozen.  Returns ``((deltas, ctx), tb_prev,
    tb_word)``, the rows ``[B, Tc]`` int32 (-1 where no word), as
    ``DeviceBeamDecoder._scan``'s plain loop does."""
    deltas, ctx = carry
    dev = scores.device
    if scores.ndim != 3:
        raise ValueError(f"scores has shape {tuple(scores.shape)}, "
                         "expected (B, Tc, S)")
    b, t_c, s = scores.shape
    n, n_s, w = tabs.bands.shape
    _check("scores", scores, dev, torch.float32, (b, t_c, s))
    _check("deltas", deltas, dev, torch.float32, (b, n, n_s))
    _check("ctx", ctx, dev, torch.int32, (b, n, n_s))
    _check("bands", tabs.bands, dev, torch.float32, (n, n_s, w))
    if not 0 <= t0 < 2**31:
        raise ValueError(f"frame offset t0={t0} outside int32")
    if not scores.is_cuda:
        raise ValueError("decoder_scan_cuda takes CUDA tensors; "
                         "DeviceBeamDecoder._scan runs the plain loop on "
                         "the CPU")
    lib = _lib()
    if n_s > lib.decoder_scan_max_states() or w > lib.decoder_scan_max_w():
        raise ValueError(f"{n_s} token states of band width {w} exceed the "
                         f"kernel's {lib.decoder_scan_max_states()} / "
                         f"{lib.decoder_scan_max_w()}")
    if not 1 <= r_top <= min(lib.decoder_scan_max_r(),
                             tabs.node_slot.shape[0]):
        raise ValueError(f"r_top={r_top} outside [1, min(16, slots)]")
    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid.to(device=dev, dtype=torch.int32)
    else:
        n_valid = torch.as_tensor(np.asarray(n_valid, np.int64)
                                  .clip(-1, 2**31 - 1).astype(np.int32),
                                  device=dev)
    n_valid = n_valid.contiguous()
    _check("n_valid", n_valid, dev, torch.int32, (b,))
    packed, struct = _cached(tabs, n_vocab, r_top, penalty)
    d_out = torch.empty_like(deltas)
    c_out = torch.empty_like(ctx)
    tb_prev = torch.empty((b, t_c), dtype=torch.int32, device=dev)
    tb_word = torch.empty((b, t_c), dtype=torch.int32, device=dev)
    if b == 0 or t_c == 0:
        return (deltas.clone(), ctx.clone()), tb_prev, tb_word
    ex = exc = None
    if not lib.decoder_scan_carry_in_smem(n, n_s, s):
        ex = torch.empty((b, n), dtype=torch.float32, device=dev)
        exc = torch.empty((b, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.decoder_scan_exact(
            ctypes.byref(struct), scores.data_ptr(), n_valid.data_ptr(),
            deltas.data_ptr(), ctx.data_ptr(), d_out.data_ptr(),
            c_out.data_ptr(), None if ex is None else ex.data_ptr(),
            None if exc is None else exc.data_ptr(), tb_prev.data_ptr(),
            tb_word.data_ptr(), b, t_c, s, int(t0),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("decoder_scan kernel launch failed: "
                           + lib.decoder_scan_error_string(rc).decode())
    decoder_scan_cuda.launches += 1
    return (d_out, c_out), tb_prev, tb_word


decoder_scan_cuda.launches = 0
