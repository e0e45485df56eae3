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
when the kernel does not launch.  Any token-state count, band width and
bank size launches: the source chooses among eight instantiations (states
in registers or in place in the carry; carry and scores rows in shared or
device memory), see :func:`states_in_regs`, :func:`carry_in_smem` and
:func:`rows_in_smem`.

The same source holds the device decoder's n-best, wrapped by
:func:`decoder_finalize_cuda`.  That kernel replaces ``finalize`` of
``DeviceBeamDecoder._build_finalize`` (``FINALIZE_REPLACES``) and its
pointer chase, a ``lax.scan`` of ``max_words - 1`` steps.  One launch takes
every utterance of a decode call or a stream result from its final carry
and traceback rows to ``(seqs [B, C, L] int32, scores [B, C] float32)``;
its plain version is :meth:`poccala_tpu_torch.decoder.device.
DeviceBeamDecoder._finalize_plain`, which ``DeviceBeamDecoder._finalize``
runs for a CPU tensor.  The two agree bit for bit.  It uses the frame
scan's packed tables and raises as the frame scan's wrapper does.

The block-pruned search's frame scan is the same source's
``decoder_scan_pruned``, wrapped by :func:`decoder_scan_pruned_cuda`.  It
replaces ``step_pruned`` of ``make_pruned`` (``PRUNED_REPLACES``) under the
same ``lax.scan`` loops: one launch runs every frame of a pruned decode call
or stream chunk for every utterance, on the compact carry ``(kb, d_act,
c_act, entry, entry_ctx)``; its plain version is :meth:`poccala_tpu_torch.
decoder.device.DeviceBeamDecoder._step_pruned` in a loop over frames
(``_scan_plain``).  The two agree bit for bit.  Beside the frame scan's
packed tables it takes each block's slot range (:func:`pack_pruned_tables`,
cached the same way); :func:`tables_placement` says which parts the kernel
keeps in shared memory for a shape.
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
FINALIZE_REPLACES = "poccala_tpu/decoder/device.py:638-692"
PRUNED_REPLACES = "poccala_tpu/decoder/device.py:500"
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


def _memo(cache: OrderedDict, key: tuple, tabs, build):
    """``build()``'s value, kept in ``cache`` under ``(id(tabs), *key)``,
    the last :data:`_CACHE_SIZE` used: an entry holds ``tabs`` weakly (a new
    object at a freed one's address is another decoder)."""
    key = (id(tabs), *key)
    hit = cache.get(key)
    if hit is not None and hit[0]() is tabs:
        cache.move_to_end(key)
        return hit[1]
    value = build()
    cache[key] = (weakref.ref(tabs), value)
    while len(cache) > _CACHE_SIZE:
        cache.popitem(last=False)
    return value


def _cached(tabs, n_vocab: int, r_top: int, penalty: float):
    """``(pack_tables(...), its _ScanTables)``, kept per table object with
    the scalars it was packed for."""
    def build():
        packed = pack_tables(tabs, n_vocab, r_top, penalty)
        return packed, _struct(packed)
    return _memo(_packs, (int(n_vocab), int(r_top), float(penalty)), tabs,
                 build)


class _PrunedTables(ctypes.Structure):
    """``struct PrunedTables`` of ``csrc/decoder_scan.cu``."""

    _fields_ = [(name, _P) for name in (
        "slot_ptr", "node_group", "group_senone")] + [
            (name, ctypes.c_int32) for name in (
                "block_size", "n_active", "n_blocks", "n_groups")]


class _PrunedIO(ctypes.Structure):
    """``struct PrunedIO`` of ``csrc/decoder_scan.cu``: the pruned scan's
    operands, results and scratch, in its order."""

    _fields_ = [(name, _P) for name in (
        "scores", "n_valid", "kb_in", "d_in", "c_in", "e_in", "ec_in",
        "kb_out", "d_out", "c_out", "e_out", "ec_out", "d_work", "c_work",
        "ex", "exc", "meta", "la", "tb_prev", "tb_word", "clocks")]


def pack_pruned_tables(tabs, block_size: int, n_active: int) -> dict:
    """The pruned scan's tables beside :func:`pack_tables`: ``slot_ptr``
    ``[n_blocks + 1]`` int32 (block ``j``'s slots are ``slot_ptr[j]`` up to
    ``slot_ptr[j + 1]``: the slots are in node order, so each block's are
    one range); ``group_senone`` ``[G, Ns]`` int32, the distinct rows of the
    senone table (-1 where a state does not emit: one per unit, and the
    dead rows), and ``node_group`` ``[N]`` int32, each node's row of it (the
    lookahead's best score is computed once per row); the block size, the
    active block count K, the block count and G; on the tables' device."""
    n = int(tabs.bands.shape[0])
    blk, k = int(block_size), int(n_active)
    if blk < 1 or n % blk:
        raise ValueError(f"{n} nodes are not a multiple of block_size={blk}")
    n_blocks = n // blk
    if not 1 <= k <= n_blocks:
        raise ValueError(f"active_blocks={k} outside [1, {n_blocks}]")
    node_slot = tabs.node_slot
    if bool((node_slot[1:] < node_slot[:-1]).any()):
        raise ValueError("the word slots are not in node order")
    starts = torch.arange(n_blocks + 1, device=node_slot.device,
                          dtype=node_slot.dtype) * blk
    slot_ptr = torch.searchsorted(node_slot.contiguous(), starts)
    senone = torch.where(tabs.emitting, tabs.senone, -1).to(torch.int32)
    rows, node_group = torch.unique(senone, dim=0, return_inverse=True)
    return dict(slot_ptr=slot_ptr.to(torch.int32).contiguous(),
                node_group=node_group.to(torch.int32).contiguous(),
                group_senone=rows.contiguous(), block_size=blk, n_active=k,
                n_blocks=n_blocks, n_groups=int(rows.shape[0]))


def _pruned_struct(p: dict) -> _PrunedTables:
    return _PrunedTables(*(p[name].data_ptr() for name in (
        "slot_ptr", "node_group", "group_senone")),
        p["block_size"], p["n_active"], p["n_blocks"], p["n_groups"])


_pruned_packs: OrderedDict = OrderedDict()


def _cached_pruned(tabs, block_size: int, n_active: int):
    """``(pack_pruned_tables(...), its _PrunedTables)``, kept per table
    object as :func:`_cached` keeps the frame scan's."""
    def build():
        packed = pack_pruned_tables(tabs, block_size, n_active)
        return packed, _pruned_struct(packed)
    return _memo(_pruned_packs, (int(block_size), int(n_active)), tabs, build)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``decoder_scan.cu``:
    the frame scan, the n-best (``decoder_finalize``) and the pruned scan
    (``decoder_scan_pruned``)."""
    lib.decoder_scan_exact.argtypes = [ctypes.POINTER(_ScanTables)] \
        + [_P] * 10 + [_I] * 4 + [_P]
    lib.decoder_finalize.argtypes = [ctypes.POINTER(_ScanTables)] \
        + [_P] * 7 + [_I] * 5 + [_P]
    lib.decoder_scan_pruned.argtypes = [
        ctypes.POINTER(_ScanTables), ctypes.POINTER(_PrunedTables),
        ctypes.POINTER(_PrunedIO)] + [_I] * 4 + [_P]
    lib.decoder_pruned_smem.argtypes = [_I] * 6
    lib.decoder_pruned_phases.argtypes = []
    for fn in (lib.decoder_scan_carry_in_smem, lib.decoder_scan_rows_in_smem):
        fn.argtypes = [_I, _I, _I]
    lib.decoder_scan_states_in_regs.argtypes = [_I, _I]
    lib.decoder_scan_max_r.argtypes = []
    for fn in (lib.decoder_finalize_rows_in_smem,
               lib.decoder_finalize_ac_in_smem):
        fn.argtypes = [_I] * 4
    for fn in (lib.decoder_scan_exact, lib.decoder_scan_carry_in_smem,
               lib.decoder_scan_rows_in_smem, lib.decoder_scan_states_in_regs,
               lib.decoder_scan_max_r, lib.decoder_finalize,
               lib.decoder_finalize_rows_in_smem,
               lib.decoder_finalize_ac_in_smem, lib.decoder_scan_pruned,
               lib.decoder_pruned_smem, lib.decoder_pruned_phases):
        fn.restype = ctypes.c_int
    lib.decoder_scan_error_string.argtypes = [_I]
    lib.decoder_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("decoder_scan"))


def carry_in_smem(n_nodes: int, n_states: int, n_senones: int) -> bool:
    """Whether the kernel keeps the carry of this lexicon in shared memory
    (else it runs a device-memory instantiation)."""
    return bool(_lib().decoder_scan_carry_in_smem(n_nodes, n_states,
                                                  n_senones))


def rows_in_smem(n_nodes: int, n_states: int, n_senones: int) -> bool:
    """Whether the kernel stages each frame's scores row in shared memory
    (else it reads the row from device memory: banks past ~28,900
    senones)."""
    return bool(_lib().decoder_scan_rows_in_smem(n_nodes, n_states,
                                                 n_senones))


def states_in_regs(n_states: int, band_w: int) -> bool:
    """Whether a node's states live in registers (``Ns <= 16`` and
    ``W <= 8``; else the advance runs in place in the carry)."""
    return bool(_lib().decoder_scan_states_in_regs(n_states, band_w))


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


def _n_valid(n_valid, dev, b: int) -> torch.Tensor:
    """The valid frame counts ``[B]`` as a contiguous int32 tensor on
    ``dev`` (values clipped into int32)."""
    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid.to(device=dev, dtype=torch.int32)
    else:
        n_valid = torch.as_tensor(np.asarray(n_valid, np.int64)
                                  .clip(-1, 2**31 - 1).astype(np.int32),
                                  device=dev)
    n_valid = n_valid.contiguous()
    _check("n_valid", n_valid, dev, torch.int32, (b,))
    return n_valid


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
    if not 1 <= r_top <= min(lib.decoder_scan_max_r(),
                             tabs.node_slot.shape[0]):
        raise ValueError(f"r_top={r_top} outside [1, min(16, slots)]")
    n_valid = _n_valid(n_valid, dev, b)
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


def finalize_sizes(n_slots: int, n_cand: int) -> tuple[int, int]:
    """``(C, R)``: the candidates kept, ``min(n_cand, Q)``, and the
    acoustic ones ranked before the LM, ``min(Q, max(32, 2 C))``, as
    ``_finalize_plain`` takes them."""
    c = min(int(n_cand), int(n_slots))
    return c, min(int(n_slots), max(32, 2 * c))


def finalize_rows_in_smem(n_slots: int, n_frames: int, n_cand: int) -> bool:
    """Whether the kernel stages an utterance's traceback rows in shared
    memory (else its chase reads them from device memory)."""
    c, r = finalize_sizes(n_slots, n_cand)
    return bool(_lib().decoder_finalize_rows_in_smem(n_slots, n_frames, c,
                                                     r))


def decoder_finalize_cuda(tabs, carry, tb_prev: torch.Tensor,
                          tb_word: torch.Tensor, n_cand: int, *,
                          n_vocab: int, r_top: int, penalty: float,
                          max_words: int):
    """The n-best of the full carry ``(deltas [B, N, Ns] float32, ctx
    [B, N, Ns] int32)`` over the traceback rows ``tb_prev`` / ``tb_word``
    ``[B, T]`` int32: ``(seqs [B, C, max_words] int32, scores [B, C]
    float32)`` with ``C = min(n_cand, Q)``, as
    ``DeviceBeamDecoder._finalize_plain`` computes them.  ``n_vocab``,
    ``r_top`` and ``penalty`` select the frame scan's packed tables."""
    deltas, ctx = carry
    dev = deltas.device
    if deltas.ndim != 3 or tb_prev.ndim != 2:
        raise ValueError(f"deltas {tuple(deltas.shape)} and tb_prev "
                         f"{tuple(tb_prev.shape)}: expected (B, N, Ns) and "
                         "(B, T)")
    b, t = tb_prev.shape
    n, n_s, w = tabs.bands.shape
    _check("deltas", deltas, dev, torch.float32, (b, n, n_s))
    _check("ctx", ctx, dev, torch.int32, (b, n, n_s))
    _check("tb_prev", tb_prev, dev, torch.int32, (b, t))
    _check("tb_word", tb_word, dev, torch.int32, (b, t))
    _check("bands", tabs.bands, dev, torch.float32, (n, n_s, w))
    if not deltas.is_cuda:
        raise ValueError("decoder_finalize_cuda takes CUDA tensors; "
                         "DeviceBeamDecoder._finalize runs the plain "
                         "version on the CPU")
    if max_words < 1 or n_cand < 1:
        raise ValueError(f"max_words={max_words} and n_cand={n_cand} must "
                         "be positive")
    q = int(tabs.node_slot.shape[0])
    c, r = finalize_sizes(q, n_cand)
    lib = _lib()
    _, struct = _cached(tabs, n_vocab, r_top, penalty)
    seqs = torch.empty((b, c, max_words), dtype=torch.int32, device=dev)
    scores = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0:
        return seqs, scores
    ac = None
    if not lib.decoder_finalize_ac_in_smem(q, t, c, r):
        ac = torch.empty((b, q), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.decoder_finalize(
            ctypes.byref(struct), deltas.data_ptr(), ctx.data_ptr(),
            tb_prev.data_ptr(), tb_word.data_ptr(),
            None if ac is None else ac.data_ptr(), seqs.data_ptr(),
            scores.data_ptr(), b, t, c, r, int(max_words),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("decoder_finalize kernel launch failed: "
                           + lib.decoder_scan_error_string(rc).decode())
    decoder_finalize_cuda.launches += 1
    return seqs, scores


decoder_finalize_cuda.launches = 0


PLACES = ("rows", "meta", "lookahead", "exits", "entry", "carry")
# the pruned scan's traced phases, in its order (``phase_clocks``)
PRUNED_PHASES = ("entry_and_row_wait", "lookahead", "top_k_and_remap",
                 "advance", "emission_passes", "emission_totals")


def pruned_placement(n_nodes: int, n_states: int, n_senones: int,
                     n_active: int, block_size: int, n_groups: int,
                     lib=None) -> dict:
    """Where the pruned scan keeps each part for this shape, ``{part: True
    for shared memory, False for device memory}`` over :data:`PLACES`: the
    two scores rows, the block arrays, the senone groups' lookahead, the
    active nodes' exits, the entry row, the compact carry (``lib``: a bound
    library other than the built one)."""
    bits = (lib or _lib()).decoder_pruned_smem(n_nodes, n_states, n_senones,
                                               n_active, block_size, n_groups)
    return {name: bool(bits >> i & 1) for i, name in enumerate(PLACES)}


def tables_placement(tabs, n_senones: int, n_active: int, block_size: int,
                     lib=None) -> dict:
    """:func:`pruned_placement` for the decoder's tables ``tabs`` (their
    senone groups counted by :func:`pack_pruned_tables`)."""
    n, n_s, _ = tabs.bands.shape
    packed, _ = _cached_pruned(tabs, block_size, n_active)
    return pruned_placement(n, n_s, n_senones, n_active, block_size,
                            packed["n_groups"], lib)


def pruned_operands(tabs, carry, scores: torch.Tensor, n_valid, *,
                    block_size: int, n_groups: int,
                    placement: dict) -> tuple[dict, dict]:
    """The pruned scan's checked operands and its new outputs and scratch,
    as ``(tensors by _PrunedIO field, results)``: ``results`` holds
    ``carry`` (the new ``(kb, d_act, c_act, entry, entry_ctx)``),
    ``tb_prev`` and ``tb_word``.  Scratch is allocated only for the parts
    ``placement`` keeps out of shared memory."""
    kb, d_act, c_act, entry, entry_ctx = carry
    dev = scores.device
    b, t_c, s = scores.shape
    n, n_s, w = tabs.bands.shape
    k, blk = kb.shape[1], int(block_size)
    _check("scores", scores, dev, torch.float32, (b, t_c, s))
    _check("kb", kb, dev, torch.int64, (b, k))
    _check("d_act", d_act, dev, torch.float32, (b, k, blk, n_s))
    _check("c_act", c_act, dev, torch.int32, (b, k, blk, n_s))
    _check("entry", entry, dev, torch.float32, (b, n))
    _check("entry_ctx", entry_ctx, dev, torch.int32, (b, n))
    _check("bands", tabs.bands, dev, torch.float32, (n, n_s, w))
    ops = dict(scores=scores, n_valid=_n_valid(n_valid, dev, b), kb_in=kb,
               d_in=d_act, c_in=c_act, e_in=entry, ec_in=entry_ctx)
    out = (torch.empty_like(kb), torch.empty_like(d_act),
           torch.empty_like(c_act), torch.empty_like(entry),
           torch.empty_like(entry_ctx))
    ops.update(zip(("kb_out", "d_out", "c_out", "e_out", "ec_out"), out))
    ops["tb_prev"], ops["tb_word"] = (
        torch.empty((b, t_c), dtype=torch.int32, device=dev)
        for _ in range(2))
    if not placement["carry"]:
        ops["d_work"] = torch.empty_like(d_act)
        ops["c_work"] = torch.empty_like(c_act)
    if not placement["exits"]:
        ops["ex"] = torch.empty((b, k * blk), dtype=torch.float32,
                                device=dev)
        ops["exc"] = torch.empty((b, k * blk), dtype=torch.int32,
                                 device=dev)
    if not placement["meta"]:
        ops["meta"] = torch.empty((b, 2 * (n // blk) + 6 * k),
                                  dtype=torch.int32, device=dev)
    if not placement["lookahead"]:
        ops["la"] = torch.empty((b, n_groups), dtype=torch.float32,
                                device=dev)
    return ops, dict(carry=out, tb_prev=ops["tb_prev"],
                     tb_word=ops["tb_word"])


def _io(ops: dict) -> _PrunedIO:
    return _PrunedIO(*(None if ops.get(name) is None
                       else ops[name].data_ptr()
                       for name, _ in _PrunedIO._fields_))


def decoder_scan_pruned_cuda(tabs, carry, scores: torch.Tensor, t0: int,
                             n_valid, *, n_vocab: int, r_top: int,
                             penalty: float, block_size: int,
                             phase_clocks: torch.Tensor | None = None):
    """Every frame of ``scores`` ``[B, Tc, S]`` (float32; the first frame's
    absolute index is ``t0``) through the block-pruned search, from the
    compact ``carry`` = ``(kb [B, K] int64, d_act [B, K, block_size, Ns]
    float32, c_act int32, entry [B, N] float32, entry_ctx [B, N] int32)``;
    frames at or past ``n_valid`` ``[B]`` are frozen.  Returns ``(carry,
    tb_prev, tb_word)``, the rows ``[B, Tc]`` int32 (-1 where no word), as
    ``DeviceBeamDecoder._scan_plain`` does with ``_step_pruned``.
    ``phase_clocks`` (int64 ``[len(PRUNED_PHASES)]`` on the card), where
    given, has the first utterance's SM cycles in each phase of
    :data:`PRUNED_PHASES` added to it."""
    if scores.ndim != 3 or carry[0].ndim != 2:
        raise ValueError(f"scores {tuple(scores.shape)} and kb "
                         f"{tuple(carry[0].shape)}: expected (B, Tc, S) and "
                         "(B, K)")
    b, t_c, s = scores.shape
    n, n_s, _ = tabs.bands.shape
    k = carry[0].shape[1]
    blk = int(block_size)
    if blk < 1 or n % blk or not 1 <= k <= n // blk:
        raise ValueError(f"{n} nodes in blocks of {blk} with {k} active: "
                         "expected a block multiple and 1 <= K <= blocks")
    packed, pstruct = _cached_pruned(tabs, blk, k)
    if scores.is_cuda:
        placement = tables_placement(tabs, s, k, blk)
    else:   # the checks below raise for a CPU tensor
        placement = dict.fromkeys(PLACES, True)
    ops, res = pruned_operands(tabs, carry, scores, n_valid, block_size=blk,
                               n_groups=packed["n_groups"],
                               placement=placement)
    if not 0 <= t0 < 2**31:
        raise ValueError(f"frame offset t0={t0} outside int32")
    if not scores.is_cuda:
        raise ValueError("decoder_scan_pruned_cuda takes CUDA tensors; "
                         "DeviceBeamDecoder._scan runs the plain loop on "
                         "the CPU")
    lib = _lib()
    if not 1 <= r_top <= min(lib.decoder_scan_max_r(),
                             tabs.node_slot.shape[0]):
        raise ValueError(f"r_top={r_top} outside [1, min(16, slots)]")
    if phase_clocks is not None:
        _check("phase_clocks", phase_clocks, scores.device, torch.int64,
               (lib.decoder_pruned_phases(),))
        ops["clocks"] = phase_clocks
    if b == 0 or t_c == 0:
        return tuple(a.clone() for a in carry), res["tb_prev"], \
            res["tb_word"]
    _, struct = _cached(tabs, n_vocab, r_top, penalty)
    dev = scores.device
    with torch.cuda.device(dev):
        rc = lib.decoder_scan_pruned(
            ctypes.byref(struct), ctypes.byref(pstruct),
            ctypes.byref(_io(ops)), b, t_c, s, int(t0),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("decoder_scan_pruned kernel launch failed: "
                           + lib.decoder_scan_error_string(rc).decode())
    decoder_scan_pruned_cuda.launches += 1
    return res["carry"], res["tb_prev"], res["tb_word"]


decoder_scan_pruned_cuda.launches = 0
