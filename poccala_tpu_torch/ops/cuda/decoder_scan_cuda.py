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
group tables (the emitting mask folded into ``group_senone``, -1 where
not emitting) and each node's info (group, parent and root-child flag in
one word, valid slot range).  CUDA tensors only: the
wrapper raises on a CPU tensor and on an operand of the wrong dtype, and
when the kernel does not launch.  Any token-state count, band width and
bank size launches: the source chooses among ten instantiations (states
in registers, unrolled to 8 states and 2 offsets or, on chip, 16 and 8,
or in place in the carry; carry and scores rows in shared or device
memory) and the CTAs an utterance takes: on chip one, or a thread-block
cluster of up to 16 whose distributed shared memory holds the carry; past
that (the device-memory route) a cluster of the size that runs the batch
in the fewest waves times nodes a CTA, each CTA keeping its nodes' info,
exits and what fits of their carry in shared memory and the rest of the
carry in a scratch the wrapper allocates; see :func:`scan_plan` and
:func:`states_in_regs`.  The tables it
reads by group (:func:`pack_tables`): each node's band and senone rows are
one of a few hundred distinct pairs, staged in shared memory.

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
cached the same way): per lexicon block the distinct groups of its root
children and of its other nodes, and each node's children, so that a
frame reads what changed instead of every node; :func:`tables_placement`
says which parts the kernel keeps in shared memory for a shape.
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
        "bands", "node_slot", "word_slot", "slot_valid", "lm_flat", "lm_uni", "lm_rboff", "lm_cbase", "lm_keys",
        "lm_vals", "node_info", "group_senone", "group_bands")] + [
            (name, ctypes.c_int32) for name in (
                "n_nodes", "n_states", "band_w", "n_slots", "n_vocab",
                "r_top", "lm_mode", "lm_n_keys", "n_groups")] + [
                    ("penalty", ctypes.c_float)]
_N_PTRS = 13


def group_tables(tabs) -> dict:
    """Each node's group, the distinct (senone row, band row) pair it has:
    ``group_senone`` ``[G, Ns]`` int32 (-1 where a state does not emit),
    ``group_bands`` ``[G, Ns, W]`` float32 and ``node_group`` ``[N]`` int32,
    in NumPy (``group_senone[node_group]`` is the senone table and
    ``group_bands[node_group]`` the band table, exactly)."""
    senone = torch.where(tabs.emitting, tabs.senone, -1).cpu().numpy()
    bands = tabs.bands.cpu().numpy()
    n = senone.shape[0]
    # a node's two rows as one row of bytes: equal rows, equal bytes
    key = np.concatenate([senone.astype(np.int32).view(np.uint8)
                          .reshape(n, -1),
                          np.ascontiguousarray(bands).view(np.uint8)
                          .reshape(n, -1)], axis=1)
    _, first, group = np.unique(key, axis=0, return_index=True,
                                return_inverse=True)
    return dict(group_senone=senone[first].astype(np.int32),
                group_bands=bands[first],
                node_group=group.reshape(-1).astype(np.int32))


def node_info(tabs, node_group: np.ndarray) -> np.ndarray:
    """``[N, 4]`` int32: each node's group, its parent word (bit 0 the
    root-child flag, bit 1 "has a parent", bits 2 up the parent, 0 where
    none), its first valid word slot and its valid slot count (the slots
    are in node order; a node's valid slots are one range)."""
    node_slot = tabs.node_slot.cpu().numpy()
    if (np.diff(node_slot) < 0).any():
        raise ValueError("the word slots are not in node order")
    # the valid slots' indices, padded so that an empty range indexes too
    valid = np.append(np.nonzero(tabs.slot_valid.cpu().numpy())[0], 0)
    nodes = np.arange(node_group.shape[0])
    lo = np.searchsorted(node_slot[valid[:-1]], nodes, side="left")
    hi = np.searchsorted(node_slot[valid[:-1]], nodes, side="right")
    count = hi - lo
    first = np.where(count > 0, valid[lo], 0)
    if (valid[np.maximum(hi - 1, 0)] - first != count - 1)[count > 0].any():
        raise ValueError("a node's valid word slots are not one range")
    has = tabs.has_parent.cpu().numpy()
    word = (tabs.is_root_child.cpu().numpy().astype(np.int64)
            | has.astype(np.int64) << 1
            | np.where(has, tabs.parent.cpu().numpy(), 0) << 2)
    return np.stack([node_group, word, first, count], 1).astype(np.int32)


def pack_tables(tabs, n_vocab: int, r_top: int, penalty: float) -> dict:
    """The kernel's operands from the decoder's ``_Tables``, on the tables'
    device: contiguous tensors, int32 indices and uint8 flags, the LM in its
    form (``lm_mode``), ``r_top`` candidates and the constant LM term
    ``penalty`` (``-word_penalty``) as float32, the group tables
    (:func:`group_tables`) and each node's info (:func:`node_info`)."""
    i32, u8, f32 = torch.int32, torch.uint8, torch.float32
    n = int(tabs.bands.shape[0])
    if n >= 2**22:
        raise ValueError(f"{n} nodes: the parent word holds fewer than "
                         "2**22")
    packed = dict(
        bands=tabs.bands.to(f32).contiguous(),
        node_slot=tabs.node_slot.to(i32).contiguous(),
        word_slot=tabs.word_slot.to(i32).contiguous(),
        slot_valid=tabs.slot_valid.to(u8).contiguous(),
        n_vocab=int(n_vocab), r_top=int(r_top),
        penalty=float(np.float32(penalty)), lm_mode=LM_NONE,
        **_grouped(tabs),
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
        *(ptr(name) for name, _ in _ScanTables._fields_[:_N_PTRS]),
        n, ns, w, p["node_slot"].shape[0], p["n_vocab"], p["r_top"],
        p["lm_mode"], 0 if keys is None else keys.shape[0],
        p["group_senone"].shape[0], p["penalty"])


_packs: OrderedDict = OrderedDict()
_groups: OrderedDict = OrderedDict()


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


def _grouped(tabs) -> dict:
    """``node_info``, ``group_senone`` and ``group_bands`` on the tables'
    device, kept per table object."""
    def build():
        groups = group_tables(tabs)
        dev = tabs.bands.device
        return dict(node_info=torch.as_tensor(
            node_info(tabs, groups["node_group"]), device=dev),
            group_senone=torch.as_tensor(groups["group_senone"], device=dev),
            group_bands=torch.as_tensor(groups["group_bands"], device=dev))
    return _memo(_groups, (), tabs, build)


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
        "rc_ptr", "rc_group", "dead_ptr", "dead_group", "src_ptr",
        "src_block", "seg_ptr", "flow_par", "flow_grp")] + [
            (name, ctypes.c_int32) for name in (
                "block_size", "n_active", "n_blocks")]


class _PrunedIO(ctypes.Structure):
    """``struct PrunedIO`` of ``csrc/decoder_scan.cu``: the pruned scan's
    operands, results and scratch, in its order."""

    _fields_ = [(name, _P) for name in (
        "scores", "n_valid", "kb_in", "d_in", "c_in", "e_in", "ec_in",
        "kb_out", "d_out", "c_out", "e_out", "ec_out", "d_work", "c_work",
        "ex", "exc", "meta", "la", "tb_prev", "tb_word", "clocks")]


def _csr(keys: np.ndarray, values: np.ndarray, n_keys: int):
    """``(ptr [n_keys + 1], values sorted by key)`` as int32, each key's
    values in ascending order."""
    order = np.lexsort((values, keys))
    ptr = np.searchsorted(keys[order], np.arange(n_keys + 1))
    return ptr.astype(np.int32), values[order].astype(np.int32)


def pack_pruned_tables(tabs, block_size: int, n_active: int) -> dict:
    """The pruned scan's tables beside :func:`pack_tables`, on the tables'
    device: per lexicon block ``j`` the distinct groups (of
    :func:`group_tables`) of its root children, ``rc_group[rc_ptr[j] :
    rc_ptr[j + 1]]``, and of its other nodes, ``dead_group[dead_ptr[j] :
    dead_ptr[j + 1]]`` (int32, ascending); its nodes that have a parent,
    by the parent's block ``a``: segments ``g`` in ``src_ptr[j] :
    src_ptr[j + 1]`` with ``src_block[g] = a``, each holding the edges
    ``seg_ptr[g] : seg_ptr[g + 1]``, an edge the parent's index in its
    block (``flow_par``) and the child's group (``flow_grp``); the block
    size, the active block count K and the block count."""
    n = int(tabs.bands.shape[0])
    blk, k = int(block_size), int(n_active)
    if blk < 1 or n % blk:
        raise ValueError(f"{n} nodes are not a multiple of block_size={blk}")
    n_blocks = n // blk
    if not 1 <= k <= n_blocks:
        raise ValueError(f"active_blocks={k} outside [1, {n_blocks}]")
    group = _grouped(tabs)["node_info"][:, 0].cpu().numpy()
    rc = tabs.is_root_child.cpu().numpy()
    block = np.arange(n) // blk
    out = dict(block_size=blk, n_active=k, n_blocks=n_blocks)
    for name, sel in (("rc", rc), ("dead", ~rc)):
        pairs = np.unique(np.stack([block[sel], group[sel]], 1), axis=0)
        out[f"{name}_ptr"], out[f"{name}_group"] = _csr(
            pairs[:, 0], pairs[:, 1], n_blocks)
    child = np.nonzero(tabs.has_parent.cpu().numpy())[0]
    par = tabs.parent.cpu().numpy()[child]
    order = np.lexsort((child, par // blk, child // blk))
    child, par = child[order], par[order]
    key = (child // blk) * n_blocks + par // blk     # (block, parent block)
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]][:len(key)])
    out["src_ptr"] = np.searchsorted(key[starts] // n_blocks,
                                     np.arange(n_blocks + 1)).astype(np.int32)
    out["src_block"] = (key[starts] % n_blocks).astype(np.int32)
    out["seg_ptr"] = np.r_[starts, len(child)].astype(np.int32)
    out["flow_par"] = (par % blk).astype(np.int32)
    out["flow_grp"] = group[child].astype(np.int32)
    dev = tabs.bands.device
    for name in PRUNED_TABLES:
        # an empty list still needs an address
        a = out[name] if out[name].size else np.zeros(1, np.int32)
        out[name] = torch.as_tensor(a, device=dev)
    return out


PRUNED_TABLES = ("rc_ptr", "rc_group", "dead_ptr", "dead_group", "src_ptr",
                 "src_block", "seg_ptr", "flow_par", "flow_grp")


def _pruned_struct(p: dict) -> _PrunedTables:
    return _PrunedTables(*(p[name].data_ptr() for name in PRUNED_TABLES),
                         p["block_size"], p["n_active"], p["n_blocks"])


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
        + [_P] * 10 + [_I] * 4 + [_P, _P]
    lib.decoder_finalize.argtypes = [ctypes.POINTER(_ScanTables)] \
        + [_P] * 7 + [_I] * 5 + [_P]
    lib.decoder_scan_pruned.argtypes = [
        ctypes.POINTER(_ScanTables), ctypes.POINTER(_PrunedTables),
        ctypes.POINTER(_PrunedIO)] + [_I] * 4 + [_P]
    lib.decoder_pruned_smem.argtypes = [_I] * 8
    lib.decoder_pruned_phases.argtypes = []
    lib.decoder_exact_phases.argtypes = []
    lib.decoder_scan_plan.argtypes = [ctypes.POINTER(_ScanTables), _I, _I,
                                      ctypes.POINTER(ctypes.c_longlong)]
    lib.decoder_scan_states_in_regs.argtypes = [_I, _I]
    lib.decoder_scan_max_r.argtypes = []
    for fn in (lib.decoder_finalize_rows_in_smem,
               lib.decoder_finalize_ac_in_smem):
        fn.argtypes = [_I] * 4
    for fn in (lib.decoder_scan_exact, lib.decoder_scan_plan,
               lib.decoder_scan_states_in_regs,
               lib.decoder_scan_max_r, lib.decoder_finalize,
               lib.decoder_finalize_rows_in_smem,
               lib.decoder_finalize_ac_in_smem, lib.decoder_scan_pruned,
               lib.decoder_pruned_smem, lib.decoder_pruned_phases,
               lib.decoder_exact_phases):
        fn.restype = ctypes.c_int
    lib.decoder_scan_error_string.argtypes = [_I]
    lib.decoder_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("decoder_scan"))


PLAN_FIELDS = ("onchip", "cluster", "nodes_per_cta", "threads", "rows_smem",
               "groups_smem", "smem_bytes", "active_clusters",
               "nodes_on_chip", "exits_smem", "scratch_words")


def scan_plan(tabs, n_senones: int, r_top: int, lib=None,
              batch: int = 1) -> dict:
    """How the exact scan runs these tables (``_Tables``) at ``n_senones``
    with ``r_top`` candidates for ``batch`` utterances, over
    :data:`PLAN_FIELDS`: the carry on chip or in device memory, the CTAs an
    utterance takes (``cluster``: 1, or a thread-block cluster's size), the
    nodes and threads a CTA, the scores rows and the group tables in shared
    memory or not, a CTA's dynamic shared memory, the clusters of that
    shape the card runs at once (CTAs where a device-memory plan's are not
    clustered), the nodes a CTA keeps the carry of in shared memory, the
    nodes' info and exits in shared memory or not, and the scratch words
    (float32 and int32 each) an utterance; ``route`` is ``"smem"`` (one
    CTA), ``"cluster"`` or ``"global"`` (the carry, or part of it, in device
    memory; only there does ``batch`` choose the cluster size) (``lib``: a
    bound library other than the built one, which keeps its plans per
    device and shape)."""
    return _plan_of(_shape_struct(tabs, r_top), n_senones, lib or _lib(),
                    batch)


def _shape_struct(tabs, r_top: int) -> _ScanTables:
    """A ``_ScanTables`` with the shapes and group tables alone: what the
    plan reads."""
    g = _grouped(tabs)
    n, n_s, w = tabs.bands.shape
    return _ScanTables(
        node_info=g["node_info"].data_ptr(),
        group_senone=g["group_senone"].data_ptr(),
        group_bands=g["group_bands"].data_ptr(), n_nodes=n, n_states=n_s,
        band_w=w, n_slots=tabs.node_slot.shape[0], n_vocab=1,
        r_top=int(r_top), n_groups=g["group_senone"].shape[0])


def _plan_of(struct: _ScanTables, n_senones: int, lib, batch: int) -> dict:
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    rc = lib.decoder_scan_plan(ctypes.byref(struct), int(n_senones),
                               int(batch), out)
    if rc == 1:                                    # cudaErrorInvalidValue
        raise ValueError("the exact scan does not take these tables")
    if rc:
        raise RuntimeError("decoder_scan plan failed: "
                           + lib.decoder_scan_error_string(rc).decode())
    plan = dict(zip(PLAN_FIELDS, (int(x) for x in out)))
    for name in ("onchip", "rows_smem", "groups_smem", "exits_smem"):
        plan[name] = bool(plan[name])
    plan["route"] = ("global" if not plan["onchip"] else
                     "smem" if plan["cluster"] == 1 else "cluster")
    return plan


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


# the exact scan's traced phases, in its order (``phase_clocks``)
EXACT_PHASES = ("row_wait", "advance", "emission_passes", "pick", "entry")


def decoder_scan_cuda(tabs, carry, scores: torch.Tensor, t0: int, n_valid,
                      *, n_vocab: int, r_top: int, penalty: float,
                      phase_clocks: torch.Tensor | None = None):
    """Every frame of ``scores`` ``[B, Tc, S]`` (float32; the first frame's
    absolute index is ``t0``) through the exact search, from ``carry`` =
    ``(deltas [B, N, Ns] float32, ctx [B, N, Ns] int32)``; frames at or past
    ``n_valid`` ``[B]`` are frozen.  Returns ``((deltas, ctx), tb_prev,
    tb_word)``, the rows ``[B, Tc]`` int32 (-1 where no word), as
    ``DeviceBeamDecoder._scan``'s plain loop does.  ``phase_clocks``
    (int64 ``[len(EXACT_PHASES)]`` on the card), where given, has the first
    utterance's SM cycles in each phase of :data:`EXACT_PHASES` added to
    it."""
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
    if phase_clocks is not None:
        _check("phase_clocks", phase_clocks, dev, torch.int64,
               (lib.decoder_exact_phases(),))
    packed, struct = _cached(tabs, n_vocab, r_top, penalty)
    d_out = torch.empty_like(deltas)
    c_out = torch.empty_like(ctx)
    tb_prev = torch.empty((b, t_c), dtype=torch.int32, device=dev)
    tb_word = torch.empty((b, t_c), dtype=torch.int32, device=dev)
    if b == 0 or t_c == 0:
        return (deltas.clone(), ctx.clone()), tb_prev, tb_word
    xf = xi = None     # the device-memory route's carry and exits
    plan = _plan_of(struct, s, lib, b)
    if not plan["onchip"] and plan["scratch_words"]:
        xf = torch.empty((b, plan["scratch_words"]), dtype=torch.float32,
                         device=dev)
        xi = torch.empty((b, plan["scratch_words"]), dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        rc = lib.decoder_scan_exact(
            ctypes.byref(struct), scores.data_ptr(), n_valid.data_ptr(),
            deltas.data_ptr(), ctx.data_ptr(), d_out.data_ptr(),
            c_out.data_ptr(), None if xf is None else xf.data_ptr(),
            None if xi is None else xi.data_ptr(), tb_prev.data_ptr(),
            tb_word.data_ptr(), b, t_c, s, int(t0),
            None if phase_clocks is None else phase_clocks.data_ptr(),
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


PLACES = ("rows", "meta", "lookahead", "exits", "carry", "groups")
# the pruned scan's traced phases, in its order (``phase_clocks``)
PRUNED_PHASES = ("entry_and_row_wait", "lookahead", "top_k_and_remap",
                 "advance", "emission_passes", "emission_totals")


def pruned_placement(n_nodes: int, n_states: int, band_w: int,
                     n_senones: int, n_active: int, block_size: int,
                     n_groups: int, r_top: int = 1, lib=None) -> dict:
    """Where the pruned scan keeps each part for this shape, ``{part: True
    for shared memory, False for device memory}`` over :data:`PLACES`: the
    two scores rows, the block arrays, the groups' lookahead, the active
    nodes' exits (two frames'), the compact carry, the group tables
    (``lib``: a bound library other than the built one)."""
    bits = (lib or _lib()).decoder_pruned_smem(
        n_nodes, n_states, band_w, n_senones, n_active, block_size,
        n_groups, r_top)
    return {name: bool(bits >> i & 1) for i, name in enumerate(PLACES)}


def n_groups(tabs) -> int:
    """The distinct (senone row, band row) pairs of the tables' nodes."""
    return int(_grouped(tabs)["group_senone"].shape[0])


def tables_placement(tabs, n_senones: int, n_active: int, block_size: int,
                     r_top: int = 1, lib=None) -> dict:
    """:func:`pruned_placement` for the decoder's tables ``tabs``."""
    n, n_s, w = tabs.bands.shape
    return pruned_placement(n, n_s, w, n_senones, n_active, block_size,
                            n_groups(tabs), r_top, lib)


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
        ops["ex"] = torch.empty((b, 2 * k * blk), dtype=torch.float32,
                                device=dev)
        ops["exc"] = torch.empty((b, 2 * k * blk), dtype=torch.int32,
                                 device=dev)
    if not placement["meta"]:
        ops["meta"] = torch.empty((b, 3 * (n // blk) + 7 * k),
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
    _, pstruct = _cached_pruned(tabs, blk, k)
    if scores.is_cuda:
        placement = tables_placement(tabs, s, k, blk, r_top)
    else:   # the checks below raise for a CPU tensor
        placement = dict.fromkeys(PLACES, True)
    ops, res = pruned_operands(tabs, carry, scores, n_valid, block_size=blk,
                               n_groups=n_groups(tabs), placement=placement)
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
