"""The block-pruned search's frame scan: the kernel's wrapper and
dispatcher on the CPU, its plain version held to the JAX package, and the
kernel's source held to the plain version.

``decoder_scan_pruned`` in ``csrc/decoder_scan.cu`` replaces ``step_pruned``
of ``poccala_tpu/decoder/device.py``'s ``make_pruned`` under the frame
``lax.scan``; it runs only on a card (``tests/test_torch_gpu.py`` holds it to
the plain loop there, bit for bit).  Here, in the seeded world of
``tests/test_torch_pruned.py`` (a ~1,500-node synthetic lexicon in 24
blocks of 64, 2 or 3 active):

* ``DeviceBeamDecoder._scan`` takes the plain loop (``_step_pruned``) for
  CPU tensors, and ``decoder_scan_pruned_cuda`` refuses CPU tensors, wrong
  dtypes, shapes and block sizes (no fallback);
* the packed pruned tables (each block's groups of root children and of
  its other nodes, each node's children) round-trip, and the group tables
  reproduce every node's band and senone rows;
* the plain loop equals JAX's jitted ``step_pruned`` bit for bit on scores
  rounded to multiples of 8 (ties everywhere), in two chunks;
* the kernel's own source, compiled with g++ against
  ``tests/cuda_emu/cuda_runtime.h`` (one thread per CUDA thread), equals the
  plain loop bit for bit (``kb``, ``d_act``, ``c_act``, ``entry``,
  ``entry_ctx``, ``tb_prev``, ``tb_word``) with no LM, a flat and a sparse
  bigram LM, rows frozen inside a chunk, two chunks whose carry passes from
  one to the next (``t0 > 0``: the entry row out of the first is the
  second's in), every placement of its parts in shared or device memory
  (chosen by cutting ``SMEM_LIMIT`` textually), K = 3 and 4, and at
  ``state_num = 10`` (18 token states a node, with and without skip
  transitions); the cases meet dead blocks, fresh blocks, and frames with
  block 0 (the parentless root's) active and inactive; with an LM they
  meet frames of fewer than 16 finite word candidates, where the plain
  loop's top 16 take ``NEG_INF`` slots from outside the active blocks;
* a mutant of the source whose top-K breaks ties by the higher block is
  rejected.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from poccala_tpu_torch.decoder import device as tdev
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.lm.ngram import Ngram
from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk
from poccala_tpu_torch.utils.logmath import NEG_INF

from .test_torch_decoder_scan import EMU, emulated_source, jax_scan, worlds  # noqa: F401
from .test_torch_decoder_scan import decoders as builtin_decoders
from .test_torch_lexicon import _ForeignLM
from .test_torch_pruned import PRUNE, batch, pair, world  # noqa: F401

torch.set_num_threads(1)

T_ALL, CHUNK = 24, 12


def bigram(world):
    rng = np.random.default_rng(13)
    lm = Ngram(2)
    lm.train([list(rng.choice(world["words"], size=2)) for _ in range(60)])
    return lm


def pruned_pair(world, lm_kind, **kw):
    lm = {"none": None, "sparse": bigram(world),
          "flat": _ForeignLM(bigram(world))}[lm_kind]
    return pair(world, lm=lm, **{**PRUNE, **kw})


def tied_scores(dec, feats):
    """The decoder's GMM scores rounded to multiples of 8: paths, exits,
    block lookaheads and word emissions tie."""
    return torch.round(dec._scores(torch.as_tensor(feats)) / 8) * 8


@pytest.fixture(scope="module")
def utts(world):
    """Four utterances of lexicon words, their first 24 frames, and frame
    counts of which two end inside the second chunk and one at 0."""
    _, feats, nf = batch(world, 4, seed=3, noise=0.3)
    n = np.minimum(nf, T_ALL)
    n[1], n[2] = 17, 0
    return feats[:, :T_ALL], n


# ----------------------------------------------------------------------
# the dispatcher, the wrapper's refusals, the packed tables

def test_dispatcher_takes_the_plain_loop_on_cpu(world, utts, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel's wrapper was called for CPU tensors")

    monkeypatch.setattr(tdev, "decoder_scan_pruned_cuda", refuse)
    monkeypatch.setattr(tdev, "decoder_scan_cuda", refuse)
    _, dec = pruned_pair(world, "sparse")
    tabs = dec._prep_device()
    assert dec._prune_on
    feats, n = utts
    scores = dec._scores(torch.as_tensor(feats))
    before = dk.decoder_scan_pruned_cuda.launches
    got = dec._scan(tabs, dec._seed(tabs, 4), scores, 0, n)
    want = dec._scan_plain(tabs, dec._seed(tabs, 4), scores, 0, n)
    for g, w in zip((*got[0], got[1], got[2]), (*want[0], want[1], want[2])):
        assert torch.equal(g, w)
    assert dec.decode_batch(feats, n)
    assert dk.decoder_scan_pruned_cuda.launches == before


def test_wrapper_refuses_cpu_tensors_and_wrong_operands(world, utts):
    _, dec = pruned_pair(world, "none")
    tabs = dec._prep_device()
    feats, n = utts
    scores = dec._scores(torch.as_tensor(feats))
    kb, d, c, e, ec = dec._seed(tabs, 4)
    kw = dict(n_vocab=dec._n_vocab, r_top=1, penalty=0.0, block_size=64)
    run = dk.decoder_scan_pruned_cuda
    with pytest.raises(ValueError, match="CUDA tensors"):
        run(tabs, (kb, d, c, e, ec), scores, 0, n, **kw)
    for carry, what in (((kb.int(), d, c, e, ec), "dtype"),
                        ((kb, d.half(), c, e, ec), "dtype"),
                        ((kb, d, c.long(), e, ec), "dtype"),
                        ((kb, d, c, e.double(), ec), "dtype"),
                        ((kb, d, c, e, ec.long()), "dtype"),
                        ((kb, d[:3], c, e, ec), "shape"),
                        ((kb, d, c, e[:, :-1], ec), "shape"),
                        ((kb, d, c.transpose(0, 1).contiguous()
                          .transpose(0, 1), e, ec), "contiguous")):
        with pytest.raises(ValueError, match=what):
            run(tabs, carry, scores, 0, n, **kw)
    with pytest.raises(ValueError, match="dtype"):
        run(tabs, (kb, d, c, e, ec), scores.double(), 0, n, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        run(tabs, (kb, d, c, e, ec),
            scores.transpose(0, 1).contiguous().transpose(0, 1), 0, n, **kw)
    with pytest.raises(ValueError, match="block multiple"):
        run(tabs, (kb, d, c, e, ec), scores, 0, n,
            **{**kw, "block_size": 100})
    with pytest.raises(ValueError, match="shape"):
        run(tabs, (kb, d, c, e, ec), scores, 0, n, **{**kw, "block_size": 32})
    with pytest.raises(ValueError, match="expected"):
        run(tabs, (kb, d, c, e, ec), scores[0], 0, n, **kw)


@pytest.mark.parametrize("k_act", [2, 3])
def test_packed_pruned_tables_round_trip(world, k_act):
    _, dec = pruned_pair(world, "none", active_blocks=k_act)
    tabs = dec._prep_device()
    p = dk.pack_pruned_tables(tabs, dec.block_size, k_act)
    n = tabs.bands.shape[0]
    n_blocks = n // 64
    assert (p["block_size"], p["n_active"], p["n_blocks"]) == \
        (64, k_act, n_blocks) == (64, k_act, dec._n_blocks)
    # the group tables: every node's band and senone rows, exactly
    g = dk.group_tables(tabs)
    group = torch.as_tensor(g["node_group"]).long()
    senone = torch.where(tabs.emitting, tabs.senone, -1)
    assert torch.equal(torch.as_tensor(g["group_senone"])[group].long(),
                       senone)
    assert torch.equal(torch.as_tensor(g["group_bands"])[group], tabs.bands)
    n_groups = g["group_senone"].shape[0]
    assert n_groups == dk.n_groups(tabs) < 300
    # per block, its root children's groups and its other nodes', once
    # each; per node, its children
    rc = tabs.is_root_child.numpy()
    for name, sel in (("rc", rc), ("dead", ~rc)):
        ptr, lst = p[f"{name}_ptr"].numpy(), p[f"{name}_group"].numpy()
        assert ptr.shape == (n_blocks + 1,) and ptr[0] == 0
        for j in range(n_blocks):
            nodes = np.arange(j * 64, (j + 1) * 64)
            want = np.unique(g["node_group"][nodes[sel[nodes]]])
            assert np.array_equal(lst[ptr[j]:ptr[j + 1]], want), (name, j)
    # per block, its nodes with a parent as (parent block, parent's index
    # in it, own group), grouped by the parent's block
    parent = np.where(tabs.has_parent.numpy(), tabs.parent.numpy(), -1)
    src, blocks = p["src_ptr"].numpy(), p["src_block"].numpy()
    seg, par, grp = (p[k].numpy() for k in ("seg_ptr", "flow_par",
                                            "flow_grp"))
    for j in range(n_blocks):
        nodes = np.arange(j * 64, (j + 1) * 64)
        nodes = nodes[parent[nodes] >= 0]
        want = sorted(zip(parent[nodes] // 64, parent[nodes] % 64,
                          g["node_group"][nodes]))
        got = sorted((blocks[s], par[e], grp[e])
                     for s in range(src[j], src[j + 1])
                     for e in range(seg[s], seg[s + 1]))
        assert got == want, j
        assert len(set(blocks[src[j]:src[j + 1]])) == src[j + 1] - src[j]
    st = dk._pruned_struct(p)
    assert (st.rc_ptr, st.flow_grp, st.block_size, st.n_active,
            st.n_blocks) == (p["rc_ptr"].data_ptr(),
                             p["flow_grp"].data_ptr(), 64, k_act, n_blocks)
    first = dk._cached_pruned(tabs, 64, k_act)
    assert dk._cached_pruned(tabs, 64, k_act)[0] is first[0]
    assert dk._cached_pruned(tabs, 64, k_act + 1)[0] is not first[0]
    with pytest.raises(ValueError, match="multiple"):
        dk.pack_pruned_tables(tabs, 100, k_act)
    with pytest.raises(ValueError, match="active_blocks"):
        dk.pack_pruned_tables(tabs, 64, n_blocks + 1)


# ----------------------------------------------------------------------
# the plain loop against JAX

@pytest.mark.parametrize("lm_kind", ["none", "sparse"])
def test_plain_pruned_scan_is_jax_step_pruned(world, utts, lm_kind):
    """Two chunks of tied scores through the plain loop and through JAX's
    ``step_pruned`` under ``lax.scan``: equal carry (``kb`` as values: JAX
    keeps int32) and traceback rows."""
    jd, td = pruned_pair(world, lm_kind)
    jd._prep_device()
    tabs = td._prep_device()
    assert jd._prune_on and td._prune_on
    feats, n = utts
    scores = tied_scores(td, feats).numpy()
    jcarry, tcarry = None, td._seed(tabs, 4)
    for t0 in (0, CHUNK):
        part = np.ascontiguousarray(scores[:, t0:t0 + CHUNK])
        nv = np.clip(n - t0, 0, CHUNK)
        jcarry, jprev, jword = jax_scan(jd, part, t0, nv, jcarry)
        tcarry, tprev, tword = td._scan_plain(tabs, tcarry,
                                              torch.as_tensor(part), t0, nv)
        np.testing.assert_array_equal(tprev.numpy(), jprev)
        np.testing.assert_array_equal(tword.numpy(), jword)
        for g, w in zip(tcarry, jcarry):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (tword.numpy() >= 0).any()


# ----------------------------------------------------------------------
# the kernel's source on the CPU

def compile_emulated(tmp, name, src) -> ctypes.CDLL:
    """``src`` (an :func:`emulated_source`) compiled with g++ and bound."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    cpp, so = tmp / f"{name}.cpp", tmp / f"lib{name}.so"
    cpp.write_text(src)
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{EMU}", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    return dk.bind(ctypes.CDLL(str(so)))


# the top-K's tie order reversed: on equal lookaheads the higher block first
TIE_MUTANT = (("n_before += before(blk_best[o], o, x, j);",
               "n_before += blk_best[o] > x || (blk_best[o] == x && o > j);"),)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's source at a shared-memory limit (None: the card's), or
    its tie-order mutant, compiled once each."""
    tmp = tmp_path_factory.mktemp("pruned_scan_emu")
    libs = {}

    def get(limit=None, mutant=False):
        key = (limit, mutant)
        if key not in libs:
            src = emulated_source(limit)
            if mutant:
                for old, new in TIE_MUTANT:
                    assert src.count(old) == 1, old
                    src = src.replace(old, new)
            libs[key] = compile_emulated(
                tmp, f"pruned{limit}{'mut' if mutant else ''}", src)
        return libs[key]
    return get


def emulated_pruned(lib, dec, tabs, carry, scores, t0, n_valid,
                    clocks=None):
    """``decoder_scan_pruned_cuda``'s call made on CPU tensors, every
    output and scratch tensor first filled with garbage (``clocks``: the
    phase counters, if any); returns ``(carry, tb_prev, tb_word)`` and the
    placement."""
    b, t_c, s = scores.shape
    n, n_s, _ = tabs.bands.shape
    k = carry[0].shape[1]
    _, pst = dk._cached_pruned(tabs, dec.block_size, k)
    place = dk.tables_placement(tabs, s, k, dec.block_size,
                                dec._r_top(tabs), lib=lib)
    ops, res = dk.pruned_operands(tabs, carry, scores, n_valid,
                                  block_size=dec.block_size,
                                  n_groups=dk.n_groups(tabs),
                                  placement=place)
    for name in ("kb_out", "d_out", "c_out", "e_out", "ec_out", "d_work",
                 "c_work", "ex", "exc", "meta", "la", "tb_prev", "tb_word"):
        if name in ops:
            ops[name].fill_(float("nan") if ops[name].is_floating_point()
                            else -77)
    if clocks is not None:
        ops["clocks"] = clocks
    _, st = dk._cached(tabs, dec._n_vocab, dec._r_top(tabs),
                       -float(dec.word_penalty))
    rc = lib.decoder_scan_pruned(ctypes.byref(st), ctypes.byref(pst),
                                 ctypes.byref(dk._io(ops)), b, t_c, s, t0,
                                 None)
    assert rc == 0
    return (res["carry"], res["tb_prev"], res["tb_word"]), place


NAMES = ("kb", "d_act", "c_act", "entry", "entry_ctx")


def count_candidates(dec, n_valid_all):
    """Wrap ``dec._enter`` to record, per call, the number of finite word
    candidates of each utterance on its active frames."""
    seen = []
    enter = dec._enter

    def recorder(tabs, ex, ex_ctx, ti):
        fin = (tabs.slot_valid & (ex[:, tabs.node_slot] > NEG_INF / 2)).sum(1)
        seen.extend(int(c) for c, nv in zip(fin, n_valid_all) if ti < nv)
        return enter(tabs, ex, ex_ctx, ti)
    dec._enter = recorder
    return seen


def chunks_equal(lib, dec, scores, n):
    """Two chunks (t0 = 0 and 12) through the emulated kernel and the plain
    loop, the carry passed on; every output equal bit for bit.  Returns
    the placements and the last chunk's words."""
    tabs = dec._prep_device()
    b = scores.shape[0]
    got = want = dec._seed(tabs, b)
    places = set()
    for t0 in (0, CHUNK):
        part = scores[:, t0:t0 + CHUNK].contiguous()
        nv = np.clip(n - t0, 0, CHUNK)
        (got, g_prev, g_word), place = emulated_pruned(lib, dec, tabs, got,
                                                       part, t0, nv)
        want, w_prev, w_word = dec._scan_plain(tabs, want, part, t0, nv)
        places.add(tuple(sorted(place.items())))
        for name, g, w in zip(NAMES + ("tb_prev", "tb_word"),
                              (*got, g_prev, g_word), (*want, w_prev, w_word)):
            assert g.dtype == w.dtype, name
            assert torch.equal(g, w), (name, t0)
        for u in range(b):   # frozen frames: no row
            live = max(0, min(CHUNK, int(n[u]) - t0))
            assert (g_prev[u, live:] == -1).all()
            assert (g_word[u, live:] == -1).all()
    assert len(places) == 1
    return dict(places.pop()), w_word


ALL = dict.fromkeys(dk.PLACES, True)
# pruned_plan's order of the parts, after the emission's lists
ORDER = ("rows", "meta", "lookahead", "groups", "exits", "carry")


def align16(n: int) -> int:
    return (n + 15) // 16 * 16


def part_bytes(dec) -> dict:
    """The shared-memory bytes of each part of the pruned scan for this
    decoder's tables (16-byte aligned), the emission's lists first."""
    tabs = dec._prep_device()
    n, n_s, w = tabs.bands.shape
    k, blk = dec.active_blocks, dec.block_size
    g = dk.n_groups(tabs)
    return {name: align16(b) for name, b in dict(
        lists=50 * dec._r_top(tabs) * 8, rows=8 * dec.bank.num_states,
        meta=4 * (3 * (n // blk) + 7 * k), lookahead=4 * g,
        groups=4 * g * n_s * (w + 1), exits=16 * k * blk,
        carry=8 * k * blk * n_s).items()}


def cut_limit(where: str, size: dict):
    """``(SMEM_LIMIT, expected placement)``: the limit the lists and the
    parts ``where`` keeps in shared memory take, and the placement the plan
    makes in it (each part in order where it fits in what the earlier ones
    leave).  "entry": every part, in exactly the room they take (the entry
    row takes none: it is read in once and written out once)."""
    stay = {"all": None, "entry": ORDER, "carry": ORDER[:-1],
            "exits": ORDER[:4],
            "groups": ORDER[:3], "rows": ("meta", "lookahead", "exits"),
            "lookahead": ("rows", "meta"), "every": ()}[where]
    if stay is None:
        return None, ALL
    limit = size["lists"] + (sum(size[k] for k in stay) or 15)
    used, placement = size["lists"], {}
    for name in ORDER:
        placement[name] = used + size[name] <= limit
        used += size[name] if placement[name] else 0
    return limit, placement


def record_blocks(dec):
    """Wrap ``dec._step_pruned`` to record, per active frame, each
    utterance's active blocks before and after the step."""
    seen = []
    step = dec._step_pruned

    def recorder(tabs, carry, frame_scores, ti, active):
        out = step(tabs, carry, frame_scores, ti, active)
        for u in np.nonzero(active.numpy())[0]:
            seen.append((set(carry[0][u].tolist()),
                         set(out[0][0][u].tolist())))
        return out
    dec._step_pruned = recorder
    return seen


# (LM, tied scores, the parts sent to device memory, active blocks)
CASES = [
    ("none", True, "all", 2), ("flat", True, "all", 2),
    ("sparse", True, "all", 2), ("sparse", False, "all", 2),
    ("none", True, "entry", 2), ("none", True, "groups", 2),
    ("sparse", True, "carry", 4),
    ("flat", True, "rows", 2), ("none", True, "lookahead", 2),
    ("sparse", True, "every", 2), ("none", True, "exits", 4),
]


def test_cases_place_every_part_both_ways(world):
    """Across CASES every part of the pruned scan is in device memory at
    least once (and in shared memory in the default case)."""
    out = set()
    for lm_kind, _, where, k_act in CASES:
        _, dec = pruned_pair(world, lm_kind, active_blocks=k_act)
        _, place = cut_limit(where, part_bytes(dec))
        out |= {k for k, v in place.items() if not v}
    assert out == set(dk.PLACES)


@pytest.mark.parametrize("lm_kind,tied,where,k_act", CASES,
                         ids=[f"{c[0]}{'_tied' if c[1] else ''}_{c[2]}"
                              for c in CASES])
def test_kernel_source_on_cpu_is_the_plain_loop(world, utts, emulated,
                                                lm_kind, tied, where, k_act):
    """Two chunks of the utterances' scores (rounded to multiples of 8 where
    ``tied``), one row ending inside the second chunk and one empty, the
    carry passed from chunk to chunk: the kernel's carry and rows equal the
    plain loop's bit for bit, with the parts ``where`` names in device
    memory (``SMEM_LIMIT`` cut to what the others take) and the rest in
    shared memory.  The frames met blocks that die and fresh ones."""
    _, dec = pruned_pair(world, lm_kind, active_blocks=k_act)
    limit, placement = cut_limit(where, part_bytes(dec))
    feats, n = utts
    scores = (tied_scores(dec, feats) if tied
              else dec._scores(torch.as_tensor(feats)))
    seen = count_candidates(dec, np.asarray(n))
    blocks = record_blocks(dec)
    place, words = chunks_equal(emulated(limit), dec, scores, n)
    assert place == placement
    assert (words >= 0).any()
    assert any(before - after for before, after in blocks)   # fresh blocks
    if lm_kind != "none":   # frames of 1..15 finite candidates were met
        assert any(0 < c < 16 for c in seen), sorted(set(seen))


@pytest.mark.parametrize("lm_kind", ["none", "sparse"])
def test_kernel_source_on_cpu_with_block_0_active(world, utts, emulated,
                                                  lm_kind):
    """One utterance of equal scores (every lookahead ties, so the lowest
    blocks, 0 among them, stay active) beside three whose block 0 dies
    after the first frame: the parentless nodes' entries take node 0's
    exit context in the one and V in the others, bit for bit as the plain
    loop."""
    _, dec = pruned_pair(world, lm_kind)
    feats, n = utts
    scores = tied_scores(dec, feats)
    scores[3] = 0.0
    blocks = record_blocks(dec)
    chunks_equal(emulated(), dec, scores, n)
    assert {0 in after for _, after in blocks} == {True, False}


def test_kernel_source_on_cpu_with_three_active_blocks(world, utts, emulated):
    _, dec = pruned_pair(world, "sparse", active_blocks=3)
    feats, n = utts
    chunks_equal(emulated(), dec, tied_scores(dec, feats), n)


@pytest.mark.parametrize("skips,lm_kind,limit", [
    (False, "sparse", None), (True, "none", None), (True, "flat", 3000)])
def test_kernel_source_on_cpu_at_state_num_10(worlds, emulated, skips,
                                              lm_kind, limit):
    """18 token states a node (band width 2, or 10 with skips) over the
    built-in lexicon in 16 blocks of 8, 3 active: the advance in place with
    runtime loops, bit for bit as the plain loop."""
    wd = worlds(10, skips=skips)
    _, dec = builtin_decoders(wd, lm_kind)
    dec = DeviceBeamDecoder(dec.bank, dec.lexicon, lm=dec.lm, lm_weight=3.0,
                            word_penalty=1.5, block_size=8, active_blocks=3)
    tabs = dec._prep_device()
    assert dec._prune_on and tuple(tabs.bands.shape[1:]) == (
        18, 10 if skips else 2)
    scores = tied_scores(dec, wd["feats"])[:, :T_ALL]
    chunks_equal(emulated(limit), dec, scores, np.minimum(wd["n_frames"],
                                                          T_ALL))


@pytest.mark.parametrize("state_num,skips", [(5, True), (7, False)])
def test_kernel_source_on_cpu_takes_every_advance(worlds, emulated, state_num,
                                                  skips):
    """The shapes between the left-to-right topology and state_num 10: 8
    states and band width 5 (skips at state_num 5), 12 states
    (state_num 7), over the built-in lexicon in 16 blocks of 8, 3 active,
    with a sparse bigram LM: bit for bit as the plain loop."""
    wd = worlds(state_num, skips=skips)
    _, dec = builtin_decoders(wd, "sparse")
    dec = DeviceBeamDecoder(dec.bank, dec.lexicon, lm=dec.lm, lm_weight=3.0,
                            word_penalty=1.5, block_size=8, active_blocks=3)
    tabs = dec._prep_device()
    n_s, w = tabs.bands.shape[1:]
    assert dec._prune_on and (n_s, w) == ((8, 5) if skips else (12, 2))
    scores = tied_scores(dec, wd["feats"])[:, :T_ALL]
    chunks_equal(emulated(), dec, scores, np.minimum(wd["n_frames"], T_ALL))


def test_phase_clocks_trace_the_first_utterance(world, utts, emulated):
    """Given a clocks tensor, the kernel adds its first utterance's time in
    each of ``PRUNED_PHASES`` (here the emulation's clock, host
    nanoseconds), and its results stay the plain loop's."""
    lib = emulated()
    assert lib.decoder_pruned_phases() == len(dk.PRUNED_PHASES) == 6
    _, dec = pruned_pair(world, "sparse")
    tabs = dec._prep_device()
    feats, n = utts
    scores = tied_scores(dec, feats)[:, :CHUNK].contiguous()
    nv = np.minimum(n, CHUNK)
    clocks = torch.zeros(len(dk.PRUNED_PHASES), dtype=torch.int64)
    (got, g_prev, g_word), _ = emulated_pruned(
        lib, dec, tabs, dec._seed(tabs, 4), scores, 0, nv, clocks=clocks)
    want, w_prev, w_word = dec._scan_plain(tabs, dec._seed(tabs, 4), scores,
                                           0, nv)
    for g, w in zip((*got, g_prev, g_word), (*want, w_prev, w_word)):
        assert torch.equal(g, w)
    assert bool((clocks > 0).all()), clocks


def test_tie_order_mutant_is_rejected(world, utts, emulated):
    """The top-K taking the higher block first among equal lookaheads (a
    consistent order, but not ``lax.top_k``'s): the equality check fails on
    one of the carry's fields or rows."""
    _, dec = pruned_pair(world, "none")
    feats, n = utts
    with pytest.raises(AssertionError, match="'(kb|d_act|c_act|entry|"
                       "entry_ctx|tb_prev|tb_word)'"):
        chunks_equal(emulated(mutant=True), dec, tied_scores(dec, feats), n)


def test_placement_at_the_pruned_cell(emulated):
    """The plan at chip_smoke.py's pruned cell (21,589 nodes in 85 blocks of
    256, Ns = 8, W = 2, 606 senones, ~210 groups): at K = 8 and 4 every
    part in shared memory, with no LM and with 16 candidates; at the
    config's default of 4 blocks of 1,024 (22,528 nodes) the carry (262
    KB) in device memory."""
    lib = emulated()
    for n, blk, k, r, out in ((21760, 256, 8, 1, None),
                              (21760, 256, 8, 16, None),
                              (21760, 256, 4, 1, None),
                              (22528, 1024, 4, 1, "carry")):
        want = {**ALL, out: False} if out else ALL
        assert dk.pruned_placement(n, 8, 2, 606, k, blk, 210, r,
                                   lib=lib) == want, (n, blk, k)
    # a small lexicon keeps everything on chip
    assert dk.pruned_placement(1536, 8, 2, 606, 2, 64, 210, lib=lib) == ALL
