"""The device decoder's n-best: the kernel's wrapper and dispatcher on the
CPU, its plain version held to the JAX package, and the kernel's source
held to the plain version.

``decoder_finalize`` in ``csrc/decoder_scan.cu`` replaces ``finalize`` of
``poccala_tpu/decoder/device.py``'s ``_build_finalize`` with its pointer
chase (a ``lax.scan``); it runs only on a card
(``tests/test_torch_gpu.py`` holds it to the plain version there, bit for
bit).  Here: ``DeviceBeamDecoder._finalize`` takes ``_finalize_plain`` for
CPU tensors and ``decoder_finalize_cuda`` refuses CPU tensors and wrong
operands (no fallback); ``_finalize_plain`` on the carry and traceback
rows of JAX's ``step`` scan (scores rounded to multiples of 8, so that
exits, slots and totals tie) equals JAX's ``finalize`` bit for bit with no
LM, a flat and a sparse bigram LM, at ``return_nbest`` 1, 3 and 10, over a
lexicon of fewer than 32 slots, with an utterance that has no valid
candidate and with chains cut at ``max_words``; and the kernel's source,
compiled with g++ against ``tests/cuda_emu/cuda_runtime.h`` (one thread
per CUDA thread), equals ``_finalize_plain`` bit for bit with the traceback
rows in shared and in device memory.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.decoder.device import DeviceBeamDecoder as JaxDecoder
from poccala_tpu_torch.decoder import device as tdev
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

from .test_torch_decoder_scan import (KEY_MUTANT, ORDER_MUTANT,
                                      emulated_library, emulated_source,
                                      jax_scan, make_world)
from .test_torch_lexicon import _ForeignLM

torch.set_num_threads(1)

LMS = ["none", "flat", "sparse"]
NBEST = [1, 3, 10]


@pytest.fixture(scope="module")
def worlds():
    """The built-in lexicon (125 nodes, more than 100 slots) and its first
    six words (fewer than 32 slots), at ``state_num = 5``."""
    return {"builtin": make_world(5), "small": make_world(5, n_words=6)}


def decoders(world, lm_kind, max_words=64, penalty=1.5):
    lm = {"none": None, "sparse": world["lm"],
          "flat": _ForeignLM(world["lm"])}[lm_kind]
    kw = dict(lm=lm, lm_weight=3.0, word_penalty=penalty,
              max_words=max_words)
    return (JaxDecoder(world["jbank"], world["jflat"], **kw),
            DeviceBeamDecoder(world["tbank"], world["tflat"], **kw))


def tied_scan(jd, td, seed=5, n=(48, 40, 0, 11)):
    """JAX's ``step`` scan over tied scores (multiples of 8) for four
    utterances, one of them with no frame (no valid candidate): JAX's
    carry and rows, and the same as torch tensors."""
    jd._prep_device()
    td._prep_device()
    rng = np.random.default_rng(seed)
    n = np.asarray(n)
    scores = (np.round(rng.normal(size=(len(n), 48, td.bank.num_states))
                       * 30 / 8) * 8).astype(np.float32)
    jcarry, prev, word = jax_scan(jd, scores, 0, n)
    tcarry = tuple(torch.as_tensor(np.array(a)) for a in jcarry)
    return (jcarry, prev, word), (tcarry, torch.as_tensor(np.array(prev)),
                                  torch.as_tensor(np.array(word)))


def jax_finalize(jd, n_cand, jcarry, prev, word):
    fin = jax.jit(jax.vmap(jd._build_finalize(n_cand)))
    seqs, scores = fin(jcarry, jnp.asarray(prev), jnp.asarray(word))
    return np.asarray(seqs), np.asarray(scores)


@pytest.mark.parametrize("nbest", NBEST)
@pytest.mark.parametrize("lm_kind", LMS)
@pytest.mark.parametrize("lex", ["builtin", "small"])
def test_plain_finalize_is_jax_finalize(worlds, lex, lm_kind, nbest):
    """``seqs`` and ``scores`` equal JAX's bit for bit; the row of the
    utterance with no frame holds no valid candidate."""
    jd, td = decoders(worlds[lex], lm_kind)
    (jcarry, prev, word), (tcarry, tprev, tword) = tied_scan(jd, td)
    tabs = td._prep_device()
    q = int(tabs.node_slot.shape[0])
    assert (q < 32) == (lex == "small")
    n_cand = td._n_cand(nbest)
    want_seqs, want_scores = jax_finalize(jd, n_cand, jcarry, prev, word)
    seqs, scores = td._finalize_plain(tabs, tcarry, tprev, tword, n_cand)
    assert seqs.dtype == torch.int32 and scores.dtype == torch.float32
    assert tuple(seqs.shape) == (4, min(n_cand, q), 64)
    np.testing.assert_array_equal(seqs.numpy(), want_seqs)
    np.testing.assert_array_equal(scores.numpy(), want_scores)
    assert (scores[2] <= -1e30 / 2).all() and (seqs[2] == -1).all()
    assert (scores[0] > -1e30 / 2).any()


@pytest.mark.parametrize("lm_kind", LMS)
def test_plain_finalize_cuts_chains_at_max_words(worlds, lm_kind):
    """``max_words = 3`` with a word bonus: chains longer than three words
    are cut, newest words kept, as JAX cuts them."""
    jd, td = decoders(worlds["builtin"], lm_kind, max_words=3, penalty=-20.0)
    (jcarry, prev, word), (tcarry, tprev, tword) = tied_scan(jd, td)
    want_seqs, want_scores = jax_finalize(jd, 8, jcarry, prev, word)
    seqs, scores = td._finalize_plain(td._prep_device(), tcarry, tprev,
                                      tword, 8)
    np.testing.assert_array_equal(seqs.numpy(), want_seqs)
    np.testing.assert_array_equal(scores.numpy(), want_scores)
    assert seqs.shape[2] == 3 and bool((seqs >= 0).all(dim=2).any())


def test_dispatcher_takes_the_plain_version_on_cpu(worlds, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called for CPU "
                             "tensors")

    monkeypatch.setattr(tdev, "decoder_finalize_cuda", refuse)
    jd, td = decoders(worlds["builtin"], "sparse")
    _, (tcarry, tprev, tword) = tied_scan(jd, td)
    tabs = td._prep_device()
    before = dk.decoder_finalize_cuda.launches
    got = td._finalize(tabs, tcarry, tprev, tword, 8)
    want = td._finalize_plain(tabs, tcarry, tprev, tword, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    w = worlds["builtin"]
    assert td.decode_batch(w["feats"], w["n_frames"])
    assert dk.decoder_finalize_cuda.launches == before


def test_wrapper_refuses_cpu_tensors_and_wrong_operands(worlds):
    jd, td = decoders(worlds["builtin"], "none")
    _, ((deltas, ctx), prev, word) = tied_scan(jd, td)
    tabs = td._prep_device()
    kw = dict(n_vocab=td._n_vocab, r_top=1, penalty=-1.5, max_words=64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dk.decoder_finalize_cuda(tabs, (deltas, ctx), prev, word, 8, **kw)
    with pytest.raises(ValueError, match="dtype"):
        dk.decoder_finalize_cuda(tabs, (deltas.double(), ctx), prev, word,
                                 8, **kw)
    with pytest.raises(ValueError, match="dtype"):
        dk.decoder_finalize_cuda(tabs, (deltas, ctx), prev.long(), word, 8,
                                 **kw)
    with pytest.raises(ValueError, match="shape"):
        dk.decoder_finalize_cuda(tabs, (deltas, ctx), prev, word[:, :5], 8,
                                 **kw)
    with pytest.raises(ValueError, match="shape"):
        dk.decoder_finalize_cuda(tabs, (deltas[:, :9], ctx), prev, word, 8,
                                 **kw)
    with pytest.raises(ValueError, match="contiguous"):
        dk.decoder_finalize_cuda(tabs, (deltas, ctx), prev.t().contiguous()
                                 .t(), word, 8, **kw)


def test_finalize_sizes_follow_the_plain_version():
    assert dk.finalize_sizes(125, 8) == (8, 32)
    assert dk.finalize_sizes(125, 32) == (32, 64)
    assert dk.finalize_sizes(10, 8) == (8, 10)
    assert dk.finalize_sizes(5, 8) == (5, 5)
    assert dk.finalize_sizes(1, 8) == (1, 1)
    assert dk.FINALIZE_REPLACES == "poccala_tpu/decoder/device.py:638-692"
    assert dk.SOURCE == "poccala_tpu_torch/csrc/decoder_scan.cu"


# ----------------------------------------------------------------------
# the kernel's source on the CPU

def emulated_finalize(lib, dec, carry, tb_prev, tb_word, n_cand):
    """``decoder_finalize_cuda``'s call, made on CPU tensors (the ac
    scratch always passed: the kernel reads it only where ac does not fit
    its shared memory)."""
    tabs = dec._prep_device()
    deltas, ctx = carry
    b, t = tb_prev.shape
    q = int(tabs.node_slot.shape[0])
    c, r = dk.finalize_sizes(q, n_cand)
    _, st = dk._cached(tabs, dec._n_vocab, dec._r_top(tabs),
                       -float(dec.word_penalty))
    seqs = torch.empty((b, c, dec.max_words), dtype=torch.int32)
    scores = torch.empty((b, c))
    ac = torch.empty((b, q))
    rc = lib.decoder_finalize(
        ctypes.byref(st), deltas.data_ptr(), ctx.data_ptr(),
        tb_prev.data_ptr(), tb_word.data_ptr(), ac.data_ptr(),
        seqs.data_ptr(), scores.data_ptr(), b, t, c, r, dec.max_words, None)
    assert rc == 0
    return seqs, scores


def lists_bytes(q: int, r: int) -> int:
    """The shared memory of the kernel's per-warp top-R lists: a value and
    a slot for each of R entries of each warp (a thread a slot, 64 to 256
    threads)."""
    warps = min(8, max(2, -(-q // 32)))
    return 8 * warps * r


@pytest.fixture(scope="module")
def emulated_limits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decoder_finalize_emu")
    libs = {}

    def get(limit):
        if limit not in libs:
            libs[limit] = emulated_library(tmp, limit)
        return libs[limit]
    return get


# (lexicon, LM, return_nbest, max_words, cut shared memory past the warps'
#  lists, rows in shared memory, ac in shared memory); the traceback rows
#  are 48 frames (384 B)
EMU_CASES = [
    ("builtin", "none", 1, 64, None, True, True),
    ("builtin", "flat", 3, 64, None, True, True),
    ("builtin", "sparse", 10, 64, None, True, True),
    ("builtin", "sparse", 1, 4, 1000, True, False),
    ("builtin", "none", 3, 64, 600, False, False),
    ("small", "flat", 1, 64, 300, False, True),
    ("small", "sparse", 10, 3, None, True, True),
]


@pytest.mark.parametrize(
    "lex,lm_kind,nbest,max_words,limit,rows,ac", EMU_CASES,
    ids=[f"{c[0]}-{c[1]}-n{c[2]}-L{c[3]}-lim{c[4]}" for c in EMU_CASES])
def test_kernel_source_on_cpu_is_the_plain_version(
        worlds, emulated_limits, lex, lm_kind, nbest, max_words, limit, rows,
        ac):
    """On JAX's tied carry and rows, with a word bonus where chains must be
    cut at ``max_words``: the kernel's ``seqs`` and ``scores`` equal
    ``_finalize_plain``'s bit for bit, in the instantiation that stages the
    rows in shared memory and in the one that reads them from device
    memory (the limit cut), with the slots' scores in shared memory or in
    the device scratch."""
    penalty = -20.0 if max_words < 64 else 1.5
    jd, td = decoders(worlds[lex], lm_kind, max_words, penalty)
    _, (tcarry, tprev, tword) = tied_scan(jd, td)
    tabs = td._prep_device()
    q, t = int(tabs.node_slot.shape[0]), int(tprev.shape[1])
    n_cand = td._n_cand(nbest)
    c, r = dk.finalize_sizes(q, n_cand)
    lib = emulated_limits(None if limit is None
                          else limit + lists_bytes(q, r))
    assert (lib.decoder_finalize_rows_in_smem(q, t, c, r),
            lib.decoder_finalize_ac_in_smem(q, t, c, r)) == (rows, ac)
    got = emulated_finalize(lib, td, tcarry, tprev, tword, n_cand)
    want = td._finalize_plain(tabs, tcarry, tprev, tword, n_cand)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1][0] > -1e30 / 2).any() and (want[1][2] <= -1e30 / 2).all()
    if max_words < 64:
        assert bool((want[0] >= 0).all(dim=2).any())


# ----------------------------------------------------------------------
# thousands of slots: the top R over many warps' lists

@pytest.fixture(scope="module")
def big_world(worlds):
    """The built-in world's bank over a synthetic lexicon of ~2,000 nodes
    (thousands of word slots; the nodes of one unit share their bands, so
    equal states give equal exits)."""
    from poccala_tpu_torch.io.corpus import UnitInventory
    from poccala_tpu_torch.lexicon.build import synthetic_lexicon

    flat, _, _ = synthetic_lexicon(UnitInventory.standard("XIF_tone"),
                                   min_nodes=2000, n_chars=30)
    return dict(worlds["builtin"], tflat=flat)


def tied_carry(dec, b=3, t=48, seed=3):
    """A random final carry and traceback rows for ``dec``'s tables:
    states from a few multiples of 8 (a tenth at NEG_INF), so that the
    exits of the nodes of a unit tie everywhere; contexts and rows that
    point at earlier frames and real words."""
    tabs = dec._prep_device()
    n, n_s, _ = tabs.bands.shape
    v = dec._n_vocab
    rng = np.random.default_rng(seed)
    deltas = (rng.integers(-4, 1, size=(b, n, n_s)) * 8).astype(np.float32)
    deltas[rng.random(size=deltas.shape) < 0.1] = -1e30
    ctx = ((rng.integers(-1, t, size=(b, n, n_s)) + 1) * (v + 1)
           + rng.integers(0, v + 1, size=(b, n, n_s))).astype(np.int32)
    word = rng.integers(-1, v, size=(b, t)).astype(np.int32)
    prev = np.minimum(rng.integers(-1, t, size=(b, t)),
                      np.arange(t) - 1).astype(np.int32)
    return ((torch.as_tensor(deltas), torch.as_tensor(ctx)),
            torch.as_tensor(prev), torch.as_tensor(word))


@pytest.mark.parametrize("nbest", [1, 5, 10])
@pytest.mark.parametrize("lm_kind", LMS)
def test_kernel_source_on_cpu_at_thousands_of_slots(big_world, lm_kind,
                                                    nbest, emulated_limits):
    """Thousands of slots (eight warps' lists of R = 32, or 64 at
    ``return_nbest`` 10, merged by rank) on a carry whose exits tie in
    large groups: ``seqs`` and ``scores`` equal ``_finalize_plain``'s bit
    for bit."""
    lib = emulated_limits(None)
    _, td = decoders(big_world, lm_kind, penalty=-4.0)
    tabs = td._prep_device()
    q = int(tabs.node_slot.shape[0])
    assert q > 2000
    n_cand = td._n_cand(nbest)
    assert dk.finalize_sizes(q, n_cand)[1] == (64 if nbest == 10 else 32)
    carry, prev, word = tied_carry(td)
    got = emulated_finalize(lib, td, carry, prev, word, n_cand)
    want = td._finalize_plain(tabs, carry, prev, word, n_cand)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1] > -1e30 / 2).all() and (want[0] >= 0).any()


def test_top_k_order_mutant_is_rejected(big_world, tmp_path):
    """The n-best's order reversed among equal values (the higher slot, and
    the later candidate, first: a consistent order, but not ``_top_k``'s):
    on the tied carry its ``seqs`` or ``scores`` leave ``_finalize_plain``'s.
    """
    src = emulated_source()
    for old, new in (ORDER_MUTANT, *KEY_MUTANT):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = emulated_library(tmp_path, source=src)
    _, td = decoders(big_world, "sparse", penalty=-4.0)
    tabs = td._prep_device()
    carry, prev, word = tied_carry(td)
    got = emulated_finalize(lib, td, carry, prev, word, 16)
    want = td._finalize_plain(tabs, carry, prev, word, 16)
    assert not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1]))
