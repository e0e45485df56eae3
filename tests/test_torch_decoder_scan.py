"""The device decoder's frame scan: the kernel's wrapper and dispatcher on
the CPU, and the kernel's plain version held to the JAX package.

``csrc/decoder_scan.cu`` replaces the ``lax.scan`` of
``poccala_tpu/decoder/device.py``'s ``step``; it runs only on a card
(``tests/test_torch_gpu.py`` holds it to the plain loop there, bit for
bit).  Here: ``DeviceBeamDecoder._scan`` takes the plain loop for CPU
tensors; ``decoder_scan_cuda`` refuses CPU tensors and wrong dtypes (no
fallback); the packed tables are the decoder's ``_Tables``; the plain loop
equals JAX's jitted ``step`` bit for bit on the same scores (rounded to
multiples of 8 so that paths, exits and word slots tie everywhere) in
chunks with ``t0 > 0`` and rows that end inside a chunk; a chunked
``stream_feed`` decode gives JAX's n-best words, scores at rtol 1e-4 (the
two packages' GMM scores differ by float32 rounding), with no LM, a flat
and a sparse bigram LM; and the kernel's own source, compiled with g++
against ``tests/cuda_emu/cuda_runtime.h`` (one thread per CUDA thread),
equals the plain loop bit for bit in its instantiations.  At
``state_num = 10`` (18 token states a node, past the kernel's registers)
and with skip transitions (band width 10), the plain loop equals JAX's
``step`` and a decode gives JAX's words; the kernel's source runs the
instantiations that keep the states in the carry, and those that read the
scores rows from device memory, bit for bit as the plain loop.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.config import ModelConfig
from poccala_tpu.decoder.device import DeviceBeamDecoder as JaxDecoder
from poccala_tpu.io.corpus import UnitInventory as JaxInventory
from poccala_tpu.lexicon import FlatLexicon as JaxFlat
from poccala_tpu.lexicon import PinYin as JaxPinYin
from poccala_tpu.lexicon import PronunciationLexicon as JaxLexicon
from poccala_tpu.lexicon.builtin_table import BUILTIN_PINYIN
from poccala_tpu.lm.ngram import Ngram
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu_torch.decoder import device as tdev
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

from .test_torch_decoder import world  # noqa: F401  (module fixture)
from .test_torch_lexicon import _ForeignLM

torch.set_num_threads(1)

LMS = ["none", "flat", "sparse"]


def decoders(world, lm_kind, penalty=1.5):
    lm = {"none": None, "sparse": world["lm"],
          "flat": _ForeignLM(world["lm"])}[lm_kind]
    kw = dict(lm=lm, lm_weight=3.0, word_penalty=penalty)
    return (JaxDecoder(world["jbank"], world["jflat"], **kw),
            DeviceBeamDecoder(world["tbank"], world["tflat"], **kw))


def test_dispatcher_takes_the_plain_loop_on_cpu(world, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called for CPU "
                             "tensors")

    monkeypatch.setattr(tdev, "decoder_scan_cuda", refuse)
    dec = DeviceBeamDecoder(world["tbank"], world["tflat"])
    tabs = dec._prep_device()
    scores = dec._scores(torch.as_tensor(world["feats"]))
    before = dk.decoder_scan_cuda.launches
    got = dec._scan(tabs, dec._seed(tabs, 3), scores, 0, world["n_frames"])
    want = dec._scan_plain(tabs, dec._seed(tabs, 3), scores, 0,
                           world["n_frames"])
    for g, w in zip((*got[0], got[1], got[2]), (*want[0], want[1], want[2])):
        assert torch.equal(g, w)
    assert dec.decode_batch(world["feats"], world["n_frames"])
    assert dk.decoder_scan_cuda.launches == before


def test_wrapper_refuses_cpu_tensors_and_wrong_dtypes(world):
    dec = DeviceBeamDecoder(world["tbank"], world["tflat"])
    tabs = dec._prep_device()
    scores = dec._scores(torch.as_tensor(world["feats"]))
    deltas, ctx = dec._seed(tabs, 3)
    kw = dict(n_vocab=dec._n_vocab, r_top=1, penalty=0.0)
    n = world["n_frames"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        dk.decoder_scan_cuda(tabs, (deltas, ctx), scores, 0, n, **kw)
    with pytest.raises(ValueError, match="dtype"):
        dk.decoder_scan_cuda(tabs, (deltas, ctx), scores.double(), 0, n,
                             **kw)
    with pytest.raises(ValueError, match="dtype"):
        dk.decoder_scan_cuda(tabs, (deltas, ctx.long()), scores, 0, n, **kw)
    with pytest.raises(ValueError, match="dtype"):
        dk.decoder_scan_cuda(tabs, (deltas.half(), ctx), scores, 0, n, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        dk.decoder_scan_cuda(tabs, (deltas, ctx),
                             scores.transpose(0, 1).contiguous()
                             .transpose(0, 1), 0, n, **kw)
    with pytest.raises(ValueError, match="shape"):
        dk.decoder_scan_cuda(tabs, (deltas[:2], ctx), scores, 0, n, **kw)


@pytest.mark.parametrize("lm_kind", LMS)
def test_packed_tables_round_trip(world, lm_kind):
    _, dec = decoders(world, lm_kind)
    tabs = dec._prep_device()
    r_top = dec._r_top(tabs)
    p = dk.pack_tables(tabs, dec._n_vocab, r_top, -dec.word_penalty)
    i32 = torch.int32
    for name in ("senone", "parent", "node_slot", "word_slot", "lm_keys"):
        assert p.get(name, torch.zeros(1, dtype=i32)).dtype == i32, name
    assert torch.equal(p["bands"], tabs.bands)
    assert torch.equal(p["senone"].clamp(min=0).long(), tabs.senone)
    assert torch.equal(p["senone"] >= 0, tabs.emitting)
    assert torch.equal(p["parent"].clamp(min=0).long(), tabs.parent)
    assert torch.equal(p["parent"] >= 0, tabs.has_parent)
    assert torch.equal(p["root_child"].bool(), tabs.is_root_child)
    assert torch.equal(p["node_slot"].long(), tabs.node_slot)
    assert torch.equal(p["word_slot"], tabs.word_slot)
    assert torch.equal(p["slot_valid"].bool(), tabs.slot_valid)
    assert p["penalty"] == np.float32(-1.5) and p["r_top"] == r_top
    assert r_top == (1 if lm_kind == "none" else 16)
    mode = {"none": dk.LM_NONE, "flat": dk.LM_FLAT,
            "sparse": dk.LM_SPARSE}[lm_kind]
    assert p["lm_mode"] == mode
    if lm_kind == "sparse":
        for name, a in zip(("lm_uni", "lm_rboff", "lm_cbase", "lm_keys",
                            "lm_vals"), tabs.lm_sparse):
            assert torch.equal(p[name], a), name
    if lm_kind == "flat":
        assert torch.equal(p["lm_flat"], tabs.lm_flat)
    # the C struct the kernel reads
    st = dk._struct(p)
    n, n_s, w = tabs.bands.shape
    assert (st.n_nodes, st.n_states, st.band_w, st.n_slots, st.n_vocab,
            st.r_top, st.lm_mode) == (n, n_s, w, tabs.node_slot.shape[0],
                                      dec._n_vocab, r_top, mode)
    assert st.bands == p["bands"].data_ptr()
    assert (st.lm_keys is None) == (lm_kind != "sparse")
    assert st.lm_n_keys == (p["lm_keys"].shape[0] if lm_kind == "sparse"
                            else 0)
    # packed once per table object, kept while it lives
    first = dk._cached(tabs, dec._n_vocab, r_top, -dec.word_penalty)
    assert dk._cached(tabs, dec._n_vocab, r_top, -dec.word_penalty)[0] \
        is first[0]
    other = decoders(world, lm_kind)[1]._prep_device()
    assert dk._cached(other, dec._n_vocab, r_top, -dec.word_penalty)[0] \
        is not first[0]


def jax_scan(jd, scores, t0, n_valid, carry=None):
    """JAX's ``step`` under ``lax.scan``, vmapped over utterances, as
    ``_chunk_fn`` runs it, on given scores ``[B, Tc, S]``."""
    step, seed, _, _ = jd._build_step()
    b, t_c, _ = scores.shape
    if carry is None:
        carry = jax.vmap(lambda _: seed())(jnp.arange(b))

    @jax.jit
    def run(carry, scores, n_valid):
        def one(c, s, n):
            tis = t0 + jnp.arange(t_c, dtype=jnp.int32)
            return jax.lax.scan(step, c, (s, tis, jnp.arange(t_c) < n))
        return jax.vmap(one)(carry, scores, n_valid)

    carry, (prev, word) = run(carry, jnp.asarray(scores),
                              jnp.asarray(n_valid, jnp.int32))
    return carry, np.asarray(prev), np.asarray(word)


@pytest.mark.parametrize("lm_kind", LMS)
def test_plain_scan_is_jax_step_bit_for_bit(world, lm_kind):
    """Two chunks (t0 = 0 and 24) of scores rounded to multiples of 8 —
    tied paths, tied exits and, at the nodes that carry several words
    (他 / 她, 十 / 时 / 识, ...), two slots emitting the same score every
    frame — through the plain loop and through JAX's step: equal carry and
    traceback rows."""
    jd, td = decoders(world, lm_kind)
    jd._prep_device()
    tabs = td._prep_device()
    slots = tabs.node_slot.numpy()
    assert len(np.unique(slots)) < len(slots)   # tied slots exist
    rng = np.random.default_rng(5)
    b, t_all = 4, 48
    scores = np.round(rng.normal(size=(b, t_all, td.bank.num_states))
                      * 30 / 8) * 8
    scores = scores.astype(np.float32)
    n = np.array([48, 40, 24, 11])
    jcarry, tcarry = None, td._seed(tabs, b)
    for t0 in (0, 24):
        part = scores[:, t0:t0 + 24]
        nv = np.clip(n - t0, 0, 24)
        jcarry, jprev, jword = jax_scan(jd, part, t0, nv, jcarry)
        tcarry, tprev, tword = td._scan_plain(tabs, tcarry,
                                              torch.as_tensor(part), t0, nv)
        np.testing.assert_array_equal(tprev.numpy(), jprev)
        np.testing.assert_array_equal(tword.numpy(), jword)
        np.testing.assert_array_equal(tcarry[0].numpy(),
                                      np.asarray(jcarry[0]))
        np.testing.assert_array_equal(tcarry[1].numpy(),
                                      np.asarray(jcarry[1]))
        assert (tword.numpy() >= 0).any()


@pytest.mark.parametrize("lm_kind", LMS)
def test_chunked_stream_matches_jax(world, lm_kind):
    """``stream_feed`` in chunks of 16 frames (t0 = 0, 16, 32; rows that
    end inside a chunk frozen) in both packages, and JAX's one-shot
    ``decode_batch``: the same n-best words, scores at rtol 1e-4."""
    jd, td = decoders(world, lm_kind)
    feats, n = world["feats"], world["n_frames"]
    jst = jd.stream_init(batch=3, max_frames=48)
    tst = td.stream_init(batch=3, max_frames=48)
    for t0 in (0, 16, 32):
        nv = np.clip(n - t0, 0, 16)
        jst = jd.stream_feed(jst, feats[:, t0:t0 + 16], n_valid=nv)
        tst = td.stream_feed(tst, feats[:, t0:t0 + 16], n_valid=nv)
    assert tst.t_offset == 48
    got = td.stream_result(tst, return_nbest=3)
    for want in (jd.stream_result(jst, return_nbest=3),
                 jd.decode_batch(feats, n, return_nbest=3)):
        for g, w in zip(got, want):
            assert [h.words for h in g] == [h.words for h in w]
            assert np.allclose([h.score for h in g], [h.score for h in w],
                               rtol=1e-4, atol=0.0)


# ----------------------------------------------------------------------
# the kernel's source on the CPU

REPO = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
PLAIN_COPIES = """__device__ __forceinline__ void cp_async_f32(float* dst,
                                             const float* src) {
  *dst = *src;
}
__device__ __forceinline__ void cp_async_commit() {}
__device__ __forceinline__ void cp_async_wait_one() {}
__device__ __forceinline__ void cp_async_wait_all() {}

"""


def emulated_source(smem_limit=None) -> str:
    """``csrc/decoder_scan.cu`` for g++: the ``cp.async`` bodies become
    plain copies, the dynamic shared memory a per-block buffer, the launch a
    call of ``emu_launch``; ``smem_limit`` shrinks the shared memory a block
    may take, so that the device-memory instantiation runs."""
    src = (REPO / dk.SOURCE).read_text()
    a = src.index("__device__ __forceinline__ void cp_async_f32")
    b = src.index("// The total order of the emission")
    src = src[:a] + PLAIN_COPIES + src[b:]
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu_dyn_smem;")
    src, n = re.subn(r"(decoder_\w+_kernel<[^<>]*>)<<<([^>]*)>>>\(",
                     r"emu_launch(\1, \2, ", src)
    assert n == 3   # the frame scan's launch, the n-best's, the pruned scan's
    if smem_limit is not None:
        old = "constexpr size_t SMEM_LIMIT = 232448 - 1024;"
        assert old in src
        src = src.replace(old, f"constexpr size_t SMEM_LIMIT = {smem_limit};")
    return '#include "cuda_runtime.h"\n' + src


def emulated_library(tmp, smem_limit=None) -> ctypes.CDLL:
    """:func:`emulated_source` compiled with g++ into ``tmp`` and bound."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    name = f"limit{smem_limit}"
    cpp, so = tmp / f"{name}.cpp", tmp / f"lib{name}.so"
    cpp.write_text(emulated_source(smem_limit))
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{EMU}", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    return dk.bind(ctypes.CDLL(str(so)))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Both instantiations' libraries: the 125-node carry in the block's
    shared memory, and (the limit cut to 8,000 bytes) in device memory."""
    tmp = tmp_path_factory.mktemp("decoder_scan_emu")
    return {"smem": emulated_library(tmp),
            "global": emulated_library(tmp, 8000)}


def emulated_scan(lib, dec, tabs, carry, scores, t0, n_valid):
    """``decoder_scan_cuda``'s call, made on CPU tensors."""
    deltas, ctx = carry
    b, t_c, s = scores.shape
    n = tabs.bands.shape[0]
    _, st = dk._cached(tabs, dec._n_vocab, dec._r_top(tabs),
                       -float(dec.word_penalty))
    out = (torch.empty_like(deltas), torch.empty_like(ctx))
    rows = [torch.empty((b, t_c), dtype=torch.int32) for _ in range(2)]
    ex = torch.empty((b, n))
    exc = torch.empty((b, n), dtype=torch.int32)
    nv = torch.as_tensor(n_valid, dtype=torch.int32)
    rc = lib.decoder_scan_exact(
        ctypes.byref(st), scores.data_ptr(), nv.data_ptr(),
        deltas.data_ptr(), ctx.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), ex.data_ptr(), exc.data_ptr(), rows[0].data_ptr(),
        rows[1].data_ptr(), b, t_c, s, t0, None)
    assert rc == 0
    return out, rows[0], rows[1]


@pytest.mark.parametrize("lm_kind,inst", [
    ("none", "smem"), ("flat", "smem"), ("sparse", "smem"),
    ("none", "global"), ("sparse", "global")])
def test_kernel_source_on_cpu_is_the_plain_loop(world, emulated, lm_kind,
                                                inst):
    """Two chunks (t0 = 0 and 12) of the world's first 24 frames of scores,
    rounded to multiples of 8, one row ending inside the second chunk: the
    kernel's carry and rows equal the plain loop's bit for bit.  (One
    thread per CUDA thread makes a frame cost milliseconds here.)"""
    _, dec = decoders(world, lm_kind)
    tabs = dec._prep_device()
    n, n_s, _ = tabs.bands.shape
    s = dec.bank.num_states
    assert emulated[inst].decoder_scan_carry_in_smem(n, n_s, s) == \
        (inst == "smem")
    scores = torch.round(dec._scores(torch.as_tensor(world["feats"])) / 8) * 8
    n_frames = np.minimum(world["n_frames"], 24)
    assert n_frames[-1] == 20
    got = want = dec._seed(tabs, 3)
    for t0 in (0, 12):
        part = scores[:, t0:t0 + 12].contiguous()
        nv = np.clip(n_frames - t0, 0, 12)
        got, g_prev, g_word = emulated_scan(emulated[inst], dec, tabs, got,
                                            part, t0, nv)
        want, w_prev, w_word = dec._scan_plain(tabs, want, part, t0, nv)
        for g, w in zip((*got, g_prev, g_word), (*want, w_prev, w_word)):
            assert torch.equal(g, w)
    assert (g_word >= 0).any()


# ----------------------------------------------------------------------
# past the kernel's registers: 18 token states (state_num = 10), band
# width 10 (skip transitions), scores rows in device memory

def make_world(state_num, n_words=None, skips=False, seed=11):
    """``tests/test_torch_decoder.py``'s world at another ``state_num``:
    a JAX XIF_tone bank with random means (and, with ``skips``, every
    left-to-right transition of each unit live, so the decoder's band is
    ``state_num`` wide), its port copy, the built-in lexicon (or its first
    ``n_words`` words) in both packages, a bigram LM, features."""
    rng = np.random.default_rng(seed)
    cfg = ModelConfig(state_num=state_num, mix_level=2, max_mix_level=2)
    jinv = JaxInventory.standard("XIF_tone")
    jbank = jsb.create_bank(len(jinv), cfg, 13, key=jax.random.PRNGKey(1))
    means = rng.normal(size=np.shape(jbank.means)).astype(np.float32) * 2
    jbank = dataclasses.replace(jbank, means=jnp.asarray(means))
    if skips:
        log_a = np.array(jbank.log_A)
        n = state_num
        for row in range(n - 1):
            p = rng.dirichlet(np.ones(n - max(row, 1)))
            log_a[:, row] = -1e30
            log_a[:, row, max(row, 1):] = np.log(p)
        jbank = dataclasses.replace(jbank, log_A=jnp.asarray(
            log_a.astype(np.float32)))
    tbank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                 for f in tsb.FIELDS}, device="cpu")
    words = list(BUILTIN_PINYIN)[:n_words]
    jl, tl = JaxLexicon(), PronunciationLexicon()
    jl.generate(words, JaxPinYin())
    tl.generate(words, PinYin())
    lm = Ngram(2)
    lm.train([list(rng.choice(words, size=6)) for _ in range(200)])
    feats = (rng.normal(size=(3, 48, 13)) * 2).astype(np.float32)
    return dict(jbank=jbank, tbank=tbank,
                jflat=JaxFlat.from_tree(jl.lexicon, jinv),
                tflat=FlatLexicon.from_tree(tl.lexicon,
                                            UnitInventory.standard()),
                lm=lm, feats=feats, n_frames=np.array([48, 37, 20]))


@pytest.fixture(scope="module")
def worlds():
    made = {}

    def get(state_num, n_words=None, skips=False):
        key = (state_num, n_words, skips)
        if key not in made:
            made[key] = make_world(state_num, n_words, skips)
        return made[key]
    return get


@pytest.mark.parametrize("skips,lm_kind", [(False, "sparse"), (True, "none"),
                                           (True, "flat")])
def test_plain_scan_at_state_num_10_is_jax_step(worlds, skips, lm_kind):
    """18 token states a node (band width 2, or 10 with skips): the plain
    loop's carry and rows equal JAX's ``step`` bit for bit on tied scores,
    in two chunks."""
    w10 = worlds(10, skips=skips)
    jd, td = decoders(w10, lm_kind)
    jd._prep_device()
    tabs = td._prep_device()
    assert tuple(tabs.bands.shape[1:]) == (18, 10 if skips else 2)
    rng = np.random.default_rng(10)
    b = 4
    scores = (np.round(rng.normal(size=(b, 32, td.bank.num_states)) * 30 / 8)
              * 8).astype(np.float32)
    n = np.array([32, 27, 16, 5])
    jcarry, tcarry = None, td._seed(tabs, b)
    for t0 in (0, 16):
        part = scores[:, t0:t0 + 16]
        nv = np.clip(n - t0, 0, 16)
        jcarry, jprev, jword = jax_scan(jd, part, t0, nv, jcarry)
        tcarry, tprev, tword = td._scan_plain(tabs, tcarry,
                                              torch.as_tensor(part), t0, nv)
        np.testing.assert_array_equal(tprev.numpy(), jprev)
        np.testing.assert_array_equal(tword.numpy(), jword)
        for g, w in zip(tcarry, jcarry):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (tword.numpy() >= 0).any()


@pytest.mark.parametrize("skips", [False, True])
def test_decode_at_state_num_10_gives_jax_words(worlds, skips):
    """``decode_batch`` at ``state_num = 10`` with a sparse bigram LM: the
    n-best words of JAX, scores at rtol 1e-4."""
    w10 = worlds(10, skips=skips)
    jd, td = decoders(w10, "sparse")
    want = jd.decode_batch(w10["feats"], w10["n_frames"], return_nbest=3)
    got = td.decode_batch(w10["feats"], w10["n_frames"], return_nbest=3)
    for g, w in zip(got, want):
        assert len(g) >= 1
        assert [h.words for h in g] == [h.words for h in w]
        assert np.allclose([h.score for h in g], [h.score for h in w],
                           rtol=1e-4, atol=0.0)


# (state_num, words, skips, LM, cut shared memory, carry in shared memory,
#  rows in shared memory, states in registers)
SHAPE_CASES = [
    (10, None, False, "sparse", None, True, True, False),
    (10, None, True, "none", 12000, False, False, False),
    (10, 6, False, "flat", 10000, True, False, False),
    (5, None, False, "none", 4000, False, False, True),
    (5, 6, False, "sparse", 4000, True, False, True),
]


@pytest.fixture(scope="module")
def emulated_limits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decoder_scan_shapes")
    libs = {}

    def get(limit):
        if limit not in libs:
            libs[limit] = emulated_library(tmp, limit)
        return libs[limit]
    return get


@pytest.mark.parametrize(
    "state_num,n_words,skips,lm_kind,limit,carry,rows,regs", SHAPE_CASES,
    ids=[f"s{c[0]}w{c[1]}{'skip' if c[2] else ''}{c[3]}lim{c[4]}"
         for c in SHAPE_CASES])
def test_kernel_source_on_cpu_takes_every_shape(
        worlds, emulated_limits, state_num, n_words, skips, lm_kind, limit,
        carry, rows, regs):
    """The instantiations past the kernel's registers (18 states, band
    width 10) and those that read each frame's scores row from device
    memory (the shared-memory limit cut so that the rows do not fit), with
    the carry in shared or device memory: carry and rows equal the plain
    loop's bit for bit over two chunks of tied scores."""
    lib = emulated_limits(limit)
    wd = worlds(state_num, n_words, skips)
    _, dec = decoders(wd, lm_kind)
    tabs = dec._prep_device()
    n, n_s, w = tabs.bands.shape
    s = dec.bank.num_states
    assert (lib.decoder_scan_carry_in_smem(n, n_s, s),
            lib.decoder_scan_rows_in_smem(n, n_s, s),
            lib.decoder_scan_states_in_regs(n_s, w)) == (carry, rows, regs)
    scores = torch.round(dec._scores(torch.as_tensor(wd["feats"])) / 8) * 8
    n_frames = np.minimum(wd["n_frames"], 24)
    got = want = dec._seed(tabs, 3)
    for t0 in (0, 12):
        part = scores[:, t0:t0 + 12].contiguous()
        nv = np.clip(n_frames - t0, 0, 12)
        got, g_prev, g_word = emulated_scan(lib, dec, tabs, got, part, t0, nv)
        want, w_prev, w_word = dec._scan_plain(tabs, want, part, t0, nv)
        for g, w in zip((*got, g_prev, g_word), (*want, w_prev, w_word)):
            assert torch.equal(g, w)
    assert (g_word >= 0).any()
