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
    for name in ("node_info", "group_senone", "node_slot", "word_slot",
                 "lm_keys"):
        assert p.get(name, torch.zeros(1, dtype=i32)).dtype == i32, name
    assert torch.equal(p["bands"], tabs.bands)
    # the group tables reproduce every node's senone and band rows
    info = p["node_info"].long()
    group = info[:, 0]
    senone = p["group_senone"][group].long()
    assert torch.equal(senone.clamp(min=0), tabs.senone)
    assert torch.equal(senone >= 0, tabs.emitting)
    assert torch.equal(p["group_bands"][group], tabs.bands)
    assert p["group_senone"].shape[0] == dk.n_groups(tabs) <= tabs.bands.shape[0]
    # the parent word: root-child flag, "has a parent", the parent
    assert torch.equal((info[:, 1] & 1).bool(), tabs.is_root_child)
    assert torch.equal((info[:, 1] >> 1 & 1).bool(), tabs.has_parent)
    assert torch.equal(info[:, 1] >> 2,
                       torch.where(tabs.has_parent, tabs.parent, 0))
    # each node's valid slots, one range
    for n in range(tabs.bands.shape[0]):
        want = torch.nonzero((tabs.node_slot == n) & tabs.slot_valid)[:, 0]
        got = torch.arange(info[n, 2], info[n, 2] + info[n, 3])
        assert torch.equal(got, want), n
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
    assert st.node_info == p["node_info"].data_ptr()
    assert st.n_groups == p["group_senone"].shape[0]
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
__device__ __forceinline__ unsigned cluster_rank() {
  return emu_cluster_rank;
}
__device__ __forceinline__ void cluster_sync() { emu_cluster_sync(); }
template <class T>
__device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
  return emu_cluster_map(p, rank);
}

"""


def emulated_source(smem_limit=None, max_cluster=None) -> str:
    """``csrc/decoder_scan.cu`` for g++: the ``cp.async`` bodies become
    plain copies, the cluster helpers (rank, barrier, distributed shared
    memory) the emulation's, the dynamic shared memory a per-block buffer,
    the ``<<<...>>>`` launches calls of ``emu_launch`` (the frame scan's
    ``cudaLaunchKernelEx`` runs its clusters in the emulation);
    ``smem_limit`` shrinks the shared memory a block may take and
    ``max_cluster`` the CTAs an utterance may take, so that the cluster or
    the device-memory route runs."""
    src = (REPO / dk.SOURCE).read_text()
    a = src.index("__device__ __forceinline__ void cp_async_f32")
    b = src.index("// The total order of the emission")
    src = src[:a] + PLAIN_COPIES + src[b:]
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu_dyn_smem;")
    src, n = re.subn(r"(decoder_\w+_kernel<[^<>]*>)<<<([^>]*)>>>\(",
                     r"emu_launch(\1, \2, ", src)
    assert n == 2   # the n-best's launch and the pruned scan's
    for name, value in (("SMEM_LIMIT", smem_limit),
                        ("MAX_CLUSTER", max_cluster)):
        if value is not None:
            src, n = re.subn(rf"constexpr (\w+) {name} = [^;]*;",
                             rf"constexpr \1 {name} = {value};", src)
            assert n == 1, name
    return '#include "cuda_runtime.h"\n' + src


def emulated_library(tmp, smem_limit=None, max_cluster=None,
                     source=None) -> ctypes.CDLL:
    """:func:`emulated_source` (or ``source``) compiled with g++ into
    ``tmp`` and bound."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    name = f"limit{smem_limit}c{max_cluster}{'' if source is None else 'x'}"
    cpp, so = tmp / f"{name}.cpp", tmp / f"lib{name}.so"
    cpp.write_text(source or emulated_source(smem_limit, max_cluster))
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{EMU}", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    return dk.bind(ctypes.CDLL(str(so)))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Both routes' libraries: the 125-node carry in one CTA's shared
    memory, and (the limit cut to 8,000 bytes, one CTA an utterance) in
    device memory."""
    tmp = tmp_path_factory.mktemp("decoder_scan_emu")
    return {"smem": emulated_library(tmp),
            "global": emulated_library(tmp, 8000, 1)}


def emulated_scan(lib, dec, tabs, carry, scores, t0, n_valid):
    """``decoder_scan_cuda``'s call, made on CPU tensors."""
    deltas, ctx = carry
    b, t_c, s = scores.shape
    _, st = dk._cached(tabs, dec._n_vocab, dec._r_top(tabs),
                       -float(dec.word_penalty))
    out = (torch.empty_like(deltas), torch.empty_like(ctx))
    rows = [torch.empty((b, t_c), dtype=torch.int32) for _ in range(2)]
    # the device-memory route's scratch, stale as on a card
    words = max(1, dk._plan_of(st, s, lib, b)["scratch_words"])
    xf = torch.full((b, words), float("nan"))
    xi = torch.full((b, words), -77, dtype=torch.int32)
    nv = torch.as_tensor(n_valid, dtype=torch.int32)
    rc = lib.decoder_scan_exact(
        ctypes.byref(st), scores.data_ptr(), nv.data_ptr(),
        deltas.data_ptr(), ctx.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), xf.data_ptr(), xi.data_ptr(), rows[0].data_ptr(),
        rows[1].data_ptr(), b, t_c, s, t0, None, None)
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
    s = dec.bank.num_states
    assert dk.scan_plan(tabs, s, dec._r_top(tabs),
                        lib=emulated[inst])["route"] == inst
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


# (state_num, words, skips, LM, cut shared memory, most CTAs an utterance,
#  route, CTAs an utterance, rows in shared memory, states in registers);
# the cluster cases split a few dozen nodes over 2 or 3 CTAs (3: 42, 42
# and 41 of 125 nodes); the last two run the register advance unrolled to
# 16 states and 8 offsets at 8 states and band width 5 (skips at
# state_num 5) and at 12 states (state_num 7)
SHAPE_CASES = [
    (10, None, False, "sparse", None, None, "smem", 1, True, False),
    (10, None, True, "none", 12000, 1, "global", 1, False, False),
    (10, 6, False, "flat", 10000, None, "smem", 1, False, False),
    (5, None, False, "none", 4000, 1, "global", 1, False, True),
    (5, 6, False, "sparse", 8000, None, "smem", 1, False, True),
    (5, None, False, "none", 12000, None, "cluster", 3, True, True),
    (5, None, False, "none", 7000, None, "cluster", 2, False, True),
    (5, 12, False, "sparse", 14000, None, "cluster", 2, True, True),
    (5, 20, False, "flat", 8000, None, "cluster", 2, False, True),
    (10, None, False, "sparse", 14000, None, "cluster", 3, False, False),
    (10, None, True, "none", 12000, None, "cluster", 2, False, False),
    (5, None, True, "sparse", None, None, "smem", 1, True, True),
    (7, None, False, "flat", None, None, "smem", 1, True, True),
]


@pytest.fixture(scope="module")
def emulated_limits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decoder_scan_shapes")
    libs = {}

    def get(limit, max_cluster=None):
        if (limit, max_cluster) not in libs:
            libs[limit, max_cluster] = emulated_library(tmp, limit,
                                                        max_cluster)
        return libs[limit, max_cluster]
    return get


@pytest.mark.parametrize(
    "state_num,n_words,skips,lm_kind,limit,most,route,ctas,rows,regs",
    SHAPE_CASES,
    ids=[f"s{c[0]}w{c[1]}{'skip' if c[2] else ''}{c[3]}lim{c[4]}{more}"
         for c, more in zip(SHAPE_CASES,
                            ("",) * 5 + ("cluster",) * 6 + ("regs",) * 2)])
def test_kernel_source_on_cpu_takes_every_shape(
        worlds, emulated_limits, state_num, n_words, skips, lm_kind, limit,
        most, route, ctas, rows, regs):
    """The instantiations past the kernel's registers (18 states, band
    width 10) and those that read each frame's scores row from device
    memory (the shared-memory limit cut so that the rows do not fit), with
    the carry in one CTA's shared memory, split over a cluster of 2 or 3
    CTAs (the limit cut so that one CTA's does not hold it; a parent's exit
    and the emission's lists cross CTAs through their shared memory), or in
    device memory: carry and rows equal the plain loop's bit for bit over
    two chunks of tied scores, rows frozen inside the second."""
    lib = emulated_limits(limit, most)
    wd = worlds(state_num, n_words, skips)
    _, dec = decoders(wd, lm_kind)
    tabs = dec._prep_device()
    n, n_s, w = tabs.bands.shape
    s = dec.bank.num_states
    plan = dk.scan_plan(tabs, s, dec._r_top(tabs), lib=lib)
    assert (plan["route"], plan["cluster"], plan["rows_smem"],
            bool(lib.decoder_scan_states_in_regs(n_s, w))) == \
        (route, ctas, rows, regs)
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


# The device-memory route (a carry no on-chip cluster holds) on clusters of
# 2 and 3 CTAs: (state_num, skips, LM, cut shared memory, most CTAs an
# utterance, CTAs an utterance, rows in shared memory, info and exits in
# shared memory, nodes a CTA keeps the carry of on chip, of nodes a CTA);
# the register kind (8 states and 2 offsets, the only one off chip), the
# in-place advance by windows of states (band width 2: 12 and 18 states)
# and a node at a time (band width 5 and 10), part of each CTA's carry on
# chip or none, exits in shared memory or in the scratch (read across CTAs
# there).
GLOBAL_CASES = [
    (5, False, "none", 10000, 3, 3, True, True, 15, 42),
    (5, False, "sparse", 10000, 2, 2, False, True, 24, 63),
    (5, False, "flat", 8000, 3, 3, False, True, 4, 42),
    (5, True, "none", 12000, 2, 2, True, True, 36, 63),
    (7, False, "none", 8000, 2, 2, False, True, 58, 63),
    (10, False, "none", 6000, 3, 3, False, True, 29, 42),
    (10, False, "flat", 12000, 2, 2, False, True, 24, 63),
    (10, True, "sparse", 10000, 3, 3, False, True, 15, 42),
    (5, False, "none", 8000, 3, 3, True, False, 0, 42),
    (10, False, "flat", 8000, 2, 2, False, False, 0, 63),
]


@pytest.mark.parametrize(
    "state_num,skips,lm_kind,limit,most,ctas,rows,exits,on_chip,chunk",
    GLOBAL_CASES,
    ids=[f"s{c[0]}{'skip' if c[1] else ''}{c[2]}lim{c[3]}c{c[4]}"
         for c in GLOBAL_CASES])
def test_device_memory_route_on_cpu_is_the_plain_loop(
        worlds, emulated_limits, state_num, skips, lm_kind, limit, most,
        ctas, rows, exits, on_chip, chunk):
    """A carry that no cluster of ``most`` CTAs holds on chip: each
    utterance over a cluster of 2 or 3 CTAs, each CTA with its nodes' info
    and exits in its shared memory (or, where they do not fit, in the
    scratch) and the carry of its first nodes on chip, the rest in the
    scratch, by state: carry and rows equal the plain loop's bit for bit
    over two chunks of tied scores (t0 = 0 and 12), rows frozen inside the
    second; and a batch too large for the card to run in one wave at that
    cluster size takes one CTA an utterance."""
    lib = emulated_limits(limit, most)
    wd = worlds(state_num, None, skips)
    _, dec = decoders(wd, lm_kind)
    tabs = dec._prep_device()
    s, r_top = dec.bank.num_states, dec._r_top(tabs)
    plan = dk.scan_plan(tabs, s, r_top, lib=lib, batch=3)
    assert (plan["route"], plan["cluster"], plan["rows_smem"],
            plan["exits_smem"], plan["nodes_on_chip"],
            plan["nodes_per_cta"]) == \
        ("global", ctas, rows, exits, on_chip, chunk)
    n, n_s, _ = tabs.bands.shape
    assert plan["scratch_words"] == ctas * (
        n_s * (chunk - on_chip) + (0 if exits else 2 * chunk))
    # the emulated card runs 132 / cluster size clusters at once: 100
    # utterances in one wave of single CTAs
    assert dk.scan_plan(tabs, s, r_top, lib=lib, batch=100)["cluster"] == 1
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


# the emission's total order reversed on equal values: the higher slot first
ORDER_MUTANT = ("return va > vb || (va == vb && qa < qb);",
                "return va > vb || (va == vb && qa > qb);")
KEY_MUTANT = (("q = (int)__reduce_min_sync(", "q = (int)__reduce_max_sync("),
              ("key == top ? (unsigned)q : 0xffffffffu",
               "key == top ? (unsigned)q : 0u"))


@pytest.mark.parametrize("exits", [True, False])
def test_device_memory_route_tie_mutant_is_rejected(world, tmp_path, exits):
    """The device-memory route over a cluster of 3 CTAs (the nodes' exits in
    shared memory or in the scratch) with the emission's slot order
    reversed among equal exits: on tied scores its rows or carry leave the
    plain loop's."""
    limit = 10000 if exits else 8000
    src = emulated_source(limit, 3)
    for old, new in (ORDER_MUTANT, *KEY_MUTANT):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = emulated_library(tmp_path, source=src)
    _, dec = decoders(world, "none")
    tabs = dec._prep_device()
    plan = dk.scan_plan(tabs, dec.bank.num_states, dec._r_top(tabs),
                        lib=lib, batch=3)
    assert (plan["route"], plan["cluster"], plan["exits_smem"]) == \
        ("global", 3, exits)
    scores = torch.round(dec._scores(torch.as_tensor(world["feats"])) / 8) * 8
    n_frames = np.minimum(world["n_frames"], 24)
    part = scores[:, :24].contiguous()
    got, g_prev, g_word = emulated_scan(lib, dec, tabs, dec._seed(tabs, 3),
                                        part, 0, n_frames)
    want, w_prev, w_word = dec._scan_plain(tabs, dec._seed(tabs, 3), part, 0,
                                           n_frames)
    assert not all(torch.equal(g, w) for g, w in zip(
        (*got, g_prev, g_word), (*want, w_prev, w_word)))


# a cluster occupancy query that fails (the card refusing a shape)
OCCUPANCY_QUERY = "return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);"


@pytest.mark.parametrize("limit", [None, 12000])
def test_failed_occupancy_query_is_raised(world, tmp_path, limit):
    """Where the cluster route's occupancy query fails, the plan and the
    launch return its error (the wrapper raises) instead of moving the scan
    to another route; one CTA asks no query and runs."""
    src = emulated_source(limit)
    assert src.count(OCCUPANCY_QUERY) == 1
    lib = emulated_library(tmp_path, source=src.replace(
        OCCUPANCY_QUERY, "return (cudaError_t)2;"))
    _, dec = decoders(world, "none")
    tabs = dec._prep_device()
    s, r_top = dec.bank.num_states, dec._r_top(tabs)
    if limit is None:
        assert dk.scan_plan(tabs, s, r_top, lib=lib)["route"] == "smem"
        return
    with pytest.raises(RuntimeError, match="plan failed"):
        dk.scan_plan(tabs, s, r_top, lib=lib)
    _, st = dk._cached(tabs, dec._n_vocab, r_top, -float(dec.word_penalty))
    scores = dec._scores(torch.as_tensor(world["feats"]))[:, :4].contiguous()
    b, n, n_s = scores.shape[0], *tabs.bands.shape[:2]
    carry = [torch.empty((b, n, n_s)),
             torch.empty((b, n, n_s), dtype=torch.int32)]
    rows = [torch.empty((b, 4), dtype=torch.int32) for _ in range(2)]
    scratch = torch.empty((b, 2, n))
    nv = torch.full((b,), 4, dtype=torch.int32)
    seed = dec._seed(tabs, b)
    assert lib.decoder_scan_exact(
        ctypes.byref(st), scores.data_ptr(), nv.data_ptr(),
        seed[0].data_ptr(), seed[1].data_ptr(), carry[0].data_ptr(),
        carry[1].data_ptr(), scratch.data_ptr(), scratch.data_ptr(),
        rows[0].data_ptr(), rows[1].data_ptr(), b, 4, s, 0, None, None) == 2


@pytest.mark.parametrize("limit", [None, 12000])
def test_tie_order_mutant_is_rejected(world, tmp_path, limit):
    """The per-warp top R and the merges taking the higher slot first among
    equal exits (a consistent order, but not ``lax.top_k``'s), on one CTA
    and on a cluster of 3: on tied scores (two slots of one node emit the
    same score every frame) the kernel's rows or carry leave the plain
    loop's."""
    lm_kind = "none"
    src = emulated_source(limit)
    for old, new in (ORDER_MUTANT, *KEY_MUTANT):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = emulated_library(tmp_path, source=src)
    _, dec = decoders(world, lm_kind)
    tabs = dec._prep_device()
    assert dk.scan_plan(tabs, dec.bank.num_states, dec._r_top(tabs),
                        lib=lib)["cluster"] == (1 if limit is None else 3)
    scores = torch.round(dec._scores(torch.as_tensor(world["feats"])) / 8) * 8
    n_frames = np.minimum(world["n_frames"], 24)
    part = scores[:, :24].contiguous()
    got, g_prev, g_word = emulated_scan(lib, dec, tabs, dec._seed(tabs, 3),
                                        part, 0, n_frames)
    want, w_prev, w_word = dec._scan_plain(tabs, dec._seed(tabs, 3), part, 0,
                                           n_frames)
    assert not all(torch.equal(g, w) for g, w in zip(
        (*got, g_prev, g_word), (*want, w_prev, w_word)))
