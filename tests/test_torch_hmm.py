"""The PyTorch port's HMM dynamic programming and sentence-HMM topology vs
the JAX package.

Seeded numpy inputs go through ``poccala_tpu.ops.hmm`` and
``poccala_tpu_torch.ops.hmm`` (the plain PyTorch versions, which the CPU
runs): alphas, betas, logliks and Viterbi scores agree at rtol = atol =
1e-5 (the bar of ``tests/test_gmm_hmm_kernels.py:102``), Viterbi paths
exactly.  The sentence-HMM tables of ``models/topology.py`` are equal
exactly, and the ``__graft_entry__.entry`` forward step composed from the
port's modules gives the JAX logliks.  The kernels' source
``csrc/hmm_banded.cu``, compiled with g++ against
``tests/cuda_emu/cuda_runtime.h`` (one thread per CUDA thread, a cluster's
CTAs together), runs on the CPU: forward and backward's block route
against the plain versions (N = 129 to 1,100, W = 9 and 16), bit for bit
against the warp kernels at N <= 128 and against the block kernels it
replaced (``tests/cuda_emu/hmm_banded_parent.cu``) on one CTA an
utterance and over clusters; Viterbi's loop instantiation (N > 1,024)
against the plain version at N = 1,100 and bit for bit against the
one-thread-a-state one where both take a shape.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from poccala_tpu.models import topology as jtop
from poccala_tpu.ops import hmm as jhmm
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.models import topology as ttop
from poccala_tpu_torch.ops import hmm as thmm
from poccala_tpu_torch.ops.cuda import hmm_banded_cuda as hk
from poccala_tpu_torch.ops.gmm_score import gmm_log_scores

from .test_senone_topology import make_bank

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
NEG = -1e30


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def banded_inputs(rng, b, t_pad, n, w, ragged=True):
    """Left-to-right bands with dead edges, log_b at MFCC-GMM scale with
    some impossible states, and ragged frame masks (one all-padded
    utterance when ragged)."""
    band = np.log(rng.dirichlet(np.ones(w), size=(b, n))).astype(np.float32)
    col = np.arange(n)[:, None] + np.arange(w)[None, :]
    band = np.where(col[None] < n, band, NEG).astype(np.float32)
    if w >= 3:
        band[:, :, 3:] = np.where(rng.uniform(size=(b, n, w - 3)) < 0.5,
                                  NEG, band[:, :, 3:])
    log_pi = np.log(rng.dirichlet(np.ones(n), size=b)).astype(np.float32)
    log_b = (rng.normal(size=(b, t_pad, n)) * 20 - 60).astype(np.float32)
    log_b[:, :, -1] = NEG
    lens = (rng.integers(1, t_pad + 1, size=b) if ragged
            else np.full(b, t_pad))
    if ragged:
        lens[0], lens[-1] = t_pad, 1
    masks = np.arange(t_pad)[None] < lens[:, None]
    if ragged and b > 2:
        masks[1] = False
    return band, log_pi, log_b, masks


@pytest.mark.parametrize("b,t_pad,n,w", [(4, 18, 11, 5), (3, 40, 26, 5),
                                         (2, 1, 8, 4)])
def test_banded_matches_jax(rng, b, t_pad, n, w):
    band, log_pi, log_b, masks = banded_inputs(rng, b, t_pad, n, w)
    args = (jnp.asarray(band), jnp.asarray(log_pi), jnp.asarray(log_b),
            jnp.asarray(masks))
    la, ll = jhmm.forward_log_banded_batch(*args, w=w)
    lb = jhmm.backward_log_banded_batch(args[0], args[2], args[3], w=w)
    before = [k.launches for k in hk.KERNELS.values()]
    ta, tll = thmm.forward_log_banded_batch(t(band), t(log_pi), t(log_b),
                                            t(masks), w)
    tb = thmm.backward_log_banded_batch(t(band), t(log_b), t(masks), w)
    close(ta, la)
    close(tll, ll)
    close(tb, lb)
    for end_states in (0, 3):
        sc, path, delta = jhmm.viterbi_log_banded_batch(
            *args, w=w, end_states=end_states)
        tsc, tpath, tdelta = thmm.viterbi_log_banded_batch(
            t(band), t(log_pi), t(log_b), t(masks), w, end_states)
        assert tpath.dtype == torch.int32
        assert np.array_equal(tpath.numpy(), np.asarray(path))
        close(tsc, sc)
        close(tdelta, delta)
    # the CPU never launches the kernels
    assert [k.launches for k in hk.KERNELS.values()] == before


def test_single_utterance_wrappers(rng):
    band, log_pi, log_b, masks = banded_inputs(rng, 1, 20, 11, 5, False)
    masks[0, 14:] = False
    la, ll = jhmm.forward_log_banded(band[0], log_pi[0], log_b[0], masks[0],
                                     w=5)
    ta, tll = thmm.forward_log_banded(t(band[0]), t(log_pi[0]), t(log_b[0]),
                                      t(masks[0]), 5)
    close(ta, la)
    close(tll, ll)
    close(thmm.backward_log_banded(t(band[0]), t(log_b[0]), t(masks[0]), 5),
          jhmm.backward_log_banded(band[0], log_b[0], masks[0], w=5))
    sc, path, _ = jhmm.viterbi_log_banded(band[0], log_pi[0], log_b[0],
                                          masks[0], w=5, end_states=2)
    tsc, tpath, _ = thmm.viterbi_log_banded(t(band[0]), t(log_pi[0]),
                                            t(log_b[0]), t(masks[0]), 5, 2)
    assert np.array_equal(tpath.numpy(), np.asarray(path))
    close(tsc, sc)


def test_viterbi_tie_order(rng):
    """Exact ties everywhere: equal band entries and equal scores.  JAX's
    argmax takes the first maximum (smallest offset, lowest final state);
    the port must take the same path."""
    n, w, t_pad = 9, 4, 12
    band = np.full((2, n, w), np.log(0.25), np.float32)
    col = np.arange(n)[:, None] + np.arange(w)[None, :]
    band = np.where(col[None] < n, band, NEG).astype(np.float32)
    log_pi = np.zeros((2, n), np.float32)
    log_b = np.zeros((2, t_pad, n), np.float32)
    masks = np.ones((2, t_pad), bool)
    masks[1, 7:] = False
    sc, path, _ = jhmm.viterbi_log_banded_batch(
        jnp.asarray(band), jnp.asarray(log_pi), jnp.asarray(log_b),
        jnp.asarray(masks), w=w)
    tsc, tpath, _ = thmm.viterbi_log_banded_batch(
        t(band), t(log_pi), t(log_b), t(masks), w)
    assert np.array_equal(tpath.numpy(), np.asarray(path))
    close(tsc, sc)


@pytest.mark.parametrize("n,t_pad", [(6, 25), (12, 40)])
def test_dense_matches_jax(rng, n, t_pad):
    a = rng.dirichlet(np.ones(n), size=n)
    a[rng.uniform(size=(n, n)) < 0.3] = 0.0
    log_A = np.where(a > 0, np.log(np.maximum(a, 1e-30)), NEG).astype(
        np.float32)
    log_pi = np.log(rng.dirichlet(np.ones(n))).astype(np.float32)
    # floor-variance scale per-frame scores, where the renormalised
    # alpha and its Kahan-compensated shift matter
    log_b = (rng.normal(size=(t_pad, n)) * 300 - 800).astype(np.float32)
    mask = np.arange(t_pad) < t_pad - 5
    la, ll = jhmm.forward_log(log_A, log_pi, log_b, mask)
    ta, tll = thmm.forward_log(t(log_A), t(log_pi), t(log_b), t(mask))
    close(ta, la)
    close(tll, ll)
    close(thmm.backward_log(t(log_A), t(log_b), t(mask)),
          jhmm.backward_log(log_A, log_b, mask))
    sc, path, delta = jhmm.viterbi_log(log_A, log_pi, log_b, mask)
    tsc, tpath, tdelta = thmm.viterbi_log(t(log_A), t(log_pi), t(log_b),
                                          t(mask))
    assert np.array_equal(tpath.numpy(), np.asarray(path))
    close(tsc, sc)
    close(tdelta, delta)


def test_band_conversions(rng):
    n, w = 7, 3
    a = np.where(rng.uniform(size=(n, n)) < 0.6,
                 rng.normal(size=(n, n)), NEG).astype(np.float32)
    band = jhmm.dense_to_band(jnp.asarray(a), w)
    tband = thmm.dense_to_band(t(a), w)
    assert np.array_equal(tband.numpy(), np.asarray(band))
    assert np.array_equal(thmm.band_to_dense(tband).numpy(),
                          np.asarray(jhmm.band_to_dense(band)))


# ----------------------------------------------------------------------
# topology
# ----------------------------------------------------------------------

def banks(rng, num_units=5, state_num=5, mix=2, dim=5):
    cfg, jbank = make_bank(rng, num_units=num_units, state_num=state_num,
                           mix=mix, max_mix=mix, dim=dim)
    tbank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                 for f in tsb.FIELDS}, device="cpu")
    return cfg, jbank, tbank


def test_build_embedded_matches_jax(rng):
    cfg, jbank, tbank = banks(rng)
    max_l = 4
    labels = rng.integers(0, 5, size=(5, max_l)).astype(np.int32)
    lens = np.array([4, 1, 3, 0, 2], np.int32)
    want = jtop.build_embedded_batch(jbank, jnp.asarray(labels),
                                     jnp.asarray(lens), cfg.state_num, max_l)
    got = ttop.build_embedded_batch(tbank, t(labels), t(lens), cfg.state_num,
                                    max_l)
    assert got.band.shape == (5, ttop.max_states(max_l, 5), 5)
    for f in ("band", "log_pi", "senone_idx", "state_mask", "n_states"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        assert np.array_equal(g, w), f
    one = ttop.build_embedded(tbank, t(labels[2]), 3, cfg.state_num, max_l)
    assert np.array_equal(one.band.numpy(), got.band[2].numpy())
    assert int(one.n_states) == 11

    # log_b and the state -> label map
    t_pad = 9
    scores = rng.normal(size=(5, t_pad, jbank.num_states)).astype(np.float32)
    wlb = jtop.embedded_log_b_batch(jnp.asarray(scores), want)
    glb = ttop.embedded_log_b(t(scores), got)
    assert np.array_equal(glb.numpy(), np.asarray(wlb))
    paths = rng.integers(0, got.band.shape[1], size=(5, t_pad)).astype(
        np.int32)
    for i in range(5):
        wpos, wunit = jtop.states_to_labels(
            jnp.asarray(paths[i]), jax_item(want, i), jnp.asarray(labels[i]),
            cfg.state_num)
        gpos, gunit = ttop.states_to_labels(t(paths[i:i + 1]),
                                            torch_item(got, i),
                                            t(labels[i:i + 1]), cfg.state_num)
        assert np.array_equal(gpos[0].numpy(), np.asarray(wpos))
        assert np.array_equal(gunit[0].numpy(), np.asarray(wunit))


def jax_item(e, i):
    return jtop.EmbeddedHMM(*(getattr(e, f)[i] for f in
                              ("band", "log_pi", "senone_idx", "state_mask",
                               "n_states")))


def torch_item(e, i):
    return ttop.EmbeddedHMM(*(getattr(e, f)[i:i + 1] for f in
                              ("band", "log_pi", "senone_idx", "state_mask",
                               "n_states")))


def test_graft_entry_forward_step():
    """``__graft_entry__.entry``'s forward step on its own bank and batch,
    composed from the port's modules: GMM scores -> sentence HMMs ->
    sentence log_b -> banded forward."""
    fn, args = graft.entry()
    want = np.asarray(fn(*args))
    jbank, labels, lens, xs, masks = args
    bank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                for f in tsb.FIELDS}, device="cpu")
    xs = t(np.asarray(xs))
    b, t_pad, d = xs.shape
    scores = gmm_log_scores(xs.reshape(b * t_pad, d), bank.means,
                            bank.log_var, bank.log_w).reshape(b, t_pad, -1)
    ehmm = ttop.build_embedded_batch(bank, t(np.asarray(labels)),
                                     t(np.asarray(lens)), 5, 4)
    log_b = ttop.embedded_log_b(scores, ehmm)
    _, got = thmm.forward_log_banded_batch(ehmm.band, ehmm.log_pi, log_b,
                                           t(np.asarray(masks)), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


# ----------------------------------------------------------------------
# the DP kernels' source on the CPU

REPO = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
DP_PLAIN_ASYNC = """__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  *dst = *src;
}
__device__ __forceinline__ void cp_async_commit() {}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {}
__device__ __forceinline__ float select_f32(bool c, float x, float y) {
  return c ? x : y;
}
__device__ __forceinline__ void cluster_sync() { emu_cluster_sync(); }
template <class T>
__device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
  return emu_cluster_map(p, rank);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  emu_mbar_init(bar, count);
}
__device__ __forceinline__ void mbar_init_fence() {}
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  emu_mbar_update(bar, 1, (int)bytes);
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  emu_mbar_wait(bar, parity);
}
__device__ __forceinline__ void st_async(float* dst, float v, uint64_t* bar,
                                         unsigned rank) {
  *emu_cluster_map(dst, rank) = v;
  emu_mbar_update(emu_cluster_map(bar, rank), 0, -4);
}

"""
PARENT_SOURCE = Path(__file__).resolve().parent / "cuda_emu" / \
    "hmm_banded_parent.cu"


def emulated_dp_source(block_max_n=None, parent=False, **limits) -> str:
    """``csrc/hmm_banded.cu`` (``parent``: the block kernels before their
    redesign, ``tests/cuda_emu/hmm_banded_parent.cu``) for g++: the
    ``cp.async``, ``selp``, cluster (barrier, distributed shared memory),
    mbarrier and ``st.async`` bodies become plain C or the emulation's, the dynamic shared
    memory a per-block buffer, every ``<<<...>>>`` launch a call of
    ``emu_launch`` (the block route's ``cudaLaunchKernelEx`` runs its
    clusters in the emulation); ``block_max_n`` cuts Viterbi's block
    kernel's limit, so that smaller shapes take its loop instantiation, and
    ``limits`` (``BLOCK_WARPS``, ``MAX_CLUSTER``) the block route's CTA and
    cluster, so that smaller shapes take several CTAs or more places a
    lane."""
    src = (PARENT_SOURCE if parent else REPO / hk.SOURCE).read_text()
    a = src.index("__device__ __forceinline__ void cp_async_f32")
    b = src.index("// The block kernels' lse_of with an exact band width."
                  if parent else "// A step's logsumexp at the band width")
    src = src[:a] + DP_PLAIN_ASYNC + src[b:]
    src = src.replace("extern __shared__ float sm[];",
                      "float* sm = reinterpret_cast<float*>(emu_dyn_smem);")
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char viterbi_offs[];",
        "unsigned char* viterbi_offs = emu_dyn_smem;")
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char dp_smem[];",
        "unsigned char* dp_smem = emu_dyn_smem;")
    src, n = re.subn(r"(\b\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\(",
                     r"emu_launch(\1, \2, ", src)
    # parent: warp macro, loop helper, three block kernels; now: warp
    # macro, loop helper, Viterbi's block kernel (the block route launches
    # through cudaLaunchKernelEx)
    assert n == (5 if parent else 3)
    if parent:   # so that hk.bind binds it: the parent has no block plan
        src += ('extern "C" int hmm_banded_block_plan(int, int, int, int, '
                'int*) { return 1; }\n')
    if block_max_n is not None:
        limits["BLOCK_MAX_N"] = block_max_n
    for name, value in limits.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]*;",
                         f"constexpr int {name} = {value};", src)
        assert n == 1, name
    return '#include "cuda_runtime.h"\n' + src


def emulated_dp_libraries(tmp, sources: dict) -> dict:
    """name -> ``sources[name]`` (an :func:`emulated_dp_source`) compiled
    with g++ into ``tmp`` (all at once) and bound."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' source for the CPU")
    procs = {}
    for name, src in sources.items():
        cpp, so = tmp / f"{name}.cpp", tmp / f"lib{name}.so"
        cpp.write_text(src)
        procs[name] = so, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             f"-I{EMU}", "-o", str(so), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err.decode()[-3000:]
        libs[name] = hk.bind(ctypes.CDLL(str(so)))
    return libs


@pytest.fixture(scope="module")
def emulated_dp(tmp_path_factory):
    """The DP library as it is; with Viterbi's block kernel cut to 64
    states (``cut``); the block kernels before their redesign
    (``parent``); the block route on one CTA an utterance (``one_cta``:
    up to 4 places a lane) and on CTAs of two warps (``small_cta``: an
    utterance over a cluster of several CTAs)."""
    builds = {"as_is": {}, "cut": dict(block_max_n=64),
              "parent": dict(parent=True), "one_cta": dict(MAX_CLUSTER=1),
              "small_cta": dict(BLOCK_WARPS=2)}
    return emulated_dp_libraries(
        tmp_path_factory.mktemp("hmm_banded_emu"),
        {name: emulated_dp_source(**kw) for name, kw in builds.items()})


def dp_calls(lib, band, log_pi, log_b, masks, w, end_states=0,
             block=False):
    """The three wrappers' calls, made on CPU tensors: ``(alpha, loglik),
    beta, (score, path, delta)``."""
    b, t_pad, n = log_b.shape
    band, log_pi, log_b = (torch.as_tensor(a, dtype=torch.float32)
                           .contiguous() for a in (band, log_pi, log_b))
    mask = torch.as_tensor(masks).to(torch.uint8).contiguous()
    alpha, beta = torch.empty(b, t_pad, n), torch.empty(b, t_pad, n)
    loglik, score = torch.empty(b), torch.empty(b)
    path = torch.empty(b, t_pad, dtype=torch.int32)
    delta = torch.empty(b, n)
    offs = torch.empty(max(b * (t_pad - 1) * n, 1), dtype=torch.uint8)
    sfx = "_block" if block else ""
    rc = [getattr(lib, f"hmm_forward_banded{sfx}")(
              band.data_ptr(), log_pi.data_ptr(), log_b.data_ptr(),
              mask.data_ptr(), alpha.data_ptr(), loglik.data_ptr(), b, t_pad,
              n, w, None),
          getattr(lib, f"hmm_backward_banded{sfx}")(
              band.data_ptr(), log_b.data_ptr(), mask.data_ptr(),
              beta.data_ptr(), b, t_pad, n, w, None),
          getattr(lib, f"hmm_viterbi_banded{sfx}")(
              band.data_ptr(), log_pi.data_ptr(), log_b.data_ptr(),
              mask.data_ptr(), offs.data_ptr(), score.data_ptr(),
              path.data_ptr(), delta.data_ptr(), b, t_pad, n, w, end_states,
              None)]
    assert rc == [0, 0, 0]
    return (alpha, loglik), beta, (score, path, delta)


def tied_inputs(rng, b, t_pad, n, w):
    """:func:`banded_inputs` with log_b rounded to multiples of 8: ties in
    every step's maximum and at the end."""
    band, log_pi, log_b, masks = banded_inputs(rng, b, t_pad, n, w)
    log_b = np.where(log_b > -1e29, np.round(log_b / 8) * 8,
                     log_b).astype(np.float32)
    return band, log_pi, log_b, masks


def block_route_matches_plain(lib, n, seed, w=5):
    """The block route at ``n`` states on tied scores (Viterbi's first
    maximum) and ragged frames against the plain versions: Viterbi bit for
    bit, alpha and beta bit for bit where the lse's expf / logf agree
    (glibc's with torch's) and at float32 rounding elsewhere."""
    rng = np.random.default_rng(seed)
    band, log_pi, log_b, masks = tied_inputs(rng, 3, 6, n, w)
    (alpha, ll), beta, (sc, path, delta) = dp_calls(
        lib, band, log_pi, log_b, masks, w, end_states=3)
    tb, tpi, tlb, tm = t(band), t(log_pi), t(log_b), t(masks)
    want_a, want_ll = thmm.forward_log_banded_plain(tb, tpi, tlb, tm, w)
    want_b = thmm.backward_log_banded_plain(tb, tlb, tm, w)
    wsc, wpath, wdelta = thmm.viterbi_log_banded_plain(tb, tpi, tlb, tm, w,
                                                       3)
    assert torch.equal(path, wpath)
    assert torch.equal(sc, wsc) and torch.equal(delta, wdelta)
    close(alpha, want_a)
    close(beta, want_b)
    close(ll, want_ll)
    exact = (alpha == want_a).float().mean() * (beta == want_b).float().mean()
    assert float(exact) > 0.99


def block_plan(lib, b, n, w, forward=True):
    """The library's block-route launch: (CTAs an utterance, places a
    lane, warps a CTA)."""
    out = (ctypes.c_int * len(hk.BLOCK_PLAN_FIELDS))()
    assert lib.hmm_banded_block_plan(b, n, w, int(forward), out) == 0
    return tuple(out[:3])


def test_loop_kernels_source_on_cpu_match_plain(emulated_dp):
    """N = 1,100 sentence states (past Viterbi's block kernel's 1,024
    threads): forward and backward's block route (over a cluster, as the
    emulation's occupancy plans it) and Viterbi's loop instantiation
    against the plain versions."""
    lib = emulated_dp["as_is"]
    assert lib.hmm_banded_max_n() == 29056
    block_route_matches_plain(lib, 1100, 1100)


@pytest.mark.parametrize("n", [1024, 1025])
def test_block_kernels_source_on_cpu_at_their_limit(emulated_dp, n):
    """The last shape Viterbi's block kernel takes a thread a state (1,024
    threads) and the first its loop instantiation takes, against the plain
    versions, with forward and backward's block route."""
    block_route_matches_plain(emulated_dp["as_is"], n, n)


@pytest.mark.parametrize("n,w", [(100, 5), (160, 9)])
def test_loop_kernels_source_on_cpu_are_the_block_kernels(emulated_dp, n, w):
    """With Viterbi's block kernel's limit cut to 64 states, the block
    route of the same shape runs its loop instantiation: alpha, beta and
    all of Viterbi's outputs equal the uncut library's bit for bit."""
    rng = np.random.default_rng(n + w)
    ops = banded_inputs(rng, 3, 7, n, w)
    want = dp_calls(emulated_dp["as_is"], *ops, w, block=True)
    got = dp_calls(emulated_dp["cut"], *ops, w, block=True)
    for g, o in zip((*got[0], got[1], *got[2]),
                    (*want[0], want[1], *want[2])):
        assert torch.equal(g, o)


@pytest.mark.parametrize("n,w", [(129, 5), (266, 5), (150, 9), (140, 16)])
def test_block_route_source_on_cpu_matches_plain(emulated_dp, n, w):
    """The block route just past the warp kernels (N = 129), at L = 88
    (N = 266), and at band widths the warp kernels do not take (W = 9, 16:
    the runtime-width instantiations), against the plain versions."""
    block_route_matches_plain(emulated_dp["as_is"], n, n + w, w)


@pytest.mark.parametrize("n,w", [(31, 3), (50, 5), (65, 4), (98, 7),
                                 (128, 6)])
def test_block_route_source_on_cpu_is_the_warp_kernels(emulated_dp, n, w):
    """Every register count of the warp kernels (K = 1..4) through
    ``block=True``, on one CTA and on CTAs of two warps: alpha and beta
    equal the warp kernels' bit for bit on tied scores and ragged frames;
    loglik at float32 rounding (both reduce, in other orders)."""
    rng = np.random.default_rng(3 * n + w)
    ops = tied_inputs(rng, 4, 9, n, w)
    want = dp_calls(emulated_dp["as_is"], *ops, w)
    for route in ("as_is", "small_cta"):
        got = dp_calls(emulated_dp[route], *ops, w, block=True)
        assert torch.equal(got[0][0], want[0][0]), route
        assert torch.equal(got[1], want[1]), route
        close(got[0][1], want[0][1], rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("n,w", [(129, 5), (266, 5), (700, 7), (1100, 5),
                                 (300, 9), (200, 16), (150, 2)])
def test_block_route_source_on_cpu_is_the_parent(emulated_dp, n, w):
    """The block route against the block kernels it replaced
    (``tests/cuda_emu/hmm_banded_parent.cu``: a thread a state, or past
    1,024 states 512 threads looping over them), on tied scores and ragged
    frames, as planned, on one CTA an utterance (up to 4 places a lane)
    and over clusters of CTAs of two warps: alpha and beta bit for bit,
    loglik at float32 rounding (the parent sums on one thread)."""
    rng = np.random.default_rng(5 * n + w)
    ops = tied_inputs(rng, 3, 7, n, w)
    want = dp_calls(emulated_dp["parent"], *ops, w, block=True)
    plans = {}
    for route in ("as_is", "one_cta", "small_cta"):
        got = dp_calls(emulated_dp[route], *ops, w, block=True)
        assert torch.equal(got[0][0], want[0][0]), route
        assert torch.equal(got[1], want[1]), route
        close(got[0][1], want[0][1], rtol=1e-6, atol=0.0)
        plans[route] = block_plan(emulated_dp[route], 3, n, w)
    assert plans["one_cta"][0] == 1
    # two warps of up to 4 places a lane: 256 places a CTA
    assert plans["small_cta"][0] >= -(-n // 256) and plans["small_cta"][2] <= 2


def test_block_route_edge_mutant_is_rejected(tmp_path):
    """The comparison with the parent sees the edges between warps: a
    source whose warps read the warp below's top places one slot off
    differs from the parent."""
    src = emulated_dp_source()
    old = "const float* edge = c.slot + s * EDGE - c.lane - 1;"
    assert old in src
    lib = emulated_dp_libraries(tmp_path, {"mutant": src.replace(
        old, old.replace(" - 1;", ";"))})["mutant"]
    rng = np.random.default_rng(266)
    ops = tied_inputs(rng, 2, 6, 266, 5)
    want = thmm.forward_log_banded_plain(*(t(a) for a in ops), 5)[0]
    got = dp_calls(lib, *ops, 5, block=True)[0][0]
    assert not torch.allclose(got, want, rtol=1e-5, atol=1e-5)
