"""The time-parallel forward algorithm (``forward_log_assoc``) in the port
against the JAX package, and the semiring product kernel's source against
its plain version.

``poccala_tpu_torch.ops.hmm.forward_log_assoc`` runs JAX's
``associative_scan`` recursion, so the tree of (logsumexp, +) products is
JAX's and only the rounding of ``exp`` / ``log`` and the order of each
sum separate the two packages:

* against JAX's ``forward_log_assoc`` at JAX's two test cases
  (``tests/test_gmm_hmm_kernels.py:243-275``: N = 6, T = 40 dense; N = 8,
  T = 25 left-to-right with NEG_INF off the band), at the training cell's
  sentence HMM made dense (N = 50, W = 5, T = 319), and at T = 1, 2 and 33
  (an odd length at every level): ``loglik`` at rtol 1e-5, the finite
  masks equal, finite ``log_alpha`` within 1e-5 of ``max(|value|, 1)``
  (values cross zero, where a relative error says nothing);
* against the port's sequential ``forward_log`` at JAX's own tolerances;
* the kernels of ``csrc/hmm_assoc.cu``, compiled with g++ against
  ``tests/cuda_emu/cuda_runtime.h`` (one thread per CUDA thread), bit for
  bit against the dense kernels they replaced
  (``tests/cuda_emu/hmm_assoc_parent.cu``, built beside them), on both
  routes of the product, on the scan's banded and triangular operands,
  dead padded states, -inf, dense and all-dead operands, strided operands
  and output; two mutants of the dead-term skip must fail; and against
  the plain product and row form at 2e-6 relative and 1e-5 absolute (the
  sums run in another order, and ``expf`` / ``logf`` are the host's); and
  the whole recursion through the emulated kernels against JAX.
"""

import ctypes
import functools
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.ops import hmm as jhmm
from poccala_tpu_torch.ops import hmm as thmm
from poccala_tpu_torch.ops.cuda import hmm_assoc_cuda as ak
from poccala_tpu_torch.utils.logmath import NEG_INF

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
LL_RTOL = 1e-5
ALPHA_TOL = 1e-5        # of max(|log_alpha|, 1)
EMU_TOL = dict(rtol=2e-6, atol=1e-5)


def dense_case(rng, n, t):
    a = rng.uniform(0.1, 1.0, size=(n, n))
    a /= a.sum(1, keepdims=True)
    pi = rng.uniform(0.1, 1.0, size=n)
    pi /= pi.sum()
    return (np.log(a).astype(np.float32), np.log(pi).astype(np.float32),
            rng.normal(size=(t, n)).astype(np.float32))


def left_to_right_case(rng, n, t):
    """``tests/test_gmm_hmm_kernels.py:260``'s chain: NEG_INF off the
    band and at every state but the first of ``log_pi``."""
    a = np.zeros((n, n))
    a[0, 1] = 1.0
    for j in range(1, n - 1):
        a[j, j] = a[j, j + 1] = 0.5
    log_a = np.where(a > 0, np.log(a, where=a > 0), NEG_INF)
    log_pi = np.full(n, NEG_INF)
    log_pi[0] = 0.0
    return (log_a.astype(np.float32), log_pi.astype(np.float32),
            rng.normal(size=(t, n)).astype(np.float32))


def training_cell_case(rng, n=50, w=5, t=319):
    """The training cell's sentence HMM (N = 50 states, band width 5)
    made dense by ``band_to_dense``, over 4 s of scores."""
    band = np.log(rng.uniform(0.05, 1.0, size=(n, w)))
    band = np.where(np.arange(n)[:, None] + np.arange(w) < n, band, NEG_INF)
    log_a = thmm.band_to_dense(torch.as_tensor(band, dtype=torch.float32))
    log_pi = np.full(n, NEG_INF, np.float32)
    log_pi[0] = 0.0
    log_b = (rng.normal(size=(t, n)) * 3 - 5).astype(np.float32)
    return log_a.numpy(), log_pi, log_b


CASES = {
    "dense_n6_t40": lambda rng: dense_case(rng, 6, 40),
    "left_to_right_n8_t25": lambda rng: left_to_right_case(rng, 8, 25),
    "training_cell_n50_t319": training_cell_case,
    "t1": lambda rng: dense_case(rng, 6, 1),
    "t2": lambda rng: dense_case(rng, 6, 2),
    "odd_t33": lambda rng: left_to_right_case(rng, 7, 33),
}


def assert_alpha_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    fin = want > NEG_INF / 2
    assert np.array_equal(got > NEG_INF / 2, fin), what
    assert (got[~fin] == NEG_INF).all(), what
    err = np.abs(got - want)[fin] / np.maximum(np.abs(want[fin]), 1.0)
    assert err.max(initial=0.0) <= ALPHA_TOL, (what, err.max())


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name):
    log_a, log_pi, log_b = CASES[name](np.random.default_rng(5))
    want_a, want_ll = jhmm.forward_log_assoc(
        jnp.asarray(log_a), jnp.asarray(log_pi), jnp.asarray(log_b))
    got_a, got_ll = thmm.forward_log_assoc(
        torch.as_tensor(log_a), torch.as_tensor(log_pi),
        torch.as_tensor(log_b))
    assert got_a.shape == want_a.shape == log_b.shape
    assert got_ll.shape == ()
    assert np.isclose(float(got_ll), float(want_ll), rtol=LL_RTOL, atol=0)
    assert_alpha_close(got_a.numpy(), want_a, name)


@pytest.mark.parametrize("name", ["dense_n6_t40", "left_to_right_n8_t25"])
def test_matches_sequential_forward(name):
    """JAX's own test of ``forward_log_assoc``, on the port: against
    ``forward_log`` at rtol 1e-5 on ``loglik`` and 1e-4 / 1e-4 (dense) or
    1e-4 / 1e-3 (finite entries of the chain) on ``log_alpha``."""
    log_a, log_pi, log_b = (torch.as_tensor(x) for x in
                            CASES[name](np.random.default_rng(7)))
    seq_a, seq_ll = thmm.forward_log(log_a, log_pi, log_b,
                                     torch.ones(log_b.shape[0], dtype=bool))
    par_a, par_ll = thmm.forward_log_assoc(log_a, log_pi, log_b)
    assert np.isclose(float(par_ll), float(seq_ll), rtol=1e-5)
    if name.startswith("dense"):
        assert np.allclose(par_a.numpy(), seq_a.numpy(), rtol=1e-4,
                           atol=1e-4)
    else:
        fin = seq_a.numpy() > NEG_INF / 2
        assert np.allclose(par_a.numpy()[fin], seq_a.numpy()[fin],
                           rtol=1e-4, atol=1e-3)


def test_cpu_takes_the_plain_version(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel's wrapper was called for CPU tensors")

    monkeypatch.setattr(ak, "lse_product_cuda", refuse)
    monkeypatch.setattr(ak, "lse_rows_cuda", refuse)
    log_a, log_pi, log_b = (torch.as_tensor(x) for x in
                            dense_case(np.random.default_rng(1), 5, 9))
    got = thmm.forward_log_assoc(log_a, log_pi, log_b)
    want = thmm.forward_log_assoc_plain(log_a, log_pi, log_b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_recursion_is_jax_tree():
    """With a product that is not associative (``a - b``, one rounding),
    the result depends on the tree of products: the recursion gives
    ``jax.lax.associative_scan``'s bit for bit at every length up to 40,
    with two products a level of two or more elements (none launched for
    an empty one)."""
    import jax

    rng = np.random.default_rng(0)
    for n in range(41):
        x = rng.normal(size=(n, 1, 1)).astype(np.float32)
        want = np.asarray(jax.lax.associative_scan(lambda a, b: a - b,
                                                   jnp.asarray(x)))
        calls = []

        def product(a, b, out):
            calls.append(len(a))
            out.copy_(a - b)
        out = torch.full((n, 1, 1), float("nan"))
        thmm._assoc_scan_into(torch.as_tensor(x), out, product)
        np.testing.assert_array_equal(out.numpy(), want)
        levels, m = 0, n
        while m >= 2:
            levels, m = levels + 1, m // 2
        assert len(calls) == 2 * levels, (n, calls)


def test_wrappers_refuse_cpu_tensors_and_wrong_operands():
    a = torch.zeros(2, 3, 4)
    b = torch.zeros(2, 4, 5)
    out = torch.zeros(2, 3, 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ak.lse_product_cuda(a, b, out)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ak.lse_rows_cuda(a[0, 0], b, out[:, 0])
    with pytest.raises(ValueError, match="expected"):
        ak.lse_product_cuda(a[0], b, out)
    with pytest.raises(ValueError, match="expected"):
        ak.lse_rows_cuda(a, b, out)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="dtype"):
        ak._stride("a", a.double(), cpu, (2, 3, 4))
    with pytest.raises(ValueError, match="shape"):
        ak._stride("b", b[:, :, :4], cpu, (2, 4, 5))
    with pytest.raises(ValueError, match="contiguous"):
        ak._stride("a", a.transpose(1, 2).contiguous().transpose(1, 2), cpu,
                   (2, 3, 4))
    with pytest.raises(ValueError, match="is on"):
        ak._stride("a", a, torch.device("meta"), (2, 3, 4))
    # a level's strided slice and the output's odd places pass
    assert ak._stride("out", torch.zeros(4, 3, 5)[1::2], cpu,
                      (2, 3, 5)) == 30


# ----------------------------------------------------------------------
# the kernels' source on the CPU

PARENT_SOURCE = EMU / "hmm_assoc_parent.cu"
ASYNC_PLAIN = """__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  *dst = *src;
}
__device__ __forceinline__ void cp_async_commit() {}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  emu_mbar_init(bar, count);
}
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  emu_mbar_update(bar, 1, (int)bytes);
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  emu_mbar_wait(bar, parity);
}
// the copy engine's alignment (both addresses and the size 16 bytes), and
// a copy into dynamic shared memory inside what the launch asked for
inline void emu_bulk_check(const void* x, const void* y, unsigned bytes) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       bytes) & 15)
    std::abort();
  const auto* d = static_cast<const unsigned char*>(x);
  if (d >= emu_dyn_smem && d < emu_dyn_smem + emu_dyn_bytes &&
      d + bytes > emu_dyn_smem + emu_dyn_bytes)
    std::abort();
}
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  emu_bulk_check(dst, src, bytes);
  std::memcpy(dst, src, bytes);
  emu_mbar_update(bar, 0, -(int)bytes);
}
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           unsigned bytes) {
  emu_bulk_check(dst, src, bytes);
  std::memcpy(dst, src, bytes);
}
__device__ __forceinline__ void proxy_fence() {}
template <bool READ>
__device__ __forceinline__ void bulk_store_wait() {}
"""
# a dead test that also drops live entries just above the sentinel, and a
# tile range one k short at its upper end: each must fail bit-equality
MUTANTS = {
    "dead_test": ("bool is_dead(float x) { return x <= NEG_INF_F; }",
                  "bool is_dead(float x) { return x < NEG_INF_F + 1e24f; }"),
    "range_short": ("  hi = min(g_rows[1], g_cols[1]);",
                    "  hi = min(g_rows[1], g_cols[1]) - 1;"),
}


def emulated_source(parent=False, mutant=None, **limits) -> str:
    """``csrc/hmm_assoc.cu`` (``parent``: the dense kernels it replaced,
    ``tests/cuda_emu/hmm_assoc_parent.cu``) for g++: the ``cp.async``
    bodies become plain copies, the dynamic shared memory a per-block
    buffer, the ``<<<...>>>`` launches calls of the emulation's
    ``emu_launch``; ``mutant`` names a swap of :data:`MUTANTS`, and
    ``limits`` (``SMEM_LIMIT``, ``ROW_SMEM``) cut the routes' limits."""
    src = (PARENT_SOURCE if parent else REPO / ak.SOURCE).read_text()
    if not parent:
        a = src.index("__device__ __forceinline__ void cp_async_f32")
        b = src.index("// End of the asynchronous-copy helpers.")
        src = src[:a] + ASYNC_PLAIN + src[b:]
        src = src.replace("extern __shared__ __align__(16) float smem[];",
                          "float* smem = reinterpret_cast<float*>(emu_dyn_smem);")
    if mutant:
        old, new = MUTANTS[mutant]
        assert src.count(old) == 1, mutant
        src = src.replace(old, new)
    for name, value in limits.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]*;",
                         f"constexpr int {name} = {value};", src)
        assert n == 1, name
    src, n = re.subn(r"(\b\w+_kernel)<<<([^>]*)>>>\(",
                     r"emu_launch(\1, \2, ", src)
    assert n == (2 if parent else 3)
    return '#include <cstdlib>\n#include "cuda_runtime.h"\n' + src


BUILDS = {"as_is": {}, "parent": dict(parent=True),
          # every shape on the k-tiled route; the row form a few rows a
          # segment (pass 2 reads the column again); a card of one SM, so
          # that a persistent CTA walks several products (staging the next
          # one while it computes one where two fit: N <= 107)
          "tiled": dict(SMEM_LIMIT=0), "short_seg": dict(ROW_SMEM=1024),
          "one_sm": dict(cflags=("-DEMU_SMS=1",)),
          **{f"mutant_{m}": dict(mutant=m) for m in MUTANTS}}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """name -> the library of :data:`BUILDS`' source (and g++ flags),
    compiled with g++ (all at once) and bound."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    tmp = tmp_path_factory.mktemp("hmm_assoc_emu")
    procs = {}
    for name, kw in BUILDS.items():
        kw = dict(kw)
        cflags = kw.pop("cflags", ())
        cpp, so = tmp / f"{name}.cpp", tmp / f"lib{name}.so"
        cpp.write_text(emulated_source(**kw))
        procs[name] = so, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             *cflags, f"-I{EMU}", "-o", str(so), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err.decode()[-3000:]
        libs[name] = ak.bind(ctypes.CDLL(str(so)))
    return libs


def emu_product(lib):
    """``product(a, b, out)`` through the emulated ``hmm_lse_product``: the
    port's wrapper, its checks made, on the host build ``lib``."""
    return functools.partial(ak.lse_product_cuda, lib=lib)


def emu_rows(lib):
    return functools.partial(ak.lse_rows_cuda, lib=lib)


def same_bits(x, y) -> bool:
    """``torch.equal`` with a NaN equal to a NaN (its payload not held)."""
    nan = torch.isnan(x)
    return bool(torch.equal(nan, torch.isnan(y))
                and torch.equal(x[~nan], y[~nan]))


def operands(rng, p, m, k, n):
    """Random log-domain operands with NEG_INF rows of ``a`` and columns of
    ``b`` (whole output rows, columns and one element at NEG_INF), and
    -1e30 sums of two sentinels elsewhere."""
    a = rng.normal(size=(p, m, k)) * 4
    b = rng.normal(size=(p, k, n)) * 4
    a[:, 1] = NEG_INF                 # a dead row
    b[:, :, 2] = NEG_INF              # a dead column
    a[:, 3, ::2] = NEG_INF            # half a row at the sentinel
    b[:, ::3, 4] = NEG_INF
    a[0, 5] = NEG_INF
    b[0, :, 6] = NEG_INF              # one output element of two sentinels
    return (torch.as_tensor(a, dtype=torch.float32),
            torch.as_tensor(b, dtype=torch.float32))


def band(rng, p, rows, cols, width, live=None, start=0):
    """``[p, rows, cols]`` log-probabilities (one frame's scores added to
    each column) on ``start <= col - row < start + width``, NEG_INF off
    it and at every state from ``live`` on: a product of the scan's
    operators (``width`` ~ 4 2^l + 1 at level l; ``width >= cols`` an upper
    triangle, a prefix product)."""
    x = rng.normal(size=(p, rows, cols)) * 3 - 5
    d = np.arange(cols)[None, :] - np.arange(rows)[:, None]
    keep = (d >= start) & (d < start + width)
    if live is not None:
        keep &= (np.arange(rows)[:, None] < live) & (np.arange(cols) < live)
    return np.where(keep, x, NEG_INF)


def kernel_case(kind, rng, p, m, k, n):
    """The operands of a product case ``kind``: the scan's banded and
    triangular operands, dead padded states, -inf for the sentinel, dense
    finite operands, an all-dead product, live entries just above the
    sentinel (which the ``dead_test`` mutant drops), NaN entries (in the
    band, and off it where the other operand is dead: a row of ``a`` at
    ``m // 2``, a column of ``b`` at ``n - 2`` NaN throughout)."""
    if kind == "random":
        return operands(rng, p, m, k, n)
    if kind == "banded":
        a, b = band(rng, p, m, k, 9), band(rng, p, k, n, 5)
    elif kind == "triangular":
        a, b = band(rng, p, m, k, k), band(rng, p, k, n, 17)
    elif kind == "padded":
        live = min(m, k, n) * 2 // 3
        a, b = band(rng, p, m, k, k, live), band(rng, p, k, n, 9, live)
    elif kind == "neg_inf":
        a, b = band(rng, p, m, k, 33), band(rng, p, k, n, 5)
        a[rng.random(a.shape) < 0.5] = -np.inf
        b[:, :, ::2] = np.where(b[:, :, ::2] <= NEG_INF, -np.inf,
                                b[:, :, ::2])
        b[:, 1::3] = np.where(b[:, 1::3] <= NEG_INF, -2e30, b[:, 1::3])
    elif kind == "dense":
        a, b = rng.normal(size=(p, m, k)) * 4, rng.normal(size=(p, k, n)) * 4
    elif kind == "all_dead":
        a, b = np.full((p, m, k), NEG_INF), np.full((p, k, n), NEG_INF)
        a[:, ::2] = -np.inf
    elif kind == "near_sentinel":
        a, b = band(rng, p, m, k, 9), band(rng, p, k, n, 5)
        near = np.float32(NEG_INF) * np.float32(0.9999999)   # a few ulps up
        a[:, ::3] = np.where(a[:, ::3] > NEG_INF, near, a[:, ::3])
        b[:, :, 1::4] = np.where(b[:, :, 1::4] > NEG_INF, near, b[:, :, 1::4])
    elif kind == "nan":
        a, b = band(rng, p, m, k, 9), band(rng, p, k, n, 5)
        a[:, 5, 7] = b[:, 3, 4] = np.nan          # in the band
        a[:, m // 2, k - 3] = np.nan              # off it: rows k - 3 of b
        b[:, k // 4, n - 2] = np.nan              # are dead there, and so on
    else:
        raise ValueError(kind)
    return (torch.as_tensor(a, dtype=torch.float32),
            torch.as_tensor(b, dtype=torch.float32))


def product_outputs(lib, a, b):
    out = torch.full((a.shape[0], a.shape[1], b.shape[2]), float("nan"))
    emu_product(lib)(a, b, out)
    return out


KINDS = ["banded", "triangular", "padded", "neg_inf", "dense", "all_dead",
         "near_sentinel", "nan"]
PRODUCT_CASES = (
    [pytest.param("random", *shape, id="-".join(map(str, shape)))
     for shape in [(3, 37, 45, 50), (2, 8, 8, 8), (1, 33, 70, 65)]]
    + [pytest.param(kind, *shape, id=f"{kind}-{'-'.join(map(str, shape))}")
       for kind in KINDS for shape in [(2, 98, 98, 98), (1, 37, 45, 50)]]
    # the shared-memory route's limit (N = 139 fits, 140 takes k-tiles)
    + [pytest.param("triangular", 1, n, n, n, id=f"limit-{n}")
       for n in (139, 140)]
    # more products than one SM's CTAs: double-buffered, single-buffered
    + [pytest.param("banded", 9, 37, 45, 50, id="persistent-9-37-45-50"),
       pytest.param("triangular", 3, 120, 120, 120, id="persistent-3-120")])


@pytest.mark.parametrize("kind,p,m,k,n", PRODUCT_CASES)
def test_product_kernel_source_on_cpu(emulated, kind, p, m, k, n):
    """Past one output tile and one k-tile, each edge ragged, with M, K and
    N apart, P = 1: the product bit for bit the parent's dense product
    (``torch.equal``) on both routes (shared memory, and k-tiles with
    ``SMEM_LIMIT`` cut to 0), with persistent CTAs that walk several
    products (a card of one SM: two buffers at N = 37 to 98, one at 120),
    and against the plain version at 2e-6
    relative and 1e-5 absolute, sentinel rows and columns exactly NEG_INF;
    a strided operand and output (every other matrix) as the recursion
    passes them.  NaN outputs are held NaN where the parent's are
    (:func:`same_bits`)."""
    rng = np.random.default_rng(p * 1000 + n)
    a, b = kernel_case(kind, rng, p, m, k, n)
    want = thmm._lse_product_plain(a, b)
    out = product_outputs(emulated["as_is"], a, b)
    parent = product_outputs(emulated["parent"], a, b)
    assert same_bits(out, parent)
    for build in ("tiled", "one_sm"):
        assert same_bits(product_outputs(emulated[build], a, b), parent)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **EMU_TOL)
    if kind == "random":
        assert (out[:, 1] == NEG_INF).all() and (out[:, :, 2] == NEG_INF).all()
    if kind == "all_dead":
        assert (out == NEG_INF).all()
    if kind == "nan":
        assert torch.isnan(out[:, m // 2]).all()
        assert torch.isnan(out[:, :, n - 2]).all()
        assert not torch.isnan(out).all()
    # strided views: a = even matrices of a stack, out = odd places
    a2 = torch.stack([a, a + 1.0], dim=1).reshape(2 * p, m, k)[0::2]
    big = torch.full((2 * p, m, n), float("nan"))
    emu_product(emulated["as_is"])(a2, b, big[1::2])
    assert same_bits(big[1::2], out)
    assert torch.isnan(big[0::2]).all()


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_product_mutant_is_rejected(emulated, mutant):
    """A dead test that drops the live entries just above the sentinel, and
    a tile range one k short, each change some output of the scan's
    operands against the parent's dense product."""
    lib = emulated[f"mutant_{mutant}"]
    differs = []
    for kind in ("banded", "triangular", "near_sentinel"):
        a, b = kernel_case(kind, np.random.default_rng(1), 2, 37, 45, 50)
        differs.append(not torch.equal(
            product_outputs(lib, a, b),
            product_outputs(emulated["parent"], a, b)))
    assert any(differs), mutant


def rows_case(kind, rng, p, k, n):
    """``(a [K], b [P, K, N])`` of a row-form case: ``a`` alpha_0 of a
    sentence HMM (live at its live states, dead at the padded ones), live at
    the first state alone (the left-to-right chain's), dense, all dead or
    with -inf; ``b`` prefix products (upper triangles with dead padded
    states) or the random operands; ``nan``: alpha_0's, with NaN in ``b``
    at a row that ``a`` reaches and at one it does not (columns 7 and 5
    NaN throughout), and in one ``p``'s own row of ``a``."""
    if kind == "random":
        a, b = operands(rng, p, 8, k, n)
        return a, b
    b = band(rng, p, k, n, k, live=k - 3)
    a = rng.normal(size=(p, k)) * 3 - 5
    if kind == "alpha0":
        a[:, k - 3:] = NEG_INF
    elif kind == "first_state":
        a[:, 1:] = NEG_INF
    elif kind == "neg_inf":
        a[:, ::2] = -np.inf
        b[:, :, 3] = -np.inf
    elif kind == "all_dead":
        a[:] = NEG_INF
    elif kind == "nan":
        a[:, k - 3:] = NEG_INF
        b[:, 0, 7] = b[:, k - 2, 5] = np.nan
        a[2, 1] = np.nan
    elif kind != "dense":
        raise ValueError(kind)
    return (torch.as_tensor(a, dtype=torch.float32),
            torch.as_tensor(b, dtype=torch.float32))


@pytest.mark.parametrize("shared_row,kind,k,n", [
    pytest.param(True, "random", 50, 45, id="True"),
    pytest.param(False, "random", 50, 45, id="False"),
    *[pytest.param(shared, kind, k, n, id=f"{kind}-{k}-{n}-{shared}")
      for kind in ("alpha0", "first_state", "dense", "neg_inf", "all_dead",
                   "nan")
      for k, n, shared in ((50, 45, True), (150, 45, False),
                           (40, 150, True))]])
def test_rows_kernel_source_on_cpu(emulated, shared_row, kind, k, n):
    """The row form bit for bit the parent's: the rows of the live range
    staged at once, and in segments (``ROW_SMEM`` cut to a few rows: pass 2
    reads the column again), B wider than a CTA's columns (N = 150), one
    row for every p or a row each; against the plain version at 2e-6
    relative and 1e-5 absolute."""
    rng = np.random.default_rng(3)
    p = 9
    a, b = rows_case(kind, rng, p, k, n)
    rows_a = (a[:, 3] if kind == "random" else a) if not shared_row \
        else (a[0, 3] if kind == "random" else a[0])
    outs = {}
    for name in ("as_is", "parent", "short_seg"):
        outs[name] = torch.full((p, n), float("nan"))
        emu_rows(emulated[name])(rows_a, b, outs[name])
    assert same_bits(outs["as_is"], outs["parent"])
    assert same_bits(outs["short_seg"], outs["parent"])
    want = torch.empty_like(outs["as_is"])
    thmm._rows_into_plain(rows_a, b, want)
    np.testing.assert_allclose(outs["as_is"].numpy(), want.numpy(),
                               **EMU_TOL)
    if kind == "random":
        assert (outs["as_is"][:, 2] == NEG_INF).all()
    if kind == "nan":
        assert torch.isnan(outs["as_is"][:, [5, 7]]).all()
        assert torch.isnan(outs["as_is"][2]).all() != shared_row


@pytest.mark.parametrize("name", ["dense_n6_t40", "left_to_right_n8_t25",
                                  "odd_t33"])
def test_recursion_through_kernel_source_matches_jax(emulated, name):
    """The whole time-parallel forward, each product and the tail through
    the emulated kernels, against JAX at the tolerances above, and bit for
    bit through the parent's dense kernels."""
    log_a, log_pi, log_b = CASES[name](np.random.default_rng(5))
    want_a, want_ll = jhmm.forward_log_assoc(
        jnp.asarray(log_a), jnp.asarray(log_pi), jnp.asarray(log_b))
    got = {lib: thmm._forward_assoc(
        torch.as_tensor(log_a), torch.as_tensor(log_pi),
        torch.as_tensor(log_b), emu_product(emulated[lib]),
        emu_rows(emulated[lib])) for lib in ("as_is", "parent")}
    got_a, got_ll = got["as_is"]
    assert torch.equal(got_a, got["parent"][0])
    assert torch.equal(got_ll, got["parent"][1])
    assert np.isclose(float(got_ll), float(want_ll), rtol=LL_RTOL, atol=0)
    assert_alpha_close(got_a.numpy(), want_a, name)
