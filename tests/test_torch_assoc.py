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
  ``tests/cuda_emu/cuda_runtime.h`` (one thread per CUDA thread), against
  the plain product and row form at 2e-6 relative and 1e-5 absolute (the
  sums run in another order, and ``expf`` / ``logf`` are the host's), on
  shapes past one 32 x 32 tile and one k-tile, with NEG_INF rows and
  columns, strided operands and output; and the whole recursion through
  the emulated kernels against JAX.
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

def emulated_source() -> str:
    """``csrc/hmm_assoc.cu`` for g++: the two ``<<<...>>>`` launches become
    calls of the emulation's ``emu_launch``."""
    src = (REPO / ak.SOURCE).read_text()
    src, n = re.subn(r"(\b\w+_kernel)<<<([^>]*)>>>\(",
                     r"emu_launch(\1, \2, ", src)
    assert n == 2
    return '#include "cuda_runtime.h"\n' + src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    tmp = tmp_path_factory.mktemp("hmm_assoc_emu")
    cpp, so = tmp / "assoc.cpp", tmp / "libassoc.so"
    cpp.write_text(emulated_source())
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{EMU}", "-o", str(so), str(cpp)], check=True,
                   capture_output=True)
    return ak.bind(ctypes.CDLL(str(so)))


def emu_product(lib):
    """``product(a, b, out)`` through the emulated ``hmm_lse_product``,
    with the wrapper's checks (made on a device-less stand-in)."""
    def product(a, b, out):
        p, m, k = a.shape
        n = b.shape[2]
        strides = [ak._stride("a", a, a.device, (p, m, k)),
                   ak._stride("b", b, a.device, (p, k, n)),
                   ak._stride("out", out, a.device, (p, m, n))]
        rc = lib.hmm_lse_product(a.data_ptr(), strides[0], b.data_ptr(),
                                 strides[1], out.data_ptr(), strides[2], p,
                                 m, k, n, None)
        assert rc == 0
    return product


def emu_rows(lib):
    def rows(a, b, out):
        p, k, n = b.shape
        sa = 0 if a.ndim == 1 else ak._stride("a", a, a.device, (p, k))
        rc = lib.hmm_lse_rows(a.data_ptr(), sa, b.data_ptr(),
                              ak._stride("b", b, b.device, (p, k, n)),
                              out.data_ptr(),
                              ak._stride("out", out, b.device, (p, n)), p, k,
                              n, None)
        assert rc == 0
    return rows


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


@pytest.mark.parametrize("p,m,k,n", [(3, 37, 45, 50), (2, 8, 8, 8),
                                     (1, 33, 70, 65)])
def test_product_kernel_source_on_cpu(emulated, p, m, k, n):
    """Past one 32 x 32 output tile and one k-tile, each edge ragged: the
    product against the plain version at 2e-6 relative and 1e-5 absolute,
    sentinel rows and columns exactly NEG_INF; a strided operand and
    output (every other matrix) as the recursion passes them."""
    rng = np.random.default_rng(p * 1000 + n)
    a, b = operands(rng, p, m, k, n)
    want = thmm._lse_product_plain(a, b)
    out = torch.full((p, m, n), float("nan"))
    emu_product(emulated)(a, b, out)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **EMU_TOL)
    assert (out[:, 1] == NEG_INF).all() and (out[:, :, 2] == NEG_INF).all()
    # strided views: a = even matrices of a stack, out = odd places
    a2 = torch.stack([a, a + 1.0], dim=1).reshape(2 * p, m, k)[0::2]
    big = torch.full((2 * p, m, n), float("nan"))
    emu_product(emulated)(a2, b, big[1::2])
    assert torch.equal(big[1::2], out)
    assert torch.isnan(big[0::2]).all()


@pytest.mark.parametrize("shared_row", [True, False])
def test_rows_kernel_source_on_cpu(emulated, shared_row):
    rng = np.random.default_rng(3)
    p, k, n = 9, 50, 45
    a, b = operands(rng, p, 8, k, n)
    rows_a = a[:, 3] if not shared_row else a[0, 3]
    out = torch.full((p, n), float("nan"))
    emu_rows(emulated)(rows_a, b, out)
    want = torch.empty_like(out)
    thmm._rows_into_plain(rows_a, b, want)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **EMU_TOL)
    assert (out[:, 2] == NEG_INF).all()


@pytest.mark.parametrize("name", ["dense_n6_t40", "left_to_right_n8_t25",
                                  "odd_t33"])
def test_recursion_through_kernel_source_matches_jax(emulated, name):
    """The whole time-parallel forward, each product and the tail through
    the emulated kernels, against JAX at the tolerances above."""
    log_a, log_pi, log_b = CASES[name](np.random.default_rng(5))
    want_a, want_ll = jhmm.forward_log_assoc(
        jnp.asarray(log_a), jnp.asarray(log_pi), jnp.asarray(log_b))
    got_a, got_ll = thmm._forward_assoc(
        torch.as_tensor(log_a), torch.as_tensor(log_pi),
        torch.as_tensor(log_b), emu_product(emulated), emu_rows(emulated))
    assert np.isclose(float(got_ll), float(want_ll), rtol=LL_RTOL, atol=0)
    assert_alpha_close(got_a.numpy(), want_a, name)
