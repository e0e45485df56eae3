"""HMM dynamic programming: forward, backward, Viterbi (port of
``poccala_tpu/ops/hmm.py``).

Two transition representations, as in the JAX package:

* **dense** ``log_A[N, N]`` — one utterance, general transition matrix;
* **banded** ``band[..., N, W]`` with ``band[j, k] = log_A[j, j+k]`` — the
  strictly left-to-right embedded sentence HMM, O(N·W) per step.

:func:`forward_log_assoc` is the dense forward as a time-parallel scan
(JAX's ``associative_scan`` recursion, O(log T) depth): each level's
(logsumexp, +) products run on the hand-written kernels of
``csrc/hmm_assoc.cu`` for a CUDA tensor, in plain PyTorch for a CPU one.

The banded functions are batched natively over a leading utterance axis
(``bands [B, N, W]``, ``log_bs [B, T, N]``, ``t_masks [B, T]``) where the
JAX package ``vmap``s a per-utterance ``lax.scan``.  The ``*_batch``
functions are the dispatchers: a CUDA tensor launches the hand-written
kernel of ``csrc/hmm_banded.cu`` (or raises), a CPU tensor takes the plain
PyTorch version below, a Python loop over frames.  The per-utterance
``forward_log_banded`` / ``backward_log_banded`` / ``viterbi_log_banded``
are batches of one.

Masking discipline: padded timesteps are identity steps (the carry passes
through unchanged), so the final carry equals the value at each
utterance's true last frame.  ``t_mask[0]`` is never read, as in JAX.
NEG_INF is the finite sentinel ``-1e30``; :func:`_clamp` keeps sums of
sentinels from drifting below it.  Ties go to the smaller offset / index
(``jnp.argmax`` takes the first maximum).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from poccala_tpu_torch.utils.logmath import NEG_INF


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.logsumexp(x, dim=dim)


def _clamp(x: torch.Tensor) -> torch.Tensor:
    """Keep 'impossible' canonical: sums of NEG_INF sentinels (e.g. into
    an absorbing exit state) would otherwise drift below NEG_INF."""
    return torch.clamp(x, min=NEG_INF)


# ======================================================================
# Dense (one utterance)
# ======================================================================

def forward_log(log_A, log_pi, log_b, t_mask):
    """Forward algorithm in log space (``LHMM.py:335-351``).

    Carries a renormalised alpha (per-step max subtracted) with the
    running shift accumulated by Kahan-compensated summation, as the JAX
    version does (``poccala_tpu/ops/hmm.py:48-97``).

    :param log_A: ``[N, N]``; :param log_pi: ``[N]``;
    :param log_b: ``[T, N]``; :param t_mask: ``[T]`` bool
    :returns: (``log_alpha [T, N]``, ``loglik`` 0-d tensor)
    """
    zero = log_b.new_zeros(())
    alpha0 = log_pi + log_b[0]
    m0 = torch.max(alpha0)
    shift = torch.where(m0 > NEG_INF / 2, m0, zero)
    alpha = torch.where(alpha0 > NEG_INF / 2, alpha0 - shift, NEG_INF)
    comp = zero
    rows = [alpha0]
    for t in range(1, log_b.shape[0]):
        nxt = _clamp(_lse(alpha[:, None] + log_A, dim=0) + log_b[t])
        m = torch.max(nxt)
        ms = torch.where(m > NEG_INF / 2, m, zero)
        nxt = torch.where(nxt > NEG_INF / 2, nxt - ms, NEG_INF)
        y = ms - comp
        t_new = shift + y
        comp_new = (t_new - shift) - y
        m_t = t_mask[t]
        alpha = torch.where(m_t, nxt, alpha)
        shift = torch.where(m_t, t_new, shift)
        comp = torch.where(m_t, comp_new, comp)
        rows.append(torch.where(alpha > NEG_INF / 2, alpha + shift, NEG_INF))
    return torch.stack(rows), shift + _lse(alpha, dim=-1)


def backward_log(log_A, log_b, t_mask):
    """Backward algorithm in log space (``LHMM.py:353-366``);
    ``beta[T_true-1] = 0``: while ``t+1`` is padding the carry stays 0."""
    t_pad, n = log_b.shape
    beta_last = log_b.new_zeros((n,))
    beta = beta_last
    rows = [beta_last]
    for t in range(t_pad - 2, -1, -1):
        nxt = _clamp(_lse(log_A + (log_b[t + 1] + beta)[None, :], dim=1))
        beta = torch.where(t_mask[t + 1], nxt, beta_last)
        rows.append(beta)
    return torch.stack(rows[::-1])


def viterbi_log(log_A, log_pi, log_b, t_mask):
    """Max-product DP with backtrace (``LHMM.py:546-609``).  Padded steps
    carry delta unchanged with identity backpointers.

    :returns: (``score``, ``path [T] int32``, ``final_delta [N]``)
    """
    t_pad, n = log_b.shape
    delta = log_pi + log_b[0]
    idx = torch.arange(n, device=log_b.device)
    bps = []
    for t in range(1, t_pad):
        scores = delta[:, None] + log_A
        bp = torch.argmax(scores, dim=0)  # first maximum
        nxt = _clamp(scores.gather(0, bp[None])[0] + log_b[t])
        delta = torch.where(t_mask[t], nxt, delta)
        bps.append(torch.where(t_mask[t], bp, idx))
    state = torch.argmax(delta)
    score = delta[state]
    path = [state]
    for bp in reversed(bps):
        state = bp[state]
        path.append(state)
    return score, torch.stack(path[::-1]).to(torch.int32), delta


def _lse_product_plain(a, b):
    """``max(LSE_k(a[p, i, k] + b[p, k, j]), NEG_INF)`` over ``[P, M, N]``:
    the (logsumexp, +) product, through the ``[P, M, K, N]`` sums."""
    return _clamp(_lse(a[..., :, :, None] + b[..., None, :, :], dim=-2))


def _product_into_plain(a, b, out):
    out.copy_(_lse_product_plain(a, b))


def _rows_into_plain(a, b, out):
    out.copy_(_clamp(_lse(a[..., :, None] + b, dim=-2)))


def _assoc_scan_into(elems, out, product) -> None:
    """``lax.associative_scan`` of the semiring product over the first axis
    of ``elems [n, N, N]``, written into ``out`` (a view of the same shape):
    ``out[t] = elems[0] ∘ ... ∘ elems[t]`` by JAX's recursion, so the tree
    of products is JAX's.  Pairs ``(0, 1), (2, 3), ...`` are combined, the
    scan of the results lands in ``out``'s odd places, the even places
    ``2, 4, ...`` combine them with ``elems[2::2]``, and ``out[0]`` is
    ``elems[0]``.  ``product(a, b, out)`` writes ``a ∘ b`` into ``out``."""
    n = elems.shape[0]
    if n < 2:
        out.copy_(elems)
        return
    reduced = elems.new_empty((n // 2, *elems.shape[1:]))
    product(elems[0:n - 1:2], elems[1::2], reduced)
    _assoc_scan_into(reduced, out[1::2], product)
    odd = out[1:n - 2:2] if n % 2 == 0 else out[1::2]
    product(odd, elems[2::2], out[2::2])
    out[0] = elems[0]


def _forward_assoc(log_A, log_pi, log_b, product, rows):
    ops = log_A[None, :, :] + log_b[1:, None, :]       # [T-1, N, N]
    prefix = torch.empty_like(ops)
    _assoc_scan_into(ops, prefix, product)
    alpha0 = log_pi + log_b[0]
    tail = log_b.new_empty((ops.shape[0], log_b.shape[1]))
    rows(alpha0, prefix, tail)                          # [T-1, N]
    log_alpha = torch.cat([alpha0[None], tail], dim=0)
    return log_alpha, _lse(log_alpha[-1], dim=-1)


def forward_log_assoc(log_A, log_pi, log_b):
    """Forward algorithm via ``associative_scan``, O(log T) depth (port of
    ``poccala_tpu/ops/hmm.py:forward_log_assoc``): the (logsumexp,
    +)-semiring operators ``M_t[i, j] = log_A[i, j] + log_b[t, j]`` are
    multiplied by JAX's scan recursion, and every ``log_alpha`` row is
    ``alpha_0`` through its prefix product.  O(T·N³) work against the
    sequential forward's O(T·N²), parallel over time.

    :param log_A: ``[N, N]``; :param log_pi: ``[N]``; :param log_b:
        ``[T, N]``, one utterance, on one device
    :returns: (``log_alpha [T, N]``, ``loglik`` 0-d), matching
        :func:`forward_log` on unmasked inputs

    On a CUDA tensor each product of a level is one launch of
    ``csrc/hmm_assoc.cu``'s kernel and the tail one of its row form (about
    ``2·log₂T + 1`` launches; the kernels never form the ``[P, N, N, N]``
    sums), or this raises; a CPU tensor takes :func:`forward_log_assoc_plain`.
    """
    if _route(log_b) == "cuda":
        from poccala_tpu_torch.ops.cuda import hmm_assoc_cuda

        return _forward_assoc(log_A, log_pi, log_b,
                              hmm_assoc_cuda.lse_product_cuda,
                              hmm_assoc_cuda.lse_rows_cuda)
    return forward_log_assoc_plain(log_A, log_pi, log_b)


def forward_log_assoc_plain(log_A, log_pi, log_b):
    """:func:`forward_log_assoc` in plain PyTorch on any device: the same
    recursion, each product through the ``[P, N, N, N]`` sums."""
    return _forward_assoc(log_A, log_pi, log_b, _product_into_plain,
                          _rows_into_plain)


# ======================================================================
# Banded
# ======================================================================

def dense_to_band(log_A, w: int):
    """``band[j, k] = log_A[j, j+k]`` for ``k in [0, w)``; out-of-range
    entries are NEG_INF."""
    n = log_A.shape[0]
    j = torch.arange(n, device=log_A.device)[:, None]
    col = j + torch.arange(w, device=log_A.device)[None, :]
    vals = log_A[j, torch.clamp(col, 0, n - 1)]
    return torch.where(col < n, vals, NEG_INF)


def band_to_dense(band):
    """Inverse of :func:`dense_to_band` (NEG_INF off-band)."""
    n, w = band.shape
    j = torch.arange(n, device=band.device)[:, None].expand(n, w)
    col = j + torch.arange(w, device=band.device)[None, :]
    valid = col < n
    out = torch.full((n * n,), NEG_INF, dtype=band.dtype, device=band.device)
    flat = (j * n + torch.clamp(col, 0, n - 1)).reshape(-1)
    src = torch.where(valid, band, NEG_INF).reshape(-1)
    return out.scatter_reduce(0, flat, src, reduce="amax").reshape(n, n)


def _shift_down(x, k: int):
    """``out[..., j] = x[..., j-k]``, NEG_INF filled."""
    return F.pad(x[..., :-k], (k, 0), value=NEG_INF) if k else x


def _shift_up(x, k: int):
    """``out[..., j] = x[..., j+k]``, NEG_INF filled."""
    return F.pad(x[..., k:], (0, k), value=NEG_INF) if k else x


def forward_log_banded_plain(bands, log_pis, log_bs, t_masks, w: int):
    """Banded forward ``α'[j] = b[j] + LSE_k(α[j-k] + band[j-k, k])`` over
    ``[B, ...]``.  Returns (``log_alpha [B, T, N]``, ``loglik [B]``)."""
    alpha = log_pis + log_bs[:, 0]
    rows = [alpha]
    for t in range(1, log_bs.shape[1]):
        terms = torch.stack([_shift_down(alpha + bands[..., k], k)
                             for k in range(w)])
        nxt = _clamp(_lse(terms, dim=0) + log_bs[:, t])
        alpha = torch.where(t_masks[:, t, None], nxt, alpha)
        rows.append(alpha)
    return torch.stack(rows, dim=1), _lse(alpha, dim=-1)


def backward_log_banded_plain(bands, log_bs, t_masks, w: int):
    """Banded backward ``β[j] = LSE_k(band[j, k] + b[j+k] + β[j+k])`` over
    ``[B, ...]``; β resets to 0 while ``t+1`` is padding."""
    b, t_pad, n = log_bs.shape
    beta_last = log_bs.new_zeros((b, n))
    beta = beta_last
    rows = [beta_last]
    for t in range(t_pad - 2, -1, -1):
        s = log_bs[:, t + 1] + beta
        terms = torch.stack([bands[..., k] + _shift_up(s, k)
                             for k in range(w)])
        nxt = _clamp(_lse(terms, dim=0))
        beta = torch.where(t_masks[:, t + 1, None], nxt, beta_last)
        rows.append(beta)
    return torch.stack(rows[::-1], dim=1)


def viterbi_log_banded_plain(bands, log_pis, log_bs, t_masks, w: int,
                             end_states: int = 0):
    """Banded Viterbi with offset backpointers over ``[B, ...]``.

    :returns: (score ``[B]``, path ``[B, T] int32``, final_delta ``[B, N]``)
    """
    b, t_pad, n = log_bs.shape
    delta = log_pis + log_bs[:, 0]
    offs = []
    for t in range(1, t_pad):
        # terms[k][j] = delta[j-k] + band[j-k, k]; strict > scanning k
        # upward keeps the first maximum, as jnp.argmax does
        best = delta + bands[..., 0]
        best_k = torch.zeros_like(delta, dtype=torch.int64)
        for k in range(1, w):
            cand = _shift_down(delta + bands[..., k], k)
            win = cand > best
            best = torch.where(win, cand, best)
            best_k = torch.where(win, k, best_k)
        nxt = _clamp(best + log_bs[:, t])
        m_t = t_masks[:, t, None]
        delta = torch.where(m_t, nxt, delta)
        offs.append(torch.where(m_t, best_k, 0))
    lo = n - end_states if end_states > 0 else 0
    state = lo + torch.argmax(delta[:, lo:], dim=-1)   # [B]
    score = delta.gather(1, state[:, None])[:, 0]
    path = [state]
    for off in reversed(offs):
        state = state - off.gather(1, _jax_index(state, n)[:, None])[:, 0]
        path.append(state)
    return score, torch.stack(path[::-1], dim=1).to(torch.int32), delta


def _jax_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's dynamic indexing of an axis of size ``n``: a negative index
    counts from the end once, then the index is clamped into range.  A
    degenerate utterance (every delta at the sentinel) can backtrace into
    negative states, and the paths must stay JAX's."""
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


# ----------------------------------------------------------------------
# Dispatchers: the CUDA kernel for a CUDA tensor, the plain version for a
# CPU one, nothing else (no fallback).
# ----------------------------------------------------------------------

def _route(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no HMM DP implementation for device {x.device}")


def forward_log_banded_batch(bands, log_pis, log_bs, t_masks, w: int):
    """Batched banded forward: ``bands [B,N,W]``, ``log_pis [B,N]``,
    ``log_bs [B,T,N]``, ``t_masks [B,T]`` -> (``[B,T,N]``, ``[B]``)."""
    if _route(log_bs) == "cuda":
        from poccala_tpu_torch.ops.cuda import hmm_banded_cuda

        return hmm_banded_cuda.forward_banded_cuda(
            bands, log_pis, log_bs, t_masks, w)
    return forward_log_banded_plain(bands, log_pis, log_bs, t_masks, w)


def backward_log_banded_batch(bands, log_bs, t_masks, w: int):
    """Batched banded backward -> ``[B, T, N]``."""
    if _route(log_bs) == "cuda":
        from poccala_tpu_torch.ops.cuda import hmm_banded_cuda

        return hmm_banded_cuda.backward_banded_cuda(bands, log_bs, t_masks, w)
    return backward_log_banded_plain(bands, log_bs, t_masks, w)


def viterbi_log_banded_batch(bands, log_pis, log_bs, t_masks, w: int,
                             end_states: int = 0):
    """Batched banded Viterbi -> (score ``[B]``, path ``[B, T]`` int32,
    final_delta ``[B, N]``)."""
    if _route(log_bs) == "cuda":
        from poccala_tpu_torch.ops.cuda import hmm_banded_cuda

        return hmm_banded_cuda.viterbi_banded_cuda(
            bands, log_pis, log_bs, t_masks, w, end_states)
    return viterbi_log_banded_plain(bands, log_pis, log_bs, t_masks, w,
                                    end_states)


def forward_log_banded(band, log_pi, log_b, t_mask, w: int):
    """One utterance: ``band [N,W]``, ``log_b [T,N]`` -> (``[T,N]``, 0-d)."""
    alpha, ll = forward_log_banded_batch(band[None], log_pi[None],
                                         log_b[None], t_mask[None], w)
    return alpha[0], ll[0]


def backward_log_banded(band, log_b, t_mask, w: int):
    return backward_log_banded_batch(band[None], log_b[None], t_mask[None],
                                     w)[0]


def viterbi_log_banded(band, log_pi, log_b, t_mask, w: int,
                       end_states: int = 0):
    score, path, delta = viterbi_log_banded_batch(
        band[None], log_pi[None], log_b[None], t_mask[None], w, end_states)
    return score[0], path[0], delta[0]
