"""The yardstick: the published peaks of one NVIDIA H100 and the least
time, operations and bytes of each kernel and step, from shapes alone.

``PEAK_BYTES_S``, ``PEAK_FLOPS``, :func:`bound_ms`, :func:`gmm_bound` and
:func:`hmm_bound` are copied unchanged from ``chip_smoke.py`` (at the
commit this benchmark was first written against); :func:`scan_bound`
keeps ``chip_smoke.py``'s arithmetic but takes the lexicon's sizes as
numbers, where the original read them from the program's tables.  Kept
here so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

# NVIDIA's data-sheet peaks of one H100 SXM (dense), for the bounds
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_ms(n_bytes: float, flops: float, op_type: str) -> dict:
    """The least time the card could take: every input read once and every
    output written once at the memory rate, or the operations at the peak
    rate of their type, whichever is larger.  Each add, multiply, max or
    compare counts as one operation, as in the published rates, which count
    an FMA as two: a kernel of adds and compares (the scans) issues at most
    half of the float32 rate, so its bound is a floor it cannot reach."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_FLOPS[op_type] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def gmm_bound(t: int, s: int, m: int, d: int, dtype: str) -> dict:
    """x, means, log_var, log_w in and [T, S] out, all float32 in device
    memory; 2·T·2D·S·M operations of the [x², x] product."""
    n_bytes = 4 * (t * d + 2 * s * m * d + s * m + t * s)
    return bound_ms(n_bytes, 2 * t * 2 * d * s * m, dtype)


def hmm_bound(name: str, b: int, t: int, n: int, w: int) -> dict:
    """band [B, N, W], log_b [B, T, N] (float32) and the uint8 frame mask
    in, plus log_pi [B, N] for forward and Viterbi; out: forward alpha
    [B, T, N] and loglik [B], backward beta [B, T, N], Viterbi score [B],
    path [B, T] int32 and delta [B, N].  About 4·W float32 operations per
    (b, t, n) for the log-sum recursions, 2·W for the max."""
    n_in = 4 * (b * n * w + b * t * n) + b * t
    if name == "backward":
        n_out, ops = 4 * b * t * n, 4 * w
    else:
        n_in += 4 * b * n
        n_out, ops = ((4 * (b * t * n + b), 4 * w) if name == "forward"
                      else (4 * (b + b * t + b * n), 2 * w))
    return bound_ms(n_in + n_out, b * t * n * ops, "float32")


def scan_bound(n: int, n_s: int, w: int, q: int, n_sen: int, b: int,
               t_c: int, frames: int) -> dict:
    """The frame scan's least time: of the scores ``[B, Tc, S]`` only the
    ``n_sen`` senones the lexicon's emitting states name, on this call's
    ``frames`` valid frames (frozen frames read none), and ``n_valid`` read
    once; the carry (deltas float32 and ctx int32, ``[B, N, Ns]``) read and
    written once, the rows ``[B, Tc]`` int32 written once, the tables
    (``N`` nodes of ``Ns`` states and band width ``W``, ``Q`` word slots)
    read once; (2W + 4) float32 operations per token state and valid frame
    (the advance's W adds and W compares, the emission score's add and
    clamp, the exit's share)."""
    n_bytes = (4 * frames * n_sen + 4 * b + 2 * 8 * b * n * n_s
               + 8 * b * t_c + 4 * n * n_s * (w + 1) + 5 * n + 9 * q)
    return bound_ms(n_bytes, frames * n * n_s * (2 * w + 4), "float32")


# ----------------------------------------------------------------------
# Whole-step work, for the steps' share of the float32 peak (``*_mfu``)
# ----------------------------------------------------------------------

def decode_flops(frames: int, d: int, s: int, m: int, n_nodes: int,
                 n_s: int, w: int) -> float:
    """Operations a decode needs on ``frames`` valid frames: the GMM
    product of every senone (2·2D·S·M a frame, as :func:`gmm_bound`) and
    the exact scan over every token state ((2W + 4) a state and frame, as
    :func:`scan_bound`).  Padded frames count nothing."""
    return frames * (2 * 2 * d * s * m + n_nodes * n_s * (2 * w + 4))


def train_flops(frames, states, d: int, m: int, w: int) -> float:
    """Operations one training step needs (an embedded Baum-Welch epoch,
    then a Viterbi alignment of the corpus), from each utterance's valid
    frames ``frames[u]`` and its sentence HMM's live states ``states[u]``
    (entry and exit included; ``states - 2`` emit):

    * E-step scoring: the [x², x] product of each emitting state's M
      Gaussians, 2·2D·M a state and frame;
    * forward and backward: 4·W each a state and frame (:func:`hmm_bound`);
    * moments: the mixture posterior's weight into c, cx and cxx,
      (1 + 2D + 3D)·M a state and frame;
    * alignment: the scoring again, and Viterbi's 2·W a state and frame.

    The M-step's per-senone arithmetic is a rounding error beside these
    and is left out."""
    total = 0.0
    for t, n in zip(frames, states):
        e = n - 2
        total += t * (e * m * (2 * 2 * d + 1 + 5 * d + 2 * 2 * d)
                      + n * (2 * 4 * w + 2 * w))
    return float(total)
