"""The frozen bounds and the operation counters against hand counts at
tiny shapes."""

import pytest

from asrbench.harness import yardstick as y


def test_bound_takes_the_larger_of_bytes_and_operations():
    b = y.bound_ms(3.35e9, 0.0, "float32")
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = y.bound_ms(0.0, 67e9, "float32")
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "operations"


def test_gmm_bound_by_hand():
    t, s, m, d = 10, 3, 2, 4
    b = y.gmm_bound(t, s, m, d, "float32")
    by_bytes = 4 * (t * d + 2 * s * m * d + s * m + t * s) / 3.35e12 * 1e3
    by_ops = 2 * t * 2 * d * s * m / 67e12 * 1e3
    assert b["bound_ms"] == pytest.approx(max(by_bytes, by_ops))


def test_hmm_bound_by_hand():
    b, t, n, w = 2, 3, 4, 5
    fwd = 4 * (b * n * w + b * t * n) + b * t + 4 * b * n + 4 * (b * t * n + b)
    assert y.hmm_bound("forward", b, t, n, w)["bound_ms"] == pytest.approx(
        max(fwd / 3.35e12, b * t * n * 4 * w / 67e12) * 1e3)
    bwd = 4 * (b * n * w + b * t * n) + b * t + 4 * b * t * n
    assert y.hmm_bound("backward", b, t, n, w)["bound_ms"] == pytest.approx(
        max(bwd / 3.35e12, b * t * n * 4 * w / 67e12) * 1e3)
    vit = (4 * (b * n * w + b * t * n) + b * t + 4 * b * n
           + 4 * (b + b * t + b * n))
    assert y.hmm_bound("viterbi", b, t, n, w)["bound_ms"] == pytest.approx(
        max(vit / 3.35e12, b * t * n * 2 * w / 67e12) * 1e3)


def test_scan_bound_by_hand():
    n, n_s, w, q, sen, b, tc, fr = 5, 8, 2, 3, 7, 2, 6, 9
    nb = (4 * fr * sen + 4 * b + 16 * b * n * n_s + 8 * b * tc
          + 4 * n * n_s * (w + 1) + 5 * n + 9 * q)
    got = y.scan_bound(n, n_s, w, q, sen, b, tc, fr)["bound_ms"]
    assert got == pytest.approx(max(nb / 3.35e12,
                                    fr * n * n_s * 8 / 67e12) * 1e3)


def test_step_operations_by_hand():
    # one frame, one node of 8 states at W = 2; S = 1, M = 1, D = 1
    assert y.decode_flops(1, 1, 1, 1, 1, 8, 2) == 4 + 8 * 8
    # one frame of a 3-state sentence HMM (one emitting), M = 1, D = 1, W = 5
    assert y.train_flops([1], [3], 1, 1, 5) == (4 + 1 + 5 + 4) + 3 * (40 + 10)
    assert y.train_flops([2, 1], [3, 3], 1, 1, 5) == 3 * y.train_flops(
        [1], [3], 1, 1, 5)
