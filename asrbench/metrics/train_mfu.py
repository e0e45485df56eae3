"""The training step's share of the float32 peak: the operations its
valid frames and live states need (``yardstick.train_flops``) over the
window's seconds at 67 TFLOP/s."""

from asrbench.harness.yardstick import PEAK_FLOPS


def read(run):
    return 100.0 * run.work["flops"] / (run.trace["window_s"]
                                        * PEAK_FLOPS["float32"])
