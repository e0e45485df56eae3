"""Device ms a training step of the program's ``train.mstep`` span:
the M-step (``apply_update``), timed by the span's CUDA events."""

from asrbench.harness.spans import device_ms_a_step


def read(run):
    return device_ms_a_step("train.mstep")
