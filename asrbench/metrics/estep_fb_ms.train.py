"""Device ms a training step of the program's
``train.estep.forward_backward`` span: the E-step's forward-backward over
the sentence HMMs, timed by the span's CUDA events."""

from asrbench.harness.spans import device_ms_a_step


def read(run):
    return device_ms_a_step("train.estep.forward_backward")
