"""Device ms a training step of the program's ``train.estep.scoring``
span: the E-step's scoring of each sentence's senones
(``train/accumulators.py``), timed by the span's CUDA events."""

from asrbench.harness.spans import device_ms_a_step


def read(run):
    return device_ms_a_step("train.estep.scoring")
