"""Device ms a training step of the program's ``train.estep.statistics``
span: the E-step's posteriors and statistics over the lattice, timed by
the span's CUDA events."""

from asrbench.harness.spans import device_ms_a_step


def read(run):
    return device_ms_a_step("train.estep.statistics")
