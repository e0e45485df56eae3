"""The share of the traced window in which no operation ran on the
device."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
