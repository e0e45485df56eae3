"""The banded DP kernels' share of their roofline: the yardstick's
``hmm_bound`` of every forward, backward and Viterbi launch of the window
over their summed device time in the trace (not measured when the trace
lost a launch of any of the three)."""

from asrbench.harness.trace import kernel_s

FAMILIES = (r"forward_(warp|block)_kernel", r"backward_(warp|block)_kernel",
            r"viterbi_(warp|block)_kernel")


def read(run):
    t = run.trace
    if not all(t["whole"].get(f) and t["kept"].get(f) for f in FAMILIES):
        return None
    busy = sum(kernel_s(t["kernels"], f) for f in FAMILIES)
    return 100.0 * run.work["hmm_bound_s"] / busy
