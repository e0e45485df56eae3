"""The float32 GMM scoring kernel's share of its roofline: the yardstick's
``gmm_bound`` of the window's calls over the kernel's device time in the
trace (not measured when the trace lost a launch)."""

from asrbench.harness.trace import kernel_s

FAMILY = r"gmm_score_f32_kernel"


def read(run):
    t = run.trace
    if not t["whole"].get(FAMILY) or not t["kept"].get(FAMILY):
        return None
    return 100.0 * run.work["gmm_bound_s"] / kernel_s(t["kernels"], FAMILY)
