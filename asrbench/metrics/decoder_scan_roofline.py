"""The exact frame scan's share of its roofline: the yardstick's
``scan_bound`` of the window's calls over the scan kernel's device time
in the trace (not measured when the trace lost a launch)."""

from asrbench.harness.trace import kernel_s

FAMILY = r"decoder_scan_kernel"


def read(run):
    t = run.trace
    if not t["whole"].get(FAMILY) or not t["kept"].get(FAMILY):
        return None
    return 100.0 * run.work["scan_bound_s"] / kernel_s(t["kernels"], FAMILY)
