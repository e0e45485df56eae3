"""The program's own spans (``poccala_tpu_torch.utils.profiling.span``),
as the per-layer metrics read them after a traced window.

The program records spans only while a ``torch.profiler`` profile is
active, and a traced run's window is its one profile, so every record is
the window's.  A program without spans (an older checkout) gives no
records, and each reader then returns None.
"""

from __future__ import annotations


def records(name: str) -> list:
    try:
        from poccala_tpu_torch.utils.profiling import recorded
    except ImportError:
        return []
    return recorded(name)


def mean_host_ms(name: str) -> float | None:
    """Mean host ms of one occurrence of the span ``name``."""
    recs = records(name)
    return sum(r.host_ms for r in recs) / len(recs) if recs else None


def device_ms_a_step(name: str) -> float | None:
    """The span's device ms over the window, over the window's training
    steps (``train.epoch`` records: one a step)."""
    recs, steps = records(name), records("train.epoch")
    if not recs or not steps:
        return None
    return sum(r.device_ms for r in recs) / len(steps)
