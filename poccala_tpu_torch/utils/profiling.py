"""Tracing and per-op timing (port of ``poccala_tpu/utils/profiling.py``).

The reference's only observability is wall-clock prints
(``Decoder.py:213-218``) and log-line timestamps (``LogPrint.py:72-79``).
:func:`trace` records a ``torch.profiler`` trace of the host and, where
there is one, the card; :class:`OpTimer` keeps a ledger of wall-clock
timings with throughput annotations.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed work, written under ``log_dir`` as
    a Chrome/Perfetto JSON file (``trace.json``).  CUDA activity is
    recorded when a card is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(out) -> None:
    """Wait for the devices of every CUDA tensor in ``out`` (a tensor or a
    nest of tuples, lists and dicts); CPU tensors need no wait."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _synchronize(o)
    elif isinstance(out, dict):
        for o in out.values():
            _synchronize(o)


@dataclass
class OpTimer:
    """Wall-clock timing ledger with throughput/roofline annotations."""

    records: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def measure(self, name: str, flops: float | None = None,
                bytes_accessed: float | None = None):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        rec = self.records.setdefault(
            name, {"calls": 0, "seconds": 0.0, "flops": flops,
                   "bytes": bytes_accessed},
        )
        rec["calls"] += 1
        rec["seconds"] += dt

    def timeit(self, name: str, fn, *args, iters: int = 10,
               flops: float | None = None, **kwargs):
        """Time ``fn`` with a warm-up call, waiting for the device of its
        output's CUDA tensors after the warm-up and after the timed calls
        (JAX's ``block_until_ready``)."""
        out = fn(*args, **kwargs)
        _synchronize(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        _synchronize(out)
        dt = (time.perf_counter() - t0) / iters
        self.records[name] = {"calls": iters, "seconds": dt, "flops": flops,
                              "bytes": None}
        return out, dt

    def report(self) -> str:
        lines = []
        for name, rec in sorted(self.records.items()):
            per_call = rec["seconds"] / max(rec["calls"], 1)
            line = f"{name}: {per_call*1e3:.3f} ms/call x{rec['calls']}"
            if rec.get("flops"):
                line += f"  {rec['flops']/per_call/1e12:.2f} TFLOP/s"
            if rec.get("bytes"):
                line += f"  {rec['bytes']/per_call/1e9:.1f} GB/s"
            lines.append(line)
        return "\n".join(lines)
