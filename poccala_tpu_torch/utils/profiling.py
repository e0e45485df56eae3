"""Tracing and per-op timing (port of ``poccala_tpu/utils/profiling.py``).

The reference's only observability is wall-clock prints
(``Decoder.py:213-218``) and log-line timestamps (``LogPrint.py:72-79``).
:func:`trace` records a ``torch.profiler`` trace of the host and, where
there is one, the card; :class:`OpTimer` keeps a ledger of wall-clock
timings with throughput annotations.

:func:`span` names the program's own phases (``decode.copy``,
``train.estep.scoring``, ...).  A span records only while a
``torch.profiler`` profile is active, the one tracing switch: with none,
entering it costs one check and allocates nothing.  Each record keeps its
host interval and, for work on a CUDA device, a pair of CUDA events around
what the block enqueued on the current stream (the stream runs in order,
so their interval is that work's device time).  Records stay in memory for
the life of the process; :func:`recorded` returns those of one name.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

_records: list[SpanRecord] = []
_local = threading.local()          # this thread's stack of open spans
_annotate = 0   # open trace() blocks: spans also mark the profile's timeline


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed work, written under ``log_dir`` as
    a Chrome/Perfetto JSON file (``trace.json``).  CUDA activity is
    recorded when a card is present.  Inside it each :func:`span` is also
    a ``poccala/<name>`` range on the trace's timeline."""
    global _annotate
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _annotate += 1
        try:
            yield
        finally:
            _annotate -= 1
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class SpanRecord:
    """One occurrence of a span: its ``name``, the enclosing span's record
    on the same thread (``parent``, None at the top), its host interval
    (``time.perf_counter_ns``) and, on a CUDA device, its pair of events."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "events")

    def __init__(self, name: str, parent: SpanRecord | None, events):
        self.name, self.parent, self.events = name, parent, events
        self.start_ns = self.end_ns = 0

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> float:
        """Device ms of what the span enqueued: the events' interval (this
        waits for the end event; a span itself never synchronises).  Work
        on the CPU runs as it is called, so there it is the host ms."""
        if self.events is None:
            return self.host_ms
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _Off:
    """The context manager of every span while nothing is profiled."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "rec", "range")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        events = None
        if self.device is not None and torch.device(self.device).type \
                == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        self.rec = rec = SpanRecord(self.name, stack[-1] if stack else None,
                                    events)
        stack.append(rec)
        # only under trace(): a bare profile (a benchmark's) counts every
        # range on the device's timeline that is not its own as an operation
        self.range = torch.profiler.record_function(
            "poccala/" + self.name) if _annotate else None
        if self.range is not None:
            self.range.__enter__()
        rec.start_ns = time.perf_counter_ns()
        if events is not None:
            events[0].record(torch.cuda.current_stream(self.device))
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(self.device))
        rec.end_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        _records.append(rec)
        return False


def span(name: str, device=None):
    """A context manager naming the enclosed block ``name`` in the trace.
    ``device``: where the block's work runs; on a CUDA device the record
    also times that work by a pair of events on the device's current
    stream.  Records only while a ``torch.profiler`` profile is active,
    from any thread (the profiler's process-wide flag: its own per-thread
    state is off in threads the profile did not start in, such as a
    service's worker)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def recorded(name: str) -> list[SpanRecord]:
    """Every record of the span ``name`` in this process, in the order
    the spans ended."""
    return [r for r in _records if r.name == name]


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
        """Time the block on the host clock; where CUDA is initialised,
        the current device is synchronised first, so the time covers the
        block's device work and not only its enqueue."""
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
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
