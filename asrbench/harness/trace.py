"""Spans, counters and the device trace of a traced run (``--trace 1``).

Each span is a host-clock duration (two clock reads; every run reports
the spans' means beside its result); with tracing on it is also a
``torch.profiler.record_function`` (so the trace can say what the host was
doing in each idle gap of the device), and the whole measured window runs
under one ``torch.profiler.profile``.

The profiler can lose kernel launches (inside a long script it was seen
to drop a few a profile).  So each kernel family's launches that the
profile kept are held against the program's own launch counters over the
same stretch, and a family whose counts differ reads as not measured.
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager, nullcontext

import torch


class Tracer:
    def __init__(self, on: bool):
        self.on = on
        self.spans: dict[str, list[float]] = {}
        self.prof = None
        self.window_s = None

    @contextmanager
    def span(self, name: str):
        """Time the block on the host clock (a block that must cover its
        device work ends in a synchronising call); traced, also mark it in
        the profile."""
        with (torch.profiler.record_function("asrbench/" + name)
              if self.on else nullcontext()):
            t0 = time.perf_counter()
            yield
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def profile(self):
        """The measured window's profile (spans start afresh with it)."""
        self.spans = {}
        if not self.on:
            return nullcontext()
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        return self.prof

    def summary(self, counted: dict[str, int]) -> dict:
        """Device time by kernel, busy seconds, the window's length (set by
        the driver from the host clock), the longest idle gaps by the
        innermost enclosing span, and which kernel families (``counted``:
        a regular expression over kernel names -> the program's launch
        count over the window) the profile kept whole."""
        events = self.prof.events()
        dev, spans = [], []
        for e in events:
            span = e.name.startswith("asrbench/")
            if e.device_type == torch.autograd.DeviceType.CUDA and not span:
                # a span's own range on the device's timeline is no
                # operation: only kernels, copies and sets count
                dev.append((e.time_range.start, e.time_range.end, e.name))
            elif span and e.device_type == torch.autograd.DeviceType.CPU:
                spans.append((e.time_range.start, e.time_range.end,
                              e.name[len("asrbench/"):]))
        by_name: dict[str, list] = {}
        for s, t, n in dev:
            v = by_name.setdefault(n, [0.0, 0])
            v[0] += (t - s) * 1e-6
            v[1] += 1
        merged = []
        for s, t, _ in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged) * 1e-6
        gaps: dict[str, float] = {}
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = 0.5 * (a + b)
            inner = [x for x in spans if x[0] <= mid <= x[1]]
            name = min(inner, key=lambda x: x[1] - x[0])[2] if inner else "host"
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
        kept = {f: sum(c for n, (_, c) in by_name.items() if re.search(f, n))
                for f in counted}
        return dict(
            busy_s=busy,
            window_s=self.window_s,
            kernels=by_name,
            whole={f: kept[f] == counted[f] for f in counted},
            kept=kept,
            device_ops=sorted(([n[:80], v[0]] for n, v in by_name.items()),
                              key=lambda x: -x[1])[:10],
            idle_gaps=sorted(([n, v] for n, v in gaps.items()),
                             key=lambda x: -x[1])[:10])


def kernel_s(kernels: dict, family: str) -> float:
    """Summed device seconds of every kernel whose name matches the
    regular expression ``family``."""
    return sum(v[0] for n, v in kernels.items() if re.search(family, n))
