"""One run of one cell: set-up, the measured window, the metrics and the
judgement of the window's outputs."""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass

import torch

from asrbench.harness import spec
from asrbench.harness.cells import DRIVERS
from asrbench.harness.model import build_model, make_bank
from asrbench.harness.trace import Tracer


@dataclass
class Run:
    """What a per-layer metric's reader reads."""

    spans: dict          # span name -> host seconds of each occurrence
    trace: dict          # Tracer.summary(): kernels, busy_s, window_s, ...
    work: dict           # the driver's operation counts and kernel bounds


def build_kernels(libs) -> bool:
    """Builds the program's CUDA libraries that the driver's calls load
    (a checkout's first run compiles them; later runs find them built),
    so that set-up's stamps show the build apart.  True if any compiled."""
    from poccala_tpu_torch.ops.cuda import build

    return any([build.build(name).compiled for name in libs])


def _merge(base: dict, over: dict | None) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             overrides: dict | None = None, control: bool = False,
             keep: dict | None = None):
    """Returns ``(result, checks)``: the result line's object and the
    numbers compared, each ``{"value", "limit"}``.  ``overrides`` (tests
    only) deep-merges into the cell's ``config`` and ``traffic``;
    ``control`` runs the program at the precision below the
    configuration's (its bfloat16 scoring path).  ``keep``, when given,
    receives the end-to-end readings and the driver's diagnostics (the
    training cell's per-leaf gaps)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.benchmark()
    cell = spec.workload(name)
    over = overrides or {}
    cfg = _merge(spec.config(cell["config"]), over.get("config"))
    mix = _merge(spec.traffic(cell["traffic"]), over.get("traffic"))
    e2e, layer = spec.cell_metrics(bench, name)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    stamps = {"imports": time.perf_counter() - t_start}
    driver_cls = DRIVERS[mix["driver"]]
    built = device == "cuda" and build_kernels(driver_cls.LIBS)
    stamps["build_s"] = time.perf_counter() - t_start - stamps["imports"]
    model = build_model(cfg, seed)
    bank = make_bank(model, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    stamps["model"] = time.perf_counter() - t_start
    tracer = Tracer(trace)
    dtype = "bfloat16" if control else cfg["score_dtype"]
    driver = driver_cls(model, bank, mix, seed, device, tracer, dtype)
    setup_s = time.perf_counter() - t_start
    stamps.update(getattr(driver, "stamps", {}), driver=setup_s)
    measured = driver.window(seconds)
    measured["setup_s"] = setup_s
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"),
                "count": cell["chips"],
                "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                      if device == "cuda" else 0)}
    metrics, breakdown = {}, None
    if trace:
        summ = tracer.summary(driver.counted)
        run = Run(tracer.spans, summ, driver.work())
        for m in layer:
            v = spec.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info.update(busy_s=summ["busy_s"], window_s=summ["window_s"])
        breakdown = {"device_ops": summ["device_ops"],
                     "idle_gaps": summ["idle_gaps"]}
    else:
        # ``<quantity>.<cells>`` is the driver's ``<quantity>`` in the cells
        # that the metric lists (a bound of their own)
        for m in e2e:
            metrics[m["name"]] = {"value": measured[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    driver.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = driver.check()
    t_check = time.perf_counter() - t_check
    if keep is not None:
        keep.update(getattr(driver, "diag", {}))
        keep.update(measured, check_s=t_check)
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items())
    result = {"correct": correct, "attempted": driver.attempted,
              "failed": driver.failed, "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["timing"] = {"setup_s": setup_s, "built": built,
                        "window_s": driver.tr.window_s, "check_s": t_check,
                        "setup_stamps": stamps,
                        "span_ms": {k: 1e3 * sum(v) / len(v)
                                    for k, v in tracer.spans.items()}}
    result["checks"] = checks
    return result, checks
