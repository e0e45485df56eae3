"""Finding the benchmark's parts by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under ``asrbench/``, found by the
name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration's sizes, its source, the
  keys changed from it (``reduced``) and the sizes assumed (``assumed``);
* ``traffic/<traffic>.json``: a traffic mix's parameters, read by the one
  general generator (:mod:`asrbench.harness.traffic`); its ``driver`` names
  the kind of timed loop (:mod:`asrbench.harness.cells`);
* ``workloads/<cell>.json``: a cell's configuration and traffic names, its
  chips, its ``why`` and the limits of the numbers compared for ``correct``;
* ``metrics/<metric>.py``: a per-layer metric's reader, a ``read(run)``
  that returns a number or None (nothing to read).

Adding a configuration, a mix, a cell or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]        # asrbench/
REPO = ROOT.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str) -> Path:
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return ROOT / kind / name


def benchmark() -> dict:
    """``BENCHMARK.json`` at the repository root."""
    return _json(REPO / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(_named("configs", name + ".json"))


def traffic(name: str) -> dict:
    return _json(_named("traffic", name + ".json"))


def workload(name: str) -> dict:
    return _json(_named("workloads", name + ".json"))


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = _named("metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "asrbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metric entries that ``cell`` reports:
    an end-to-end metric without a ``workloads`` key is every cell's; a
    per-layer metric without one is every cell's that reports the metric
    it ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer
