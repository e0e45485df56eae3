"""Run one cell of the benchmark once and print its result line.

    python3 asrbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``asrbench/workloads/<cell>.json``) names a configuration and a
traffic mix; the mix names its driver (:mod:`asrbench.harness.cells`).
Set-up makes the weights and the traffic from the seed on the card, builds
the program's objects and warms up the cell's shapes; then the window runs
for ``--seconds``; then the window's outputs are judged against the plain
reference.  With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read by
``asrbench/metrics/<metric>.py`` from the window's spans, counters and
device trace.  The last line of standard output is the result; the
numbers compared for ``correct`` close standard error, each beside its
limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FORBIDDEN = ("jax", "jaxlib", "flax", "poccala_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one this benchmark must never
    load (compared whole: ``poccala_tpu_torch`` is not ``poccala_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from asrbench.harness import spec
    from asrbench.harness.runner import run_cell

    cell = spec.workload(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    if result["timing"]["built"]:
        print(f"this run built the port's CUDA kernels: "
              f"{result['timing']['setup_stamps']['build_s']:.1f} s of setup_s",
              file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
