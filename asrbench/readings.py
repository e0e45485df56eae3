"""The readings that the limits of ``correct`` are set from: a cell's
compared numbers over many seeds in one process, for the program as the
configuration states it or, with ``--control``, for the control (the
program's bfloat16 scoring path, the precision below the configuration's
float32).

    python3 asrbench/readings.py --workload <cell> --seeds 11,12,13 --seconds 2 [--control]

One JSON line a seed, then one with each number's largest reading.  With
``--fault`` a fault of :mod:`asrbench.harness.faults` is planted under the
program first.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=("state_unchanged", "half_batch",
                                       "answer_altered"))
    args = p.parse_args(argv)
    import torch

    from asrbench.harness import faults, spec
    from asrbench.harness.runner import run_cell

    if args.fault:
        mix = spec.traffic(spec.workload(args.workload)["traffic"])
        faults.plant(mix["driver"], args.fault)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    worst: dict = {}
    for s in (int(x) for x in args.seeds.split(",")):
        result, checks = run_cell(args.workload, s, args.seconds, False,
                                  device="cuda", control=args.control,
                                  keep=(diag := {}))
        line = {"seed": s, "correct": result["correct"],
                **{k: c["value"] for k, c in checks.items()},
                **diag}
        print(json.dumps(line), flush=True)
        for k, c in checks.items():
            worst[k] = max(worst.get(k, c["value"]), c["value"])
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "largest": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
