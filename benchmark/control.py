"""The controls of the comparison that decides ``correct``.

    python -m benchmark.control --workload <cell> --seeds 1,2,3

For each seed the cell's inputs and weights are made as a run makes them,
the reference computed in the nearest precision below the configuration's
(``benchmark/reference/precision.py``: fp8 below bf16, TF32 below f32) is
put in the program's place, and its outputs are judged as a run judges the
program's.  One JSON line a seed: each compared number beside the cell's
limit.  A control has to read above the limit of at least one number; the
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from benchmark import core

DEFAULT_ROUNDING = {"bfloat16": "fp8", "float32": "tf32"}


def main(argv: Optional[Sequence[str]] = None, *, root: str = core.ROOT, device=None,
         overrides=None) -> int:
    from benchmark.reference.precision import ROUNDINGS
    from benchmark.run import Session

    p = argparse.ArgumentParser(prog="benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    core.cache_dirs(root)
    try:
        cell = core.resolve_cell(args.workload, root)
        dev = device if device is not None else core.card(cell.chips)
    except core.HarnessError as exc:
        print(f"benchmark.control: {exc}", file=sys.stderr)
        return 2
    kind = core.kind_module(cell)
    failed_all = True
    for seed in [int(x) for x in args.seeds.split(",") if x.strip()]:
        s = Session(cell, seed, 0.0, False, dev, overrides)
        rounding = DEFAULT_ROUNDING[s.cfg.compute_dtype]
        numbers = kind.control(s, ROUNDINGS[rounding]).numbers
        fails = not core.judge(numbers, cell.limits)
        failed_all &= fails
        print(json.dumps({"workload": cell.name, "seed": seed, "rounding": rounding,
                          "control_fails": fails,
                          "compare": {k: {"value": v, "limit": cell.limits.get(k)}
                                      for k, v in numbers.items()}}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
