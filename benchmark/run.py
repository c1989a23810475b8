"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run makes its inputs and weights from ``--seed``, builds the port's
entry for the cell and warms up the cell's own shapes (set-up), measures
for ``--seconds``, compares what the timed path produced with the plain
reference (``benchmark/judge.py``), and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (with ``--trace 1`` also ``breakdown``) and, last, ``compare``:
each compared number beside its limit, which also close standard error.
With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read by ``benchmark/metrics/<name>.py``
from the run's spans, counters and a profiled sub-window at the window's
end.

It exits non-zero and prints no result without a card (or with fewer
cards than the cell asks for), when a file of the cell is missing, and when
a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # the process's start, as near as the harness sees it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Callable, Dict, Optional, Sequence  # noqa: E402

if __package__ in (None, ""):  # run as a file: make the checkout importable
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import core  # noqa: E402


class Session:
    """What a cell's generator (``benchmark/kinds/<kind>.py``) is given:
    the cell, the run's options, the device, the port's configuration and
    the reference's, host spans, and the shared inputs."""

    def __init__(self, cell: core.Cell, seed: int, seconds: float, trace: bool, device,
                 overrides: Optional[Dict[str, Any]] = None,
                 fault: Optional[Callable[[str, Any], Any]] = None):
        from benchmark.trace import Spans

        self.t_start = T_START
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        ov = overrides or {}
        self.cfg = core.port_config(cell, ov.get("config"))
        self.ref_cfg = core.reference_config(self.cfg)
        self.params = {**cell.traffic["params"], **ov.get("traffic", {})}
        self.spans = Spans()
        self._fault = fault

    # ---- the program, and faults planted in it by the tests -----------------

    def program(self, what: str, obj):
        """``obj`` as the window drives it (a test may plant a fault)."""
        return obj if self._fault is None else self._fault(what, obj)

    # ---- shared inputs ------------------------------------------------------------

    def weights(self, train_init: bool):
        from benchmark.inputs.seeds import torch_seed
        from benchmark.inputs.weights import make_state_dict

        return make_state_dict(self.ref_cfg, torch_seed(self.seed, "weights"), self.device,
                               train_init=train_init)

    def mano(self):
        """(the reference's MANO buffers, the same tensors as the port's
        ``ManoBuffers``) on the device: the stand-in at MANO's shapes."""
        from hoisdf_torch.mano.layer import ManoBuffers as PortBuffers

        from benchmark.reference.mano_layer import ManoBuffers
        from benchmark.reference.mano_model import make_synthetic_mano

        ref = ManoBuffers.from_model(make_synthetic_mano(0), self.device)
        if PortBuffers._fields != ManoBuffers._fields:
            raise core.HarnessError("the port's ManoBuffers fields changed: "
                                    f"{PortBuffers._fields}")
        return ref, PortBuffers(*ref)

    def rng(self, purpose: str):
        from benchmark.inputs.seeds import rng

        return rng(self.seed, purpose)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def mark(self, what: str) -> None:
        """Log the seconds since the process started, at a step of set-up."""
        self.log(f"set-up {time.perf_counter() - self.t_start:.3f} s: {what}")

    def log(self, line: str) -> None:
        print(f"[bench] {line}", file=sys.stderr, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the first card as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _metrics_line(session: Session, result: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The metrics the run reports: end-to-end, or with ``--trace 1`` the
    per-layer readers' (a reader that finds nothing is left out)."""
    cell = session.cell
    out: Dict[str, Dict[str, Any]] = {}
    if not session.trace:
        for m in cell.end_to_end:
            v = result["end_to_end"].get(m["name"])
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    ctx = result["layer_context"]
    for m in cell.per_layer:
        v = core.metric_reader(cell, m["name"])(ctx)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, *, root: str = core.ROOT, device=None,
         overrides: Optional[Dict[str, Any]] = None,
         fault: Optional[Callable[[str, Any], Any]] = None) -> int:
    """The command.  ``device``, ``overrides`` (``{"config": ..., "traffic":
    ...}``) and ``fault`` are the tests' entry (the CPU, a tiny model, a
    planted fault); the command itself always asks for a card."""
    args = parse(argv)
    core.cache_dirs(root)
    try:
        cell = core.resolve_cell(args.workload, root)
        dev = device if device is not None else core.card(cell.chips)
    except core.HarnessError as exc:
        print(f"benchmark: {exc}", file=sys.stderr, flush=True)
        return 2
    if dev.type == "cuda":
        print(f"[bench] card: {card_line()}", file=sys.stderr, flush=True)
    session = Session(cell, args.seed, args.seconds, bool(args.trace), dev, overrides, fault)
    session.mark("harness and torch imported, card found")
    result = core.kind_module(cell).run(session)
    metrics = _metrics_line(session, result)
    loaded = core.forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {loaded}; it may load no JAX module",
              file=sys.stderr, flush=True)
        return 3
    numbers, limits = result["compare"], cell.limits
    correct = core.judge(numbers, limits)
    import torch

    device_info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips if dev.type == "cuda" else 1,
        "memory_peak_bytes": result["memory_peak_bytes"],
    }
    line: Dict[str, Any] = {"correct": correct, "attempted": result["attempted"],
                            "failed": result["failed"], "metrics": metrics,
                            "device": device_info}
    if session.trace:
        tr = result["layer_context"].trace
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_by_host(10)}
    line["compare"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    for text in core.compared_lines(numbers, limits):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
