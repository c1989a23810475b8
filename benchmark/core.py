"""The harness's shared parts: the manifest and a cell's files found by name,
the port's configuration built from a configuration file, the run's result
line, the device guard and the check that no JAX module was loaded.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``.  Its files:

- ``benchmark/workloads/<cell>.json``: configuration, traffic, chips, why
  and the limits of the numbers its comparison prints;
- ``benchmark/configs/<config>.json``: the published sizes and the port's
  settings;
- ``benchmark/traffic/<traffic>.json``: the mix's ``kind`` (the generator,
  ``benchmark/kinds/<kind>.py``) and its parameters;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import types
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = "BENCHMARK.json"
# top-level module names a run may not load (whole names: the port's name
# begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "hoisdf_tpu")


class HarnessError(RuntimeError):
    """A cell, file or device the harness cannot use: the run prints no result."""


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell and everything found for it by name."""

    name: str
    entry: Dict[str, Any]  # the manifest's workloads entry
    spec: Dict[str, Any]  # workloads/<cell>.json
    config: Dict[str, Any]  # configs/<config>.json
    traffic: Dict[str, Any]  # traffic/<traffic>.json
    end_to_end: List[Dict[str, Any]]  # the manifest's metrics this cell reports
    per_layer: List[Dict[str, Any]]
    root: str = ROOT

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.spec["limits"]


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def bench_path(root: str, *parts: str) -> str:
    return os.path.join(root, "benchmark", *parts)


def resolve_cell(name: str, root: str = ROOT, manifest: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``root``'s manifest (or ``manifest``), its files
    read and checked against the manifest's entry."""
    if manifest is None:
        path = os.path.join(root, MANIFEST)
        if not os.path.exists(path):
            raise HarnessError(f"no {MANIFEST} at {root}")
        manifest = load_json(path)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise HarnessError(f"no cell {name!r} in {MANIFEST} (have {sorted(entries)})")
    entry = entries[name]
    files = {"spec": bench_path(root, "workloads", f"{name}.json"),
             "config": bench_path(root, "configs", f"{entry['config']}.json"),
             "traffic": bench_path(root, "traffic", f"{entry['traffic']}.json")}
    for what, path in files.items():
        if not os.path.exists(path):
            raise HarnessError(f"cell {name!r}: no {what} file {os.path.relpath(path, root)}")
    spec = load_json(files["spec"])
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise HarnessError(f"cell {name!r}: {key} is {spec[key]!r} in its file, "
                               f"{entry[key]!r} in {MANIFEST}")
    cell = Cell(name, entry, spec, load_json(files["config"]), load_json(files["traffic"]),
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)], root)
    kind_file = bench_path(root, "kinds", f"{cell.kind}.py")
    if not os.path.exists(kind_file):
        raise HarnessError(f"cell {name!r}: no generator {os.path.relpath(kind_file, root)}")
    for m in cell.per_layer:
        reader = bench_path(root, "metrics", f"{m['name']}.py")
        if not os.path.exists(reader):
            raise HarnessError(f"metric {m['name']!r}: no reader {os.path.relpath(reader, root)}")
    return cell


def load_module(path: str, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(cell: Cell) -> types.ModuleType:
    return load_module(bench_path(cell.root, "kinds", f"{cell.kind}.py"),
                       f"benchmark_kind_{cell.kind}")


def metric_reader(cell: Cell, metric: str) -> Callable[[Any], Optional[float]]:
    mod = load_module(bench_path(cell.root, "metrics", f"{metric}.py"),
                      "benchmark_metric_" + metric.replace(".", "_"))
    return mod.read


# ---- configuration ---------------------------------------------------------------

def port_config(cell: Cell, overrides: Optional[Dict[str, Any]] = None):
    """The port's ``Config`` for the cell: the preset, the published sizes
    of the configuration file, the port's settings there, the traffic's
    precision and wire, and test-only ``overrides``."""
    from hoisdf_torch.config import get_config

    c = cell.config
    kw = dict(c["published"])
    kw.update(c.get("port", {}))
    kw.update(cell.traffic.get("port", {}))
    kw.update(overrides or {})
    return get_config(c["preset"], **kw)


def reference_config(cfg) -> types.SimpleNamespace:
    """The configuration's numbers as the reference reads them (a plain
    namespace: the reference takes no object of the program)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["nerf_num_freqs"] = (cfg.point_feat_size - 3) // 6
    return types.SimpleNamespace(**fields)


# ---- the run's guards and output --------------------------------------------------

def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden (whole names)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def card(chips: int):
    """The device the run measures, or HarnessError: no CUDA, or fewer cards
    than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise HarnessError("CUDA is not available: this benchmark measures an NVIDIA card")
    if torch.cuda.device_count() < chips:
        raise HarnessError(f"the cell needs {chips} cards, {torch.cuda.device_count()} seen")
    return torch.device("cuda", 0)


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its kernels into ``hoisdf_torch/_build`` itself)."""
    base = os.path.join(root, "benchmark", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every compared number is known, finite and at most its
    limit; a number without a limit fails."""
    return all(k in limits and v is not None and math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items()) and bool(numbers)


def compared_lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"compare {k}: {v!r} limit {limits.get(k)!r}" for k, v in numbers.items()]
