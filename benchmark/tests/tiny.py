"""The tiny configuration of the benchmark's CPU tests, and a run of a cell
through the harness's test-only entry."""

from __future__ import annotations

import contextlib
import io
import json

import torch

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES

TINY = dict(SYNTHETIC_TINY_OVERRIDES, hier_levels=((4, 16), (2, 48)), hier_levels_obj=None)
TINY_F32 = dict(TINY, compute_dtype="float32")
TRAFFIC = {"eval_stream": {"batch": 2, "pool": 2, "warmup": 1, "profile_steps": 1},
           "poisson_serve": {"batch": 2, "pool": 4, "checked_requests": 4, "rate_hz": 10.0,
                             "profile_seconds": 0.5},
           "train_mix": {"batch": 2, "pool": 4, "profile_steps": 5}}


def run_cell(cell: str, kind: str, *, seconds: float = 1.0, trace: int = 0, seed: int = 7,
             config=None, fault=None, root=None):
    """Run ``cell`` on the CPU at the tiny size -> (rc, the result line or
    None, standard error)."""
    from benchmark import run

    out, err = io.StringIO(), io.StringIO()
    kw = {} if root is None else {"root": root}
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device=torch.device("cpu"),
                      overrides={"config": TINY if config is None else config,
                                 "traffic": TRAFFIC[kind]}, fault=fault, **kw)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
