"""The IK head's cell (``ho3d_render.eval``, kind ``eval_stream_ik``) on the
CPU at the tiny size: untraced and traced runs, faults planted in the
program's hand that the comparison has to catch, a program whose step
gives no hand (it stops at its first step), the control, and the reading
of device time under a program span."""

import contextlib
import io
import json

import pytest
import torch

from benchmark import control, core
from benchmark.counts.ik import ik_solve_bound_s, ik_solve_bytes, ik_solve_ops
from benchmark.tests.tiny import TINY, TINY_F32, TRAFFIC, run_cell

CELL = "ho3d_render.eval"
KIND = "eval_stream"  # the tiny traffic's parameters are eval_stream's


def test_the_cell_resolves_to_its_files():
    c = core.resolve_cell(CELL)
    assert c.kind == "eval_stream_ik" and c.config["preset"] == "ho3d_render"
    assert c.config["reduced"] == [] and not c.config["published"]["use_big_decoder"]
    assert set(c.limits) == {"outputs", "select", "select_frame", "ik", "ik_frame", "ik_valid"}
    assert {m["name"] for m in c.per_layer} >= {"eval.ik_ms", "eval.ik_device_ms",
                                                 "ik_roofline.eval"}


@pytest.mark.parametrize("trace", [0, 1])
def test_runs_are_correct(trace):
    rc, line, err = run_cell(CELL, KIND, trace=trace, config=TINY_F32)
    assert rc == 0 and line["correct"], line["compare"]
    names = set(line["metrics"])
    if trace:
        # the CPU has no device time: the host spans only
        assert {"eval.host_ms", "eval.ik_ms"} <= names
        assert not any("idle" in n or "roofline" in n or "device" in n for n in names)
    else:
        assert names == {"eval_fps", "setup_s"}
    assert set(line["compare"]) == {"outputs", "select", "select_frame", "ik", "ik_frame",
                                    "ik_valid"}


def _altered(key):
    def hook(what, step):
        if what != "eval_step":
            return step

        def altered(batch):
            out = dict(step(batch))
            if key == "ik_valid":
                out[key] = 1 - out[key]
            elif key == "drop":
                del out["mano_joints"]
            elif key == "hand_joints":  # every voted joint halfway to the root
                out[key] = out[key] * 0.5
            else:
                v = out[key].clone()
                v[0] = v[0] + 0.01  # one frame's hand 1 cm off
                out[key] = v
            return out
        return altered
    return hook


@pytest.mark.parametrize("key,number", [("mano_verts", "ik_frame"), ("ik_valid", "ik_valid"),
                                        ("hand_joints", "outputs")])
def test_planted_faults_come_out_incorrect(key, number):
    rc, line, _ = run_cell(CELL, KIND, config=TINY_F32, fault=_altered(key))
    assert rc == 0 and not line["correct"]
    cmp = line["compare"][number]
    assert cmp["value"] > cmp["limit"], line["compare"]


def test_a_step_without_the_hand_stops_at_once():
    with pytest.raises(RuntimeError, match="gives no"):
        run_cell(CELL, KIND, config=TINY_F32, fault=_altered("drop"))


def test_the_lower_precision_control_comes_out_incorrect():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = control.main(["--workload", CELL, "--seeds", "1"], device=torch.device("cpu"),
                          overrides={"config": TINY, "traffic": TRAFFIC[KIND]})
    (line,) = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert rc == 0 and line["control_fails"]
    assert any(v["value"] > v["limit"] for v in line["compare"].values())


def test_device_time_is_read_under_a_span_by_correlation():
    kind = core.load_module(core.bench_path(core.ROOT, "kinds", "eval_stream_ik.py"), "k_ik")
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "eval.ik", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 2,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 160, "dur": 2,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 300, "dur": 20,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 330, "dur": 40,
         "args": {"correlation": 8}},
    ]
    got = kind.range_device_seconds(ev, ("eval.ik", "eval.none"))
    assert got == {"eval.ik": pytest.approx(20e-6)}


def test_the_kernels_counts():
    pk = {"float32": 66.9e12, "bytes": 3.35e12}
    assert ik_solve_ops(22) == 22 * ik_solve_ops(1) > 22 * 3000
    assert ik_solve_bytes(1) == 2 * 63 * 4 + 48 * 4 + 4
    assert ik_solve_bound_s(22, pk) == max(ik_solve_ops(22) / 66.9e12,
                                           ik_solve_bytes(22) / 3.35e12)
