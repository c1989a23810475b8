"""The controls of the comparison, at a size a test run holds: the reference
in the nearest lower precision put in the program's place has to read above
a limit of the cell (on the card the same controls run at the cells' own
size: ``python -m benchmark.control``)."""

import contextlib
import io
import json

import pytest
import torch

from benchmark import control
from benchmark.tests.tiny import TINY, TINY_F32, TRAFFIC


@pytest.mark.parametrize("cell,kind,config", [("dexycb.eval", "eval_stream", TINY),
                                              ("dexycb.serve", "poisson_serve", TINY),
                                              ("ho3d.train", "train_mix", TINY_F32)])
def test_the_lower_precision_control_comes_out_incorrect(cell, kind, config):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = control.main(["--workload", cell, "--seeds", "1,2"], device=torch.device("cpu"),
                          overrides={"config": config, "traffic": TRAFFIC[kind]})
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert rc == 0 and len(lines) == 2
    for line in lines:
        assert line["control_fails"]
        assert any(v["value"] > v["limit"] for v in line["compare"].values())
