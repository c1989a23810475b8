"""The plain reference against the port on the CPU at the tiny size, with the
same weights and inputs: the eval step (the selection and every output),
the served outputs of a Predictor, and train steps of both branches.  And
the import rules: no run loads JAX or the JAX package, and the reference
loads nothing of the port."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import judge, shared
from benchmark.core import FORBIDDEN_MODULES, reference_config
from benchmark.inputs.frames import frames_of, make_batch, split
from benchmark.inputs.seeds import rng
from benchmark.inputs.weights import make_state_dict
from benchmark.reference.mano_layer import ManoBuffers
from benchmark.reference.mano_model import make_synthetic_mano
from benchmark.reference.steps import AdamW, eval_outputs, train_step
from benchmark.tests.tiny import TINY_F32
from hoisdf_torch.config import get_config

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _setup(train_init=False, **kw):
    cfg = get_config("dexycb", **{**TINY_F32, **kw})
    ref_cfg = reference_config(cfg)
    sd = make_state_dict(ref_cfg, 11, CPU, train_init=train_init)
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    return cfg, ref_cfg, sd, mano


def _port_mano(mano):
    from hoisdf_torch.mano.layer import ManoBuffers as PortBuffers

    return PortBuffers(*mano)


def test_eval_step_selection_and_outputs():
    from hoisdf_torch.models.hoisdf import HOISDF
    from hoisdf_torch.train import make_eval_step

    cfg, ref_cfg, sd, mano = _setup(transfer_dtype="uint8")
    model = HOISDF(cfg)
    model.load_state_dict(sd)
    step = make_eval_step(cfg, model, _port_mano(mano), device="cpu")
    reader = shared.ProgramReader(model)
    batch_np = make_batch(cfg, 3, rng(5, "frames"))
    prog = step(batch_np)
    picks = reader.take()
    ref = shared.reference_model(ref_cfg, sd, CPU)
    batch = shared.on_device(batch_np, CPU)
    own = eval_outputs(ref, mano, batch, supervise_sdf=True)
    # in f32 both select the same points
    assert torch.equal(own["hand_points"], picks["hand"])
    assert torch.equal(own["obj_points"], picks["obj"])
    forced = eval_outputs(ref, mano, batch, supervise_sdf=True, forced=picks)
    keys = [k for k in forced if k in prog]
    assert len(keys) == 9
    assert judge.worst(judge.output_gaps(prog, forced, keys))[0] < 1e-5
    tally = shared.Tally()
    shared.judge_eval_batch(tally, ref, mano, batch, prog, picks, shared.EVAL_KEYS)
    assert tally.numbers["outputs"] < 1e-5 and tally.numbers["mano"] < 1e-5
    assert tally.numbers["select"] == 0.0 and tally.numbers["select_frame"] == 0.0


def test_served_outputs_frame_by_frame():
    from hoisdf_torch.predictor import SERVE_KEYS, Predictor

    cfg, ref_cfg, sd, mano = _setup()
    pred = Predictor(cfg, 4, "uint8", device="cpu")
    pred.model.load_state_dict(sd)
    reader = shared.ProgramReader(pred.model)
    batch_np = make_batch(cfg, 3, rng(6, "frames"), supervise=False)
    frames = frames_of(batch_np)
    served = pred.predict({k: np.stack([f[k] for f in frames]) for k in frames[0]})
    picks = {k: v[:3] for k, v in reader.take().items()}  # the padded row dropped
    ref = shared.reference_model(ref_cfg, sd, CPU)
    out = eval_outputs(ref, mano, shared.on_device(batch_np, CPU), supervise_sdf=False,
                       forced=picks)
    for k in SERVE_KEYS:
        gap = judge.frame_gap(torch.from_numpy(served[k]), out[k])
        assert float(gap.max()) < 1e-5, k


@pytest.mark.parametrize("field_guided", [False, True])
def test_train_step_losses_and_gradients(field_guided):
    from hoisdf_torch.models.hoisdf import HOISDF
    from hoisdf_torch.train import create_train_state, make_train_step

    cfg, ref_cfg, sd, mano = _setup(train_init=True, compute_dtype="float32",
                                    transfer_dtype="float32", reference_init=False)
    inputs, targets = split(make_batch(cfg, 2, rng(8, "frames"), train=True))
    inputs["img"] = inputs["img"].astype(np.float32) / 255.0
    model = HOISDF(cfg)
    model.load_state_dict(sd)
    state = create_train_state(cfg, model, 10, device="cpu")
    reader = shared.ProgramReader(model)
    step = make_train_step(cfg, _port_mano(mano), device="cpu")
    _, losses = step(state, inputs, targets, torch.Generator().manual_seed(3), 0.03,
                     use_presampled=not field_guided)
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    picks = reader.take() if field_guided else None
    ref = shared.reference_model(ref_cfg, sd, CPU)
    opt = AdamW(ref)
    ref_losses, _ = train_step(ref_cfg, ref, opt, mano, shared.on_device(inputs, CPU),
                               shared.on_device(targets, CPU), torch.Generator().manual_seed(3),
                               0.03, cfg.lr, use_presampled=not field_guided, forced=picks)
    assert set(losses) == set(ref_losses)
    for k in losses:
        assert float(losses[k]) == pytest.approx(float(ref_losses[k]), rel=1e-4, abs=1e-6), k
    ref_grads = {n: p.grad for n, p in ref.named_parameters() if p.grad is not None}
    assert set(grads) == set(ref_grads)
    g_p = {k: float(v.norm()) for k, v in grads.items()}
    g_r = {k: float(v.norm()) for k, v in ref_grads.items()}
    assert judge.leaf_gaps(g_p, g_r, list(g_r))[0] < 1e-3
    # one AdamW step moves every trainable leaf as torch's AdamW does
    for n, p in ref.named_parameters():
        if n in opt.params:
            torch.testing.assert_close(p, dict(model.named_parameters())[n].detach(),
                                       rtol=0, atol=2e-4 * cfg.lr / 1e-4)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_port_or_jax():
    ref_dir = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(ref_dir):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref_dir, name))}
            assert not tops & {"hoisdf_torch", *FORBIDDEN_MODULES}, name
    code = ("import sys; import benchmark.reference.steps, benchmark.reference.precision, "
            "benchmark.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert "hoisdf_torch" not in tops and not tops & set(FORBIDDEN_MODULES)


def test_a_run_loads_no_jax_module():
    """A whole tiny run in a fresh process, and the whole-name check (the
    port's name begins with the JAX package's)."""
    code = ("import sys, torch; sys.path.insert(0, '.');"
            "from benchmark.tests.tiny import run_cell;"
            "rc, line, err = run_cell('dexycb.eval', 'eval_stream');"
            "from benchmark.core import forbidden_modules;"
            "print(rc, line is not None, forbidden_modules(),"
            " 'hoisdf_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=600).stdout.split()
    assert out == ["0", "True", "[]", "True"]
    from benchmark import core

    try:
        sys.modules["hoisdf_tpu_extra"] = sys.modules["os"]
        assert core.forbidden_modules() == []
        sys.modules["hoisdf_tpu.models"] = sys.modules["os"]
        assert core.forbidden_modules() == ["hoisdf_tpu"]
    finally:
        sys.modules.pop("hoisdf_tpu_extra", None)
        sys.modules.pop("hoisdf_tpu.models", None)
