"""The port's serving export (``hoisdf_torch/tools/export.py``) against the
JAX package's StableHLO export (``hoisdf_tpu/tools/export_stablehlo.py``):
one tiny dexycb config on both sides, f32, the port's seeded weights
carried to JAX by ``convert_state_dict`` (BatchNorm statistics moved off
(0, 1)) and back by ``state_dict_from_jax``.

Each artifact is called as a loader would call it: the port's after
``torch.export.load`` with its ``params.npz``, JAX's after
``jax.export.deserialize``, on the same inputs.  Tolerance ``rtol=1e-4,
atol=1e-5``, as ``tests/test_export.py`` holds the JAX artifact to its
Predictor (f32 on both sides; summation order through the backbone and the
transformers).  The port's artifact, exported with a polymorphic batch, is
also held to the port's eager step on the same inputs, bit for bit (the
same CPU ops at the same shapes), at batch 2 and 3.  (The fixed-batch
export differs only in its ``dynamic_shapes``; chip_smoke's ``export``
line runs both.)  The CLI is checked for
its defaults and ``--ckpt`` without exporting again.  One JAX export: a
file of its own.
"""

import importlib
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES
from hoisdf_torch.predictor import INPUT_KEYS, Predictor
from hoisdf_torch.tools.export import OUTPUT_KEYS, flatten_params, unflatten_params
from hoisdf_torch.tools import export as export_mod
from hoisdf_torch.tools.export import export_serving_module, main
from hoisdf_torch.weights import state_dict_from_jax
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_tpu.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.models.hoisdf import build_model as jax_build_model
from hoisdf_tpu.tools.convert_torch_ckpt import convert_state_dict
from hoisdf_tpu.tools.export_stablehlo import export_serving_module as jax_export

from torch_port_util import configs, one_torch_thread, perturb_batch_stats  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 2


@pytest.fixture(scope="module")
def setup(one_torch_thread, tmp_path_factory):
    jcfg, pcfg = configs("dexycb", hier_levels=((4, 16), (2, 32)))
    # seeded port weights carried to JAX (no JAX init to compile), BN
    # statistics moved off (0, 1)
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in build_model(pcfg, 0).state_dict().items()})
    stats = perturb_batch_stats(stats)
    model = jax_build_model(jcfg)
    inputs, _ = split_inputs_targets(synthetic_batch(jcfg, BATCH, train=False))
    # what the JAX export reads of a JAX Predictor, without its eager init
    jpred = types.SimpleNamespace(
        cfg=jcfg, model=model, params=params, batch_stats=stats, batch_size=BATCH,
        mano=JaxManoBuffers.from_model(make_synthetic_mano(0)),
        _template={k: jnp.asarray(v) for k, v in inputs.items() if k in INPUT_KEYS})
    state = state_dict_from_jax(params, stats)
    root = tmp_path_factory.mktemp("export")
    jax_export(jpred, str(root / "jax"))
    preds = {b: Predictor(pcfg, batch_size=b, device="cpu", state_dict=state) for b in (2, 3)}
    export_serving_module(preds[BATCH], str(root / "poly"), polymorphic_batch=True)
    return dict(root=root, jpred=jpred, preds=preds, state=state, loaded=_load(root / "poly"))


def _load(out_dir):
    sig = json.load(open(os.path.join(out_dir, "signature.json")))
    importlib.import_module(sig["ops"])
    prog = torch.export.load(os.path.join(out_dir, "model.pt2")).module()
    flat = np.load(os.path.join(out_dir, "params.npz"))
    params = [torch.from_numpy(flat[k]) for k in sig["param_order"]]

    def call(inputs):
        with torch.no_grad():
            out = prog(*params, *[torch.from_numpy(np.asarray(inputs[k]))
                                  for k in sig["input_order"]])
        return {k: v.numpy() for k, v in out.items()}

    return sig, call


def _eager(pred, inputs):
    """The port's eval step on ``inputs``, reduced as the artifact reduces."""
    out = pred._eval_step({k: np.asarray(v) for k, v in inputs.items()})
    got = {k: out[k] for k in ("mano_joints", "mano_verts", "hand_joints")}
    got.update(obj_rot=out["obj_rot"].mean(dim=1), obj_trans=out["obj_trans"].mean(dim=1))
    return {k: v.numpy() for k, v in got.items()}


def test_flatten_roundtrip_over_a_state_dict():
    sd = {"b.w": torch.ones(2), "a.x.y": torch.zeros(3), "a.z": torch.eye(2)}
    flat = dict(flatten_params(sd))
    assert list(flat) == ["a.x.y", "a.z", "b.w"]
    back = unflatten_params(flat)
    np.testing.assert_array_equal(back["a"]["x"]["y"], np.zeros(3))
    np.testing.assert_array_equal(back["b"]["w"], np.ones(2))


def test_signature_has_the_jax_keys_and_the_ops_module(setup):
    sig, _ = setup["loaded"]
    want = json.load(open(setup["root"] / "jax" / "signature.json"))
    assert set(sig) == set(want) | {"ops"} and sig["ops"] == "hoisdf_torch.ops.kernels"
    assert sig["input_order"] == want["input_order"] == list(INPUT_KEYS)
    assert sig["outputs"] == want["outputs"] == list(OUTPUT_KEYS)
    assert sig["param_order"] == sorted(setup["preds"][BATCH].model.state_dict())
    assert sig["batch_size"] == "b" and want["batch_size"] == BATCH
    for k, v in want["inputs"].items():  # the batch symbolic, the rest JAX's
        assert sig["inputs"][k] == dict(v, shape=["b", *v["shape"][1:]]), k


def test_port_artifact_matches_the_jax_artifact(setup):
    from jax import export as jexport

    jdir = setup["root"] / "jax"
    jsig = json.load(open(jdir / "signature.json"))
    flat = np.load(jdir / "params.npz")
    exp = jexport.deserialize(open(jdir / "model.stablehlo", "rb").read())
    inputs = {k: np.asarray(v) for k, v in setup["jpred"]._template.items()}
    want = exp.call(*[flat[k] for k in jsig["param_order"]],
                    *[inputs[k] for k in jsig["input_order"]])
    _, call = setup["loaded"]
    got = call(inputs)
    for k in OUTPUT_KEYS:
        assert got[k].shape == np.shape(want[k]), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("batch", [2, 3])
def test_port_artifact_is_the_eager_step(setup, batch):
    pred = setup["preds"][batch]
    _, call = setup["loaded"]
    inputs = {k: np.asarray(v) for k, v in pred._template.items()}
    got, want = call(inputs), _eager(pred, inputs)
    for k in OUTPUT_KEYS:
        assert got[k].shape[0] == batch and np.array_equal(got[k], want[k]), k


def test_cli_defaults_and_ckpt(setup, tmp_path, monkeypatch):
    """``main`` builds the JAX CLI's Predictor (hier, bf16 unless ``--cfg``
    says otherwise, batch 8 by default, the CPU with ``--cpu``) with the
    weights of a port snapshot directory, and exports it where asked."""
    snap = tmp_path / "model_dump"
    snap.mkdir()
    torch.save({"epoch": 0, "network": {"module." + k: v for k, v in setup["state"].items()},
                "optimizer": {}, "step": 0}, snap / "snapshot_0.pth.tar")
    seen = {}

    def fake_export(pred, out_dir, *, polymorphic_batch=False):
        seen.update(pred=pred, out_dir=out_dir, poly=polymorphic_batch)
        return os.path.join(out_dir, "model.pt2")

    monkeypatch.setattr(export_mod, "export_serving_module", fake_export)
    over = {k: v for k, v in SYNTHETIC_TINY_OVERRIDES.items()}
    over.update(hier_levels=[[4, 16], [2, 32]], hier_levels_obj=None)
    main([str(tmp_path / "out"), "--cpu", "--ckpt", str(snap), "--polymorphic-batch"]
         + [a for k, v in over.items() for a in ("--cfg", f"{k}={json.dumps(v)}")])
    pred = seen["pred"]
    assert seen["out_dir"] == str(tmp_path / "out") and seen["poly"]
    assert pred.batch_size == 8 and pred.device.type == "cpu"
    assert pred.cfg.sdf_infer_mode == "hier" and pred.cfg.compute_dtype == "bfloat16"
    got = pred.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in setup["state"].items())
