"""The port's evaluation harness against the JAX package's: ``Evaluator`` on
the same predictions for all four presets (the pitcher exclusion and the
codalab lists of HO3D, IK for ho3d_render and for DexYCB, the mesh metrics of
dexycb_full), ``pad_batch`` / ``trim_batch``, and ``evaluate.main
--synthetic --cpu`` end to end.

Both sides run in f32 on the CPU.  Accumulated results agree within 1e-5
relative (the metrics' own tolerance, ``test_torch_metrics.py``); the codalab
lists within 1e-5 absolute (metres), and their JSON within one step of its
4 decimals.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch import evaluate as PE
from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES as PORT_TINY
from hoisdf_torch.config import get_config
from hoisdf_torch.data import loader as PL
from hoisdf_torch.data.ho3d import HO3D_OBJECTS, dump_codalab_json
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.models.mano_head import mano_head_gt
from hoisdf_torch.train import make_eval_step
from hoisdf_tpu import evaluate as JE
from hoisdf_tpu.config import get_config as jax_get_config
from hoisdf_tpu.data import ho3d as jax_ho3d
from hoisdf_tpu.data import loader as JL
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers

PRESETS = ("dexycb", "dexycb_full", "ho3d", "ho3d_render")
RTOL = 1e-5
T = torch.from_numpy


@pytest.fixture(scope="module")
def mano():
    m = make_synthetic_mano(0)
    return ManoBuffers.from_model(m), JaxManoBuffers.from_model(m)


def _batch(buf, seed, b=3, points=7):
    """Predictions near the ground truth: the object pose and the hand mesh
    with noise of a few millimetres, as one eval batch gives them."""
    rng = np.random.RandomState(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    targets = {
        "obj_rot": f32(rng.randn(b, 3)),
        "rel_obj_trans": f32(rng.randn(b, 3) * 0.05),
        "mano_param": f32(rng.randn(b, 58) * 0.2),
        "joint_cam_no_trans": f32(rng.randn(b, 21, 3) * 50),
    }
    gt = mano_head_gt(buf, T(targets["mano_param"]))
    targets["joint_cam_no_trans"] = f32(gt["joints3d"].numpy() * 1000
                                        + rng.randn(b, 21, 3) * 3)
    preds = {
        "obj_rot": f32(targets["obj_rot"][:, None] + rng.randn(b, points, 3) * 0.05),
        "obj_trans": f32(targets["rel_obj_trans"][:, None] + rng.randn(b, points, 3) * 0.01),
        "mano_joints": f32(gt["joints3d"].numpy() + rng.randn(b, 21, 3) * 0.004),
        "mano_verts": f32(gt["verts3d"].numpy() + rng.randn(b, 778, 3) * 0.004),
        "hand_joints": f32(gt["joints3d"].numpy()[:, 1:] + rng.randn(b, 20, 3) * 0.004),
        "mano_shape": f32(targets["mano_param"][:, 48:] + rng.randn(b, 10) * 0.05),
    }
    meta = {"mano_root": f32(rng.randn(b, 3) * 0.02 + [0, 0, 0.6]),
            "obj_cls": np.array([HO3D_OBJECTS.index("019_pitcher_base"), 2, 7][:b], np.int32)}
    templates = f32(rng.randn(b, 60, 3) * 0.05)
    return preds, targets, meta, templates


@pytest.mark.parametrize("setting", PRESETS)
def test_evaluator_matches_jax(mano, setting, tmp_path):
    """Two batches through both evaluators; HO3D leaves the pitcher (sample
    0 of each batch) out of ADD-S, MME and the count."""
    port = PE.Evaluator(get_config(setting), mano[0], device="cpu")
    jev = JE.Evaluator(jax_get_config(setting), mano[1])
    for seed in (0, 1):
        preds, targets, meta, templates = _batch(mano[0], seed)
        port.feed(preds, targets, meta, templates)
        jev.feed({k: jnp.asarray(v) for k, v in preds.items()},
                 {k: jnp.asarray(v) for k, v in targets.items()}, meta, jnp.asarray(templates))
    assert port.total == jev.total == (4 if "ho3d" in setting else 6)
    assert set(port.results) == set(jev.results)
    for k, v in jev.results.items():
        assert port.results[k] == pytest.approx(v, rel=RTOL), k
        assert np.isfinite(port.results[k]) and port.results[k] > 0, k
    if "ho3d" in setting:
        assert len(port.joint_list) == len(jev.joint_list) == 6
        for got, want in ((port.joint_list, jev.joint_list), (port.mesh_list, jev.mesh_list)):
            np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0, atol=1e-5)
        (tmp_path / "codalab").mkdir()
        path = dump_codalab_json(str(tmp_path), port.joint_list, port.mesh_list)
        want_path = jax_ho3d.dump_codalab_json(str(tmp_path / "codalab"), jev.joint_list,
                                               jev.mesh_list)
        with open(path) as f, open(want_path) as g:
            got_lists, want_lists = json.load(f), json.load(g)
        for a, b in zip(got_lists, want_lists):  # 4 decimals: one step at a rounding edge
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1.01e-4)
    if setting == "dexycb_full":
        np.testing.assert_allclose(port.f_scores, jev.f_scores, rtol=RTOL)
        np.testing.assert_allclose(port.f_scores_aligned, jev.f_scores_aligned, rtol=RTOL)
        for a, b in ((port.mesh_err, jev.mesh_err),
                     (port.mesh_err_aligned, jev.mesh_err_aligned)):
            np.testing.assert_allclose(a.get_measures(0.0, 0.05, 100)[:3],
                                       b.get_measures(0.0, 0.05, 100)[:3], rtol=RTOL)
    got_txt = open(port.write_results(str(tmp_path))).read()
    jdir = tmp_path / "jax"
    jdir.mkdir()
    want_txt = open(jev.write_results(str(jdir))).read()
    num = re.compile(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?")
    assert num.sub("#", got_txt) == num.sub("#", want_txt)
    for a, b in zip(num.findall(got_txt), num.findall(want_txt)):
        assert float(a) == pytest.approx(float(b), rel=RTOL, abs=1.5e-3), (a, b)


def test_evaluator_obj_valid_overrides_obj_cls(mano):
    preds, targets, meta, templates = _batch(mano[0], 2)
    port = PE.Evaluator(get_config("ho3d"), mano[0], device="cpu")
    jev = JE.Evaluator(jax_get_config("ho3d"), mano[1])
    meta = dict(meta, obj_valid=np.array([True, False, True]))
    port.feed(preds, targets, meta, templates)
    jev.feed({k: jnp.asarray(v) for k, v in preds.items()}, targets, meta,
             jnp.asarray(templates))
    assert port.total == jev.total == 2
    assert port.results["MME_error"] == pytest.approx(jev.results["MME_error"], rel=RTOL)


def test_pad_and_trim_match_jax():
    rng = np.random.RandomState(3)
    d = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randint(0, 9, (3,)),
         "c": rng.randn(5, 2)}
    got, want = PL.pad_batch(d, 5), JL.pad_batch(d, 5)
    for k in d:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].shape[0] == 5
        np.testing.assert_array_equal(PL.trim_batch(got, 3)[k], JL.trim_batch(want, 3)[k])
    np.testing.assert_array_equal(got["a"][3:], np.repeat(d["a"][-1:], 2, axis=0))


def _tiny(setting):
    cfg = get_config(setting, **PORT_TINY)
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    step = make_eval_step(cfg, build_model(cfg), mano, device="cpu")
    return cfg, mano, step


def test_padded_tail_batch_gives_the_valid_rows_results():
    """Three valid rows padded to four, through ``evaluate_batches`` (the
    lookahead loop), score as the three rows alone."""
    cfg, mano, step = _tiny("dexycb_full")
    inputs, targets, templates, _ = next(PE.synthetic_batches(cfg, 1, 3))
    padded = PE.Evaluator(cfg, mano, device="cpu")
    PE.evaluate_batches(cfg, step, padded, [(PL.pad_batch(inputs, 4), PL.pad_batch(targets, 4),
                                            PL.pad_batch({"t": templates}, 4)["t"], 3)], 4)
    alone = PE.Evaluator(cfg, mano, device="cpu")
    alone.feed(step(inputs), targets, inputs, templates)
    assert padded.total == alone.total == 3
    for k, v in alone.results.items():
        assert padded.results[k] == pytest.approx(v, rel=RTOL), k
    np.testing.assert_allclose(padded.f_scores, alone.f_scores, rtol=RTOL)


@pytest.mark.parametrize("setting", ["dexycb", "dexycb_full"])
def test_main_synthetic_cpu_writes_the_evaluators_results(setting, tmp_path):
    path = PE.main(["--setting", setting, "--synthetic", "--cpu", "--batches", "2",
                    "--batch-size", "2", "--out", str(tmp_path)])
    cfg, mano, step = _tiny(setting)
    direct = PE.Evaluator(cfg, mano, device="cpu")
    for inputs, targets, templates, _ in PE.synthetic_batches(cfg, 2, 2):
        direct.feed(step(inputs), targets, inputs, templates)
    with open(path) as f:
        written = f.read()
    (tmp_path / "direct").mkdir()
    with open(direct.write_results(str(tmp_path / "direct"))) as f:
        assert written == f.read()
    assert ("F@5.0mm" in written) == (setting == "dexycb_full")
    values = [float(line.split(":")[1]) for line in written.splitlines() if " :  " in line]
    assert len(values) == 5 and np.isfinite(values).all()


@pytest.mark.parametrize("source", ["torch_ckpt", "ckpt"])
def test_main_loads_weights(source, tmp_path):
    """``--torch-ckpt``: an original snapshot (``module.`` prefixes, the
    dead heads, the unused norm1, no BatchNorm counters) loads strictly;
    ``--ckpt``: the port's own latest snapshot.  Either way the results are
    those of the model with those weights, not of the seeded init."""
    cfg, mano, _ = _tiny("dexycb")
    model = build_model(cfg, seed=7)
    network = {"module." + k: v for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    if source == "torch_ckpt":
        network.update({"module.norm1.weight": torch.ones(3),
                        "module.linear_objvote.layers.0.weight": torch.ones(2, 2),
                        "module.linear_objcls.layers.0.bias": torch.ones(2)})
        path = tmp_path / "snapshot_69.pth.tar"
        torch.save({"epoch": 69, "network": network}, path)
        args = ["--torch-ckpt", str(path)]
    else:
        (tmp_path / "dump").mkdir()
        network = {"module." + k: v for k, v in model.state_dict().items()}
        torch.save({"epoch": 3, "network": network, "optimizer": {}, "step": 0},
                   tmp_path / "dump" / "snapshot_3.pth.tar")
        args = ["--ckpt", str(tmp_path / "dump")]
    out = PE.main(["--setting", "dexycb", "--synthetic", "--cpu", "--batches", "1",
                   "--batch-size", "2", "--out", str(tmp_path / "res"), *args])
    direct = PE.Evaluator(cfg, mano, device="cpu")
    step = make_eval_step(cfg, model, mano, device="cpu")
    for inputs, targets, templates, _ in PE.synthetic_batches(cfg, 1, 2):
        direct.feed(step(inputs), targets, inputs, templates)
    (tmp_path / "direct").mkdir()
    with open(out) as f, open(direct.write_results(str(tmp_path / "direct"))) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("argv,match", [
    (["--cfg", "native_pipeline=on"], "native_pipeline='on'"),
    ([], "simple_object_models_dir"),
])
def test_main_refuses_the_native_pipeline_and_a_split_without_templates(argv, match):
    """A dataset's eval runs (``test_torch_data_mains.py``); what it refuses is
    the native image pipeline, which the port does not have, and a split
    without its object templates."""
    with pytest.raises((SystemExit, NotImplementedError), match=match):
        PE.main(["--setting", "ho3d", "--cpu", *argv])
