"""``train_loop.main`` and ``evaluate.main`` of the port on on-disk DexYCB and
HO3D trees (``torch_data_fixtures``), on the CPU at the tiny model size:
each writes what its JAX counterpart writes (snapshots, the eval pass's
debug images and scalars, ``results.txt``, the codalab JSON), and the real
eval's results equal a direct Evaluator pass over the same samples."""

import json
import os

import numpy as np
import pytest
import torch

from hoisdf_torch import evaluate as PE
from hoisdf_torch import train_loop
from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, get_config
from hoisdf_torch.data.loader import DataLoader
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.train import make_eval_step

from torch_data_fixtures import write_dexycb, write_ho3d, write_simple_models
from torch_port_util import one_torch_thread  # noqa: F401  (a fixture)

TINY = {**SYNTHETIC_TINY_OVERRIDES, "num_samp_hand": 16, "num_samp_obj": 8, "bins_n": 8,
        "points_filter_dist": 1.0, "num_data_workers": 2}


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg_args(over):
    return [a for k, v in over.items() for a in ("--cfg", f"{k}={json.dumps(v)}")]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    simple = write_simple_models(str(base / "simple"))
    return (dict(write_dexycb(str(base / "dexycb"), n_train=4, n_test=5),
                 simple_object_models_dir=simple),
            dict(write_ho3d(str(base / "ho3d"), n_eval=3), simple_object_models_dir=simple))


def _results(path):
    with open(path) as f:
        return {k.strip(): float(v) for k, _, v in
                (line.partition(":") for line in f if " :  " in line)}


def test_train_loop_trains_and_evaluates_on_dexycb(trees, tmp_path):
    """Two batches of 2 an epoch (4 samples, the tail dropped), a snapshot,
    the test split's eval (5 samples: a padded tail) with its debug image and
    scalars, on the u8 wire, the loader in process mode (its batches equal
    thread mode's: ``test_torch_loader.py``)."""
    over = dict(trees[0], **TINY, train_batch_size=2, eval_batch_size=2,
                output_dir=str(tmp_path), transfer_dtype="uint8", data_worker_mode="process")
    train_loop.main(["--setting", "dexycb", "--cpu", "--end_epoch", "1", "--run_dir_name", "r",
                     *_cfg_args(over)])
    out = tmp_path / "r"
    assert (out / "model_dump" / "snapshot_0.pth.tar").exists()
    assert [f for f in os.listdir(out / "debug_images") if f.endswith(".png")]
    rows = [json.loads(line) for line in
            (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(rows[0]["train_total"])
    assert all(np.isfinite(rows[-1][k]) for k in ("ADDS_error", "mano_mje", "OCE_error"))
    log = (out / "log" / "train_logs.txt").read_text()
    assert "itr 1/2" in log and "eval: " in log and "training done" in log


def test_train_loop_eval_without_templates_dumps_images_only(trees, tmp_path):
    """Without ``simple_object_models_dir`` the eval pass at the snapshot
    still runs the test split and dumps the first batch's debug image, and
    feeds no batch to the metrics (the JAX package's rule)."""
    over = {k: v for k, v in trees[0].items() if k != "simple_object_models_dir"}
    over.update(TINY, train_batch_size=2, eval_batch_size=2, output_dir=str(tmp_path))
    train_loop.main(["--setting", "dexycb", "--cpu", "--end_epoch", "1", "--run_dir_name", "r",
                     "--iters-per-epoch", "1", *_cfg_args(over)])
    out = tmp_path / "r"
    assert [f for f in os.listdir(out / "debug_images") if f.endswith(".png")]
    rows = [json.loads(line) for line in
            (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["ADDS_error"] == 0.0 and rows[-1]["mano_mje"] == 0.0


@pytest.mark.parametrize("setting", ["ho3d", "ho3d_render"])
def test_train_loop_trains_ho3d_presets(trees, tmp_path, setting):
    """HO3D's train split (2 frames, and ho3d_render's 2 rendered ones) at the
    tiny size; ho3d keeps DecoderBig."""
    over = dict(trees[1], **{**TINY, "use_big_decoder": setting == "ho3d"},
                train_batch_size=2, output_dir=str(tmp_path), point_sampling_epoch=0)
    train_loop.main(["--setting", setting, "--cpu", "--end_epoch", "1", "--run_dir_name", "r",
                     *_cfg_args(over)])
    log = (tmp_path / "r" / "log" / "train_logs.txt").read_text()
    assert f"itr {1 if setting == 'ho3d_render' else 0}/" in log and "training done" in log
    assert (tmp_path / "r" / "model_dump" / "snapshot_0.pth.tar").exists()


@pytest.mark.parametrize("setting", ["dexycb", "ho3d"])
def test_evaluate_main_on_the_eval_split(trees, tmp_path, setting):
    """The whole eval split in batches of 2 (a padded tail of 1) equals a
    direct Evaluator pass over the loader's samples; HO3D also writes the
    codalab JSON, its pitcher frame left out of the object metrics."""
    tree = trees[setting == "ho3d"]
    over = dict(tree, **TINY)
    path = PE.main(["--setting", setting, "--cpu", "--batch-size", "2",
                    "--out", str(tmp_path / "res"), *_cfg_args(over)])
    got = _results(path)
    assert got and all(np.isfinite(v) for v in got.values())

    cfg = get_config(setting, **over)
    mano_model = make_synthetic_mano(0)
    mano = ManoBuffers.from_model(mano_model)
    step = make_eval_step(cfg, build_model(cfg), mano, device="cpu")
    direct = PE.Evaluator(cfg, mano, device="cpu")
    templates, names = PE.prepare_model_templates(tree["simple_object_models_dir"])
    # the whole split as one batch (eval-mode BatchNorm: rows are independent)
    for batch in DataLoader(PE.open_dataset(cfg, "test", mano_model), 64, num_workers=1):
        inputs, targets = PE.split_inputs_targets(batch)
        tmpl = np.stack([templates[list(names.values()).index(
            PE.HO3D_OBJECTS[int(c)] if setting == "ho3d" else names[int(c)])]
            for c in inputs["obj_cls"]])
        preds = step({k: v for k, v in inputs.items() if k not in ("obj_cls", "obj_valid")})
        direct.feed(preds, targets, inputs, tmpl)
    (tmp_path / "direct").mkdir()
    want = _results(direct.write_results(str(tmp_path / "direct")))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    if setting == "ho3d":
        xyz, verts = json.loads((tmp_path / "res" / "pred_mano.json").read_text())
        assert len(xyz) == len(verts) == 3 and np.shape(xyz[0]) == (21, 3)
        assert direct.total == 2  # the pitcher frame is left out


@pytest.mark.parametrize("argv,match", [
    (["--cfg", "approx_selection_topk=true"], "approx_selection_topk"),
    (["--cfg", "fused_sdf_infer=false"], "fused_sdf_infer"),
    (["--backbone-init", "weights/"], "--backbone-init"),
])
def test_train_loop_refuses_what_is_not_ported(argv, match):
    """What the port cannot run is refused by name before any work: a setting
    the port refuses (the TPU's approximate top-k), a config field it does
    not have (a TPU compiler knob), or a flag given what it cannot use
    (``--backbone-init`` without a state-dict file)."""
    with pytest.raises((SystemExit, TypeError, ValueError), match=match):
        train_loop.main(["--setting", "dexycb", "--cpu", *argv])
