"""The ho3d_render preset's training against the JAX package's, at the tiny
config in f32: its presampled train step against ``make_train_step`` (one
JAX compile, in a file of its own; the tolerances are
``test_torch_train.py``'s), and ``compute_losses`` of the IK head on the
same outputs: the two shape losses and ``aux["mano_shape"]``, no MANO
forward kinematics.  And, with no JAX compile: dexycb_full trains exactly as
dexycb (its fields differ only in what the data and the evaluator read), and
the snapshots of the ho3d presets' models (DecoderBig, the IK head) round-trip
and read back through the original's key names."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch import train as ptrain
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.utils import checkpoint as ckpt
from hoisdf_torch.weights import state_dict_numpy_from_jax
from hoisdf_tpu import train as jtrain
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.tools.convert_torch_ckpt import convert_state_dict, load_torch_state

from torch_port_util import check_train_step, configs, one_torch_thread, train_setup  # noqa: F401


def test_presampled_train_step_matches_jax(one_torch_thread):
    jcfg, pcfg = configs("ho3d_render", reference_init=False)
    assert pcfg.use_inverse_kinematics and not pcfg.use_big_decoder
    state, losses = check_train_step(train_setup(jcfg, pcfg, ("presampled",)), "presampled")
    assert {"shape_param_loss", "shape_reg_loss"} <= set(losses)
    assert not {"mano_mesh_loss", "mano_joint_loss", "pose_param_loss"} & set(losses)
    assert not hasattr(state.model, "linear_pose")


def test_ik_losses_and_aux_match_jax(one_torch_thread):
    """compute_losses on one set of outputs (L = 2 decoder layers, batch 3):
    every loss within 1e-5 relative, ``aux`` with the last layer's shape and
    no MANO meshes."""
    jcfg, pcfg = configs("ho3d_render")
    rng = np.random.RandomState(0)
    lay, b, ph, po = 2, 3, pcfg.num_samp_hand, pcfg.num_samp_obj
    out = {"hand_points_notrans": rng.randn(b, ph, 3) * 0.05,
           "hand_off": rng.randn(lay, b, ph, 60) * 0.01, "hand_cls": rng.randn(lay, b, ph, 20),
           "mano_shape": rng.randn(lay, b, 10), "obj_rot": rng.randn(lay, b, po, 3),
           "obj_trans": rng.randn(lay, b, po, 3) * 0.05}
    targets = {"joint_cam_no_trans": rng.randn(b, 21, 3) * 50, "mano_param": rng.randn(b, 58),
               "obj_rot": rng.randn(b, 3), "rel_obj_trans": rng.randn(b, 3) * 0.05}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    targets = {k: v.astype(np.float32) for k, v in targets.items()}
    mano = make_synthetic_mano(0)
    got, got_aux = ptrain.compute_losses(
        pcfg, {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in targets.items()},
        ManoBuffers.from_model(mano), with_sdf=False)
    want, want_aux = jtrain.compute_losses(
        jcfg, {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in targets.items()},
        JaxManoBuffers.from_model(mano), with_sdf=False)
    assert set(got) == set(want) and "shape_reg_loss" in got and "mano_mesh_loss" not in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(ptrain.weighted_total(pcfg, got)),
                               float(jtrain.weighted_total(jcfg, want)), rtol=1e-5)
    assert set(got_aux) == set(want_aux) == {"hand_joints", "mano_shape"}
    np.testing.assert_array_equal(got_aux["mano_shape"].numpy(), out["mano_shape"][-1])
    np.testing.assert_allclose(got_aux["hand_joints"].numpy(), np.asarray(want_aux["hand_joints"]),
                               rtol=1e-5, atol=1e-6)


def test_dexycb_full_trains_as_dexycb(one_torch_thread):
    _, full = configs("dexycb_full")
    _, small = configs("dexycb")
    differ = {f.name for f in dataclasses.fields(full)
              if getattr(full, f.name) != getattr(small, f.name)}
    assert differ == {"setting", "small_dexycb", "eval_mesh"}
    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch

    inputs, targets = split_inputs_targets(synthetic_batch(small, 2, seed=2, train=True))
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    runs = []
    for cfg in (small, full):
        state = ptrain.create_train_state(cfg, build_model(cfg, 0), 4, device="cpu")
        step = ptrain.make_train_step(cfg, mano, device="cpu")
        for pre in (True, False):
            state, losses = step(state, inputs, targets, torch.Generator().manual_seed(1), 0.03,
                                 use_presampled=pre)
        runs.append((losses, state.model.state_dict()))
    (l_small, sd_small), (l_full, sd_full) = runs
    assert set(l_small) == set(l_full)
    for k in l_small:
        assert torch.equal(l_small[k], l_full[k]), k
    for k in sd_small:
        assert torch.equal(sd_small[k], sd_full[k]), k


@pytest.mark.parametrize("setting", ["ho3d", "ho3d_render"])
def test_snapshot_round_trips_through_the_original_key_names(setting, tmp_path,
                                                             one_torch_thread):
    """After one CPU step: the JAX package's converter reads the snapshot
    (the original's ``module.`` keys) into trees equal to the model; the
    port resumes it into a fresh state, model and optimizer; and
    ``load_original_state`` loads it strictly."""
    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch

    _, cfg = configs(setting, use_big_decoder=setting == "ho3d")
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    state = ptrain.create_train_state(cfg, build_model(cfg, 0), 4, device="cpu")
    inputs, targets = split_inputs_targets(synthetic_batch(cfg, 2, seed=2, train=True))
    state, _ = ptrain.make_train_step(cfg, mano, device="cpu")(
        state, inputs, targets, torch.Generator().manual_seed(1), 0.03, use_presampled=True)
    path = ckpt.save_snapshot(str(tmp_path), 0, state)
    sd = state.model.state_dict()
    want = state_dict_numpy_from_jax(*convert_state_dict(load_torch_state(path),
                                                         big_decoder=cfg.use_big_decoder))
    assert set(want) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)
    assert ("decoder_net.resnet_decoder.convOut_hm.6.weight" in sd) == cfg.use_big_decoder
    assert (sd["mano_query_embed.weight"].shape[0] == 1) == cfg.use_inverse_kinematics

    fresh = ptrain.create_train_state(cfg, build_model(cfg, 1), 4, device="cpu")
    assert ckpt.restore_snapshot(str(tmp_path), fresh) == 0 and fresh.step == 1
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for i, st in state.optimizer.state_dict()["state"].items():
        for name, v in st.items():
            assert torch.equal(fresh.optimizer.state_dict()["state"][i][name], v), (i, name)
    other = build_model(cfg, 2)
    other.load_state_dict(ckpt.load_original_state(path, other), strict=True)
    assert os.path.basename(path) == "snapshot_0.pth.tar"
