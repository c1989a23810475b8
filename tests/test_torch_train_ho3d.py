"""The ho3d preset's train step against the JAX package's
``make_train_step``, both branches, at the tiny config in f32: DecoderBig
kept on (the JAX package's tiny overrides switch it off; its pyramid is
2,432 channels wide on ResNet-18), so its train-mode BatchNorm, the backbone
BN freeze around it and the gather's backward at its width are all held.
Dropout off and no jitter on both sides; the tolerances are
``test_torch_train.py``'s (``torch_port_util.check_train_step``).  One JAX
compile per branch, in a file of its own."""

import pytest
import torch

from torch_port_util import (BRANCHES, check_train_step, configs, one_torch_thread,  # noqa: F401
                             train_setup)


@pytest.fixture(scope="module")
def setup(one_torch_thread):
    jcfg, pcfg = configs("ho3d", use_big_decoder=True, reference_init=False)
    assert pcfg.use_big_decoder and not pcfg.use_inverse_kinematics
    return train_setup(jcfg, pcfg)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_train_step_matches_jax(setup, branch):
    state, losses = check_train_step(setup, branch)
    assert "mano_mesh_loss" in losses
    sd = state.model.state_dict()
    # DecoderBig's two-conv heads and its top-level deconvolution trained
    assert "decoder_net.resnet_decoder.convOut_hm.6.weight" in sd
    assert sd["decoder_net.resnet_decoder.deconv1.0.weight"].shape[0] == 512  # ResNet-18's stride32


def test_reference_init_touches_what_jax_touches(setup):
    """The original's train-mode init on the ho3d model: the port redraws
    exactly the tensors that the JAX package's ``apply_reference_init``
    redraws (DecoderBig's convolutions and deconvolutions among them), from
    the same distributions (decoder N(0, 0.001), the rest N(0, 0.01))."""
    import jax
    import numpy as np

    from hoisdf_torch.models.initializers import apply_reference_init
    from hoisdf_torch.weights import state_dict_numpy_from_jax
    from hoisdf_tpu.models.initializers import apply_reference_init as jax_reference_init

    from torch_port_util import port_model

    pcfg, params, stats, *_ = setup
    before = state_dict_numpy_from_jax(params, stats)
    jax_after = state_dict_numpy_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_reference_init(params, jax.random.PRNGKey(3))),
        stats)
    port_after = {k: v.numpy() for k, v in apply_reference_init(
        port_model(pcfg, params, stats), torch.Generator().manual_seed(3)).state_dict().items()}
    changed = {name: {k for k, v in after.items() if k in before
                      and not np.array_equal(v, before[k])}
               for name, after in (("jax", jax_after), ("port", port_after))}
    assert changed["port"] == changed["jax"]
    dec = "decoder_net.resnet_decoder."
    assert {dec + "deconv1.0.weight", dec + "conv4.0.weight",
            dec + "convOut_obj_seg.3.weight"} <= changed["port"]
    for k in changed["port"]:
        if port_after[k].size >= 1000:
            std = 0.001 if k.startswith("decoder_net") else 0.01
            for after in (port_after, jax_after):
                assert abs(after[k].std() - std) < 0.3 * std, k
