"""The ho3d preset against the JAX package: ``DecoderBig`` (the JAX module
and the torch golden), the weight bridge of its two-conv heads, and the whole
eval step at the tiny config; and one train step of every preset.
``test_torch_presets_ik_mesh.py`` covers ho3d_render and dexycb_full.

Both sides run in f32 on the CPU (JAX at matmul precision "highest").  The
tiny ho3d model keeps DecoderBig (the JAX package's tiny overrides switch it
off), so its pyramid is 2432 channels wide on ResNet-18.  Tolerances: 1e-4
for DecoderBig against the JAX module and 1e-3 against the golden (the bars of
``test_torch_modules.py`` and ``test_golden_backbone.py``); the eval step as
``test_torch_eval_step.py`` (1e-4 absolute + 1e-4 relative, the same selected
points); the bridge bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.decoder import DecoderBig as PortDecoderBig
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.models.resnet import ResNetBackbone as PortResNet
from hoisdf_torch.train import create_train_state, make_train_step
from hoisdf_torch.weights import state_dict_numpy_from_jax
from hoisdf_tpu.models.decoder import DecoderBig as JaxDecoderBig
from hoisdf_tpu.tools.synth_weights import synth_state_dict

from torch_port_util import (check_bridge, check_eval_step, one_torch_thread,  # noqa: F401
                             perturb_batch_stats, preset_configs, preset_setup)

T = torch.from_numpy


def _nchw(a):
    return np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def _load(module, state, prefix):
    sd = {k[len(prefix):]: T(np.array(v)) for k, v in state.items() if k.startswith(prefix)}
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return module.eval()


# ---- DecoderBig ----------------------------------------------------------------

def test_decoder_big_matches_jax_module_in_both_layouts():
    rng = np.random.RandomState(0)
    skips = {f"stride{2 ** i}": rng.rand(2, 32 >> i, 32 >> i, c).astype(np.float32)
             for i, c in zip(range(1, 6), (64, 64, 128, 256, 512))}  # ResNet-18 widths
    feat = skips["stride32"]
    jdec = JaxDecoderBig()
    jskips = {k: jnp.asarray(v) for k, v in skips.items()}
    v = jdec.init(jax.random.PRNGKey(1), jnp.asarray(feat), jskips)
    stats = perturb_batch_stats(v["batch_stats"], seed=1)
    pyr, heads = jdec.apply({"params": v["params"], "batch_stats": stats},
                            jnp.asarray(feat), jskips)
    state = state_dict_numpy_from_jax({"decoder_net": v["params"]}, {"decoder_net": stats})
    assert "decoder_net.resnet_decoder.convOut_hm.6.weight" in state
    pdec = _load(PortDecoderBig({k: x.shape[-1] for k, x in skips.items()}), state,
                 "decoder_net.resnet_decoder.")
    for layout in (torch.contiguous_format, torch.channels_last):
        pskips = {k: T(_nchw(x)).contiguous(memory_format=layout) for k, x in skips.items()}
        with torch.no_grad():
            ppyr, pheads = pdec(pskips["stride32"], pskips)
        np.testing.assert_allclose(pheads.numpy(), _nchw(heads), atol=1e-4, rtol=1e-4)
        for k in pyr:
            assert ppyr[k].shape[1] == pdec.out_channels[k], k
            np.testing.assert_allclose(ppyr[k].numpy(), _nchw(pyr[k]), atol=1e-4, rtol=1e-4,
                                       err_msg=f"{layout} {k}")


def test_decoder_big_golden(golden):
    """The original torch DecoderBig on ResNet-50 features (all five levels,
    2048 channels at stride32) and its heads."""
    g = golden("backbone_decoder")
    dec = _load(PortDecoderBig(PortResNet(50).skip_channels),
                synth_state_dict(str(g["spec_decoder_big"])), "decoder_big.")
    skips = {f"stride{s}": T(g[f"skip_stride{s}"]) for s in (2, 4, 8, 16, 32)}
    with torch.no_grad():
        pyr, heads = dec(T(g["feat"]), skips)
    tol = dict(atol=1e-3, rtol=1e-3)
    assert sum(dec.out_channels.values()) == 3968
    for s in (2, 4, 8, 16, 32):
        np.testing.assert_allclose(pyr[f"stride{s}"].numpy(), g[f"big_stride{s}"],
                                   err_msg=f"stride{s}", **tol)
    np.testing.assert_allclose(heads.numpy(), g["big_heads"], **tol)


# ---- ho3d: the weight bridge and the eval step ---------------------------------

@pytest.fixture(scope="module")
def ho3d():
    return preset_setup("ho3d")


def test_ho3d_bridge_matches_flax_to_torch_state_and_round_trips(ho3d):
    check_bridge(ho3d)


def test_ho3d_eval_step_matches_jax(ho3d):
    check_eval_step(ho3d)


@pytest.mark.parametrize("setting", ["dexycb", "dexycb_full", "ho3d", "ho3d_render"])
def test_every_preset_takes_a_train_step(setting, one_torch_thread):
    """Each preset builds its train state and takes one presampled and one
    field-guided CPU step with finite losses; ho3d_render's carry the IK
    shape losses and no MANO mesh losses."""
    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch

    _, pcfg = preset_configs(setting)
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    state = create_train_state(pcfg, build_model(pcfg, 0), steps_per_epoch=2, device="cpu")
    step = make_train_step(pcfg, mano, device="cpu")
    inputs, targets = split_inputs_targets(synthetic_batch(pcfg, 2, seed=1, train=True))
    gen = torch.Generator().manual_seed(0)
    for pre in (True, False):
        state, losses = step(state, inputs, targets, gen, 0.03, use_presampled=pre)
        assert all(np.isfinite(float(v)) for v in losses.values()), losses
    assert state.step == 2
    ik = setting == "ho3d_render"
    assert ("shape_reg_loss" in losses) == ik and ("mano_mesh_loss" in losses) != ik
