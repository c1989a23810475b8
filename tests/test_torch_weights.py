"""Weight bridge of the PyTorch port against the JAX package's own mapping.

The port's ``state_dict_from_jax`` must reproduce
``tools/make_standin_ckpt.py::flax_to_torch_state`` key for key and bit for
bit (plus the BatchNorm counters torch needs), load into the port strictly,
and convert back to the flax trees exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hoisdf_torch.models.hoisdf import HOISDF as PortHOISDF
from hoisdf_torch.weights import state_dict_from_jax
from hoisdf_tpu.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_tpu.models.hoisdf import build_model as jax_build_model
from hoisdf_tpu.tools.convert_torch_ckpt import convert_state_dict
from hoisdf_tpu.tools.make_standin_ckpt import flax_to_torch_state

from torch_port_util import configs, init_jax, perturb_batch_stats, port_model


@pytest.fixture(scope="module")
def tiny():
    jcfg, pcfg = configs()
    _, params, stats = init_jax(jcfg)
    return pcfg, params, perturb_batch_stats(stats)


def test_bridge_matches_flax_to_torch_state_bitwise(tiny):
    _, params, stats = tiny
    want = flax_to_torch_state(params, stats)
    got = state_dict_from_jax(params, stats)
    counters = {k for k in got if k.endswith("num_batches_tracked")}
    assert set(got) - counters == set(want)
    assert counters and all(int(got[k]) == 0 for k in counters)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape and g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    assert not any(k.startswith(("linear_objvote", "linear_objcls", "norm1."))
                   for k in got)


def test_bridge_loads_strict_and_round_trips(tiny):
    pcfg, params, stats = tiny
    model = port_model(pcfg, params, stats)  # load_state_dict(strict=True)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    back_params, back_stats = convert_state_dict(state)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    for want, got in ((flat(params), flat(back_params)), (flat(stats), flat(back_stats))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bridge_full_width_dexycb_structure():
    """The production preset (ResNet-50 bottlenecks, 256-wide heads): the
    flax tree's shapes, bridged, load strictly into the port's module tree."""
    jcfg, pcfg = configs(**{k: v for k, v in (
        ("resnet_type", 50), ("hidden_dim", 256), ("dim_feedforward", 1024),
        ("enc_layers", 6), ("dec_layers", 4), ("num_samp_hand", 600),
        ("num_samp_obj", 200), ("input_img_shape", (256, 256)), ("bins_n", 64))})
    model = jax_build_model(jcfg)
    inputs, _ = split_inputs_targets(synthetic_batch(jcfg, 1, train=True))
    shapes = jax.eval_shape(
        lambda x: model.init({"params": jax.random.PRNGKey(0),
                              "sample_noise": jax.random.PRNGKey(1)},
                             x, use_presampled=True, dist_range=0.0),
        {k: jnp.asarray(v) for k, v in inputs.items()})
    zeros = lambda t: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), t)
    state = state_dict_from_jax(zeros(shapes["params"]), zeros(shapes["batch_stats"]))
    port = PortHOISDF(pcfg)
    port.load_state_dict(state, strict=True)
    assert sum(p.numel() for p in port.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
