"""Shared set-up of the PyTorch-port parity tests: one tiny HOISDF built by
the JAX package, its weights carried into the port through the port's bridge.

Both packages run on the CPU in f32; JAX at matmul precision "highest"
(tests/conftest.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES as PORT_TINY
from hoisdf_torch.config import get_config as port_get_config
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import HOISDF as PortHOISDF
from hoisdf_torch.ops import wire
from hoisdf_torch.train import make_eval_step
from hoisdf_torch.weights import state_dict_from_jax
from hoisdf_tpu.config import SYNTHETIC_TINY_OVERRIDES as JAX_TINY
from hoisdf_tpu.config import get_config as jax_get_config
from hoisdf_tpu.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.models.hoisdf import build_model as jax_build_model
from hoisdf_tpu.tools.convert_torch_ckpt import convert_state_dict
from hoisdf_tpu.tools.make_standin_ckpt import flax_to_torch_state
from hoisdf_tpu.train import make_eval_step as jax_make_eval_step


def configs(setting: str = "dexycb", **over):
    """(jax cfg, port cfg) of ``setting`` at the tiny size with one shared
    cascade."""
    over = {"hier_levels_obj": None, **over}
    return (jax_get_config(setting, **{**JAX_TINY, **over}),
            port_get_config(setting, **{**PORT_TINY, **over}))


def init_jax(jcfg, seed: int = 0):
    """The flax model and its (params, batch_stats) as numpy trees."""
    model = jax_build_model(jcfg)
    inputs, _ = split_inputs_targets(synthetic_batch(jcfg, 1, train=True))
    init = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(seed), "sample_noise": jax.random.PRNGKey(seed + 1)},
        x, use_presampled=True, dist_range=0.0))
    variables = init({k: jnp.asarray(v) for k, v in inputs.items()})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return model, to_np(variables["params"]), to_np(variables.get("batch_stats", {}))


def port_model(pcfg, params, batch_stats) -> PortHOISDF:
    model = PortHOISDF(pcfg)
    model.load_state_dict(state_dict_from_jax(params, batch_stats), strict=True)
    return model.eval()


def perturb_batch_stats(batch_stats, seed: int = 0):
    """BN running stats away from (0, 1), so the tests see them used."""
    rng = np.random.RandomState(seed)

    def f(path, v):
        name = path[-1].key
        if name == "mean":
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, batch_stats)



# ---- eval-step comparison ----------------------------------------------------

EVAL_TOL = dict(atol=1e-4, rtol=1e-4)
HAND_KEYS = ("hand_points_notrans", "hand_off", "hand_cls")
OBJ_KEYS = ("obj_rot", "obj_trans")


def _hand_ids(notrans, cfg):
    step = 2.0 / (cfg.bins_n - 1)
    ijk = np.rint((notrans.astype(np.float64) * cfg.hand_sdf_scale + 1.0) / step).astype(int)
    return (ijk[..., 0] * cfg.bins_n + ijk[..., 1]) * cfg.bins_n + ijk[..., 2]


def _sorted_rows(v, ids):
    order = np.argsort(ids, axis=1)
    axis = 2 if v.ndim == 4 else 1
    idx = order[None, ..., None] if v.ndim == 4 else order[..., None]
    return np.take_along_axis(v, idx, axis=axis)


def assert_eval_matches_jax(got, want, cfg):
    """The port's eval-step outputs against the JAX package's (numpy dicts):
    the same keys, the same selected hand points as sets, per-point outputs
    compared after sorting by lattice point (near-equal |sdf| may order
    differently under another summation order), per-object-point rows matched
    one to one by nearest neighbour (the step reports no object points), all
    within 1e-4 absolute + 1e-4 relative."""
    assert set(got) == set(want)
    ids_g = _hand_ids(got["hand_points_notrans"], cfg)
    ids_w = _hand_ids(want["hand_points_notrans"], cfg)
    for b in range(ids_g.shape[0]):
        assert set(ids_g[b]) == set(ids_w[b]), "selected hand points differ"
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == np.float32, k
        if k in HAND_KEYS:
            g, w = _sorted_rows(g, ids_g), _sorted_rows(w, ids_w)
        elif k in OBJ_KEYS:
            continue
        np.testing.assert_allclose(g, w, err_msg=k, **EVAL_TOL)
    g_rows = np.concatenate([got[k] for k in OBJ_KEYS], -1)
    w_rows = np.concatenate([want[k] for k in OBJ_KEYS], -1)
    for b in range(g_rows.shape[0]):
        d = np.abs(g_rows[b][:, None] - w_rows[b][None]).max(-1)
        match = d.argmin(1)
        assert len(set(match)) == len(match), "object rows do not pair up"
        np.testing.assert_allclose(g_rows[b], w_rows[b][match], **EVAL_TOL)


# ---- the other presets ---------------------------------------------------------

def preset_configs(setting: str):
    """Tiny configs of ``setting``; the tiny ho3d keeps its DecoderBig (the
    JAX package's tiny overrides switch it off), 2432 channels wide on
    ResNet-18."""
    return configs(setting, use_big_decoder=setting == "ho3d")


def preset_setup(setting: str):
    """One JAX init and one JAX eval step (the preset's default supervision)
    at batch 2 on the synthetic inputs, with the image on the u8 grid."""
    jcfg, pcfg = preset_configs(setting)
    jmodel, params, stats = init_jax(jcfg)
    stats = perturb_batch_stats(stats)
    mano = make_synthetic_mano(0)
    inputs, _ = split_inputs_targets(synthetic_batch(jcfg, 2, seed=3, train=False))
    inputs["img"] = wire.quantize_image_u8(inputs["img"]).astype(np.float32) / 255.0
    jstep = jax_make_eval_step(jcfg, jmodel, JaxManoBuffers.from_model(mano))
    want = jstep(params, stats, {k: jnp.asarray(v) for k, v in inputs.items()})
    return dict(setting=setting, pcfg=pcfg, params=params, stats=stats, mano=mano,
                inputs=inputs, want={k: np.asarray(v) for k, v in want.items()})


def check_bridge(preset):
    """``state_dict_from_jax`` equals ``flax_to_torch_state`` bit for bit,
    loads strictly and converts back exactly."""
    pcfg, params, stats = preset["pcfg"], preset["params"], preset["stats"]
    big = pcfg.use_big_decoder
    want = flax_to_torch_state(params, stats, big_decoder=big)
    got = state_dict_from_jax(params, stats)
    assert set(k for k in got if not k.endswith("num_batches_tracked")) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape and g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    if pcfg.use_inverse_kinematics:  # one shape query and no pose head
        assert got["mano_query_embed.weight"].shape == (1, pcfg.hidden_dim)
        assert not any(k.startswith("linear_pose.") for k in got)
    if big:  # two hidden convs in each head
        assert "decoder_net.resnet_decoder.convOut_obj_seg.6.bias" in got

    model = port_model(pcfg, params, stats)  # load_state_dict(strict=True)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    back_params, back_stats = convert_state_dict(state, big_decoder=big)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    for w, b in ((flat(params), flat(back_params)), (flat(stats), flat(back_stats))):
        assert set(b) == set(w)
        for k in w:
            np.testing.assert_array_equal(b[k], w[k], err_msg=k)


def check_eval_step(preset):
    """The port's eval step at the preset's default supervision (dexycb_full
    queries the ground-truth SDF points, the ho3d presets do not) against the
    JAX step's outputs.  Under IK the step gives ``mano_shape`` and no MANO
    meshes."""
    pcfg = preset["pcfg"]
    model = port_model(pcfg, preset["params"], preset["stats"])
    step = make_eval_step(pcfg, model, ManoBuffers.from_model(preset["mano"]), device="cpu")
    got = {k: v.numpy() for k, v in step(preset["inputs"]).items()}
    assert ("mano_shape" in got) == pcfg.use_inverse_kinematics
    assert ("mano_verts" in got) != pcfg.use_inverse_kinematics
    assert_eval_matches_jax(got, preset["want"], pcfg)
