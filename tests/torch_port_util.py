"""Shared set-up of the PyTorch-port parity tests: one tiny HOISDF built by
the JAX package, its weights carried into the port through the port's bridge.

Both packages run on the CPU in f32; JAX at matmul precision "highest"
(tests/conftest.py).
"""

from __future__ import annotations

import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES as PORT_TINY
from hoisdf_torch.config import get_config as port_get_config
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch import train as ptrain
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import HOISDF as PortHOISDF
from hoisdf_torch.models.layers import Dropout
from hoisdf_torch.ops import wire
from hoisdf_torch.train import make_eval_step
from hoisdf_torch.weights import state_dict_from_jax, state_dict_numpy_from_jax
from hoisdf_tpu import train as jtrain
from hoisdf_tpu.config import SYNTHETIC_TINY_OVERRIDES as JAX_TINY
from hoisdf_tpu.config import get_config as jax_get_config
from hoisdf_tpu.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.models.hoisdf import build_model as jax_build_model
from hoisdf_tpu.tools.convert_torch_ckpt import convert_state_dict
from hoisdf_tpu.tools.make_standin_ckpt import flax_to_torch_state
from hoisdf_tpu.train import make_eval_step as jax_make_eval_step
from torch_parallel_util import BNCancelledBiases  # noqa: F401 -- the tests import it here


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
    JAX step's outputs.  Under IK the JAX step gives ``mano_shape`` and no
    MANO meshes; the port's also solves the hand (``mano_joints``,
    ``mano_verts``, ``mano_pose``, ``ik_valid``), held here against the JAX
    solver on the port's own voted joints and shape (1e-4, the IK parity
    tolerance of ``test_torch_ik.py``)."""
    pcfg = preset["pcfg"]
    model = port_model(pcfg, preset["params"], preset["stats"])
    step = make_eval_step(pcfg, model, ManoBuffers.from_model(preset["mano"]), device="cpu")
    got = {k: v.numpy() for k, v in step(preset["inputs"]).items()}
    assert ("mano_shape" in got) == pcfg.use_inverse_kinematics
    assert "mano_verts" in got
    if pcfg.use_inverse_kinematics:
        from hoisdf_tpu.ops.ik import ik_solver_mano as jax_ik_solver_mano

        joints = np.concatenate([np.zeros_like(got["hand_joints"][:, :1]), got["hand_joints"]],
                                axis=1)
        want = jax_ik_solver_mano(JaxManoBuffers.from_model(preset["mano"]), jnp.asarray(joints),
                                  jnp.asarray(got["mano_shape"]))
        for k, w in (("mano_joints", "joints"), ("mano_verts", "verts"), ("mano_pose", "pose")):
            np.testing.assert_allclose(got.pop(k), np.asarray(want[w]), rtol=0, atol=1e-4,
                                       err_msg=k)
        np.testing.assert_array_equal(got.pop("ik_valid"), np.asarray(want["vis"]).ravel())
    assert_eval_matches_jax(got, preset["want"], pcfg)


# ---- train-step comparison ---------------------------------------------------
#
# One train step of each branch from the same bridged weights and BatchNorm
# statistics, against ``hoisdf_tpu.train.make_train_step``.  Random streams
# cannot match (a torch generator does not give JAX's bits), so both sides run
# without them: ``dist_range=0`` makes the presample jitter exactly zero, and
# every dropout is an identity (the port's dropout p = 0; flax's
# ``nn.Dropout`` patched to an identity for the JAX compile).  A ReLU input
# within rounding of zero falls on either side depending on the summation
# order (the port's CPU matmuls change theirs with the thread count), and
# one such switch moves the gradient of a tiny model by ~3e-3 in norm.  So
# the port's step runs first and records which elements of each ReLU pass
# (``chip_smoke.relu_pattern``), and JAX's presampled step is compiled with
# each of its ReLUs passing exactly those: the two compute one function.  The
# JAX step's own decisions must differ from the port's only at near-ties.
# The field-guided branch keeps each side's own decisions: its point sampler
# picks points by their SDF values, and the tie's shift of JAX's values
# (up to |x|) can move that pick, after which no ReLU pattern matches.  JAX's
# gradients are read from its optimizer's first moment after one step
# (mu = 0.1 g); the frozen BN parameters have none there (they are masked
# out) and are checked to stay unchanged instead.  The tolerances and their
# reasons are in ``test_torch_train.py``'s docstring.

STEPS_PER_EPOCH = 10
BRANCHES = {"presampled": True, "field_guided": False}


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for the port's tiny models, for the rest of the
    test module: the suite's parallel workers would otherwise oversubscribe
    the cores many times over."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads_from_first_moment(params, opt_state):
    """The gradient of every trainable leaf, g = mu / 0.1 after one AdamW
    step; frozen leaves (optax.MaskedNode) are left out."""
    mu = opt_state.inner_states["trainable"].inner_state[0].mu
    out = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = mu
        for k in path:
            node = node[k.key]
        if isinstance(node, optax.MaskedNode):
            continue
        sub = out
        for k in path[:-1]:
            sub = sub.setdefault(k.key, {})
        sub[path[-1].key] = np.asarray(node) / np.float32(0.1)
    return state_dict_numpy_from_jax(out, {})


# the JAX package's modules whose ReLUs act on NHWC image maps (NCHW in the port)
IMAGE_MAP_SOURCES = ("models/resnet.py", "models/decoder.py")


def _imposed_relu(masks, ties, lift: bool = False):
    """A stand-in for ``jax.nn.relu`` whose i-th traced call passes exactly
    ``masks[i]`` (the port's i-th ReLU; its NCHW image maps turned to NHWC),
    or decides itself where that is None.  At run time it notes in
    ``ties[i]`` how many of JAX's own decisions differ, the largest |x| among
    them and the call's largest |x|.  With ``lift`` a passing element gives
    max(x, the smallest normal float) with gradient 1, as the port's
    ``chip_smoke.relu_pattern`` does (the two then compute one function
    where the mask differs from the sign of x by more than a near-tie)."""
    calls, own = [], jax.nn.relu

    def note(i, n, near, top):
        ties[int(i)] = (int(n), float(near), float(top))

    def relu(x):
        i = len(calls)
        calls.append(i)
        assert i < len(masks), "JAX's step has more ReLUs than the port's"
        if masks[i] is None:  # outside autograd in the port: JAX's own decisions
            ties[i] = (0, 0.0, 0.0)
            return own(x)
        m = masks[i].numpy()
        if sys._getframe(1).f_code.co_filename.replace("\\", "/").endswith(IMAGE_MAP_SOURCES):
            m = m.transpose(0, 2, 3, 1)
        assert m.shape == x.shape, (i, m.shape, x.shape)
        differ, mag = (x > 0) != m, jnp.abs(x)
        jax.debug.callback(note, i, differ.sum(), jnp.max(jnp.where(differ, mag, 0.0)),
                           jnp.max(mag))
        if lift:
            tiny = jnp.finfo(x.dtype).tiny
            x = x + jax.lax.stop_gradient(jnp.maximum(x, tiny) - x)
        return jnp.where(m, x, jnp.zeros_like(x))

    return relu


def train_setup(jcfg, pcfg, branches=tuple(BRANCHES)):
    """One JAX init; then for each of ``branches`` one port step and one JAX
    step on its ReLU pattern, at batch 2 -> (pcfg, params, stats, mano,
    inputs, targets, results by branch)."""
    from chip_smoke import relu_pattern

    jmodel, params, stats = init_jax(jcfg)
    stats = perturb_batch_stats(stats)
    mano = make_synthetic_mano(0)
    inputs, targets = split_inputs_targets(synthetic_batch(jcfg, 2, seed=3, train=True))
    tx = jtrain.make_optimizer(jcfg, params, STEPS_PER_EPOCH)
    jstate = jtrain.TrainState(step=jnp.asarray(0), params=params, batch_stats=stats,
                               opt_state=tx.init(params), tx=tx)
    results = {}
    for name in branches:
        state = port_train_state(pcfg, params, stats)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        step = ptrain.make_train_step(pcfg, ManoBuffers.from_model(mano), device="cpu")
        pattern = relu_pattern()
        cancelled = BNCancelledBiases(state.model)
        with pattern:
            state, losses = step(state, inputs, targets, None, 0.0,
                                 use_presampled=BRANCHES[name])
        cancelled.close()
        ties = {} if BRANCHES[name] else None
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
            if ties is not None:
                relu = _imposed_relu(pattern.masks, ties)
                mp.setattr(fnn, "relu", relu)
                mp.setattr(jax.nn, "relu", relu)
            jstep = jtrain.make_train_step(jcfg, jmodel, JaxManoBuffers.from_model(mano))
            new, jlosses = jstep(jstate, {k: jnp.asarray(v) for k, v in inputs.items()},
                                 {k: jnp.asarray(v) for k, v in targets.items()},
                                 jax.random.PRNGKey(0), jnp.asarray(0.0),
                                 use_presampled=BRANCHES[name])
            jax.effects_barrier()
        results[name] = {
            "losses": {k: float(v) for k, v in jlosses.items()},
            "state": state_dict_numpy_from_jax(_np(new.params), _np(new.batch_stats)),
            "grads": _grads_from_first_moment(params, new.opt_state),
            "relu_calls": len(pattern.masks), "relu_ties": ties,
            "bn_cancelled_floors": cancelled.floors(),
            "port": (state, losses, before),
        }
    return pcfg, params, stats, mano, inputs, targets, results


def port_train_state(pcfg, params, stats):
    """The port's train state on the CPU from the bridged weights, dropout off."""
    model = port_model(pcfg, params, stats)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return ptrain.create_train_state(pcfg, model, STEPS_PER_EPOCH, device="cpu")


def check_train_step(setup, branch):
    """The port's step of ``branch`` against the JAX results of
    :func:`train_setup`: the ReLU patterns, every loss, every trainable
    gradient, the parameters after AdamW, the running statistics and the BN
    freeze."""
    import torch

    from chip_smoke import TIE_REL

    pcfg, params, stats, mano, inputs, targets, results = setup
    want = results[branch]
    state, losses, before = want["port"]
    assert state.step == 1

    # presampled: every ReLU of the port's step met once in JAX's, whose own
    # decisions differ only at near-ties
    if want["relu_ties"] is not None:
        assert sorted(want["relu_ties"]) == list(range(want["relu_calls"]))
        for i, (n, near, top) in want["relu_ties"].items():
            assert n == 0 or near <= TIE_REL * top, (i, n, near, top)

    # every loss key
    assert set(losses) == set(want["losses"])
    for k, v in want["losses"].items():
        assert np.isfinite(v)
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-4, atol=1e-6, err_msg=k)

    # every trainable parameter's gradient; a bias that train-mode BN cancels
    # is held on each side under its noise floor (BNCancelledBiases)
    named = dict(state.model.named_parameters())
    frozen = {n for n in named if ptrain.is_frozen(n)}
    assert set(want["grads"]) == set(named) - frozen
    floors = want["bn_cancelled_floors"]
    assert set(floors) <= set(want["grads"])
    err2 = ref2 = 0.0
    for k, g in want["grads"].items():
        got = named[k].grad.numpy()
        err = np.linalg.norm(got - g)
        if k in floors:
            assert np.linalg.norm(got) <= floors[k], (k, np.linalg.norm(got), floors[k])
            assert np.linalg.norm(g) <= floors[k], (k, np.linalg.norm(g), floors[k])
        else:
            assert err <= 3e-2 * np.linalg.norm(g) + 1e-5, (k, err, np.linalg.norm(g))
        err2 += err ** 2
        ref2 += np.sum(g.astype(np.float64) ** 2)
    assert np.sqrt(err2 / ref2) <= 1e-3

    # the parameters after the AdamW update, and the running statistics
    lr = ptrain.lr_for_step(pcfg, 0, STEPS_PER_EPOCH)
    after = state.model.state_dict()
    for k, w in want["state"].items():
        got = after[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-6, err_msg=k)
            continue
        if k in frozen:
            np.testing.assert_array_equal(got, before[k].numpy(), err_msg=k)
            np.testing.assert_array_equal(w, before[k].numpy(), err_msg=k)
            continue
        g, gp = want["grads"][k], named[k].grad.numpy()
        sure = (np.minimum(np.abs(g), np.abs(gp)) > 1e-5) & (np.sign(g) == np.sign(gp))
        diff = np.abs(got - w)
        assert diff[sure].max(initial=0.0) <= 1e-6, k
        assert diff.max() <= 2 * lr + 1e-6, k
    # the BN freeze: stem and block BNs frozen, the downsample BNs train
    assert "backbone_net.resnet.bn1.weight" in frozen
    assert "backbone_net.resnet.layer1.0.bn2.bias" in frozen
    ds = "backbone_net.resnet.layer2.0.downsample.1.weight"
    assert ds not in frozen and not torch.equal(after[ds], before[ds])
    rm = "backbone_net.resnet.bn1.running_mean"
    assert not torch.equal(after[rm], before[rm])  # frozen BNs' statistics still move
    return state, losses


# ---- the sampler settings' eval forward ----------------------------------------
#
# The raw eval forward (``HOISDF.apply`` against the port module's forward),
# at batch 2, f32, ``supervise_sdf=False``, with one flax init serving every
# setting (the settings change no parameter).

FORWARD_TOL = dict(atol=1e-4, rtol=1e-4)


def forward_setup():
    """One JAX init at the tiny config (BN statistics moved off (0, 1)) and
    the synthetic eval inputs with the image on the u8 grid."""
    jcfg, pcfg = configs()
    _, params, stats = init_jax(jcfg)
    stats = perturb_batch_stats(stats)
    inputs, _ = split_inputs_targets(synthetic_batch(jcfg, 2, seed=3, train=False))
    inputs["img"] = wire.quantize_image_u8(inputs["img"]).astype(np.float32) / 255.0
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, stats=stats, inputs=inputs)


def forward_pair(setup, **over):
    """(port outputs, JAX outputs) of the eval forward with ``over`` set on
    both configs, as numpy dicts."""
    import dataclasses
    import functools

    import torch

    jcfg = dataclasses.replace(setup["jcfg"], **over)
    pcfg = dataclasses.replace(setup["pcfg"], **over)
    jmodel = jax_build_model(jcfg)
    apply = jax.jit(functools.partial(jmodel.apply, use_presampled=False, supervise_sdf=False))
    want = apply({"params": setup["params"], "batch_stats": setup["stats"]},
                 {k: jnp.asarray(v) for k, v in setup["inputs"].items()})
    model = port_model(pcfg, setup["params"], setup["stats"])
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in setup["inputs"].items()},
                    supervise_sdf=False)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()}, pcfg)


def lattice_ids(points_scaled, bins_n):
    step = 2.0 / (bins_n - 1)
    ijk = np.rint((points_scaled.astype(np.float64) + 1.0) / step).astype(int)
    return (ijk[..., 0] * bins_n + ijk[..., 1]) * bins_n + ijk[..., 2]


def assert_forward_matches_jax(got, want, cfg):
    """The same selected lattice points per field and image (as sets), and
    every output within ``FORWARD_TOL``, per-point outputs after sorting by
    lattice point (near-equal |sdf| may order otherwise under another
    summation order).  The attention weights are left out: their key axis
    follows the selection order."""
    per_field = {"hand": ("hand_points", "hand_sdf", "hand_points_notrans", "hand_off",
                          "hand_cls"),
                 "obj": ("obj_points", "obj_sdf", "obj_rot", "obj_trans")}
    assert set(got) == set(want)
    done = {"attn_wts"}
    for field, keys in per_field.items():
        ids_g = lattice_ids(got[f"{field}_points"], cfg.bins_n)
        ids_w = lattice_ids(want[f"{field}_points"], cfg.bins_n)
        np.testing.assert_array_equal(np.sort(ids_g, 1), np.sort(ids_w, 1),
                                      err_msg=f"selected {field} points differ")
        for k in keys:
            np.testing.assert_allclose(_sorted_rows(got[k], ids_g), _sorted_rows(want[k], ids_w),
                                       err_msg=k, **FORWARD_TOL)
            done.add(k)
    for k in set(want) - done:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FORWARD_TOL)
