"""The PyTorch port's whole eval step against the JAX package's, at the tiny
config, with one JAX compile; then the port's Predictor against the port's
own eval step on both wires.

Weights come from the flax init (with BatchNorm statistics moved off (0, 1)),
bridged with ``state_dict_from_jax``.  Inputs are the synthetic batch with the
image pinned to the u8 grid, so both wires carry the same values.
Tolerance: 1e-4 absolute + 1e-4 relative on every output (f32 on both sides;
summation order through the backbone and the transformers).  The selected
hand points must be the same set; per-point outputs are compared after
sorting by lattice point, since near-equal |sdf| values may order differently
under another summation order.  The eval step reports no object points, so
per-object-point rows are matched one to one by nearest neighbour.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import HOISDF
from hoisdf_torch.ops import wire
from hoisdf_torch.predictor import SERVE_KEYS, Predictor
from hoisdf_torch.train import make_eval_step, resolve_device
from hoisdf_torch.weights import state_dict_from_jax
from hoisdf_tpu.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.train import make_eval_step as jax_make_eval_step

from torch_port_util import configs, init_jax, perturb_batch_stats

TOL = dict(atol=1e-4, rtol=1e-4)
HAND_KEYS = ("hand_points_notrans", "hand_off", "hand_cls")
OBJ_KEYS = ("obj_rot", "obj_trans")


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = configs()
    jmodel, params, stats = init_jax(jcfg)
    stats = perturb_batch_stats(stats)
    mano = make_synthetic_mano(0)
    inputs, _ = split_inputs_targets(synthetic_batch(jcfg, 2, seed=3, train=False))
    inputs["img"] = wire.quantize_image_u8(inputs["img"]).astype(np.float32) / 255.0
    jstep = jax_make_eval_step(jcfg, jmodel, JaxManoBuffers.from_model(mano),
                               supervise_sdf=False)
    want = jstep(params, stats, {k: jnp.asarray(v) for k, v in inputs.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    state = state_dict_from_jax(params, stats)
    return pcfg, state, mano, inputs, want


def _port_step(pcfg, state, mano, supervise):
    model = HOISDF(pcfg)
    model.load_state_dict(state, strict=True)
    return make_eval_step(pcfg, model, ManoBuffers.from_model(mano),
                          supervise_sdf=supervise, device="cpu")


def _hand_ids(notrans, cfg):
    step = 2.0 / (cfg.bins_n - 1)
    ijk = np.rint((notrans.astype(np.float64) * cfg.hand_sdf_scale + 1.0) / step).astype(int)
    return (ijk[..., 0] * cfg.bins_n + ijk[..., 1]) * cfg.bins_n + ijk[..., 2]


def _sorted_rows(v, ids):
    order = np.argsort(ids, axis=1)
    axis = 2 if v.ndim == 4 else 1
    idx = order[None, ..., None] if v.ndim == 4 else order[..., None]
    return np.take_along_axis(v, idx, axis=axis)


def _assert_matches_jax(got, want, cfg):
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
        np.testing.assert_allclose(g, w, err_msg=k, **TOL)
    # per-object-point rows: a one-to-one nearest-neighbour match
    g_rows = np.concatenate([got[k] for k in OBJ_KEYS], -1)
    w_rows = np.concatenate([want[k] for k in OBJ_KEYS], -1)
    for b in range(g_rows.shape[0]):
        d = np.abs(g_rows[b][:, None] - w_rows[b][None]).max(-1)
        match = d.argmin(1)
        assert len(set(match)) == len(match), "object rows do not pair up"
        np.testing.assert_allclose(g_rows[b], w_rows[b][match], **TOL)


@pytest.mark.parametrize("supervise", [False, True])
def test_eval_step_matches_jax(setup, supervise):
    """One JAX reference (supervise_sdf=False) serves both port settings: the
    supervision branch adds no eval-step output."""
    pcfg, state, mano, inputs, want = setup
    step = _port_step(pcfg, state, mano, supervise)
    got = {k: v.numpy() for k, v in step(inputs).items()}
    _assert_matches_jax(got, want, pcfg)


def test_u8_wire_bit_identical_and_predictor_matches_eval_step(setup):
    pcfg, state, mano, inputs, _ = setup
    step = _port_step(pcfg, state, mano, False)
    ref = {k: v.numpy() for k, v in step(inputs).items()}
    u8 = step(dict(inputs, img=wire.quantize_image_u8(inputs["img"])))
    for k, v in u8.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)

    frames = {k: inputs[k] for k in ("img", "cam_intr", "mano_root", "obj_center_cam",
                                     "bbox_hand", "bbox_obj")}
    pred_f32 = Predictor(pcfg, batch_size=2, device="cpu", state_dict=state)
    pred_u8 = Predictor(pcfg, batch_size=2, transfer_dtype="uint8", device="cpu",
                        state_dict=state)
    out_f32 = pred_f32.predict(frames)
    out_u8 = pred_u8.predict(dict(frames, img=wire.quantize_image_u8(frames["img"])))
    assert set(out_f32) == set(SERVE_KEYS)
    for k in SERVE_KEYS:
        np.testing.assert_array_equal(out_f32[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(out_u8[k], ref[k], err_msg=k)
    # a short batch is padded with its last frame and trimmed back
    one = pred_f32.predict({k: v[:1] for k, v in frames.items()})
    assert one["mano_joints"].shape == (1, 21, 3)
    assert np.isfinite(one["mano_verts"]).all()
    assert pred_f32.latency_summary()["n"] == 2


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal applies only without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
