"""The serving slice as a whole against the JAX package: the same frames,
submitted one at a time from threads, through the JAX package's
``BatchingServer(Predictor)`` and the port's, with the same weights.

The JAX Predictor draws its weights by its own flax init; its BatchNorm
statistics are moved off (0, 1) and both sets are bridged into the port
with ``state_dict_from_jax``.  Config: the tiny dexycb config of both
packages, f32, with the hier cascade ((4, 16), (2, 32)) that both run.  The
image is on the u8 grid.  Tolerance, as ``tests/test_torch_eval_step.py``:
1e-4 absolute + 1e-4 relative on every output (f32 on both sides; summation
order through the backbone and the transformers); per-object-point rows
(rotation ++ translation) are matched one to one by nearest neighbour,
since near-equal |sdf| values may order the selected object points
differently under another summation order.  One JAX compile: a file of its
own, so the suite's workers spread it.
"""

import threading

import jax
import numpy as np
import pytest

from hoisdf_torch.ops import wire
from hoisdf_torch.predictor import BatchingServer, Predictor
from hoisdf_torch.weights import state_dict_from_jax
from hoisdf_tpu.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_tpu.predictor import BatchingServer as JaxBatchingServer
from hoisdf_tpu.predictor import Predictor as JaxPredictor

from torch_port_util import EVAL_TOL, configs, one_torch_thread, perturb_batch_stats  # noqa: F401

BATCH = 4
N_FRAMES = 3


def _serve(server, frames):
    """Submit every frame from its own thread (the dispatcher coalesces them
    into one step) and return the per-frame results in order."""
    futs = [None] * N_FRAMES

    def send(i):
        futs[i] = server.submit({k: v[i] for k, v in frames.items()})

    threads = [threading.Thread(target=send, args=(i,)) for i in range(N_FRAMES)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return [f.result(timeout=600) for f in futs]


@pytest.fixture(scope="module")
def served(one_torch_thread):
    jcfg, pcfg = configs("dexycb", hier_levels=((4, 16), (2, 32)))
    jpred = JaxPredictor(jcfg, batch_size=BATCH)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params, stats = to_np(jpred.params), perturb_batch_stats(to_np(jpred.batch_stats))
    jpred.batch_stats = jax.device_put(stats)
    ppred = Predictor(pcfg, batch_size=BATCH, device="cpu",
                      state_dict=state_dict_from_jax(params, stats))

    inputs, _ = split_inputs_targets(synthetic_batch(jcfg, N_FRAMES, seed=7, train=False))
    frames = {k: inputs[k] for k in ("img", "cam_intr", "mano_root", "obj_center_cam",
                                     "bbox_hand", "bbox_obj")}
    frames["img"] = wire.quantize_image_u8(frames["img"]).astype(np.float32) / 255.0
    with JaxBatchingServer(jpred, max_wait_ms=2000.0) as srv:
        want = _serve(srv, frames)
        jax_batches = srv.batches_dispatched
    with BatchingServer(ppred, max_wait_ms=2000.0) as srv:
        got = _serve(srv, frames)
        port_batches = srv.batches_dispatched
    return dict(pcfg=pcfg, jpred=jpred, ppred=ppred, frames=frames, got=got, want=want,
                batches=(jax_batches, port_batches))


def _assert_frame_matches(g, w, num_obj):
    for k in ("mano_joints", "mano_verts", "hand_joints"):
        assert g[k].shape == w[k].shape and g[k].dtype == np.float32, k
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **EVAL_TOL)
    g_rows = np.concatenate([g["obj_rot"], g["obj_trans"]], -1)
    w_rows = np.concatenate([w["obj_rot"], w["obj_trans"]], -1)
    assert g_rows.shape == w_rows.shape == (num_obj, 6)
    match = np.abs(g_rows[:, None] - w_rows[None]).max(-1).argmin(1)
    assert len(set(match)) == len(match), "object rows do not pair up"
    np.testing.assert_allclose(g_rows, w_rows[match], **EVAL_TOL)


def test_port_server_matches_jax_server(served):
    assert served["batches"] == (1, 1)  # both coalesced the three requests into one step
    for g, w in zip(served["got"], served["want"]):
        _assert_frame_matches(g, w, served["pcfg"].num_samp_obj)


def test_port_async_split_matches_jax_predict(served):
    """The port's predict_async + materialize on a short batch (2 of 4 rows)
    against the JAX package's blocking predict, on the same compile."""
    frames = {k: v[1:] for k, v in served["frames"].items()}
    want = served["jpred"].predict(frames)
    got = served["ppred"].materialize(*served["ppred"].predict_async(frames))
    for i in range(2):
        _assert_frame_matches({k: v[i] for k, v in got.items()},
                              {k: v[i] for k, v in want.items()},
                              served["pcfg"].num_samp_obj)
