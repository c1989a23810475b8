"""The port's serving front-end on the CPU: ``Predictor.predict_async`` /
``materialize``, ``BatchingServer`` and ``run_poisson_load`` (the
counterparts of ``tests/test_predictor.py``), and that a warmed step builds
no tensor from host data.

One tiny port Predictor per module (``SYNTHETIC_TINY_OVERRIDES``, f32, the
hier cascade cut to ((4, 16), (2, 32)) so a step takes a fraction of a
second), batch 4, one torch thread; no JAX compile.  Outputs of one device
and one thread count are bitwise repeatable, so coalescing and the async
split are held bit for bit.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, get_config
from hoisdf_torch.data.synthetic import synthetic_batch
from hoisdf_torch.ops import wire
from hoisdf_torch.predictor import INPUT_KEYS, BatchingServer, Predictor, run_poisson_load

from torch_port_util import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BATCH = 4
SERVE_SHAPES = {"mano_joints": (21, 3), "mano_verts": (778, 3), "hand_joints": (20, 3)}


@pytest.fixture(scope="module")
def tiny_cfg():
    return get_config("dexycb", **SYNTHETIC_TINY_OVERRIDES, compute_dtype="float32",
                      hier_levels=((4, 16), (2, 32)), hier_levels_obj=None)


@pytest.fixture(scope="module")
def pred(tiny_cfg, one_torch_thread):
    p = Predictor(tiny_cfg, batch_size=BATCH, device="cpu")
    p.warmup()
    return p


@pytest.fixture(scope="module")
def pred_u8(tiny_cfg, pred):
    p = Predictor(tiny_cfg, batch_size=BATCH, transfer_dtype="uint8", device="cpu")
    p.warmup()
    return p


def _frames(cfg, n, seed):
    batch = synthetic_batch(cfg, n, seed=seed)
    return {k: batch[k] for k in INPUT_KEYS}


def _one(frames, i):
    return {k: v[i] for k, v in frames.items()}


def test_predictor_pads_and_trims(tiny_cfg, pred):
    out = pred.predict(_frames(tiny_cfg, 3, seed=0))
    assert out["mano_joints"].shape == (3, 21, 3)
    assert out["obj_rot"].shape == (3, tiny_cfg.num_samp_obj, 3)
    assert np.isfinite(out["mano_joints"]).all()
    s = pred.latency_summary()
    assert s["n"] >= 1 and s["p50_ms"] > 0
    with pytest.raises(ValueError, match="batch 5"):
        pred.predict(_frames(tiny_cfg, 5, seed=0))


@pytest.mark.parametrize("wire_name", ["float32", "uint8"])
def test_materialize_of_predict_async_equals_predict(tiny_cfg, pred, pred_u8, wire_name):
    """A short batch (n < batch) through the async split and through the
    blocking call, with other steps in flight between enqueue and
    materialize, bit for bit; a handle is materialized once."""
    p = pred_u8 if wire_name == "uint8" else pred
    frames = _frames(tiny_cfg, 3, seed=41)
    frames["img"] = wire.quantize_image_u8(frames["img"])
    other = _frames(tiny_cfg, 2, seed=43)
    handle, n = p.predict_async(frames)
    in_flight = [p.predict_async(other) for _ in range(3)]  # wraps the input ring
    got = p.materialize(handle, n)
    for h in in_flight:
        p.materialize(*h)
    want = p.predict(frames)
    assert n == 3 and set(got) == set(want)
    for k in want:
        assert got[k].shape[0] == 3
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="already materialized"):
        p.materialize(handle, n)


def test_batching_server_matches_direct_predict(tiny_cfg, pred):
    frames = _frames(tiny_cfg, 3, seed=7)
    direct = pred.predict(frames)
    with BatchingServer(pred, max_wait_ms=2000.0) as srv:
        # submit from threads so the dispatcher coalesces all 3 into one step
        futs = [None] * 3

        def send(i):
            futs[i] = srv.submit(_one(frames, i))

        threads = [threading.Thread(target=send, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        outs = [f.result(timeout=120) for f in futs]
    assert srv.frames_served == 3 and srv.batches_dispatched == 1
    # coalescing must not change results: scattered rows == direct batch rows
    for i, out in enumerate(outs):
        assert set(out) == set(direct)
        for k, v in out.items():
            np.testing.assert_array_equal(v, direct[k][i], err_msg=k)


def test_batching_server_cancelled_future_does_not_kill_worker(tiny_cfg, pred):
    """A caller .cancel()ing a queued Future must not crash the dispatcher
    (set_result on a cancelled Future raises InvalidStateError)."""
    frames = _frames(tiny_cfg, 2, seed=13)
    with BatchingServer(pred, max_wait_ms=300.0) as srv:
        doomed = srv.submit(_one(frames, 0))
        doomed.cancel()  # races the coalescing window; usually wins
        # the server must still serve subsequent traffic either way
        out = srv.submit(_one(frames, 1)).result(timeout=120)
        assert out["mano_joints"].shape == (21, 3)
        if doomed.cancelled():
            assert not doomed.running()
        else:  # dispatcher claimed it before cancel(); it must complete
            assert doomed.result(timeout=120)["mano_joints"].shape == (21, 3)


def test_batching_server_close_serves_accepted_requests(tiny_cfg, pred):
    """Requests accepted before close() are served, never failed: the submit
    lock orders them ahead of the shutdown sentinel."""
    frames = _frames(tiny_cfg, 4, seed=17)
    srv = BatchingServer(pred, max_wait_ms=50.0)
    futs = [srv.submit(_one(frames, i)) for i in range(4)]
    srv.close()  # drains: every accepted future resolves with a result
    for f in futs:
        assert f.result(timeout=120)["mano_joints"].shape == (21, 3)


def test_batching_server_fails_only_the_bad_batch(tiny_cfg, pred):
    """A malformed frame fails its own batch's futures; the server serves
    the next request."""
    frames = _frames(tiny_cfg, 2, seed=19)
    with BatchingServer(pred, max_wait_ms=1.0) as srv:
        bad = srv.submit(dict(_one(frames, 0), cam_intr=np.zeros((2, 2), np.float32)))
        with pytest.raises(ValueError):
            bad.result(timeout=120)
        assert srv.submit(_one(frames, 1)).result(timeout=120)["mano_joints"].shape == (21, 3)


def test_batching_server_poisson_saturation(tiny_cfg, pred):
    """Open-loop overload: an offered rate far above capacity must build a
    backlog that fully drains (every request completes), with the server
    coalescing toward full batches."""
    frames = _frames(tiny_cfg, 4, seed=23)
    pool = [_one(frames, i) for i in range(4)]
    with BatchingServer(pred, max_wait_ms=5.0) as srv:
        rep = run_poisson_load(srv, pool, rate_hz=30.0, duration_s=2.0, seed=3)
        fill = rep["completed"] / max(srv.batches_dispatched, 1)
    assert rep["submitted"] > 20  # the generator really ran open-loop
    assert rep["completed"] == rep["submitted"]  # backlog fully drained
    assert rep["goodput_hz"] > 0
    # saturation must coalesce multi-frame batches (a CPU step takes a
    # large part of a second, so the queue is never empty mid-run)
    assert fill > 1.5, fill
    lats = rep["latencies_s"]
    assert lats == sorted(lats) and lats[-1] < 600


def test_batching_server_single_request_and_close(tiny_cfg, pred):
    frames = _frames(tiny_cfg, 1, seed=11)
    srv = BatchingServer(pred, max_wait_ms=1.0)
    out = srv.submit(_one(frames, 0)).result(timeout=120)
    assert out["mano_joints"].shape == (21, 3)
    srv.close()
    srv.close()  # idempotent
    assert not srv._dispatcher.is_alive() and not srv._completer.is_alive()
    with pytest.raises(RuntimeError):
        srv.submit(_one(frames, 0))


def test_uint8_transfer_dtype_bit_exact_for_u8_sources(tiny_cfg, pred, pred_u8):
    """The u8 wire (bytes shipped, decoded through the host-rounded table)
    matches the f32 wire bit for bit when the source frames are u8."""
    rng = np.random.RandomState(29)
    frames = _frames(tiny_cfg, 3, seed=29)
    img_u8 = rng.randint(0, 256, frames["img"].shape, dtype=np.uint8)
    img_f32 = img_u8.astype(np.float32) / 255.0

    out_u8 = pred_u8.predict(dict(frames, img=img_u8))
    out_f32 = pred.predict(dict(frames, img=img_f32))
    for k in out_f32:
        np.testing.assert_array_equal(out_u8[k], out_f32[k], err_msg=k)
    # an f32 [0,1] crop that came from u8 re-quantizes losslessly
    out_req = pred_u8.predict(dict(frames, img=img_f32))
    np.testing.assert_array_equal(out_req["mano_joints"], out_u8["mano_joints"])
    # the f32 wire normalizes a raw u8 frame on the host (same result)
    out_host = pred.predict(dict(frames, img=img_u8))
    np.testing.assert_array_equal(out_host["mano_joints"], out_u8["mano_joints"])


# the sampler settings a warmed step is checked in besides the default "hier"
# (on both wires): each on the f32 wire
SAMPLER_CASES = {
    "full": dict(sdf_infer_mode="full", sdf_infer_chunk=1024),
    "coarse2fine": dict(sdf_infer_mode="coarse2fine", coarse_bins=4, coarse_keep_cells=16),
    "paired": dict(paired_sdf_infer=True),
    "nearest": dict(infer_gather_nearest=True),
}


@pytest.mark.parametrize("case", ["float32", "uint8", *SAMPLER_CASES])
def test_warmed_step_builds_no_tensor_from_host_data(tiny_cfg, pred, pred_u8, monkeypatch,
                                                     case):
    """A second predict_async (model forward, sampler, wire decode, MANO,
    packing) calls none of torch.tensor / as_tensor / from_numpy: on the
    card each would be a copy from the host that holds the host until the
    card reaches it.  Checked for the default sampler on both wires and for
    every other sampler setting ("full", "coarse2fine", the paired cascade,
    the nearest gather).  The card's own check (set_sync_debug_mode) is
    chip_smoke's serve_async and sampler phases."""
    if case in SAMPLER_CASES:
        cfg = dataclasses.replace(tiny_cfg, **SAMPLER_CASES[case])
        p = Predictor(cfg, batch_size=BATCH, device="cpu")
        p.warmup()
    else:
        p = pred_u8 if case == "uint8" else pred
    frames = _frames(tiny_cfg, 2, seed=31)
    p.materialize(*p.predict_async(frames))
    calls = []

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, counting(name, getattr(torch, name)))
    handle, n = p.predict_async(frames)
    monkeypatch.undo()
    assert calls == []
    assert np.isfinite(p.materialize(handle, n)["mano_verts"]).all()


class _InstantServer:
    """A server whose every request completes at submit."""

    def submit(self, frame):
        from concurrent.futures import Future

        fut = Future()
        fut.set_result({"x": frame["x"]})
        return fut


def test_poisson_report_has_the_jax_drivers_keys():
    """The port's driver reports what hoisdf_tpu.predictor.run_poisson_load
    reports (numpy only; no JAX compile)."""
    from hoisdf_tpu.predictor import run_poisson_load as jax_run_poisson_load

    pool = [{"x": np.zeros(1)}]
    got = run_poisson_load(_InstantServer(), pool, rate_hz=200.0, duration_s=0.2, seed=7)
    want = jax_run_poisson_load(_InstantServer(), pool, rate_hz=200.0, duration_s=0.2, seed=7)
    assert set(got) == set(want)
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}
    assert got["offered_hz"] == 200.0 and got["completed"] == got["submitted"] > 10
    assert got["latencies_s"] == sorted(got["latencies_s"])
