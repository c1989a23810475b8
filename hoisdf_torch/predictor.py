"""Serving API of the port (``hoisdf_tpu/predictor.py``).

A fixed-batch predictor: eval forward + MANO head on the card, automatic
padding of short batches, one packed [B, D] f32 output per batch (one
device-to-host copy), and per-call latency statistics.  Two image wires:
``"float32"`` ships the [0,1] crop, ``"uint8"`` ships the bytes and rebuilds
the exact f32 values on the card (``ops/wire.py``).

``Predictor.predict_async`` enqueues a step without waiting for the card and
``materialize`` waits for that step's result alone, so a caller can enqueue
step N+1 while step N runs.  ``BatchingServer`` coalesces single-frame
requests from any number of threads into device batches and keeps
``pipeline_depth`` steps in flight; ``run_poisson_load`` drives it with
open-loop Poisson arrivals.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from hoisdf_torch.config import Config, get_config
from hoisdf_torch.data.synthetic import synthetic_batch
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import load_mano_npz, make_synthetic_mano
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.ops import wire
from hoisdf_torch.train import make_eval_step, resolve_device
from hoisdf_torch.utils.profiling import StepStats

INPUT_KEYS = ("img", "cam_intr", "mano_root", "obj_center_cam", "bbox_hand", "bbox_obj")
# Outputs a serving caller gets (all batch-leading), in packing order.
SERVE_KEYS = ("mano_joints", "mano_verts", "hand_joints", "obj_rot", "obj_trans")
# Under the IK head (ho3d_render) the step gives the shape, not the meshes;
# the caller solves the pose from the voted joints (ops/ik.py).
IK_SERVE_KEYS = ("mano_shape", "hand_joints", "obj_rot", "obj_trans")
# Host input slots, each reused once its previous batch's host-to-device copy
# has run: a server with up to INPUT_SLOTS - 1 steps in flight never waits
# for one.
INPUT_SLOTS = 4


class _InputSlot:
    """One batch of host inputs (pinned on the card) and the event recorded
    after its host-to-device copies were enqueued."""

    def __init__(self, template: Mapping[str, np.ndarray], pin: bool):
        self.tensors = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                                       pin_memory=pin) for k, v in template.items()}
        self.arrays = {k: t.numpy() for k, t in self.tensors.items()}
        self.copied = torch.cuda.Event() if pin else None


class StepHandle:
    """An enqueued step's packed result: a host buffer (pinned on the card)
    that its device-to-host copy fills, and the event recorded after that
    copy (None on the CPU, where the step ran before ``predict_async``
    returned)."""

    __slots__ = ("out", "done")

    def __init__(self, out: torch.Tensor, done: Optional[torch.cuda.Event]):
        self.out: Optional[torch.Tensor] = out
        self.done = done


class Predictor:
    """Inputs per frame: img [H,W,3] in [0,1] (or u8), cam_intr [3,3],
    mano_root [3], obj_center_cam [3], bbox_hand / bbox_obj [4].  Outputs:
    MANO joints/verts (root-relative, metres), voted hand joints, object
    rotation (axis-angle) and relative translation per object point; under
    the IK head (ho3d_render) the MANO shape [10] instead of the meshes.
    Every preset serves."""

    def __init__(self, cfg: Optional[Config] = None, batch_size: int = 8,
                 transfer_dtype: str = "float32", *, device="cuda",
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None):
        """Weights come from ``state_dict`` (strict) or, without one, are
        random from seed 0.  ``device`` defaults to the card and raises
        without CUDA."""
        if transfer_dtype not in ("float32", "uint8"):
            raise ValueError(f"transfer_dtype {transfer_dtype!r}")
        self.device = resolve_device(device)
        self.transfer_dtype = transfer_dtype
        self.cfg = cfg or get_config("dexycb", compute_dtype="bfloat16")
        self.batch_size = batch_size
        self.model = build_model(self.cfg)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        mano = (load_mano_npz(self.cfg.mano_model_path) if self.cfg.mano_model_path
                else make_synthetic_mano(0))
        self.mano = ManoBuffers.from_model(mano, self.device)
        self._eval_step = make_eval_step(self.cfg, self.model, self.mano, supervise_sdf=False,
                                         device=self.device)
        inputs = synthetic_batch(self.cfg, batch_size)
        self._template = {k: inputs[k] for k in INPUT_KEYS}
        if transfer_dtype == "uint8":
            self._template["img"] = wire.quantize_image_u8(self._template["img"])
        k_obj = self.cfg.num_samp_obj
        shapes = {"mano_joints": (21, 3), "mano_verts": (778, 3), "mano_shape": (10,),
                  "hand_joints": (20, 3), "obj_rot": (k_obj, 3), "obj_trans": (k_obj, 3)}
        keys = IK_SERVE_KEYS if self.cfg.use_inverse_kinematics else SERVE_KEYS
        self._pack_layout: List[Tuple[str, Tuple[int, ...]]] = [(k, shapes[k]) for k in keys]
        self._width = sum(int(np.prod(s)) for _, s in self._pack_layout)
        self._cuda = self.device.type == "cuda"
        self._slots = [_InputSlot(self._template, self._cuda) for _ in range(INPUT_SLOTS)]
        self._next_slot = 0
        self._launch_lock = threading.Lock()  # one thread fills a slot and enqueues at a time
        self._free_out: List[torch.Tensor] = []  # output buffers no handle holds
        self._out_lock = threading.Lock()
        self.stats = StepStats()

    def warmup(self) -> None:
        self.materialize(*self.predict_async(self._template))

    def _fill(self, slot: _InputSlot, frames: Mapping[str, np.ndarray], n: int) -> None:
        """Encode ``frames`` into ``slot``, padding rows n.. with the last frame;
        keys the frames lack take the template's."""
        for k in INPUT_KEYS:
            dst = slot.arrays[k]
            if k not in frames:
                dst[...] = self._template[k]
                continue
            v = np.asarray(frames[k])
            if k == "img":
                if self.transfer_dtype == "uint8":
                    v = wire.quantize_image_u8(v)
                elif v.dtype == np.uint8:
                    v = v.astype(np.float32) / 255.0
            dst[:n] = v
            dst[n:] = v[n - 1]

    def _take_out(self) -> torch.Tensor:
        with self._out_lock:
            if self._free_out:
                return self._free_out.pop()
        return torch.empty((self.batch_size, self._width), dtype=torch.float32,
                           pin_memory=self._cuda)

    def predict_async(self, frames: Mapping[str, np.ndarray]) -> Tuple[StepHandle, int]:
        """Enqueue one step without waiting for the card: frames (leading dim
        N <= batch_size) are padded and encoded into the next host input
        slot, copied to the card, the step and its packed result's copy to a
        host buffer are enqueued, and an event is recorded after that copy.
        Returns ``(handle, N)`` for :meth:`materialize`.  On the card it
        waits only if the slot's previous copy has not run yet."""
        n = frames["img"].shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch {n} > predictor batch {self.batch_size}")
        with self._launch_lock:
            slot = self._slots[self._next_slot]
            self._next_slot = (self._next_slot + 1) % len(self._slots)
            if slot.copied is not None:
                slot.copied.synchronize()
            self._fill(slot, frames, n)
            with torch.inference_mode():
                batch = {k: t.to(self.device, non_blocking=True)
                         for k, t in slot.tensors.items()}
                if slot.copied is not None:
                    slot.copied.record(torch.cuda.current_stream(self.device))
                preds = self._eval_step(batch)
                packed = torch.cat([preds[k].reshape(self.batch_size, -1).float()
                                    for k, _ in self._pack_layout], dim=1)
                out = self._take_out()
                out.copy_(packed, non_blocking=True)
                done = None
                if self._cuda:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
        return StepHandle(out, done), n

    def materialize(self, handle: StepHandle, n: int) -> Dict[str, np.ndarray]:
        """Wait for ``handle``'s step alone (its event, not the stream) and
        unpack its packed result to numpy, trimmed to the ``n`` live rows.
        Each handle is materialized once."""
        out = handle.out
        if out is None:
            raise ValueError("this step's result was already materialized")
        if handle.done is not None:
            handle.done.synchronize()
        flat = out.numpy()[:n].copy()
        handle.out = None
        with self._out_lock:
            self._free_out.append(out)
        res, off = {}, 0
        for k, shape in self._pack_layout:
            size = int(np.prod(shape))
            res[k] = flat[:, off:off + size].reshape((n,) + shape)
            off += size
        return res

    def predict(self, frames: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """frames: per-frame arrays with leading dim N <= batch_size.
        Returns numpy outputs trimmed to N."""
        with self.stats.measure():
            return self.materialize(*self.predict_async(frames))

    def latency_summary(self) -> Dict[str, float]:
        return self.stats.summary()


class BatchingServer:
    """Dynamic micro-batching front-end over a :class:`Predictor`.

    Callers (any number of threads) submit ONE frame at a time and get a
    ``concurrent.futures.Future`` back.  Two pipeline stages serve them:

    * the **dispatcher** thread drains the request queue, coalesces up to
      ``predictor.batch_size`` frames (waiting at most ``max_wait_ms`` after
      the first frame arrives for stragglers) and enqueues one step
      (``predict_async``); it is the only thread that launches work on the
      card;
    * the **completer** thread materializes each step's outputs (it waits
      on the step's event only) and scatters per-frame results to the
      futures.

    The bounded hand-off queue (``pipeline_depth``, default 2) keeps that
    many steps in flight, so batch assembly and the host's enqueueing of
    one step overlap the card running another.  A failing step propagates
    to exactly the futures of its batch; the server stays up.
    """

    def __init__(self, predictor: Predictor, max_wait_ms: float = 5.0,
                 pipeline_depth: int = 2):
        self.predictor = predictor
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max(1, pipeline_depth))
        self._closed = False
        # orders every submit() against close()'s sentinel: nothing can be
        # enqueued after the sentinel, so the dispatcher serves ALL accepted
        # requests before shutting down
        self._submit_lock = threading.Lock()
        self.batches_dispatched = 0
        self.frames_served = 0
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._completer = threading.Thread(target=self._complete_loop, daemon=True)
        self._dispatcher.start()
        self._completer.start()

    def submit(self, frame: Mapping[str, np.ndarray]) -> "Future":
        """frame: per-frame arrays WITHOUT a leading batch dim (``img
        [H,W,3]``, ``cam_intr [3,3]``, ...).  Returns a Future whose result
        is the per-frame output dict (leading dim stripped)."""
        fut: "Future" = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("BatchingServer is closed")
            self._q.put((frame, fut))
        return fut

    def _dispatch_loop(self) -> None:
        bs = self.predictor.batch_size
        stop = False
        while not stop:
            item = self._q.get()
            if item is None:
                break
            pending: List[tuple] = [item]
            deadline = time.monotonic() + self.max_wait_s
            while len(pending) < bs:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                pending.append(nxt)
            self._dispatch_batch(pending)
        self._inflight.put(None)  # completer: drain and exit

    @staticmethod
    def _fail(futures, exc) -> None:
        for fut in futures:
            try:
                fut.set_exception(exc)
            except InvalidStateError:  # racing caller already cancelled it
                pass

    def _dispatch_batch(self, pending: List[tuple]) -> None:
        # claim each future; callers may have .cancel()ed while queued, and
        # setting a result on a cancelled Future raises InvalidStateError,
        # which would kill the worker thread
        pending = [(f, fut) for f, fut in pending if fut.set_running_or_notify_cancel()]
        if not pending:
            return
        try:
            # batch assembly inside the try: a malformed frame (ragged
            # shapes, missing key) must fail THIS batch's futures, not kill
            # the dispatcher thread and strand every later request
            frames = {k: np.stack([np.asarray(f[k]) for f, _ in pending])
                      for k in INPUT_KEYS if k in pending[0][0]}
            handle, _n = self.predictor.predict_async(frames)
        except Exception as exc:  # bad inputs / launch error: this batch only
            self._fail([fut for _, fut in pending], exc)
            return
        self.batches_dispatched += 1
        # blocks when pipeline_depth steps are already in flight
        self._inflight.put((pending, handle))

    def _complete_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            pending, handle = item
            try:
                out = self.predictor.materialize(handle, len(pending))
            except Exception as exc:  # device-side failure of THIS step
                self._fail([fut for _, fut in pending], exc)
                continue
            self.frames_served += len(pending)
            for i, (_, fut) in enumerate(pending):
                fut.set_result({k: v[i] for k, v in out.items()})

    def close(self) -> None:
        """Serve every request accepted before close(), then stop both
        pipeline stages.  The submit lock orders all accepted requests ahead
        of the shutdown sentinel, so none can be stranded behind it."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._dispatcher.join()
        self._completer.join()
        # the lock makes post-sentinel items impossible; fail loudly rather
        # than hang forever if that invariant ever breaks
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._fail([item[1]], RuntimeError("BatchingServer closed"))

    def __enter__(self) -> "BatchingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_poisson_load(server: BatchingServer, frames: List[Dict[str, np.ndarray]],
                     rate_hz: float, duration_s: float, seed: int = 0) -> Dict[str, object]:
    """Open-loop Poisson load driver for :class:`BatchingServer`.

    Submits single frames (round-robin from ``frames``) with exponential
    inter-arrival gaps at ``rate_hz`` for ``duration_s`` seconds, without
    waiting for completions (open loop: an overloaded server builds a
    backlog instead of throttling the generator).  Waits for every
    submitted request, then reports::

        {"offered_hz", "submitted", "completed", "elapsed_s", "goodput_hz",
         "latencies_s": sorted per-request latencies}

    ``goodput_hz`` counts completions over the window from first submit to
    last completion, so at overload it converges to server capacity.
    """
    rng = np.random.RandomState(seed)
    latencies: List[float] = []
    lock = threading.Lock()
    # Future.set_result wakes result() waiters BEFORE invoking done
    # callbacks, so the driver could build the report while the last
    # callbacks are still pending; each callback releases this semaphore
    # and the driver acquires once per submit before reading `latencies`.
    done_sem = threading.Semaphore(0)
    futs = []
    t_start = time.perf_counter()
    t_end = t_start + duration_s
    next_t = t_start
    i = 0
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 1e-3))
            continue
        t0 = time.perf_counter()

        def _done(fut, t0=t0):
            try:
                if not fut.cancelled() and fut.exception() is None:
                    with lock:
                        latencies.append(time.perf_counter() - t0)
            finally:
                done_sem.release()

        fut = server.submit(frames[i % len(frames)])
        fut.add_done_callback(_done)
        futs.append(fut)
        i += 1
        next_t += rng.exponential(1.0 / rate_hz)
    for fut in futs:
        try:
            fut.result(timeout=600)
        except Exception:  # a failed request counts as not completed
            pass
    deadline = time.monotonic() + 60.0
    for _ in futs:  # every callback has run before the report is built
        if not done_sem.acquire(timeout=max(deadline - time.monotonic(), 1e-3)):
            break
    elapsed = time.perf_counter() - t_start
    with lock:
        lats = sorted(latencies)
    return {
        "offered_hz": rate_hz,
        "submitted": len(futs),
        "completed": len(lats),
        "elapsed_s": elapsed,
        "goodput_hz": len(lats) / elapsed if elapsed > 0 else 0.0,
        "latencies_s": lats,
    }
