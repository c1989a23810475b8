"""Serving API of the port (``hoisdf_tpu/predictor.py::Predictor``).

A fixed-batch predictor: eval forward + MANO head on the card, automatic
padding of short batches, one packed [B, D] f32 output per batch (one
device-to-host copy), and per-call latency statistics.  Two image wires:
``"float32"`` ships the [0,1] crop, ``"uint8"`` ships the bytes and rebuilds
the exact f32 values on the card (``ops/wire.py``).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
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

INPUT_KEYS = ("img", "cam_intr", "mano_root", "obj_center_cam", "bbox_hand", "bbox_obj")
# Outputs a serving caller gets (all batch-leading), in packing order.
SERVE_KEYS = ("mano_joints", "mano_verts", "hand_joints", "obj_rot", "obj_trans")


class StepStats:
    """Host-clock durations of completed calls."""

    def __init__(self):
        self.durations: List[float] = []

    @contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.durations.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {"n": 0}
        ms = np.asarray(self.durations) * 1e3
        return {"n": int(ms.size), "p50_ms": float(np.percentile(ms, 50)),
                "p90_ms": float(np.percentile(ms, 90)), "mean_ms": float(ms.mean())}


class Predictor:
    """Inputs per frame: img [H,W,3] in [0,1] (or u8), cam_intr [3,3],
    mano_root [3], obj_center_cam [3], bbox_hand / bbox_obj [4].  Outputs:
    MANO joints/verts (root-relative, metres), voted hand joints, object
    rotation (axis-angle) and relative translation per object point."""

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
        self._eval_step = make_eval_step(self.cfg, self.model, ManoBuffers.from_model(mano),
                                         supervise_sdf=False, device=self.device)
        inputs = synthetic_batch(self.cfg, batch_size)
        self._template = {k: inputs[k] for k in INPUT_KEYS}
        if transfer_dtype == "uint8":
            self._template["img"] = wire.quantize_image_u8(self._template["img"])
        k_obj = self.cfg.num_samp_obj
        shapes = {"mano_joints": (21, 3), "mano_verts": (778, 3), "hand_joints": (20, 3),
                  "obj_rot": (k_obj, 3), "obj_trans": (k_obj, 3)}
        self._pack_layout: List[Tuple[str, Tuple[int, ...]]] = [
            (k, shapes[k]) for k in SERVE_KEYS]
        self.stats = StepStats()

    def _packed_step(self, batch: Mapping[str, np.ndarray]) -> torch.Tensor:
        preds = self._eval_step(batch)
        return torch.cat([preds[k].reshape(self.batch_size, -1).float()
                          for k, _ in self._pack_layout], dim=1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        self._packed_step(self._template)
        self._sync()

    def predict(self, frames: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """frames: per-frame arrays with leading dim N <= batch_size.
        Returns numpy outputs trimmed to N."""
        n = frames["img"].shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch {n} > predictor batch {self.batch_size}")
        with self.stats.measure():
            batch = {}
            for k in INPUT_KEYS:
                if k not in frames:
                    batch[k] = self._template[k]
                    continue
                v = np.asarray(frames[k])
                if k == "img":
                    if self.transfer_dtype == "uint8":
                        v = wire.quantize_image_u8(v)
                    elif v.dtype == np.uint8:
                        v = v.astype(np.float32) / 255.0
                if n < self.batch_size:
                    v = np.concatenate([v, np.repeat(v[-1:], self.batch_size - n, axis=0)])
                batch[k] = v
            # one device-to-host copy of the packed result (waits for the step)
            flat = self._packed_step(batch).cpu().numpy()
            out, off = {}, 0
            for k, shape in self._pack_layout:
                size = int(np.prod(shape))
                out[k] = flat[:n, off:off + size].reshape((n,) + shape)
                off += size
        return out

    def latency_summary(self) -> Dict[str, float]:
        return self.stats.summary()
