"""Evaluation entry point of the port (``hoisdf_tpu/evaluate.py``): a model
and an eval split -> ``results.txt``.

The original's ``main/test.py:77-269`` metric set.  DexYCB: ADD-S, OCE and
MCE, and the MANO MJE and PA-MJE (dexycb_full adds the mesh EPE / AUC and the
F-scores at 5 and 15 mm).  HO3D: ADD-S and MME, with 019_pitcher_base left
out of both and of the sample count, and the codalab lists of joints (MANO
order -> the leaderboard's) and vertices in the OpenGL frame.  ho3d_render
recovers the hand by IK from the voted joints and the predicted shape.

Metrics run on the evaluator's device, one host transfer per batch; the
accumulation is host numpy.  ``main`` evaluates on one card (or the CPU with
``--cpu``) and keeps a one-batch lookahead: batch i+1's eval step is enqueued
before batch i's metrics, which run on a side stream behind an event, so
their host transfer does not wait for batch i+1.

A dataset's eval split (DexYCB's test split, HO3D's evaluation split, which
also writes the codalab ``pred_mano.json``) is read whole, in order, and its
short tail batch is padded to the batch size and trimmed before the metrics.
The model then has the preset's full size, unless ``--cfg`` overrides say
otherwise; ``--synthetic`` takes the tiny model on synthetic batches.

Usage:
    python -m hoisdf_torch.evaluate --setting dexycb --synthetic [--cpu]
    python -m hoisdf_torch.evaluate --setting ho3d --torch-ckpt snapshot_69.pth.tar \\
        --cfg data_dir=... --cfg fast_data_dir=... --cfg object_models_dir=... \\
        --cfg simple_object_models_dir=... --batch-size 22 --out results/
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from hoisdf_torch.config import Config, SYNTHETIC_TINY_OVERRIDES, get_config, parse_cfg_overrides
from hoisdf_torch.data.dexycb import DexYCBDataset
from hoisdf_torch.data.ho3d import HO3D_OBJECTS, HO3DDataset, dump_codalab_json
from hoisdf_torch.data.loader import DataLoader, pad_batch, trim_batch
from hoisdf_torch.data.meshes import load_obj_vertices
from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import load_mano_npz, make_synthetic_mano
from hoisdf_torch.metrics import EvalUtil, eval_batched_obj_direct, eval_hand_joint, mesh_metrics_batch
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.models.mano_head import mano_head_gt
from hoisdf_torch.ops import wire
from hoisdf_torch.ops.ik import ik_solver_mano
from hoisdf_torch.train import disable_tf32, make_eval_step, resolve_device
from hoisdf_torch.utils import checkpoint as ckpt_util

# MANO joint order -> the "simple" leaderboard order (data/ho3d.py:47-70)
JOINTS_MANO_TO_SIMPLE = np.array(
    [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20])
JOINTS_SIMPLE_TO_MANO = np.argsort(JOINTS_MANO_TO_SIMPLE)

COORD_CHANGE_MAT = np.array([[1.0, 0.0, 0.0], [0, -1.0, 0.0], [0.0, 0.0, -1.0]],
                            dtype=np.float32)


def prepare_model_templates(obj_root: str) -> Tuple[List[np.ndarray], Dict[int, str]]:
    """The sorted object folders' ``textured_simple_2000.obj`` vertices, and
    their names by 1-based id."""
    templates, obj_names = [], {}
    for obj_id, obj in enumerate(sorted(os.listdir(obj_root)), start=1):
        templates.append(load_obj_vertices(os.path.join(obj_root, obj,
                                                        "textured_simple_2000.obj")))
        obj_names[obj_id] = obj
    return templates, obj_names


def _to_host(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device tensors -> numpy in one transfer (one flat f32 copy)."""
    if not tensors:
        return {}
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors.values()]).cpu().numpy()
    out, off = {}, 0
    for k, t in tensors.items():
        out[k] = flat[off:off + t.numel()].reshape(tuple(t.shape))
        off += t.numel()
    return out


class Evaluator:
    """Accumulates the original's metric set over eval batches.  Metrics run
    on ``device`` (default the card; raises without CUDA)."""

    def __init__(self, cfg: Config, mano_buffers: ManoBuffers, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        disable_tf32()  # the metrics' geometry in full f32, as the eval step's
        self.mano = mano_buffers.to(self.device)
        self.results: Dict[str, float] = {"ADDS_error": 0.0}
        self.total = 0
        if cfg.dataset == "dexycb":
            self.results.update(mano_mje=0.0, mano_pamje=0.0, OCE_error=0.0, MCE_error=0.0)
            self.mesh_err = EvalUtil(num_kp=778)
            self.mesh_err_aligned = EvalUtil(num_kp=778)
            self.f_scores: List[List[float]] = []
            self.f_scores_aligned: List[List[float]] = []
            self.f_threshs = (0.005, 0.015)
        else:
            self.results["MME_error"] = 0.0
            self.joint_list: List[np.ndarray] = []
            self.mesh_list: List[np.ndarray] = []

    def _t(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _obj_valid_mask(self, meta: Mapping, b: int) -> np.ndarray:
        """Per-sample object-metric validity: HO3D leaves 019_pitcher_base
        out of ADD-S and MME (common/metrics.py:131-143).  The dataset gives
        ``obj_valid``; without it, ``obj_cls`` decides."""
        if "obj_valid" in meta:
            return np.asarray(meta["obj_valid"]).astype(bool).reshape(b)
        if self.cfg.dataset == "ho3d" and "obj_cls" in meta:
            pitcher = HO3D_OBJECTS.index("019_pitcher_base")
            return np.asarray(meta["obj_cls"]).reshape(b) != pitcher
        return np.ones(b, bool)

    def _ik(self, preds: Mapping) -> Dict[str, torch.Tensor]:
        joints = self._t(preds["hand_joints"])
        joints = torch.cat([torch.zeros_like(joints[:, :1]), joints], dim=1)
        shape = preds.get("mano_shape")
        return ik_solver_mano(self.mano, joints, None if shape is None else self._t(shape))

    def feed(self, preds: Mapping, targets: Mapping, meta: Mapping, templates) -> None:
        """One batch: ``preds`` of the eval step (tensors on any device, or
        numpy), ``targets`` and ``meta`` (the inputs) as numpy or tensors,
        ``templates`` [B, N, 3] the objects' template vertices."""
        cfg = self.cfg
        b = int(meta["mano_root"].shape[0])
        ho3d = cfg.dataset == "ho3d"
        with torch.inference_mode():
            dev = eval_batched_obj_direct(
                self._t(preds["obj_rot"]).mean(dim=1), self._t(preds["obj_trans"]).mean(dim=1),
                self._t(targets["obj_rot"]), self._t(targets["rel_obj_trans"]),
                self._t(templates), ho3d=ho3d)
            if ho3d:
                if cfg.use_inverse_kinematics:
                    ik = self._ik(preds)
                    dev["joints"], dev["mesh"] = ik["joints"], ik["verts"]
                else:
                    dev["joints"] = self._t(preds["mano_joints"])
                    dev["mesh"] = self._t(preds["mano_verts"])
            else:
                need_gt = cfg.eval_mesh or not cfg.use_inverse_kinematics
                gt = mano_head_gt(self.mano, self._t(targets["mano_param"])) if need_gt else None
                if cfg.use_inverse_kinematics:
                    dev["mje"], dev["pamje"] = eval_hand_joint(
                        self._ik(preds)["joints"], self._t(targets["joint_cam_no_trans"]) / 1000)
                else:
                    dev["mje"], dev["pamje"] = eval_hand_joint(
                        self._t(preds["mano_joints"]), gt["joints3d"])
                if cfg.eval_mesh:
                    dev.update(mesh_metrics_batch(gt["verts3d"], self._t(preds["mano_verts"]),
                                                  self.f_threshs))
            host = _to_host(dev)

        mask = self._obj_valid_mask(meta, b)
        n = int(mask.sum())
        if n:
            self.results["ADDS_error"] += float(host["ADDS"][mask].mean()) * n * 100
        if ho3d:
            if n:
                self.results["MME_error"] += float(host["MME"][mask].mean()) * n * 100
            root = np.asarray(meta["mano_root"])[:, None, :]
            joints = (host["joints"] + root) @ COORD_CHANGE_MAT
            mesh = (host["mesh"] + root) @ COORD_CHANGE_MAT
            for x, v in zip(joints, mesh):
                self.joint_list.append(x[JOINTS_SIMPLE_TO_MANO])
                self.mesh_list.append(v)
            self.total += n
            return
        self.results["mano_mje"] += float(host["mje"]) * b * 100
        self.results["mano_pamje"] += float(host["pamje"]) * b * 100
        if n:
            self.results["OCE_error"] += float(host["OCE"][mask].mean()) * n * 100
            self.results["MCE_error"] += float(host["MCE"][mask].mean()) * n * 100
        if cfg.eval_mesh:
            for i in range(b):
                self.mesh_err.feed_dist(host["epe_dist"][i])
                self.mesh_err_aligned.feed_dist(host["epe_dist_aligned"][i])
                self.f_scores.append([float(v) for v in host["fscores"][i]])
                self.f_scores_aligned.append([float(v) for v in host["fscores_aligned"][i]])
        self.total += b

    def write_results(self, log_dir: str) -> str:
        path = os.path.join(log_dir, "results.txt")
        with open(path, "w") as f:
            for k, v in self.results.items():
                print(k, ": ", v / max(self.total, 1), file=f)
            if self.cfg.dataset == "dexycb" and self.cfg.eval_mesh:
                m, _, auc, _, _ = self.mesh_err.get_measures(0.0, 0.05, 100)
                print("Evaluation 3D MESH results:", file=f)
                print("auc=%.3f, mean_vert3d_avg=%.2f cm" % (auc, m * 100), file=f)
                ma, _, auca, _, _ = self.mesh_err_aligned.get_measures(0.0, 0.05, 100)
                print("Evaluation 3D MESH ALIGNED results:", file=f)
                print("auc=%.3f, mean_vert3d_avg=%.2f cm\n" % (auca, ma * 100), file=f)
                print("F-scores", file=f)
                fs = np.asarray(self.f_scores).T
                fsa = np.asarray(self.f_scores_aligned).T
                for row, rowa, t in zip(fs, fsa, self.f_threshs):
                    print("F@%.1fmm = %.3f" % (t * 1000, row.mean()),
                          "\tF_aligned@%.1fmm = %.3f" % (t * 1000, rowa.mean()), file=f)
        return path


def evaluate_batches(cfg: Config, eval_step, evaluator: Evaluator,
                     batches: Iterable[Tuple[Dict, Dict, Optional[np.ndarray], int]],
                     batch_size: int, on_first_batch: Optional[Callable] = None) -> None:
    """Feed every batch ``(inputs, targets, templates, valid)`` through
    ``eval_step`` and ``evaluator``, with a one-batch lookahead: batch i+1's
    step is enqueued before batch i's metrics run.  On the card the metrics
    run on a side stream behind an event recorded after their step, so their
    host transfer waits for that step only.  Rows past ``valid`` (tail-batch
    padding) are dropped before the metrics; a batch without templates skips
    them.  ``on_first_batch(preds, targets)`` sees the first batch, trimmed."""
    cuda = evaluator.device.type == "cuda"
    side = torch.cuda.Stream(evaluator.device) if cuda else None
    hook = on_first_batch

    def feed(preds, targets, inputs, templates, valid, ready):
        nonlocal hook
        if valid < batch_size:
            preds, targets, inputs = (trim_batch(preds, valid), trim_batch(targets, valid),
                                      trim_batch(inputs, valid))
            templates = None if templates is None else templates[:valid]
        with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
            if cuda:
                side.wait_event(ready)
            if hook is not None:
                hook(preds, targets)
                hook = None
            if templates is not None:
                evaluator.feed(preds, targets, inputs, templates)

    pending = None
    for inputs, targets, templates, valid in batches:
        device_inputs = {k: v for k, v in inputs.items() if k not in ("obj_cls", "obj_valid")}
        if cfg.transfer_dtype == "uint8":  # metrics keep the f32 inputs
            device_inputs = wire.encode_inputs(device_inputs)
        preds = eval_step(device_inputs)
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record()
        if pending is not None:
            feed(*pending)
        pending = (preds, targets, inputs, templates, valid, ready)
    if pending is not None:
        feed(*pending)


def synthetic_batches(cfg: Config, n: int, batch_size: int):
    """``n`` synthetic eval batches and random object templates (100
    vertices, 5 cm spread), as the JAX package's ``--synthetic`` draws them."""
    for i in range(n):
        inputs, targets = split_inputs_targets(synthetic_batch(cfg, batch_size, seed=i))
        templates = np.random.RandomState(0).randn(batch_size, 100, 3).astype(np.float32) * 0.05
        yield inputs, targets, templates, batch_size


def open_dataset(cfg: Config, split: str, mano_model, mano_left=None, seed: int = 0):
    """The preset's dataset of ``split`` ("train", or "test" for DexYCB's
    and "evaluation" for HO3D's eval split) from the paths in ``cfg``."""
    if cfg.dataset == "dexycb":
        return DexYCBDataset(cfg, split, mano_model, mano_left=mano_left, seed=seed)
    return HO3DDataset(cfg, "evaluation" if split == "test" else split, mano_model, seed=seed)


def dataset_batches(cfg: Config, loader: DataLoader, batch_size: int,
                    obj_root: Optional[str]):
    """``evaluate_batches``' batches from an eval split: the short tail
    padded to ``batch_size`` (the pad rows are trimmed before the metrics),
    and each sample's template, the simplified mesh of its object (main/
    test.py:84-118), or None without ``obj_root``.  DexYCB's ``obj_cls`` is
    the 1-based YCB id, the position in the sorted listing of ``obj_root``;
    HO3D's indexes ``HO3D_OBJECTS``, resolved by name in that listing
    (common/metrics.py:131-146)."""
    template_for = None
    if obj_root:
        templates_by_cls, obj_names = prepare_model_templates(obj_root)
        if cfg.dataset == "ho3d":
            name_pos = {n: i for i, n in enumerate(obj_names.values())}

            def template_for(c):
                return templates_by_cls[name_pos[HO3D_OBJECTS[int(c)]]]
        else:
            def template_for(c):
                return templates_by_cls[int(c) - 1]

    for batch in loader:
        inputs, targets = split_inputs_targets(batch)
        valid = int(inputs["obj_cls"].shape[0])
        if valid < batch_size:
            inputs, targets = pad_batch(inputs, batch_size), pad_batch(targets, batch_size)
        templates = (None if template_for is None
                     else np.stack([template_for(c) for c in inputs["obj_cls"]]))
        yield inputs, targets, templates, valid


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--setting", default="dexycb")
    p.add_argument("--ckpt", default=None, help="the port's snapshot dir (latest snapshot)")
    p.add_argument("--torch-ckpt", default=None,
                   help="an original snapshot_*.pth.tar to load and evaluate directly")
    p.add_argument("--mano", default=None, help="MANO .npz path override")
    p.add_argument("--cfg", action="append", default=[], metavar="KEY=VALUE",
                   help="config field override (repeatable, JSON-parsed values); the "
                        "dataset's paths and simple_object_models_dir for a real split")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic batches at the tiny model size instead of a dataset")
    p.add_argument("--batches", type=int, default=2, help="synthetic batches")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--out", default="outputs/result")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    overrides = dict(SYNTHETIC_TINY_OVERRIDES) if args.synthetic else {}
    overrides.update(parse_cfg_overrides(args.cfg))
    if args.mano:
        overrides["mano_model_path"] = args.mano
    cfg = get_config(args.setting, **overrides)
    device = torch.device("cpu" if args.cpu else "cuda")

    mano_model = (load_mano_npz(cfg.mano_model_path) if cfg.mano_model_path
                  else make_synthetic_mano(0))
    mano = ManoBuffers.from_model(mano_model)
    loader = None
    if not args.synthetic:
        if not cfg.simple_object_models_dir:
            raise SystemExit("evaluate: a dataset's eval needs --cfg "
                             "simple_object_models_dir=<the simplified YCB meshes>")
        mano_left = load_mano_npz(cfg.mano_left_path) if cfg.mano_left_path else None
        # the whole split, in order, the tail kept (common/base.py:163-169)
        loader = DataLoader(open_dataset(cfg, "test", mano_model, mano_left), args.batch_size,
                            num_workers=cfg.num_data_workers, drop_last=False,
                            worker_mode=cfg.data_worker_mode)
    model = build_model(cfg)
    if args.torch_ckpt:
        model.load_state_dict(ckpt_util.load_original_state(args.torch_ckpt, model),
                              strict=True)
    elif args.ckpt:
        network = ckpt_util.load_network(args.ckpt)
        if network is not None:
            model.load_state_dict(network, strict=True)

    eval_step = make_eval_step(cfg, model, mano, device=device)
    evaluator = Evaluator(cfg, mano, device=device)
    if loader is None:
        batches = synthetic_batches(cfg, args.batches, args.batch_size)
    else:
        batches = dataset_batches(cfg, loader, args.batch_size, cfg.simple_object_models_dir)
    try:
        evaluate_batches(cfg, eval_step, evaluator, batches, args.batch_size)
    finally:
        if loader is not None:
            loader.close()

    os.makedirs(args.out, exist_ok=True)
    path = evaluator.write_results(args.out)
    if cfg.dataset == "ho3d" and loader is not None:
        print("wrote", dump_codalab_json(args.out, evaluator.joint_list, evaluator.mesh_list))
    print("wrote", path)
    with open(path) as f:
        print(f.read())
    return path


if __name__ == "__main__":
    main()
