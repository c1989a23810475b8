"""Export the serving forward as a ``torch.export`` artifact
(``hoisdf_tpu/tools/export_stablehlo.py``).

The eval forward of a :class:`~hoisdf_torch.predictor.Predictor` (backbone,
SDF fields, field-guided sampling, transformers, MANO on the final decoder
layer; no ground-truth SDF supervision), with its weights as inputs, traced
by ``torch.export.export`` on the predictor's device.  The hand-written
kernels stay in the program as the custom ops ``hoisdf_torch::sdf_mlp`` and
``hoisdf_torch::gather_lerp``: on the card each call launches them, on the
CPU their plain versions run.

Layout written to OUT_DIR:

* ``model.pt2``       -- ``torch.export.save`` of the ``ExportedProgram``;
  call order ``(params_flat..., img, cam_intr, mano_root, obj_center_cam,
  bbox_hand, bbox_obj)``, with the image on the predictor's wire (u8 bytes
  or the [0, 1] f32 crop; the CLI's predictor takes f32, as the JAX CLI's)
* ``params.npz``      -- the model's state dict, flat ``{name: array}`` in
  the original torch key names
* ``signature.json``  -- input names, shapes and dtypes, output names, the
  flat parameter order, and ``ops``: the module that registers the kernels

Unlike the StableHLO blob, the program names custom ops: a loader imports
``hoisdf_torch.ops.kernels`` (``signature.json``'s ``ops``) before
``torch.export.load``.  Loader sketch::

    import importlib, json, numpy as np, torch
    sig = json.load(open("signature.json"))
    importlib.import_module(sig["ops"])
    prog = torch.export.load("model.pt2").module()
    flat = np.load("params.npz")
    params = [torch.from_numpy(flat[k]).to(dev) for k in sig["param_order"]]
    outs = prog(*params, img, cam_intr, root, obj_c, bb_h, bb_o)  # a dict

The program's constants (the MANO buffers, the u8 table, the cascade's
offsets) were made on the export's device, so it runs there.

Usage::

    python -m hoisdf_torch.tools.export out/export --setting dexycb \\
        [--ckpt run/model_dump | --ckpt snapshot_69.pth.tar] [--batch-size 8] \\
        [--polymorphic-batch] [--cpu] [--cfg K=V ...]
"""

from __future__ import annotations

import argparse
import json
import os
from collections.abc import Mapping
from typing import Dict, List, Tuple

import numpy as np
import torch

from hoisdf_torch.config import get_config, parse_cfg_overrides
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.models.mano_head import mano_head_pred
from hoisdf_torch.ops import wire
from hoisdf_torch.predictor import INPUT_KEYS, Predictor
from hoisdf_torch.train import vote_hand_joints
from hoisdf_torch.utils import checkpoint as ckpt_util

OPS_MODULE = "hoisdf_torch.ops.kernels"
OUTPUT_KEYS = ("mano_joints", "mano_verts", "hand_joints", "obj_rot", "obj_trans")


def flatten_params(tree, prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    """Deterministic (sorted) dotted-path flattening of a state dict or a
    nested mapping of tensors or arrays, to numpy."""
    out = []
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            out.extend(flatten_params(tree[k], f"{prefix}{k}."))
    else:
        v = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
        out.append((prefix[:-1], v))
    return out


def unflatten_params(flat: Dict[str, np.ndarray]):
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


class ServingForward(torch.nn.Module):
    """The exported function: the flat weights and the six inputs -> the
    five serving outputs (``OUTPUT_KEYS``), through
    ``torch.func.functional_call`` so that the weights are inputs."""

    def __init__(self, model: torch.nn.Module, mano, param_order: List[str]):
        super().__init__()
        self.model, self.mano, self.param_order = model, mano, param_order

    def forward(self, *args) -> Dict[str, torch.Tensor]:
        n = len(self.param_order)
        weights = dict(zip(self.param_order, args[:n]))
        inputs = wire.decode_inputs(dict(zip(INPUT_KEYS, args[n:])))
        out = torch.func.functional_call(self.model, weights, (inputs,),
                                         {"supervise_sdf": False})
        # the final decoder layer only, as the eval step
        pred_mano = mano_head_pred(self.mano, out["mano_pose6d"][-1:], out["mano_shape"][-1:])
        return {"mano_joints": pred_mano["joints3d"][-1],
                "mano_verts": pred_mano["verts3d"][-1],
                "hand_joints": vote_hand_joints(out),
                "obj_rot": out["obj_rot"][-1].mean(dim=1),
                "obj_trans": out["obj_trans"][-1].mean(dim=1)}


def export_serving_module(predictor, out_dir: str, *, polymorphic_batch: bool = False) -> str:
    """Export ``predictor``'s serving forward on its device and write it and
    its weights to ``out_dir`` (module docstring); returns the program's
    path.  With ``polymorphic_batch`` the batch is a ``torch.export.Dim``;
    otherwise the predictor's batch is baked in."""
    if predictor.cfg.use_inverse_kinematics:
        raise ValueError("export: the serving program covers the 6D pose head; the IK head "
                         "(ho3d_render) is not exported")
    dev = predictor.device
    state = predictor.model.state_dict()
    pflat = flatten_params(state)
    param_order = [k for k, _ in pflat]
    tmpl = {k: np.asarray(predictor._template[k]) for k in INPUT_KEYS}
    args = ([state[k].detach() for k in param_order]
            + [torch.from_numpy(tmpl[k]).to(dev) for k in INPUT_KEYS])
    dynamic = None
    if polymorphic_batch:
        b = torch.export.Dim("b", min=1, max=4096)
        dynamic = ((None,) * len(param_order) + ({0: b},) * len(INPUT_KEYS),)  # forward(*args)
    program = torch.export.export(
        ServingForward(predictor.model, predictor.mano.to(dev), param_order), tuple(args),
        dynamic_shapes=dynamic)

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model.pt2")
    torch.export.save(program, path)
    np.savez(os.path.join(out_dir, "params.npz"), **dict(pflat))
    sig = {
        "param_order": param_order,
        "inputs": {k: {"shape": ["b" if polymorphic_batch else v.shape[0], *v.shape[1:]],
                       "dtype": str(v.dtype)} for k, v in tmpl.items()},
        "input_order": list(INPUT_KEYS),
        "outputs": list(OUTPUT_KEYS),
        "batch_size": "b" if polymorphic_batch else predictor.batch_size,
        "setting": predictor.cfg.dataset,
        "ops": OPS_MODULE,
    }
    with open(os.path.join(out_dir, "signature.json"), "w") as f:
        json.dump(sig, f, indent=1)
    return path


def load_state(cfg, ckpt: str) -> Dict[str, torch.Tensor]:
    """``--ckpt``: a port snapshot directory (its latest snapshot) or an
    original ``snapshot_*.pth.tar``."""
    if os.path.isdir(ckpt):
        network = ckpt_util.load_network(ckpt)
        if network is None:
            raise FileNotFoundError(f"no snapshot under {ckpt}")
        return network
    return ckpt_util.load_original_state(ckpt, build_model(cfg))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--setting", default="dexycb")
    p.add_argument("--ckpt", default=None,
                   help="a port snapshot directory or an original snapshot_*.pth.tar")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--polymorphic-batch", action="store_true",
                   help="export with a symbolic leading dim (one artifact, any batch)")
    p.add_argument("--cpu", action="store_true", help="export on the CPU instead of the card")
    p.add_argument("--cfg", action="append", default=[], metavar="KEY=VALUE")
    args = p.parse_args(argv)
    overrides = {"sdf_infer_mode": "hier", "compute_dtype": "bfloat16"}
    overrides.update(parse_cfg_overrides(args.cfg))  # --cfg wins
    cfg = get_config(args.setting, **overrides)
    pred = Predictor(cfg, batch_size=args.batch_size, device="cpu" if args.cpu else "cuda",
                     state_dict=load_state(cfg, args.ckpt) if args.ckpt else None)
    path = export_serving_module(pred, args.out_dir, polymorphic_batch=args.polymorphic_batch)
    print("wrote", path)


if __name__ == "__main__":
    main()
