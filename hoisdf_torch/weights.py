"""Weight bridge: the JAX package's parameter trees -> this port's state dict.

The port's module tree carries the original PyTorch HOISDF key names
(``backbone_net.resnet.*``, ``decoder_net.resnet_decoder.*``,
``hand_sdf_decoder.linh{i}.weight_g`` ...), so an original snapshot loads
unchanged.  This module maps a flax ``(params, batch_stats)`` pair, given as
nested mappings of numpy arrays, onto those names with the layout rules

  conv      flax kernel [Kh,Kw,I,O]           -> torch [O,I,Kh,Kw]
  deconv    flax kernel [Kh,Kw,O,I] (transposed) -> torch [I,O,Kh,Kw]
  linear    flax kernel [I,O]                 -> torch [O,I]
  batchnorm scale/bias + mean/var             -> weight/bias + running stats
  weightnorm g [O] / v / bias                 -> weight_g [O,1] / weight_v / bias
  MHA       in_proj_* direct, out_proj kernel -> out_proj.weight (transposed)

It also adds the zero ``num_batches_tracked`` buffer of every BatchNorm, so
``load_state_dict(strict=True)`` accepts the result.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}
_HEAD_TO_TORCH = {"hm": "convOut_hm", "hand_seg": "convOut_hand_seg",
                  "obj_seg": "convOut_obj_seg"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _conv(w: np.ndarray) -> np.ndarray:  # [Kh,Kw,I,O] -> [O,I,Kh,Kw]
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def _deconv(w: np.ndarray) -> np.ndarray:  # [Kh,Kw,O,I] -> [I,O,Kh,Kw]
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def _linear(w: np.ndarray) -> np.ndarray:  # [I,O] -> [O,I]
    return np.ascontiguousarray(w.T)


def _backbone_key(path: Tuple[str, ...], stat: bool) -> str:
    pre = "backbone_net.resnet."
    bn = _BN_STAT if stat else _BN_PARAM
    if path[0] == "conv1":
        return pre + "conv1.weight"
    if path[0] == "bn1":
        return pre + "bn1." + bn[path[2]]
    stage, block = path[0].rsplit("_", 1)
    base = f"{pre}{stage}.{block}."
    sub = path[1]
    if sub == "downsample_conv":
        return base + "downsample.0.weight"
    if sub == "downsample_bn":
        return base + "downsample.1." + bn[path[3]]
    if sub.startswith("conv"):
        return base + sub + ".weight"
    return base + sub + "." + bn[path[3]]


def _decoder_key(path: Tuple[str, ...], stat: bool, head_depth: int) -> str:
    """``head_depth``: hidden convs of each head (1 in Decoder, 2 in DecoderBig)."""
    pre = "decoder_net.resnet_decoder."
    bn = _BN_STAT if stat else _BN_PARAM
    name = path[0]
    if name == "heads":
        stem, _, tail = path[1].rpartition("_")
        head = _HEAD_TO_TORCH[stem]
        if tail == "out":
            leaf = "weight" if path[2] == "kernel" else "bias"
            return f"{pre}{head}.{3 * head_depth}.{leaf}"
        k = int(tail)
        if path[2] == "conv":
            return f"{pre}{head}.{3 * k}." + ("weight" if path[3] == "kernel" else "bias")
        return f"{pre}{head}.{3 * k + 1}." + bn[path[4]]
    if name.startswith("deconv"):
        if path[1] == "deconv":
            return f"{pre}{name}.0.weight"
        return f"{pre}{name}.1." + bn[path[3]]
    if path[1] == "conv":
        return f"{pre}{name}.0." + ("weight" if path[2] == "kernel" else "bias")
    return f"{pre}{name}.1." + bn[path[3]]


def _transformer_entry(top: str, path: Tuple[str, ...], val: np.ndarray):
    stack = path[0]  # encoder | decoder
    if path[1].startswith("layer"):
        n = path[1][len("layer"):]
        sub = path[2]
        base = f"{top}.{stack}.layers.{n}.{sub}"
        if sub in ("self_attn", "multihead_attn"):
            if path[3] in ("in_proj_weight", "in_proj_bias"):
                return f"{base}.{path[3]}", val
            if path[4] == "kernel":
                return f"{base}.out_proj.weight", _linear(val)
            return f"{base}.out_proj.bias", val
        if sub in ("linear1", "linear2"):
            if path[3] == "kernel":
                return f"{base}.weight", _linear(val)
            return f"{base}.bias", val
        return f"{base}." + ("weight" if path[3] == "scale" else "bias"), val
    leaf = "weight" if path[2] == "scale" else "bias"  # inter_norm / norm
    return f"{top}.{stack}.{path[1]}.{leaf}", val


def _entry(path: Tuple[str, ...], v: np.ndarray, stat: bool, head_depth: int):
    top, rest = path[0], path[1:]
    if top == "backbone":
        return _backbone_key(rest, stat), (_conv(v) if v.ndim == 4 else v)
    if top == "decoder_net":
        if v.ndim == 4:
            deconv = rest[0].startswith("deconv") and rest[1] == "deconv"
            v = _deconv(v) if deconv else _conv(v)
        return _decoder_key(rest, stat, head_depth), v
    if top.endswith("_sdf_decoder"):
        layer, leaf = rest
        if leaf == "g":
            return f"{top}.{layer}.weight_g", v[:, None]
        if leaf == "v":
            return f"{top}.{layer}.weight_v", v
        if leaf == "kernel":
            return f"{top}.{layer}.weight", _linear(v)
        return f"{top}.{layer}.bias", v
    if top.endswith("_transformer"):
        return _transformer_entry(top, rest, v)
    if top.startswith("linear_"):
        layer, leaf = rest
        n = layer[len("layers_"):]
        if leaf == "kernel":
            return f"{top}.layers.{n}.weight", _linear(v)
        return f"{top}.layers.{n}.bias", v
    if top in ("hand_sigmoid_beta", "obj_sigmoid_beta"):
        return top, v
    if top == "mano_query_embed":
        return "mano_query_embed.weight", v
    raise ValueError(f"no torch mapping for param path {path}")


def state_dict_numpy_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, np.ndarray]:
    """The flax trees as original-layout numpy arrays (no BN counters).  The
    decoder's kind shows in its heads: DecoderBig's have two hidden convs."""
    heads = params.get("decoder_net", {}).get("heads", {})
    head_depth = sum(1 for k in heads if k.startswith("hm_") and k != "hm_out")
    state: Dict[str, np.ndarray] = {}
    for tree, stat in ((params, False), (batch_stats, True)):
        for path, v in _leaves(tree):
            key, val = _entry(path, v, stat, head_depth)
            state[key] = val
    return state


def state_dict_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """The flax trees as this port's state dict, ready for
    ``HOISDF.load_state_dict(..., strict=True)``."""
    state = {
        k: torch.from_numpy(np.ascontiguousarray(v).copy())
        for k, v in state_dict_numpy_from_jax(params, batch_stats).items()
    }
    for key in [k for k in state if k.endswith(".running_mean")]:
        state[key[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long
        )
    return state
