"""Configuration of the PyTorch port (the DexYCB eval and train slices).

A copy of ``hoisdf_tpu.config`` trimmed to the fields the eval forward and
the train step read: the port imports nothing of the JAX package.  Field
names and defaults are the JAX package's, so the same overrides configure
both; a field the port does not have (an option of a path not ported yet) is
refused by name, and so is ``use_inverse_kinematics=True`` (the ho3d_render
head).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

# Settings this slice of the port serves (the dexycb eval forward: hier
# sampler, merged field queries, small decoder).  The ho3d presets need
# DecoderBig and the IK head, and dexycb_full the mesh metrics: not ported yet.
SETTINGS = ("dexycb",)


@dataclasses.dataclass(frozen=True)
class Config:
    setting: str = "dexycb"
    dataset: str = "dexycb"
    mano_model_path: Optional[str] = None  # npz of hoisdf_tpu.tools.convert_mano_pkl
    output_dir: str = "outputs"

    # ---- batch size --------------------------------------------------------
    train_batch_size: int = 22

    # ---- point sampling --------------------------------------------------
    num_samp_hand: int = 600
    num_samp_obj: int = 200
    # presample jitter: batch-progress thresholds and the move distance of
    # each band (main/config.py:64-69)
    random_ratio: Tuple[float, ...] = (0.3, 0.7)
    random_move_dist: Tuple[float, ...] = (0.03, 0.05, 0.07)
    hand_sdf_scale: float = 3.1
    obj_sdf_scale: float = 3.1
    hand_cls_dist: float = 0.04
    bins_n: int = 64
    num_class: int = 6
    point_feat_size: int = 33  # 30-d NeRF enc + xyz
    classifier_branch: bool = False
    clamping_distance: float = 0.15
    # (cell_factor, keep) cascade of the field-guided sampler
    hier_levels: tuple = ((8, 128), (4, 224), (2, 448))
    # object-field cascade; None = share hier_levels (gated at K <= 200)
    hier_levels_obj: tuple | None = ((8, 104), (4, 184), (2, 368))

    # ---- model -------------------------------------------------------------
    resnet_type: int = 50
    multiscale_layers: Tuple[str, ...] = (
        "stride2", "stride4", "stride8", "stride16", "stride32",
    )
    use_inverse_kinematics: bool = False  # ho3d_render's IK head: not ported
    input_img_shape: Tuple[int, int] = (256, 256)
    output_hm_shape: Tuple[int, int, int] = (128, 128, 128)
    sigma: float = 2.5 / 2
    hidden_dim: int = 256
    dropout: float = 0.1
    nheads: int = 4
    dim_feedforward: int = 1024
    enc_layers: int = 6
    dec_layers: int = 4
    mano_num_queries: int = 17  # 15 finger + 1 global + 1 shape
    mano_shape_indx: int = 16

    # ---- optimization (main/config.py:128-134) ------------------------------
    reference_init: bool = True  # from-scratch init (main/model.py:668-679)
    end_epoch: int = 70
    point_sampling_epoch: int = 40
    lr: float = 1e-4
    lr_decay_gamma: float = 0.7
    lr_drop: int = 9  # step every N epochs
    lr_floor: float = 1e-5  # common/base.py:30-32

    # ---- loss weights (main/config.py:136-151) ------------------------------
    sdf_hand_weight: float = 50.0
    sdf_obj_weight: float = 25.0
    sdf_cls_weight: float = 10.0
    hm_weight: float = 100 / 100000
    joint_weight: float = 1 / 10
    cls_weight: float = 1.0
    obj_hm_weight: float = 1.0
    obj_rot_weight: float = 0.7
    obj_trans_weight: float = 100.0
    lambda_verts3d: float = 1e4
    lambda_joints3d: float = 1e4
    lambda_manopose: float = 10.0
    lambda_manoshape: float = 0.1
    mano_lambda_regulshape: float = 1e-6

    compute_dtype: str = "float32"  # "bfloat16" for serving
    transfer_dtype: str = "float32"  # train/eval wire: "uint8" ships image bytes
    seed: int = 0

    @property
    def multiscale_dim(self) -> int:
        return 32 + 64 + 128 + 256 + 512

    @property
    def nerf_num_freqs(self) -> int:
        return (self.point_feat_size - 3) // 6

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.transfer_dtype not in ("float32", "uint8"):
            raise ValueError(f"transfer_dtype {self.transfer_dtype!r}")
        if self.use_inverse_kinematics:
            raise ValueError("use_inverse_kinematics=True (the ho3d_render IK head) "
                             "is not ported")
        # The stock object cascade is quality-gated at K <= 200 only; past the
        # gate fall back to the shared cascade, as the JAX package does.
        stock = type(self).__dataclass_fields__["hier_levels_obj"].default
        if self.hier_levels_obj == stock and self.num_samp_obj > 200:
            warnings.warn(
                f"num_samp_obj={self.num_samp_obj} exceeds the stock "
                "hier_levels_obj quality gate (K<=200); sharing hier_levels.",
                stacklevel=2,
            )
            object.__setattr__(self, "hier_levels_obj", None)


# The shrunken model of the synthetic smoke paths and the CPU tests.
SYNTHETIC_TINY_OVERRIDES = dict(
    resnet_type=18, hidden_dim=64, dim_feedforward=128, enc_layers=2,
    dec_layers=2, num_samp_hand=32, num_samp_obj=16,
    input_img_shape=(64, 64), output_hm_shape=(32, 32, 32), bins_n=16,
)


def get_config(setting: str = "dexycb", **overrides) -> Config:
    """Build a preset config (the dexycb presets of the JAX package)."""
    if setting not in SETTINGS:
        raise ValueError(f"setting {setting!r} is not ported (have {SETTINGS})")
    base = dict(setting=setting, dataset="dexycb")
    base.update(overrides)

    def _tup(v):
        return tuple(_tup(x) for x in v) if isinstance(v, list) else v

    return Config(**{k: _tup(v) for k, v in base.items()})


def parse_cfg_overrides(pairs) -> dict:
    """Parse repeatable CLI ``--cfg KEY=VALUE`` items; VALUE is JSON with a
    plain-string fallback (so paths need no quoting)."""
    import json

    out = {}
    for item in pairs:
        key, _, raw = item.partition("=")
        try:
            out[key] = json.loads(raw)
        except json.JSONDecodeError:
            out[key] = raw
    return out
