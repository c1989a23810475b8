"""Configuration of the PyTorch port: the four presets of the JAX package.

A copy of ``hoisdf_tpu.config`` trimmed to the fields the eval forward, the
evaluator, the train step and the data pipeline read: the port imports
nothing of the JAX package.  Field names and defaults are the JAX package's,
so the same overrides configure both; a field the port does not have (an
option of a path not ported yet) is refused by name.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

# Every preset of the JAX package; all four train and evaluate.
SETTINGS = ("ho3d", "ho3d_render", "dexycb", "dexycb_full")


@dataclasses.dataclass(frozen=True)
class Config:
    setting: str = "dexycb"
    dataset: str = "dexycb"
    # ---- paths (None => no dataset; main/config.py:46-58) --------------------
    object_models_dir: Optional[str] = None  # the YCB models' points.xyz clouds
    simple_object_models_dir: Optional[str] = None  # the simplified YCB meshes
    annotation_dir: Optional[str] = None
    data_dir: Optional[str] = None
    fast_data_dir: Optional[str] = None
    image_fast_path: Optional[str] = None
    output_dir: str = "outputs"
    mano_model_path: Optional[str] = None  # npz of hoisdf_tpu.tools.convert_mano_pkl
    mano_left_path: Optional[str] = None  # the left hand's npz (DexYCB's flipped samples)

    # ---- batch sizes (main/config.py:60-62) ---------------------------------
    train_batch_size: int = 22
    test_batch_size: int = 22
    eval_batch_size: int = 22

    # ---- point sampling --------------------------------------------------
    num_samp_hand: int = 600
    num_samp_obj: int = 200
    points_filter_dist: float = 0.05  # |sdf| below which a point is "near" (presampled)
    # presample jitter: batch-progress thresholds and the move distance of
    # each band (main/config.py:64-69)
    random_ratio: Tuple[float, ...] = (0.3, 0.7)
    random_move_dist: Tuple[float, ...] = (0.03, 0.05, 0.07)
    # ---- dataset-specific (main/config.py:70-85) -----------------------------
    add_render: bool = False
    small_dexycb: bool = True
    obj_depth_mean_value: Optional[float] = None
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
    use_big_decoder: bool = False  # the ho3d preset's full-width DecoderBig
    use_inverse_kinematics: bool = False  # ho3d_render: one shape query, joints by IK
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

    eval_mesh: bool = False  # dexycb_full: the mesh EPE/AUC and F-scores

    # ---- data loading ------------------------------------------------------
    num_data_workers: int = 15
    data_worker_mode: str = "thread"  # or "process" (data/loader.py)
    # The JAX package's native C++ image pipeline: "auto" takes the PIL path
    # here (the port has no native library yet), "off" is the PIL path, and
    # "on", which requires the library, is refused.
    native_pipeline: str = "auto"

    compute_dtype: str = "float32"  # "bfloat16" for serving
    transfer_dtype: str = "float32"  # train/eval wire: "uint8" ships image bytes
    seed: int = 0

    @property
    def multiscale_dim(self) -> int:
        # main/config.py:101-108 (at ResNet-50; DecoderBig passes the
        # backbone's stride32 map through, so a smaller ResNet narrows it)
        if self.use_big_decoder:
            return 128 + 256 + 512 + 1024 + 2048
        return 32 + 64 + 128 + 256 + 512

    @property
    def nerf_num_freqs(self) -> int:
        return (self.point_feat_size - 3) // 6

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.transfer_dtype not in ("float32", "uint8"):
            raise ValueError(f"transfer_dtype {self.transfer_dtype!r}")
        if self.data_worker_mode not in ("thread", "process"):
            raise ValueError(f"data_worker_mode {self.data_worker_mode!r}")
        if self.native_pipeline == "on":
            raise NotImplementedError(
                "native_pipeline='on' requires the native C++ image pipeline, which the "
                "port does not have yet (ROADMAP.md, Queue 1 item 2); 'auto' and 'off' "
                "take the PIL path")
        if self.native_pipeline not in ("auto", "off"):
            raise ValueError(f"native_pipeline {self.native_pipeline!r}")
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
    use_big_decoder=False,
)


def get_config(setting: str = "dexycb", **overrides) -> Config:
    """Build a preset config; the derivations of main/config.py:39-97."""
    if setting not in SETTINGS:
        raise ValueError(f"unknown setting {setting!r} (have {SETTINGS})")
    dataset = "ho3d" if "ho3d" in setting else "dexycb"
    base = dict(
        setting=setting,
        dataset=dataset,
        use_big_decoder=(setting == "ho3d"),
        use_inverse_kinematics=(setting == "ho3d_render"),
        eval_mesh=(setting == "dexycb_full"),
    )
    if dataset == "ho3d":
        base.update(add_render=("render" in setting), obj_depth_mean_value=0.5244322)
    else:
        base.update(small_dexycb=("full" not in setting))
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
