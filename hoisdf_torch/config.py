"""Configuration of the PyTorch port (the DexYCB eval slice).

A copy of ``hoisdf_tpu.config`` trimmed to the fields the eval forward reads:
the port imports nothing of the JAX package.  Field names and defaults are
the JAX package's, so the same overrides configure both; a field the port
does not have (an option of a path not ported yet) is refused by name.
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

    # ---- point sampling --------------------------------------------------
    num_samp_hand: int = 600
    num_samp_obj: int = 200
    hand_sdf_scale: float = 3.1
    obj_sdf_scale: float = 3.1
    bins_n: int = 64
    point_feat_size: int = 33  # 30-d NeRF enc + xyz
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
    input_img_shape: Tuple[int, int] = (256, 256)
    hidden_dim: int = 256
    nheads: int = 4
    dim_feedforward: int = 1024
    enc_layers: int = 6
    dec_layers: int = 4
    mano_num_queries: int = 17  # 15 finger + 1 global + 1 shape
    mano_shape_indx: int = 16
    compute_dtype: str = "float32"  # "bfloat16" for serving

    @property
    def multiscale_dim(self) -> int:
        return 32 + 64 + 128 + 256 + 512

    @property
    def nerf_num_freqs(self) -> int:
        return (self.point_feat_size - 3) // 6

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
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
    input_img_shape=(64, 64), bins_n=16,
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
