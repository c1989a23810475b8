"""MANO model buffers (numpy): loading, conversion and the synthetic stand-in.

A copy of ``hoisdf_tpu/mano/model.py``.  The framework loads an ``.npz``
that :func:`convert_mano_pkl` makes once from the original
``MANO_{RIGHT,LEFT}.pkl`` without chumpy (``python -m
hoisdf_torch.tools.convert_mano_pkl``), or uses ``make_synthetic_mano`` when
no MANO assets are present.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import types
from typing import Optional

import numpy as np

NUM_VERTS = 778
NUM_JOINTS = 16  # kinematic joints (root + 15)
NUM_POSE = 45
NUM_SHAPE = 10

# Fingertip vertex indices appended as extra joints.
TIPS_RIGHT = (745, 317, 444, 556, 673)
TIPS_LEFT = (745, 317, 445, 556, 673)
# Joint reorder applied after appending the tips.
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)
# FK levels: per-finger chains, base -> tip.
LEV1_IDXS = (1, 4, 7, 10, 13)
LEV2_IDXS = (2, 5, 8, 11, 14)
LEV3_IDXS = (3, 6, 9, 12, 15)
# Transform reorder back to joint order.
TRANSFORM_REORDER = (0, 1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 5, 10, 15)


@dataclasses.dataclass(frozen=True)
class ManoModel:
    betas: np.ndarray  # [10]
    shapedirs: np.ndarray  # [778, 3, 10]
    posedirs: np.ndarray  # [778, 3, 135]
    v_template: np.ndarray  # [778, 3]
    j_regressor: np.ndarray  # [16, 778]
    weights: np.ndarray  # [778, 16]
    faces: np.ndarray  # [F, 3] int32
    hands_components: np.ndarray  # [45, 45]
    hands_mean: np.ndarray  # [45]
    side: str = "right"

    @property
    def tips(self):
        return TIPS_RIGHT if self.side == "right" else TIPS_LEFT


def save_mano_npz(model: ManoModel, path: str) -> None:
    np.savez(
        path,
        betas=model.betas,
        shapedirs=model.shapedirs,
        posedirs=model.posedirs,
        v_template=model.v_template,
        j_regressor=model.j_regressor,
        weights=model.weights,
        faces=model.faces,
        hands_components=model.hands_components,
        hands_mean=model.hands_mean,
        side=np.array(model.side),
    )


def load_mano_npz(path: str) -> ManoModel:
    with np.load(path, allow_pickle=False) as z:
        return ManoModel(
            betas=z["betas"].astype(np.float32),
            shapedirs=z["shapedirs"].astype(np.float32),
            posedirs=z["posedirs"].astype(np.float32),
            v_template=z["v_template"].astype(np.float32),
            j_regressor=z["j_regressor"].astype(np.float32),
            weights=z["weights"].astype(np.float32),
            faces=z["faces"].astype(np.int32),
            hands_components=z["hands_components"].astype(np.float32),
            hands_mean=z["hands_mean"].astype(np.float32),
            side=str(z["side"]),
        )


def _install_chumpy_stub():
    """Register minimal 'chumpy' modules so MANO pkls unpickle without chumpy."""
    if "chumpy" in sys.modules:
        return

    class _ChStub:
        # chumpy.Ch pickles via its instance __dict__; the dense array lives
        # under one of a few attribute names depending on the node type.
        def __setstate__(self, state):
            self.__dict__.update(state)

        @property
        def r(self):
            for key in ("x", "a", "v"):
                v = self.__dict__.get(key)
                if isinstance(v, np.ndarray):
                    return v
                if hasattr(v, "r"):
                    return v.r
            for v in self.__dict__.values():
                if isinstance(v, np.ndarray) and v.size > 1:
                    return v
            raise ValueError("could not extract ndarray from chumpy stub")

    mod = types.ModuleType("chumpy")
    ch_mod = types.ModuleType("chumpy.ch")
    for name in ("Ch", "Cw"):
        setattr(mod, name, _ChStub)
        setattr(ch_mod, name, _ChStub)
    reordering = types.ModuleType("chumpy.reordering")
    for name in ("Select", "transpose", "Transpose"):
        setattr(reordering, name, _ChStub)
    mod.ch = ch_mod
    sys.modules["chumpy"] = mod
    sys.modules["chumpy.ch"] = ch_mod
    sys.modules["chumpy.reordering"] = reordering


def _dense(v) -> np.ndarray:
    if hasattr(v, "toarray"):  # scipy sparse
        return np.asarray(v.toarray())
    if hasattr(v, "r"):  # chumpy stub
        return np.asarray(v.r)
    return np.asarray(v)


def convert_mano_pkl(pkl_path: str, side: Optional[str] = None) -> ManoModel:
    """Convert an original MANO_{RIGHT,LEFT}.pkl into a :class:`ManoModel`.

    Chumpy-free replacement for the reference's ``ready_arguments``
    (smpl_handpca_wrapper_HAND_only.py:22-67).
    """
    _install_chumpy_stub()
    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if side is None:
        side = "left" if "LEFT" in pkl_path.upper() else "right"
    nposedirs = _dense(data["posedirs"]).reshape(NUM_VERTS, 3, -1)
    return ManoModel(
        betas=np.zeros(NUM_SHAPE, np.float32),
        shapedirs=_dense(data["shapedirs"]).astype(np.float32),
        posedirs=nposedirs.astype(np.float32),
        v_template=_dense(data["v_template"]).astype(np.float32),
        j_regressor=_dense(data["J_regressor"]).astype(np.float32),
        weights=_dense(data["weights"]).astype(np.float32),
        faces=_dense(data["f"]).astype(np.int32),
        hands_components=_dense(data["hands_components"]).astype(np.float32),
        hands_mean=_dense(data["hands_mean"]).astype(np.float32),
        side=side,
    )


def make_synthetic_mano(seed: int = 0, side: str = "right") -> ManoModel:
    """Structurally valid random MANO stand-in with the real shapes and
    dtypes (the same draws as the JAX package's, so both sides agree)."""
    rng = np.random.RandomState(seed)
    v_template = rng.randn(NUM_VERTS, 3).astype(np.float32) * 0.01
    v_template[:, 0] += np.linspace(-0.04, 0.09, NUM_VERTS).astype(np.float32)
    v_template[:, 1] += 0.02 * np.sin(np.linspace(0, 6.0, NUM_VERTS)).astype(np.float32)

    shapedirs = (rng.randn(NUM_VERTS, 3, NUM_SHAPE) * 0.003).astype(np.float32)
    posedirs = (rng.randn(NUM_VERTS, 3, 9 * 15) * 0.001).astype(np.float32)

    j_regressor = np.zeros((NUM_JOINTS, NUM_VERTS), np.float32)
    centers = np.linspace(30, NUM_VERTS - 30, NUM_JOINTS)
    idx = np.arange(NUM_VERTS)
    for j, c in enumerate(centers):
        w = np.exp(-0.5 * ((idx - c) / 25.0) ** 2)
        j_regressor[j] = w / w.sum()

    d = np.abs(idx[:, None] - centers[None, :])
    weights = np.exp(-0.5 * (d / 40.0) ** 2).astype(np.float32)
    weights /= weights.sum(axis=1, keepdims=True)

    faces = rng.randint(0, NUM_VERTS, size=(1538, 3)).astype(np.int32)
    q, _ = np.linalg.qr(rng.randn(NUM_POSE, NUM_POSE))
    hands_components = q.astype(np.float32)
    hands_mean = (rng.randn(NUM_POSE) * 0.1).astype(np.float32)

    return ManoModel(
        betas=np.zeros(NUM_SHAPE, np.float32), shapedirs=shapedirs,
        posedirs=posedirs, v_template=v_template, j_regressor=j_regressor,
        weights=weights, faces=faces, hands_components=hands_components,
        hands_mean=hands_mean, side=side,
    )
