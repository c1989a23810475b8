"""MANO constants and the synthetic MANO stand-in at MANO's shapes (a frozen
copy of the port's): the benchmark hands the same buffers to both sides."""

from __future__ import annotations

import dataclasses

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
