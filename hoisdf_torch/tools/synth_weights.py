"""Deterministic synthetic state-dict values for conv-stack golden fixtures
(a copy of ``hoisdf_tpu/tools/synth_weights.py``; numpy only).

Committing real random weights for the ResNet-50 + decoder parity goldens
would cost ~100 MB; instead the fixture stores only the state-dict *spec*
(key names + shapes) plus inputs and reference outputs, and BOTH sides — the
torch-side generator (``hoisdf_tpu.tools.gen_goldens``) and the flax-side
parity test (``tests/test_golden_backbone.py``) — regenerate identical values
from a per-key crc32 seed.

Value distributions are chosen so a 50-layer random network stays numerically
sane in eval mode: conv/linear weights are fan-in scaled, BN running stats
stay near (0, 1), and BN scales near 1.
"""

from __future__ import annotations

import json
import zlib
from typing import Dict, List, Tuple

import numpy as np


def synth_value(key: str, shape, seed: int = 0) -> np.ndarray:
    """Deterministic value for one state-dict entry, keyed by name."""
    rs = np.random.RandomState((zlib.crc32(key.encode()) ^ seed) & 0x7FFFFFFF)
    shape = tuple(int(s) for s in shape)
    if key.endswith("running_var"):
        return rs.uniform(0.8, 1.6, shape).astype(np.float32)
    if key.endswith("running_mean"):
        return (rs.standard_normal(shape) * 0.2).astype(np.float32)
    if len(shape) == 4:  # conv [O,I,Kh,Kw] / deconv [I,O,Kh,Kw]
        # deliberately sub-kaiming (0.5x): with *random* BN eval stats the
        # residual branches are un-normalized, and full kaiming compounds to
        # ~2000x activations by stride32 — which would turn the 1e-3 parity
        # tolerance into a no-op relative check
        fan_in = shape[1] * shape[2] * shape[3]
        return (rs.standard_normal(shape) * (0.5 * np.sqrt(2.0 / fan_in))).astype(
            np.float32
        )
    if len(shape) == 2:  # linear [O,I]
        return (rs.standard_normal(shape) * np.sqrt(1.0 / shape[1])).astype(
            np.float32
        )
    if key.endswith("bias"):
        return (rs.standard_normal(shape) * 0.1).astype(np.float32)
    # remaining 1-D weights are BN scales (kept below 1 to damp the
    # residual-sum variance growth across 16 blocks)
    return rs.uniform(0.55, 0.9, shape).astype(np.float32)


def spec_from_items(items: List[Tuple[str, Tuple[int, ...]]]) -> str:
    """Serialize a state-dict spec (list of (key, shape)) to JSON."""
    return json.dumps([[k, list(s)] for k, s in items])


def synth_state_dict(spec_json: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """Regenerate the full state dict from a serialized spec."""
    return {
        k: synth_value(k, shape, seed) for k, shape in json.loads(spec_json)
    }
