"""Tail-batch padding of the eval loop (``hoisdf_tpu/data/loader.py``).  The
loader itself comes with the real-data pipeline."""

from __future__ import annotations

from typing import Dict

import numpy as np


def pad_batch(d: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """Pad every array's leading dim to ``n`` by repeating its last row, so a
    short tail batch runs at the full batch shape; :func:`trim_batch` drops
    the rows again before the metrics."""
    return {k: np.concatenate([v] + [v[-1:]] * (n - v.shape[0]), axis=0)
            if v.shape[0] < n else v for k, v in d.items()}


def trim_batch(d: Dict, n: int) -> Dict:
    """Drop pad rows: slice every value's leading dim back to ``n``."""
    return {k: v[:n] for k, v in d.items()}
