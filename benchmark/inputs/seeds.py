"""Sub-seeds of a run's ``--seed``: one stream per purpose, so a change to
one draw never shifts another.  Any whole number up to 2**63 is taken."""

from __future__ import annotations

import numpy as np

PURPOSES = ("weights", "frames", "arrivals", "sample", "order", "generator")


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A numpy generator for ``purpose`` under ``seed``."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), PURPOSES.index(purpose)]))


def torch_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for a ``torch.Generator``, for ``purpose`` under ``seed``."""
    return int(rng(seed, purpose).integers(0, 2**63 - 1))
