"""The work of one launch of the IK solve (``hoisdf_torch::ik_solve``): its
operations and bytes, for its roofline.

A frame's operations, counted as the solve needs them (a multiply-add is
two, a division, square root or transcendental one):

- the Kabsch covariance: the ten knuckle directions (30 subtractions) and
  the 3 x 3 sum of five outer products (45 multiply-adds);
- the fixed Jacobi sweeps: each rotation forms three 3-term dot products
  (15), its angle (12: zeta, t, c and s) and turns a pair of columns of the
  matrix and of V (36); three rotations a sweep, six sweeps;
- U, R and its flag: three column norms (18), two columns normalised (6),
  a cross product (9), its sign (6), R as three outer products (45) and its
  determinant (14); R to axis-angle (40);
- the 15 bone solves: the bone's template direction and parent bone (6),
  the reconstructed joint (18), the target direction in the parent frame
  (18), the axis (9 + 6 + 3), the cosine (5 + 8 + 2), the clamp, arccos and
  axis-angle (6); and for the ten bones that have a child, the Rodrigues
  matrix (40) and the next parent frame (45).

Bytes: the target and template joints in (two [21, 3] f32 a frame), the
pose out ([48] f32) and the flag (one int32).
"""

from __future__ import annotations

from typing import Dict

SWEEPS = 6
COVARIANCE = 30 + 2 * 45
ROTATION = 15 + 12 + 36
KABSCH = COVARIANCE + 3 * SWEEPS * ROTATION + 18 + 6 + 9 + 6 + 45 + 14 + 40
BONE = 6 + 18 + 18 + 18 + 15 + 6
CHILD_FRAME = 40 + 45


def ik_solve_ops(batch: int) -> int:
    """Operations of one launch over ``batch`` frames."""
    return batch * (KABSCH + 15 * BONE + 10 * CHILD_FRAME)


def ik_solve_bytes(batch: int) -> int:
    """Bytes of one launch: inputs read once, outputs written once."""
    return batch * (2 * 21 * 3 * 4 + 48 * 4 + 4)


def ik_solve_bound_s(batch: int, pk: Dict[str, float]) -> float:
    """The launch's bound: its operations at the f32 peak or its bytes at
    the bandwidth, whichever is longer."""
    return max(ik_solve_ops(batch) / pk["float32"], ik_solve_bytes(batch) / pk["bytes"])
