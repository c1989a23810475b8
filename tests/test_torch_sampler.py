"""The PyTorch port's hierarchical field-guided sampler against the JAX
package's, with the same analytic SDF on both sides.

The SDF is an L-infinity box distance, computed with abs/max/subtract only,
so both sides produce bit-identical values and the lattice symmetry yields
many exact ties: the selections must be identical, order included (stable
argsort breaks ties by the lower index, like ``lax.top_k``).  The tight-bbox
scenes put most probes out of the box, where every score ties at +inf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.ops import point_sampling as P
from hoisdf_tpu.ops import point_sampling as J

SCENES = {
    # name: (bins_n, levels, num_points, bbox (x0, y0, x1, y1) over a 64x64 image)
    "tiny-wide": (16, ((8, 128), (4, 224), (2, 448)), 32, (0.0, 0.0, 64.0, 64.0)),
    "tiny-tight": (16, ((8, 128), (4, 224), (2, 448)), 32, (24.0, 26.0, 40.0, 37.0)),
    "b32-tight": (32, ((8, 32), (4, 64), (2, 128)), 100, (20.0, 22.0, 45.0, 41.0)),
    "b32-obj": (32, ((8, 26), (4, 46), (2, 92)), 40, (10.0, 12.0, 50.0, 55.0)),
}


def _inputs(b=2):
    cam = np.tile(np.array([[[200.0, 0, 32], [0, 200, 32], [0, 0, 1]]], np.float32), (b, 1, 1))
    center = np.array([[0.0, 0.0, 0.5], [0.01, -0.02, 0.55]][:b], np.float32)
    return cam, center


def _box_sdf(p, half, absf, maxf):
    d = absf(p) - half
    return maxf(maxf(d[..., 0], d[..., 1]), d[..., 2])


@pytest.mark.parametrize("scene", list(SCENES))
def test_hier_selection_identical_to_jax(scene):
    bins_n, levels, k, bbox = SCENES[scene]
    cam, center = _inputs()
    bb = np.tile(np.asarray([bbox], np.float32), (2, 1))
    half = np.asarray([0.31, 0.17, 0.23], np.float32)
    calls = []

    def jax_sdf(p):
        return _box_sdf(p, jnp.asarray(half), jnp.abs, jnp.maximum)

    def port_sdf(p):
        calls.append(tuple(p.shape))
        return _box_sdf(p, torch.from_numpy(half), torch.abs, torch.maximum)

    want_pts, want_sdf = J.sdf_guided_sample_hierarchical(
        jax_sdf, jnp.asarray(center), jnp.asarray(cam), jnp.asarray(bb),
        sdf_scale=3.1, num_points=k, bins_n=bins_n, levels=levels, clamp=0.15)
    got_pts, got_sdf = P.sdf_guided_sample_hierarchical(
        port_sdf, torch.from_numpy(center), torch.from_numpy(cam), torch.from_numpy(bb),
        sdf_scale=3.1, num_points=k, bins_n=bins_n, levels=levels, clamp=0.15)
    assert got_pts.shape == (2, k, 3) and got_sdf.shape == (2, k, 1)
    assert len(calls) == len(levels) + 1  # one probe per cascade stage
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))
    np.testing.assert_array_equal(got_sdf.numpy(), np.asarray(want_sdf))


def test_bbox_tests_match_jax():
    """The z-guarded point test and the 8-corner cell test, including points
    behind the camera (the guard's case)."""
    rng = np.random.RandomState(0)
    cam, center = _inputs()
    center[1, 2] = 0.05  # part of the lattice sits at z <= 0
    bb = np.tile(np.asarray([[10.0, 12.0, 50.0, 55.0]], np.float32), (2, 1))
    pts = (rng.rand(2, 500, 3) * 2 - 1).astype(np.float32)
    args_j = (jnp.asarray(center), jnp.asarray(cam), jnp.asarray(bb), 3.1)
    args_p = (torch.from_numpy(center), torch.from_numpy(cam), torch.from_numpy(bb), 3.1)
    for guard in (False, True):
        np.testing.assert_array_equal(
            P._in_bbox(torch.from_numpy(pts), *args_p, z_guard=guard).numpy(),
            np.asarray(J._in_bbox(jnp.asarray(pts), *args_j, z_guard=guard)))
    for factor in (1, 2, 4):
        step = 2.0 / 63
        np.testing.assert_array_equal(
            P._cell_overlaps_bbox(torch.from_numpy(pts), factor, step, *args_p).numpy(),
            np.asarray(J._cell_overlaps_bbox(jnp.asarray(pts), factor, step, *args_j)))


def test_smallest_breaks_ties_by_lower_index():
    score = torch.tensor([[3.0, float("inf"), 1.0, 1.0, float("inf"), 0.5, 1.0]])
    np.testing.assert_array_equal(P._smallest(score, 6).numpy(), [[5, 2, 3, 6, 0, 1]])
