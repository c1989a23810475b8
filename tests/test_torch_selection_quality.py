"""The port's dense-scan quality gate (``hoisdf_torch/ops/selection_quality.py``)
at the production scale (64^3 lattice, K = 600 hand / 200 object points):
its report on the stress scene against the JAX package's, and the gate on
the port's own samplers, as ``tests/test_point_sampling.py`` holds the JAX
package's.  The port's dense scan is the oracle, so this gates the port's
"hier" defaults on their own terms, not only against JAX's cascade.

Tolerances: ``overlap_at_k`` equal to the JAX report's; the |sdf| ratios and
the rank correlation within 1e-4 absolute.  The fields are distances through
p^2 + v^2 - 2 p.v, which cancels near the surface (|p - v| << |p|), so the
two packages' roundings (MANO, the matmul) move a selected point's |sdf| by
up to about 1e-4 relative (measured: 3.7e-5 on ``max_abs_ratio``).  The gate's
bar: overlap >= 0.99 for the defaults at every batch item.
"""

import numpy as np
import pytest

from hoisdf_torch.config import Config
from hoisdf_torch.ops import selection_quality as Q
from hoisdf_tpu.ops import selection_quality as JQ

from torch_port_util import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCALE = dict(sdf_scale=3.1, bins_n=64)


@pytest.fixture(scope="module")
def scene(one_torch_thread):
    return Q.stress_geometry(batch=2, seed=3)


def _check_passes(rep):
    assert Q.gate(rep), rep
    assert (rep["overlap_at_k"] >= 0.99).all(), rep["overlap_at_k"]


def test_report_equals_the_jax_report_and_hand_default_passes(scene):
    levels = Config().hier_levels
    rep = Q.selection_quality(*scene, num_points=600, levels=levels, **SCALE)
    want = JQ.selection_quality(*JQ.stress_geometry(batch=2, seed=3), num_points=600,
                                levels=levels, **SCALE)
    assert set(rep) == set(want)
    np.testing.assert_array_equal(rep["overlap_at_k"], want["overlap_at_k"])
    for k in ("mean_abs_ratio", "max_abs_ratio", "rank_corr"):
        np.testing.assert_allclose(rep[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    _check_passes(rep)


def test_object_default_passes_at_its_k(scene):
    levels = Config().hier_levels_obj
    assert levels is not None
    _check_passes(Q.selection_quality(*scene, num_points=200, levels=levels, **SCALE))


def test_cheaper_levels_fail_the_gate(scene):
    rep = Q.selection_quality(*scene, num_points=600, levels=((4, 128), (2, 256)), **SCALE)
    assert not Q.gate(rep), rep


def test_defaults_pass_on_the_perturbed_field():
    """A smooth-noise field (a trained decoder's error; local Lipschitz
    violations up to ~0.59) on the scene where the JAX package's sweep
    measured its worst case (seed 7)."""
    field, center, cam, bbox = Q.stress_geometry(batch=2, seed=7)
    noisy = Q.perturbed_field(field, seed=0)
    for k, levels in ((600, Config().hier_levels), (200, Config().hier_levels_obj)):
        _check_passes(Q.selection_quality(noisy, center, cam, bbox, num_points=k,
                                          levels=levels, **SCALE))


def test_hand_geometry_field_is_the_jax_field():
    import jax.numpy as jnp
    import torch

    pts = np.random.RandomState(0).uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    got = Q.hand_geometry_field()(torch.from_numpy(pts)).numpy()
    want = np.asarray(JQ.hand_geometry_field()(jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(Q._lattice_keys(np.zeros((1, 3), np.float32), 64),
                          JQ._lattice_keys(np.zeros((1, 3), np.float32), 64))
