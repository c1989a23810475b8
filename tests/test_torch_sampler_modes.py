"""The port's dense scan ("full"), coarse2fine and nearest gather against the
JAX package's functions, with the same inputs on both sides.

The SDF is the L-infinity box distance of ``test_torch_sampler.py``: abs,
max and subtract only, so both sides compute bit-identical values, and the
lattice's symmetry gives many exact ties.  So selections must be identical,
order included (tolerance 0): the lattice points and the clamped sdf.  The
scenes cover a chunk smaller than the lattice (the running merge runs), a
bbox that admits fewer lattice points than K (the +inf ties decide which
points fill the rest) and a bbox that admits none.  The nearest gather is
held bitwise against ``grid_sample_nearest`` x 5 + concat, with grid points
at exact .5 texel positions, where rounding half to even decides.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.config import Config, get_config
from hoisdf_torch.ops import point_sampling as P
from hoisdf_torch.ops.kernels.gather_lerp import (gather_lerp, gather_nearest_plain,
                                                half_texel_coords)
from hoisdf_tpu.config import Config as JaxConfig
from hoisdf_tpu.ops import grid_sample as jgs
from hoisdf_tpu.ops import point_sampling as J

from test_torch_sampler import _box_sdf, _inputs

HALF = np.asarray([0.31, 0.17, 0.23], np.float32)
# name: (bins_n, num_points, bbox over the 64 x 64 image)
SCENES = {
    "wide": (16, 32, (0.0, 0.0, 64.0, 64.0)),
    "tight": (16, 32, (24.0, 26.0, 40.0, 37.0)),
    "sliver": (8, 64, (30.0, 30.0, 34.0, 34.0)),  # fewer in-box points than K
    "degenerate": (8, 16, (500.0, 500.0, 501.0, 501.0)),  # no point in the box
}


def _run_both(scene, jax_sampler, port_sampler, **kw):
    bins_n, k, bbox = SCENES[scene]
    cam, center = _inputs()
    bb = np.tile(np.asarray([bbox], np.float32), (2, 1))
    calls = []

    def port_sdf(p):
        calls.append(tuple(p.shape))
        return _box_sdf(p, torch.from_numpy(HALF), torch.abs, torch.maximum)

    want = jax_sampler(lambda p: _box_sdf(p, jnp.asarray(HALF), jnp.abs, jnp.maximum),
                       jnp.asarray(center), jnp.asarray(cam), jnp.asarray(bb), sdf_scale=3.1,
                       num_points=k, bins_n=bins_n, clamp=0.15, **kw)
    got = port_sampler(port_sdf, torch.from_numpy(center), torch.from_numpy(cam),
                       torch.from_numpy(bb), sdf_scale=3.1, num_points=k, bins_n=bins_n,
                       clamp=0.15, **kw)
    assert got[0].shape == (2, k, 3) and got[1].shape == (2, k, 1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.isfinite(got[1].numpy()).all()
    return calls, got


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("chunk_share", [1, 4], ids=["one-chunk", "four-chunks"])
def test_full_scan_selection_identical_to_jax(scene, chunk_share):
    n = SCENES[scene][0] ** 3
    calls, _ = _run_both(scene, J.sdf_guided_sample, P.sdf_guided_sample,
                         chunk=n // chunk_share)
    assert calls == [(2, n // chunk_share, 3)] * chunk_share


@pytest.mark.parametrize("scene", list(SCENES))
def test_coarse2fine_selection_identical_to_jax(scene):
    bins_n, k, _ = SCENES[scene]
    factor, keep = (4, 16) if bins_n == 16 else (2, 16)
    calls, _ = _run_both(scene, J.sdf_guided_sample_coarse2fine,
                         P.sdf_guided_sample_coarse2fine, coarse_factor=factor, keep_cells=keep)
    assert calls == [(2, (bins_n // factor) ** 3, 3), (2, keep * factor ** 3, 3)]


def test_sliver_scene_fills_from_outside_the_bbox():
    """Fewer in-box points than K: the rest is filled by +inf ties, which
    the dense scan's initial state (lattice point 0, sdf 0) wins."""
    _, (pts, sdf) = _run_both("sliver", J.sdf_guided_sample, P.sdf_guided_sample, chunk=128)
    origin = torch.full((3,), -1.0)
    assert (pts == origin).all(-1).sum() > 0 and (sdf == 0).any()


@pytest.mark.parametrize("bins_n,factor", [(64, 4), (16, 4), (16, 2), (64, 8)])
def test_coarse_probes_are_the_jax_block_means_bitwise(bins_n, factor):
    cb = bins_n // factor
    fine = jnp.asarray(J.make_lattice(bins_n)).reshape(cb, factor, cb, factor, cb, factor, 3)
    want = np.asarray(fine.mean(axis=(1, 3, 5)).reshape(-1, 3))
    got = P._coarse_probes(bins_n, factor, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(P.make_lattice(bins_n), J.make_lattice(bins_n))


def test_samplers_refuse_what_jax_cannot_run():
    cam, center = _inputs()
    args = (lambda p: p[..., 0], torch.from_numpy(center), torch.from_numpy(cam),
            torch.zeros(2, 4))
    with pytest.raises(ValueError, match="divide"):
        P.sdf_guided_sample(*args, sdf_scale=3.1, num_points=4, bins_n=8, chunk=100)
    with pytest.raises(ValueError, match="cannot give"):
        P.sdf_guided_sample_coarse2fine(*args, sdf_scale=3.1, num_points=200, bins_n=8,
                                        coarse_factor=2, keep_cells=16)


def test_per_item_scale_matches_jax():
    rng = np.random.RandomState(4)
    pts = rng.randn(4, 50, 3).astype(np.float32)
    center = rng.randn(4, 3).astype(np.float32)
    scales = np.asarray([3.1, 2.5, 3.1, 2.5], np.float32)
    want = J.scaled_to_cam(jnp.asarray(pts), jnp.asarray(center), jnp.asarray(scales))
    got = P.scaled_to_cam(torch.from_numpy(pts), torch.from_numpy(center),
                          torch.from_numpy(scales))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the nearest gather ------------------------------------------------------

SIZES = (32, 16, 8, 4, 2)  # the tiny pyramid's levels at a 64 x 64 input
CHANNELS = (8, 16, 32, 64, 128)


def _half_texel_grid(seed=5):
    """Points at exact .5 texel positions of each level (x and y computed as
    the gather computes them, in f32), random points, and points beyond the
    border: [2, P, 2] f32."""
    rng = np.random.RandomState(seed)
    half = half_texel_coords(SIZES)
    assert half.size >= 20
    xy = np.stack(np.meshgrid(half, half[::-1]), -1).reshape(-1, 2)
    rand = rng.uniform(-1.2, 1.2, size=(200, 2)).astype(np.float32)
    grid = np.concatenate([xy, rand], 0)
    return np.stack([grid, grid[::-1]]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nearest_plain_equals_jax_grid_sample_nearest_bitwise(dtype):
    rng = np.random.RandomState(6)
    grid = _half_texel_grid()
    maps = [rng.randn(2, s, s, c).astype(np.float32) for s, c in zip(SIZES, CHANNELS)]
    jmaps = [jnp.asarray(m).astype(dtype) for m in maps]
    want = jnp.concatenate([jgs.grid_sample_nearest(m, jnp.asarray(grid)) for m in jmaps], -1)
    want = np.asarray(want.astype(jnp.float32))
    tmaps = [torch.from_numpy(m).to(getattr(torch, dtype)) for m in maps]
    got = gather_nearest_plain(torch.from_numpy(grid), tmaps)
    assert got.dtype == tmaps[0].dtype and got.shape == (2, grid.shape[1], sum(CHANNELS))
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(gather_lerp(torch.from_numpy(grid), tmaps, nearest=True)
                                  .float().numpy(), want)
    # and JAX's multi-level entry point gives the same
    via_ms = jgs.multiscale_point_features(dict(zip("abcde", jmaps)), jnp.asarray(grid),
                                           list("abcde"), nearest=True, slice_gather=True)
    np.testing.assert_array_equal(np.asarray(via_ms.astype(jnp.float32)), want)


def test_nearest_gather_is_forward_only():
    grid = torch.from_numpy(_half_texel_grid())
    maps = [torch.randn(2, s, s, c, requires_grad=True) for s, c in zip(SIZES, CHANNELS)]
    with pytest.raises(ValueError, match="forward only"):
        gather_lerp(grid, maps, nearest=True)
    with torch.no_grad():
        assert gather_lerp(grid, maps, nearest=True).grad_fn is None


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nearest_kernel_matches_plain_on_card(dtype):
    grid = torch.from_numpy(_half_texel_grid()).cuda()
    maps = [torch.randn(2, s, s, c, device="cuda").to(dtype) for s, c in zip(SIZES, CHANNELS)]
    assert torch.equal(gather_lerp(grid, maps, nearest=True).cpu(),
                       gather_nearest_plain(grid.cpu(), [m.cpu() for m in maps]))


# ---- the config --------------------------------------------------------------

SAMPLER_FIELDS = ("sdf_infer_mode", "sdf_infer_chunk", "coarse_bins", "coarse_keep_cells",
                  "infer_gather_nearest", "paired_sdf_infer", "merged_field_queries",
                  "approx_selection_topk", "hier_levels", "hier_levels_obj")


def test_config_has_every_sampler_field_with_the_jax_default():
    port = {f.name: f.default for f in dataclasses.fields(Config)}
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    for name in SAMPLER_FIELDS:
        assert port[name] == jax_fields[name], name
    for mode in ("full", "coarse2fine", "hier"):
        assert get_config("dexycb", sdf_infer_mode=mode).sdf_infer_mode == mode
    with pytest.raises(ValueError, match="approx_selection_topk"):
        get_config("dexycb", approx_selection_topk=True)
    with pytest.raises(ValueError, match="sdf_infer_mode"):
        get_config("dexycb", sdf_infer_mode="dense")
    for tpu_only in ("fused_sdf_infer", "gather_chunked_max_table"):
        assert tpu_only in jax_fields and tpu_only not in port
        with pytest.raises(TypeError, match=tpu_only):
            get_config("dexycb", **{tpu_only: 0})


@pytest.mark.parametrize("center_z,equal", [(0.5, True), (0.05, False)],
                         ids=["in-front", "straddles-the-camera"])
def test_hier_final_stage_guard_against_the_dense_scan(center_z, equal):
    """A cascade that keeps every cell scores every lattice point, as the
    dense scan does, but its final stage takes the z-guarded bbox test
    (points at depth <= 1e-6 count as inside), where the dense scan divides
    unguarded: the two select the same points while the lattice lies in
    front of the camera, and differ once part of it lies behind.  The field
    is a sphere's, off the lattice's symmetry, so no two scores tie (the
    cascade lists its candidates cell by cell, not in lattice order).  The
    bbox is the quadrant right of and below the principal point: a point
    behind the camera projects mirrored, out of it, unless the guard counts
    it in."""
    cam, center = _inputs()
    center[:, 2] = center_z
    bb = np.tile(np.asarray([[32.5, 32.5, 1e3, 1e3]], np.float32), (2, 1))
    c = torch.tensor([0.113, -0.071, 0.052])
    args = (lambda p: torch.linalg.norm(p - c, dim=-1) - 0.537,
            torch.from_numpy(center), torch.from_numpy(cam), torch.from_numpy(bb))
    kw = dict(sdf_scale=3.1, num_points=48, bins_n=8, clamp=1.0)
    full, full_sdf = P.sdf_guided_sample(*args, chunk=512, **kw)
    hier, _ = P.sdf_guided_sample_hierarchical(*args, levels=((2, 64),), **kw)
    assert (full_sdf != 0).all()  # every pick scored in the box: no +inf fill
    ids = [np.sort(P_ids(x), 1) for x in (full, hier)]
    assert np.array_equal(*ids) == equal


def P_ids(points):
    step = 2.0 / 7
    ijk = np.rint((points.numpy().astype(np.float64) + 1.0) / step).astype(int)
    return (ijk[..., 0] * 8 + ijk[..., 1]) * 8 + ijk[..., 2]
