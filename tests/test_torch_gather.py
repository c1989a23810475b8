"""Kernel B of the PyTorch port (multi-level bilinear gather): its plain
PyTorch version against the JAX package's Pallas kernel (interpret mode),
its multi-level gather and the torch grid_sample golden; its backward
(autograd through the plain route) against ``jax.vjp`` of the JAX package's
multi-level gather on the grad path.

Grids are drawn from ``rand * 2.2 - 1.1`` so the border clamp is exercised.
Tolerance: atol 1e-5 in f32 (the JAX package takes other formulations for
small levels, e.g. one-hot matmuls); 1e-2 for bf16 maps, whose result the port
rounds to bf16.  Gradients: 2e-5 absolute + 1e-5 relative (sums of up to a few
hundred f32 terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.ops.grid_sample import (
    grid_sample_bilinear,
    multiscale_point_features,
    pixels_to_grid,
    project_points,
)
from hoisdf_torch.ops.kernels.build import BWD_COPIES_BYTES
from hoisdf_torch.ops.kernels.gather_lerp import (
    bwd_plan,
    gather_lerp,
    gather_lerp_bwd,
    gather_lerp_bwd_plain,
    gather_lerp_plain,
)
from hoisdf_tpu.ops import grid_sample as jgs
from hoisdf_tpu.ops.pallas.gather_lerp import fused_gather_lerp3

ATOL_F32 = 1e-5
ATOL_BF16 = 1e-2
LEVELS5 = {"stride2": (32, 32, 8), "stride4": (16, 16, 16), "stride8": (8, 8, 24),
           "stride16": (4, 4, 32), "stride32": (2, 2, 40)}
LEVELS_ODD = {"a": (16, 16, 6), "b": (8, 8, 10), "c": (3, 5, 7)}  # no 16-byte vectors


def _maps(b, dims, seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(b, *d).astype(np.float32) for k, d in dims.items()}


def _grid(b, p, seed=1):
    return (np.random.RandomState(seed).rand(b, p, 2) * 2.2 - 1.1).astype(np.float32)


def test_plain_matches_fused_gather_lerp3_interpret():
    maps = _maps(2, {"a": (16, 16, 8), "b": (8, 8, 16), "c": (4, 4, 32)})
    grid = _grid(2, 300)
    want = np.asarray(fused_gather_lerp3(
        jnp.asarray(grid), *[jnp.asarray(m) for m in maps.values()],
        tile=128, interpret=True))
    got = gather_lerp(torch.from_numpy(grid), [torch.from_numpy(m) for m in maps.values()])
    assert got.shape == (2, 300, 56) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)


@pytest.mark.parametrize("chunked", [0, 1024], ids=["gather", "chunked-matmul"])
def test_multiscale_matches_jax_five_levels(chunked):
    maps = _maps(3, LEVELS5)
    grid = _grid(3, 257)
    names = list(LEVELS5)
    want = np.asarray(jgs.multiscale_point_features(
        {k: jnp.asarray(v) for k, v in maps.items()}, jnp.asarray(grid), names,
        chunked_max_table=chunked))
    got = multiscale_point_features(
        {k: torch.from_numpy(v) for k, v in maps.items()}, torch.from_numpy(grid), names)
    assert got.shape == (3, 257, sum(d[2] for d in LEVELS5.values()))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)


def test_bf16_maps_round_the_f32_lerp():
    maps = _maps(2, LEVELS5, seed=3)
    grid = _grid(2, 100, seed=4)
    jmaps = [jnp.asarray(m).astype(jnp.bfloat16) for m in maps.values()]
    want = np.concatenate(
        [np.asarray(jgs.grid_sample_bilinear(m, jnp.asarray(grid)), np.float32) for m in jmaps],
        axis=-1)
    got = gather_lerp(torch.from_numpy(grid),
                      [torch.from_numpy(m).bfloat16() for m in maps.values()])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL_BF16, rtol=1e-2)


def test_grid_sample_golden(golden):
    g = golden("grid_sample")
    feats = torch.from_numpy(g["feats"]).permute(0, 2, 3, 1).contiguous()  # NCHW -> NHWC
    grid = torch.from_numpy(g["grid"][:, 0])  # [B,P,2]
    want = g["out"][:, :, 0].transpose(0, 2, 1)  # [B,C,1,P] -> [B,P,C]
    np.testing.assert_allclose(grid_sample_bilinear(feats, grid).numpy(), want, atol=ATOL_F32)
    np.testing.assert_allclose(gather_lerp_plain(grid, [feats]).numpy(), want, atol=ATOL_F32)


def test_projection_and_grid_match_jax():
    rng = np.random.RandomState(5)
    pts = (rng.rand(2, 40, 3) + np.array([0, 0, 0.5])).astype(np.float32)
    k = np.tile(np.array([[[230.4, 0, 128], [0, 230.4, 128], [0, 0, 1]]], np.float32), (2, 1, 1))
    want = np.asarray(jgs.pixels_to_grid(jgs.project_points(jnp.asarray(pts), jnp.asarray(k)),
                                         (256, 256)))
    got = pixels_to_grid(project_points(torch.from_numpy(pts), torch.from_numpy(k)), (256, 256))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


GRAD_TOL = dict(atol=2e-5, rtol=1e-5)


def _border_grid(b, p, seed=6):
    """Random points, the four corners, points on each edge and points
    beyond it (clamped to the border)."""
    grid = _grid(b, p, seed)
    grid[:, :8] = [[-1, -1], [1, 1], [1, -1], [-1, 1], [1, 0.3], [-0.2, -1], [1.5, 0.1],
                   [0.4, -2.0]]
    return grid


@pytest.mark.parametrize("levels", [LEVELS5, LEVELS_ODD], ids=["pyramid", "odd"])
def test_autograd_matches_jax_vjp_on_the_grad_path(levels):
    """d/dfeat of the port's gather (its autograd Function, plain route on
    the CPU) against jax.vjp of multiscale_point_features with
    slice_gather=False: the custom-VJP 4-corner scatter (_gsb_fast_bwd) on
    the large levels, autodiff of the one-hot matmul on the small ones.  The
    grid gets no gradient on either side (the JAX package stops it at the
    call, as its model does)."""
    maps = _maps(3, levels, seed=7)
    grid = _border_grid(3, 257)
    names = list(levels)
    c_total = sum(d[2] for d in levels.values())
    g = np.random.RandomState(8).randn(3, 257, c_total).astype(np.float32)

    def f(m, gr):
        return jgs.multiscale_point_features(m, jax.lax.stop_gradient(gr), names,
                                             slice_gather=False)

    _, vjp = jax.vjp(f, {k: jnp.asarray(v) for k, v in maps.items()}, jnp.asarray(grid))
    want_maps, want_grid = vjp(jnp.asarray(g))
    assert not np.asarray(want_grid).any()

    tmaps = {k: torch.from_numpy(v).requires_grad_() for k, v in maps.items()}
    tgrid = torch.from_numpy(grid).requires_grad_()
    out = multiscale_point_features(tmaps, tgrid, names)
    out.backward(torch.from_numpy(g))
    assert tgrid.grad is None
    for k in names:
        np.testing.assert_allclose(tmaps[k].grad.numpy(), np.asarray(want_maps[k]),
                                   err_msg=k, **GRAD_TOL)


def test_bwd_plain_matches_jax_gsb_fast_bwd_and_casts_to_the_maps_type():
    maps = _maps(2, {"a": (16, 16, 8)}, seed=9)
    feat = jnp.asarray(maps["a"])
    grid = _border_grid(2, 300)
    g = np.random.RandomState(10).randn(2, 300, 8).astype(np.float32)
    (want, dgrid) = jgs._gsb_fast_bwd((feat, jnp.asarray(grid)), jnp.asarray(g))
    assert not np.asarray(dgrid).any()
    (got,) = gather_lerp_bwd(torch.from_numpy(grid), torch.from_numpy(g), [(16, 16, 8)],
                             torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    (got16,) = gather_lerp_bwd(torch.from_numpy(grid), torch.from_numpy(g), [(16, 16, 8)],
                               torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), got.bfloat16().float().numpy())


def test_gather_outside_autograd_records_no_graph():
    maps = [torch.from_numpy(m).requires_grad_() for m in _maps(1, LEVELS5).values()]
    grid = torch.from_numpy(_grid(1, 9))
    with torch.no_grad():
        assert gather_lerp(grid, maps).grad_fn is None
    assert gather_lerp(grid, maps).grad_fn is not None


def _clustered_grid(b, p, seed=11):
    """Points packed into a few cells, as the cascade's selections are."""
    rng = np.random.RandomState(seed)
    centres = rng.rand(b, 4, 2) * 1.6 - 0.8
    pick = rng.randint(0, 4, (b, p))
    grid = np.take_along_axis(centres, pick[..., None], axis=1) + rng.randn(b, p, 2) * 0.02
    return grid.astype(np.float32)


PYRAMID = {"stride2": (128, 128, 32), "stride4": (64, 64, 64), "stride8": (32, 32, 128),
           "stride16": (16, 16, 256), "stride32": (8, 8, 512)}


def _bwd_parts(shapes, plan):
    """The parts of d/dfeat that the plan assigns: (level, first channel, end
    channel, copies) for each channel slice of a shared-route level, and the
    whole of each global-route level (copies 0)."""
    parts = []
    for i, ((_, _, c), (s, copies)) in enumerate(zip(shapes, plan)):
        if s:
            parts.extend((i, c0, min(c0 + s, c), copies) for c0 in range(0, c, s))
        else:
            parts.append((i, 0, c, copies))
    return parts


@pytest.mark.parametrize("levels", [PYRAMID, LEVELS5, LEVELS_ODD],
                         ids=["pyramid", "tiny", "odd"])
def test_bwd_plan_covers_every_image_level_channel_once(levels):
    """The backward's launch plan: each (level, channel) lies in exactly one
    part, for every image alike; each shared-route block's private copies fit
    the budget that the kernel is built with, and the kernel checks at compile
    time that the budget and its staging fit 227 KB of shared memory; at the
    production pyramid, stride16 and stride32 take the shared route and
    stride2-8 the global one."""
    shapes = [tuple(d) for d in levels.values()]
    plan = bwd_plan(shapes)
    assert len(plan) == len(shapes)
    offs = np.cumsum([0] + [c for _, _, c in shapes])
    cover = np.zeros(offs[-1], np.int32)
    for lv, c0, c1, copies in _bwd_parts(shapes, plan):
        h, w, c = shapes[lv]
        slice_ = plan[lv][0]
        assert 0 <= c0 < c1 <= c
        if slice_:
            assert h * w <= 256 and c1 - c0 <= slice_ <= 16 and 1 <= copies <= 16
            assert copies * h * w * slice_ * 4 <= BWD_COPIES_BYTES
        else:
            assert (c0, c1) == (0, c) and copies == 0 and h * w > 256
        cover[offs[lv] + c0:offs[lv] + c1] += 1
    assert (cover == 1).all()
    if levels is PYRAMID:  # stride16: 3 copies of 16 KB; stride32: 12 of 4 KB
        assert plan == ((0, 0), (0, 0), (0, 0), (16, 3), (16, 12))


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid_kind", ["uniform", "clustered", "border"])
@pytest.mark.parametrize("levels", [LEVELS5, LEVELS_ODD], ids=["vector", "scalar"])
def test_bwd_kernel_matches_plain_on_card(levels, grid_kind, dtype):
    """The backward kernel (atomics, so not bitwise repeatable) against its
    plain version: scaled error 1e-5 in f32; bf16 results within one bf16
    rounding (2^-8 relative) of the plain version's f32 sums (its bf16
    result is a second rounding, of sums taken in another order)."""
    b, p = 3, 700
    grid = {"uniform": _grid, "clustered": _clustered_grid, "border": _border_grid}[grid_kind](b, p)
    grid = torch.from_numpy(grid).cuda()
    shapes = [tuple(d) for d in levels.values()]
    c_total = sum(s[2] for s in shapes)
    g = torch.randn(b, p, c_total, generator=torch.Generator().manual_seed(12)).to("cuda", dtype)
    got = gather_lerp_bwd(grid, g, shapes, dtype)
    torch.cuda.synchronize()
    want = gather_lerp_bwd_plain(grid, g, shapes, torch.float32)
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        scale = max(w.float().abs().max().item(), 1.0)
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
        assert (a.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,points", [(2, 333), (1, 5), (3, 4000)])
@pytest.mark.parametrize("levels", [LEVELS5, LEVELS_ODD], ids=["vector", "scalar"])
def test_kernel_matches_plain_on_card(levels, dtype, batch, points):
    """Few points a block: the coarsest maps alone are staged in shared
    memory; many: every level that fits.  Channel counts that are no multiple
    of a 16-byte vector take the scalar path.  Bit-identical in every case."""
    maps = [torch.from_numpy(m).to("cuda", dtype) for m in _maps(batch, levels).values()]
    grid = torch.from_numpy(_grid(batch, points)).cuda()
    got = gather_lerp(grid, maps)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_lerp_plain(grid, maps))
