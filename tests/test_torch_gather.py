"""Kernel B of the PyTorch port (multi-level bilinear gather): its plain
PyTorch version against the JAX package's Pallas kernel (interpret mode),
its multi-level gather and the torch grid_sample golden.

Grids are drawn from ``rand * 2.2 - 1.1`` so the border clamp is exercised.
Tolerance: atol 1e-5 in f32 (the JAX package takes other formulations for
small levels, e.g. one-hot matmuls); 1e-2 for bf16 maps, whose result the port
rounds to bf16.
"""

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
from hoisdf_torch.ops.kernels.gather_lerp import gather_lerp, gather_lerp_plain
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
