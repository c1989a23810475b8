"""Kernel A of the PyTorch port (fused SDF MLP): its plain PyTorch version
against the JAX package's Pallas kernel (interpret mode) and plain oracle.

Tolerance: atol 1e-5 in f32 (summation order only); 2e-2 in bf16, where
activations round to bf16 between layers and a different f32 summation order
can flip a rounding (tanh output in [-1, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.models.sdf_decoder import SDFDecoder as PortSDFDecoder
from hoisdf_torch.ops.kernels.sdf_mlp import (
    fold_weight_norm,
    prepare_weights,
    sdf_mlp,
    sdf_mlp_plain,
)
from hoisdf_tpu.models.sdf_decoder import SDFDecoder
from hoisdf_tpu.ops.pallas import sdf_mlp as jax_sdf_mlp

ATOL_F32 = 1e-5
ATOL_BF16 = 2e-2


def _decoders(latent_size):
    """A flax SDFDecoder with random (non-trivial) params and the port's
    decoder holding the same values."""
    dec = SDFDecoder(latent_size=latent_size, point_feat_size=33)
    params = dec.init(jax.random.PRNGKey(latent_size), jnp.zeros((2, latent_size + 33)))
    rng = np.random.RandomState(latent_size)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.randn(*v.shape).astype(np.float32) * 0.05,
        params["params"])
    port = PortSDFDecoder(latent_size, 33)
    with torch.no_grad():
        for i in range(4):
            lin = getattr(port, f"linh{i}")
            lin.weight_v.copy_(torch.from_numpy(params[f"linh{i}"]["v"]))
            lin.weight_g.copy_(torch.from_numpy(params[f"linh{i}"]["g"])[:, None])
            lin.bias.copy_(torch.from_numpy(params[f"linh{i}"]["bias"]))
        port.linh4.weight.copy_(torch.from_numpy(params["linh4"]["kernel"].T.copy()))
        port.linh4.bias.copy_(torch.from_numpy(params["linh4"]["bias"]))
    return dec, params, port


@pytest.fixture(scope="module", params=[256, 64], ids=["289-512", "97-512"])
def decoders(request):
    return _decoders(request.param)


def test_fold_weight_norm_matches_jax(decoders):
    _, params, port = decoders
    want = jax_sdf_mlp.fold_weight_norm(params)
    got = fold_weight_norm(port)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n", [300, 64 * 3 + 37])
def test_plain_matches_pallas_interpret_and_reference(decoders, n):
    dec, params, port = decoders
    rng = np.random.RandomState(n)
    in_dim = port.in_dim
    x = rng.randn(n, in_dim).astype(np.float32)
    weights = jax_sdf_mlp.fold_weight_norm(params)
    want_kernel = np.asarray(jax_sdf_mlp.sdf_mlp_fused(
        jnp.asarray(x), weights, tile=128, interpret=True))
    want_ref = np.asarray(jax_sdf_mlp.sdf_mlp_reference(jnp.asarray(x), weights))
    want_flax = np.asarray(dec.apply({"params": params}, jnp.asarray(x))[0])
    got = sdf_mlp(torch.from_numpy(x),
                  prepare_weights(fold_weight_norm(port), torch.float32)).numpy()
    assert got.shape == (n, 1) and got.dtype == np.float32
    for want in (want_kernel, want_ref, want_flax):
        np.testing.assert_allclose(got, want, atol=ATOL_F32)
    # the port's decoder module computes the same function
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), got,
                               atol=ATOL_F32)


def test_plain_bf16_matches_pallas_interpret(decoders):
    _, params, port = decoders
    rng = np.random.RandomState(7)
    x = rng.randn(200, port.in_dim).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_sdf_mlp.sdf_mlp_fused(
        xb, jax_sdf_mlp.fold_weight_norm(params), tile=128, interpret=True))
    xt = torch.from_numpy(x).bfloat16()
    got = sdf_mlp_plain(xt, fold_weight_norm(port))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_BF16)
    # the wrapper on CPU tensors is the plain version on the prepared weights
    prepared = prepare_weights(fold_weight_norm(port), torch.bfloat16)
    assert torch.equal(sdf_mlp(xt, prepared), got)


def test_bf16_packing_holds_each_weight_transposed_in_its_k_range(decoders):
    """Layer 2 takes [h1 | x]: two k-ranges, each starting at a multiple of
    32; rows past the layer's width and columns between ranges are zero."""
    _, _, port = decoders
    folded = fold_weight_norm(port)
    w = prepare_weights(folded, torch.bfloat16)
    assert prepare_weights(folded, torch.float32).packed is None
    h1 = folded[2].shape[1]
    ranges = ([folded[0]], [folded[2]], [folded[4][:h1], folded[4][h1:]], [folded[6]])
    for packed, segs in zip(w.packed, ranges):
        n = segs[0].shape[1]
        assert packed.dtype == torch.bfloat16 and packed.shape[0] % 128 == 0
        expect = torch.zeros_like(packed)
        off = 0
        for s in segs:
            expect[:n, off:off + s.shape[0]] = s.t().bfloat16()
            off += -(-s.shape[0] // 32) * 32
        assert packed.shape[1] == off
        assert torch.equal(packed, expect)
    with pytest.raises(ValueError, match="weight shapes"):
        prepare_weights(folded[:8] + (folded[8][:-1], folded[9]), torch.float32)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA card")
@pytest.mark.parametrize("dtype,atol", [(torch.float32, ATOL_F32), (torch.bfloat16, ATOL_BF16)])
def test_kernel_matches_plain_on_card(decoders, dtype, atol):
    _, _, port = decoders
    x = torch.randn(4 * 64 + 37, port.in_dim, generator=torch.Generator().manual_seed(0))
    weights = prepare_weights([w.cuda() for w in fold_weight_norm(port)], dtype)
    xc = x.to("cuda", dtype)
    got = sdf_mlp(xc, weights)
    torch.cuda.synchronize()
    want = sdf_mlp_plain(xc, weights.plain)
    assert (got - want).abs().max().item() <= atol
