"""Kernel A of the PyTorch port (fused SDF MLP): its plain PyTorch version
against the JAX package's Pallas kernel (interpret mode) and plain oracle.

Tolerance: atol 1e-5 in f32 (summation order only); 2e-2 in bf16, where
activations round to bf16 between layers and a different f32 summation order
can flip a rounding (tanh output in [-1, 1]).

The CUDA kernel cannot run without a card, so its weight layout (the packed
stages) is pinned here: unpacked back to each W^T, and walked in the kernel's
order by a PyTorch model of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.models.sdf_decoder import SDFDecoder as PortSDFDecoder
from hoisdf_torch.ops.kernels.sdf_mlp import (
    PAD_F32,
    PASS_N,
    SLICE_K,
    f32_passes,
    f32_slice_count,
    fold_weight_norm,
    prepare_weights,
    sdf_mlp,
    sdf_mlp_plain,
    swizzle128,
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
    port = PortSDFDecoder(latent_size, 33).eval()
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
    np.testing.assert_allclose(port(torch.from_numpy(x))[0].detach().numpy(), got,
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


def _unpack(stages, n, k_ranges):
    """Undo ``_pack_bf16`` for one layer, knowing only the documented layout:
    stages of 128 columns x 64 k of W^T in the 128-byte swizzle (the 16-byte
    chunk ``c`` of row ``r`` sits at chunk ``c ^ (r % 8)``), ordered by pass of
    two column halves, then k panel, then half.  Returns W^T zero-padded to
    ``[halves * 128, sum of round64(k)]`` and the number of stages used."""
    halves = -(-n // 128)
    panels = sum(-(-k // 64) for k in k_ranges)
    wt = torch.zeros(halves * 128, panels * 64, dtype=stages.dtype)
    i = 0
    for h0 in range(0, halves, 2):
        for kp in range(panels):
            for half in range(h0, min(h0 + 2, halves)):
                tile = stages[i].reshape(128, 8, 8)
                for r in range(128):
                    for c in range(8):
                        wt[half * 128 + r, kp * 64 + c * 8:kp * 64 + c * 8 + 8] = \
                            tile[r, c ^ (r % 8)]
                i += 1
    return wt, i


def test_bf16_packing_holds_each_weight_transposed_in_its_k_range(decoders):
    """Layer 2 takes [h1 | x]: two k-ranges, each starting at a multiple of
    64; rows past the layer's width and columns between ranges are zero."""
    _, _, port = decoders
    folded = fold_weight_norm(port)
    w = prepare_weights(folded, torch.bfloat16)
    assert prepare_weights(folded, torch.float32).packed[0].dtype == torch.float32
    stages, vectors = w.packed
    assert stages.dtype == torch.bfloat16 and stages.shape[1] == 128 * 64
    assert stages.is_contiguous()
    h1 = folded[2].shape[1]
    ranges = ([folded[0]], [folded[2]], [folded[4][:h1], folded[4][h1:]], [folded[6]])
    used = 0
    for segs in ranges:
        n = segs[0].shape[1]
        got, count = _unpack(stages[used:], n, [s.shape[0] for s in segs])
        used += count
        expect = torch.zeros_like(got)
        off = 0
        for s in segs:
            expect[:n, off:off + s.shape[0]] = s.t().bfloat16()
            off += -(-s.shape[0] // 64) * 64
        assert got.shape[1] == off
        assert torch.equal(got, expect)
    assert used == stages.shape[0]
    # the vectors: b0..b3 and w4, each zero-padded to a multiple of 128
    off = 0
    for v in (folded[1], folded[3], folded[5], folded[7], folded[8].reshape(-1)):
        pad = -(-v.numel() // 128) * 128
        assert torch.equal(vectors[off:off + v.numel()], v.bfloat16())
        assert not vectors[off + v.numel():off + pad].any()
        off += pad
    assert off == vectors.numel() and vectors.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="weight shapes"):
        prepare_weights(folded[:8] + (folded[8][:-1], folded[9]), torch.float32)


def test_swizzle128_is_an_involution_on_chunks():
    t = torch.arange(16 * 64, dtype=torch.float32).reshape(16, 64).bfloat16()
    swz = swizzle128(t)
    assert torch.equal(swizzle128(swz), t)
    for r in (0, 1, 7, 9):
        for c in range(8):
            assert torch.equal(swz[r, 8 * c:8 * c + 8], t[r, 8 * (c ^ (r % 8)):8 * (c ^ (r % 8)) + 8])


def test_bf16_stage_walk_reproduces_plain(decoders):
    """The kernel's walk in PyTorch: 64-row activation panels padded to 64
    columns against the packed stages in order (per pass, k panel, column
    half), f32 accumulation, bias and w4 from the padded vectors, bf16
    rounding between layers, the output layer as a dot with the rounded h3."""
    _, _, port = decoders
    folded = fold_weight_norm(port)
    w = prepare_weights(folded, torch.bfloat16)
    stages, vectors = w.packed
    tiles = swizzle128(stages.reshape(-1, 128, 64)).float()  # [stage, column, k]
    in_dim = port.in_dim
    h = [folded[0].shape[1], folded[2].shape[1], folded[4].shape[1], folded[6].shape[1]]
    x = torch.randn(64, in_dim, generator=torch.Generator().manual_seed(3)).bfloat16()

    def panels(a):  # zero-pad the columns to a multiple of 64
        return torch.nn.functional.pad(a.float(), (0, -a.shape[1] % 64))

    state = {"stage": 0, "vec": 0}

    def layer(segments, n):
        a = torch.cat([panels(s) for s in segments], dim=1)
        halves = -(-n // 128)
        acc = torch.zeros(64, halves * 128)
        for h0 in range(0, halves, 2):
            for kp in range(a.shape[1] // 64):
                for half in range(h0, min(h0 + 2, halves)):
                    acc[:, half * 128:(half + 1) * 128] += \
                        a[:, kp * 64:(kp + 1) * 64] @ tiles[state["stage"]].t()
                    state["stage"] += 1
        bias = vectors[state["vec"]:state["vec"] + halves * 128].float()
        state["vec"] += halves * 128
        out = torch.relu(acc + bias).bfloat16()
        assert not out[:, n:].any()  # padded columns stay zero for the next k-range
        return out[:, :n]

    h0 = layer([x], h[0])
    h1 = layer([h0], h[1])
    h2 = layer([h1, x], h[2])
    h3 = layer([h2], h[3])
    assert state["stage"] == stages.shape[0]
    w4 = vectors[state["vec"]:state["vec"] + h[3]].float()
    got = torch.tanh(h3.float() @ w4 + w.plain[9].float())[:, None]
    want = sdf_mlp_plain(x, w.plain)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL_BF16)


def test_plain_output_layer_rounds_h3_to_bf16_before_the_f32_dot(decoders):
    """The kernel takes the output layer from layer 3's accumulators: bias,
    ReLU, rounding to bf16, then an f32 dot with bf16 w4.  That is the plain
    version's order, so they differ by summation order only; skipping the
    rounding would not be the same function."""
    _, _, port = decoders
    folded = fold_weight_norm(port)
    x = torch.randn(200, port.in_dim, generator=torch.Generator().manual_seed(5)).bfloat16()
    w = [t.bfloat16().float() for t in folded]

    def hidden(rounded):
        def layer(a, wt, b):
            return torch.relu(a.float() @ wt + b).bfloat16()
        a = layer(x, w[0], w[1])
        a = layer(a, w[2], w[3])
        a = layer(torch.cat([a, x], -1), w[4], w[5])
        pre = torch.relu(a.float() @ w[6] + w[7])
        return pre.bfloat16().float() if rounded else pre

    want = sdf_mlp_plain(x, folded)
    rounded = torch.tanh(hidden(True) @ w[8] + w[9])
    unrounded = torch.tanh(hidden(False) @ w[8] + w[9])
    assert torch.equal(rounded, want)
    assert not torch.equal(unrounded, want)
    assert (unrounded - want).abs().max().item() <= ATOL_BF16


def _f32_layers(folded):
    """(width, k-range blocks) of the four hidden layers, as the f32 packing
    lays them: layer 2 takes [h1 | x]."""
    h1 = folded[2].shape[1]
    return ([folded[0]], [folded[2]], [folded[4][:h1], folded[4][h1:]], [folded[6]])


def _f32_unpack(folded, slices):
    """Cut the f32 run of k-slices back into each layer's padded W, knowing
    only the documented layout: per layer, per pass of f32_passes, slices of
    SLICE_K rows x the pass's width, row-major, in k order."""
    out, used = [], 0
    for segs in _f32_layers(folded):
        n = segs[0].shape[1]
        k_pad = sum(-(-s.shape[0] // PAD_F32) * PAD_F32 for s in segs)
        wp = torch.zeros(k_pad, -(-n // PAD_F32) * PAD_F32)
        for n0, pw in f32_passes(n):
            assert pw % PAD_F32 == 0 and 0 < pw <= PASS_N
            wp[:, n0:n0 + pw] = slices[used:used + k_pad * pw].reshape(k_pad, pw)
            used += k_pad * pw
        out.append(wp)
    return out, used


def test_f32_packing_holds_each_weight_in_its_k_range(decoders):
    """Widths pad to a multiple of 8 (223 -> 224); each k-range of a layer
    starts at a multiple of 8; the padding is zeros; the vectors b0..b3 and
    w4 are each zero-padded to a multiple of 8."""
    _, _, port = decoders
    folded = fold_weight_norm(port)
    slices, vectors = prepare_weights(folded, torch.float32).packed
    assert slices.dtype == vectors.dtype == torch.float32 and slices.dim() == 1
    layers, used = _f32_unpack(folded, slices)
    assert used == slices.numel()
    h = [folded[i].shape[1] for i in (0, 2, 4, 6)]
    assert f32_slice_count(port.in_dim, h) * SLICE_K == sum(
        wp.shape[0] * len(f32_passes(n)) for wp, n in zip(layers, h))
    for wp, segs in zip(layers, _f32_layers(folded)):
        expect = torch.zeros_like(wp)
        off = 0
        for s in segs:
            expect[off:off + s.shape[0], :s.shape[1]] = s
            off += -(-s.shape[0] // PAD_F32) * PAD_F32
        assert torch.equal(wp, expect)
    off = 0
    for v in (folded[1], folded[3], folded[5], folded[7], folded[8].reshape(-1)):
        pad = -(-v.numel() // PAD_F32) * PAD_F32
        assert torch.equal(vectors[off:off + v.numel()], v)
        assert not vectors[off + v.numel():off + pad].any()
        off += pad
    assert off == vectors.numel()


def test_f32_slice_walk_and_fused_output_dot_reproduce_plain(decoders):
    """The f32 kernel's walk in PyTorch over the packed run: 32-row tiles,
    k-major activations zero-padded to 8, per layer and pass the k-slices in
    order (the skip layer's second k-range reads the input), f32
    accumulation, bias and ReLU from the padded vectors; layer 3 is never
    stored: each thread's columns (runs of 4, a run apart; 8 x 8 tiles on
    passes over 256 wide, else 8 x 4) dot w4, and a row's partials add in
    column-group order, then tanh.  Ragged rows (70 = 2 tiles
    + 6) are zero-padded."""
    _, _, port = decoders
    folded = fold_weight_norm(port)
    w = prepare_weights(folded, torch.float32)
    slices, vectors = w.packed
    h = [folded[i].shape[1] for i in (0, 2, 4, 6)]
    x = torch.randn(70, port.in_dim, generator=torch.Generator().manual_seed(4))
    rows = 32
    pad = -x.shape[0] % rows
    xt = torch.nn.functional.pad(x, (0, -port.in_dim % PAD_F32, 0, pad))
    state = {"slice": 0, "vec": 0}

    def walk(segments, n):
        a = torch.cat(segments, dim=1)  # [rows, padded k]
        n_pad = -(-n // PAD_F32) * PAD_F32
        acc = torch.zeros(a.shape[0], n_pad)
        for n0, pw in f32_passes(n):
            for k0 in range(0, a.shape[1], SLICE_K):
                sl = slices[state["slice"]:state["slice"] + SLICE_K * pw].reshape(SLICE_K, pw)
                acc[:, n0:n0 + pw] += a[:, k0:k0 + SLICE_K] @ sl
                state["slice"] += SLICE_K * pw
        bias = vectors[state["vec"]:state["vec"] + n_pad]
        state["vec"] += n_pad
        return torch.relu(acc + bias), n_pad

    h0, _ = walk([xt], h[0])
    h1, _ = walk([h0], h[1])
    h2, _ = walk([h1, xt], h[2])
    h3, n3 = walk([h2], h[3])
    assert state["slice"] == slices.numel()
    w4 = vectors[state["vec"]:state["vec"] + n3]
    dot = torch.zeros(xt.shape[0])
    for n0, pw in f32_passes(h[3]):
        tile = 8 if pw > 256 else 4
        groups, run = pw // tile, pw // (tile // 4)
        assert groups <= 64  # 4 row groups on the kernel's 256 threads
        cols = [[4 * g + q * run + i for q in range(tile // 4) for i in range(4)]
                for g in range(groups)]
        assert sorted(c for cs in cols for c in cs) == list(range(pw))
        for cs in cols:  # the threads of a row, in column-group order
            idx = torch.tensor(cs) + n0
            dot += (h3[:, idx] * w4[idx]).sum(dim=1)
    got = torch.tanh(dot + w.plain[9])[:x.shape[0], None]
    want = sdf_mlp_plain(x, w.plain)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


RAGGED_ROWS = (1, 31, 32, 33, 47, 48, 49, 63, 64, 65, 127, 128, 129, 255, 257, 4 * 64 + 37)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA card")
@pytest.mark.parametrize("dtype,atol", [(torch.float32, ATOL_F32), (torch.bfloat16, ATOL_BF16)])
def test_kernel_matches_plain_on_card(decoders, dtype, atol):
    _, _, port = decoders
    x = torch.randn(max(RAGGED_ROWS), port.in_dim, generator=torch.Generator().manual_seed(0))
    weights = prepare_weights([w.cuda() for w in fold_weight_norm(port)], dtype)
    for n in RAGGED_ROWS:  # around the f32 (32-row) and bf16 (64-row) tiles
        xc = x[:n].to("cuda", dtype).contiguous()
        got = sdf_mlp(xc, weights)
        torch.cuda.synchronize()
        want = sdf_mlp_plain(xc, weights.plain)
        assert got.shape == (n, 1)
        assert (got - want).abs().max().item() <= atol, n
    # a view that starts one row in: odd-width rows off the 16-byte boundary
    xc = x.to("cuda", dtype)[1:130]
    got = sdf_mlp(xc, weights)
    torch.cuda.synchronize()
    assert (got - sdf_mlp_plain(xc, weights.plain)).abs().max().item() <= atol
