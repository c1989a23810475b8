"""Every module of the PyTorch port's eval slice against its JAX counterpart
and, where one exists, the committed torch golden.

Both sides run in f32 on the CPU (JAX at matmul precision "highest").
Tolerances: 1e-4 for the conv stacks (deep sums), 2e-5 for the SDF decoder
and transformers (the goldens' own bar), 1e-5 for single ops, 2e-2 mm for
MANO against its golden (as the JAX package's test), and exact equality for
the u8 wire and the masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, get_config
from hoisdf_torch.data.synthetic import synthetic_batch
from hoisdf_torch.mano.layer import ManoBuffers, mano_forward
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models import transformer as PT
from hoisdf_torch.models.decoder import Decoder as PortDecoder
from hoisdf_torch.models.hoisdf import MLP as PortMLP
from hoisdf_torch.models.hoisdf import sdf_attention_weight
from hoisdf_torch.models.mano_head import mano_head_pred
from hoisdf_torch.models.resnet import ResNetBackbone as PortResNet
from hoisdf_torch.models.sdf_decoder import SDFDecoder as PortSDFDecoder
from hoisdf_torch.ops import rotations as PR
from hoisdf_torch.ops import wire as pwire
from hoisdf_torch.ops.nerf import nerf_positional_encoding
from hoisdf_torch.weights import state_dict_numpy_from_jax
from hoisdf_tpu.data.image_io import to_float_image
from hoisdf_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from hoisdf_tpu.config import get_config as jax_get_config
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.mano.layer import mano_forward as jax_mano_forward
from hoisdf_tpu.models import hoisdf as jh
from hoisdf_tpu.models import transformer as JT
from hoisdf_tpu.models.decoder import Decoder as JaxDecoder
from hoisdf_tpu.models.mano_head import mano_head_pred as jax_mano_head_pred
from hoisdf_tpu.models.resnet import ResNetBackbone as JaxResNet
from hoisdf_tpu.ops import rotations as JR
from hoisdf_tpu.ops import wire as jwire
from hoisdf_tpu.ops.nerf import nerf_positional_encoding as jax_nerf
from hoisdf_tpu.tools.synth_weights import synth_state_dict

from torch_port_util import perturb_batch_stats

T = torch.from_numpy


def _nchw(a):
    return np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def _load(module, state, prefix):
    sd = {k[len(prefix):]: T(np.array(v)) for k, v in state.items()
          if k.startswith(prefix)}
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return module.eval()


# ---- conv stacks -----------------------------------------------------------

def test_resnet18_and_decoder_match_jax_modules():
    rng = np.random.RandomState(0)
    img = rng.rand(2, 64, 64, 3).astype(np.float32)
    jres = JaxResNet(resnet_type=18)
    v = jres.init(jax.random.PRNGKey(0), jnp.asarray(img))
    stats = perturb_batch_stats(v["batch_stats"])
    feat, skips = jres.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(img))
    port = _load(PortResNet(18), state_dict_numpy_from_jax(
        {"backbone": v["params"]}, {"backbone": stats}), "backbone_net.resnet.")
    with torch.no_grad():
        pfeat, pskips = port(T(_nchw(img)))
    np.testing.assert_allclose(pfeat.numpy(), _nchw(feat), atol=1e-4, rtol=1e-4)
    for k in skips:
        np.testing.assert_allclose(pskips[k].numpy(), _nchw(skips[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)

    jdec = JaxDecoder()
    dv = jdec.init(jax.random.PRNGKey(1), feat, skips)
    dstats = perturb_batch_stats(dv["batch_stats"], seed=1)
    pyr, heads = jdec.apply({"params": dv["params"], "batch_stats": dstats}, feat, skips)
    pdec = _load(PortDecoder(port.skip_channels), state_dict_numpy_from_jax(
        {"decoder_net": dv["params"]}, {"decoder_net": dstats}),
        "decoder_net.resnet_decoder.")
    with torch.no_grad():
        ppyr, pheads = pdec(pfeat, pskips)
    np.testing.assert_allclose(pheads.numpy(), _nchw(heads), atol=1e-4, rtol=1e-4)
    for k in pyr:
        np.testing.assert_allclose(ppyr[k].numpy(), _nchw(pyr[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_resnet50_and_decoder_golden(golden):
    """Golden from the original torch modules: ResNet-50 + the small decoder
    (this also pins ConvTranspose2d(4, 2, 1) against the original deconv)."""
    g = golden("backbone_decoder")
    port = _load(PortResNet(50), synth_state_dict(str(g["spec_backbone"])), "backbone.")
    dec = _load(PortDecoder(port.skip_channels),
                synth_state_dict(str(g["spec_decoder"])), "decoder.")
    with torch.no_grad():
        feat, skips = port(T(g["img"]))
        pyr, heads = dec(feat, skips)
    tol = dict(atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(feat.numpy(), g["feat"], **tol)
    for s in (2, 4, 8, 16, 32):
        np.testing.assert_allclose(skips[f"stride{s}"].numpy(), g[f"skip_stride{s}"], **tol)
        np.testing.assert_allclose(pyr[f"stride{s}"].numpy(), g[f"dec_stride{s}"], **tol)
    np.testing.assert_allclose(heads.numpy(), g["dec_heads"], **tol)


# ---- SDF decoder, MLP heads ------------------------------------------------

def test_sdf_decoder_golden(golden):
    g = golden("sdf_decoder")
    dec = PortSDFDecoder(256, 33).eval()
    dec.load_state_dict({k: T(g[k]) for k in g.files if k.startswith("linh")}, strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(dec(T(g["x"]))[0].numpy(), g["sdf"], atol=2e-5)


def test_mlp_and_attention_weight_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(5, 7, 40).astype(np.float32)
    mlp = jh.MLP((32, 16, 8), relu_last=True)
    params = mlp.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = PortMLP(40, (32, 16, 8), relu_last=True)
    port.load_state_dict({f"layers.{i}.{n}": T(np.ascontiguousarray(
        np.asarray(params[f"layers_{i}"][j]).T if n == "weight" else params[f"layers_{i}"][j]))
        for i in range(3) for n, j in (("weight", "kernel"), ("bias", "bias"))})
    with torch.no_grad():
        np.testing.assert_allclose(port(T(x)).numpy(),
                                   np.asarray(mlp.apply({"params": params}, jnp.asarray(x))),
                                   atol=1e-5)
    sdf = rng.randn(2, 9, 1).astype(np.float32) * 0.1
    for beta in (0.1, 1e-4):  # the second is clamped to 2e-3
        b = np.array([beta], np.float32)
        np.testing.assert_allclose(
            sdf_attention_weight(T(sdf), T(b)).numpy(),
            np.asarray(jh.sdf_attention_weight(jnp.asarray(sdf), jnp.asarray(b))),
            rtol=1e-6, atol=1e-12)


# ---- transformers ---------------------------------------------------------

def test_mha_golden(golden):
    g = golden("mha")
    mha = PT.MultiheadAttention(32, 4)
    mha.load_state_dict({"in_proj_weight": T(g["in_proj_weight"]),
                         "in_proj_bias": T(g["in_proj_bias"]),
                         "out_proj.weight": T(g["out_proj_weight"]),
                         "out_proj.bias": T(g["out_proj_bias"])})
    q, k, v = (T(g[n]).transpose(0, 1) for n in ("q", "k", "v"))  # [T,B,C] -> [B,T,C]
    with torch.no_grad():
        out, wts = mha(q, k, v, T(g["attn_mask"]))
    np.testing.assert_allclose(out.transpose(0, 1).numpy(), g["out"], atol=1e-5)
    np.testing.assert_allclose(wts.numpy(), g["wts"], atol=1e-5)


def test_transformers_golden(golden):
    g = golden("transformer")
    t = PT.Transformer(32, 4, 2, 2, 64)
    t.load_state_dict({k[2:]: T(g[k]) for k in g.files if k.startswith("t.")}, strict=True)
    vt = PT.VoteTransformer(32, 4, 2, 64)
    vt.load_state_dict({k[2:]: T(g[k]) for k in g.files if k.startswith("v.")}, strict=True)
    src = T(g["src"]).transpose(0, 1)  # [S,B,C] -> [B,S,C]
    pos = torch.zeros_like(src)
    with torch.no_grad():
        hs, memory, inter, attn = t(src, pos, T(g["query"]), T(g["tgt_mask"]),
                                    T(g["memory_mask"]))
        vmem, vinter = vt(src, pos)
    np.testing.assert_allclose(hs.numpy(), g["hs"].transpose(0, 2, 1, 3), atol=2e-5)
    np.testing.assert_allclose(memory.numpy(), g["memory"].transpose(1, 0, 2), atol=2e-5)
    np.testing.assert_allclose(inter.numpy(), g["inter"].transpose(0, 2, 1, 3), atol=2e-5)
    np.testing.assert_allclose(attn.numpy(), g["attn"], atol=2e-5)
    np.testing.assert_allclose(vmem.numpy(), g["vmem"].transpose(1, 0, 2), atol=2e-5)
    np.testing.assert_allclose(vinter.numpy(), g["vinter"].transpose(0, 2, 1, 3), atol=2e-5)


def test_transformer_matches_jax_with_fully_masked_rows():
    """A memory mask that hides every token from one query: finite NEG_INF
    gives that row uniform weights on both sides (no NaN)."""
    d, s = 32, 12
    rng = np.random.RandomState(4)
    src = rng.randn(2, s, d).astype(np.float32)
    query = rng.randn(17, d).astype(np.float32)
    tgt_mask = np.asarray(JT.get_mano_tgt_mask(17, 16))
    mem_mask = np.array(JT.get_mano_memory_mask(17, 8, 4))
    mem_mask[3] = True
    model = JT.Transformer(d_model=d, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
                           dim_feedforward=64, dropout=0.0)
    args = (jnp.asarray(src), jnp.zeros_like(jnp.asarray(src)), jnp.asarray(query),
            jnp.asarray(tgt_mask), jnp.asarray(mem_mask))
    params = model.init(jax.random.PRNGKey(0), *args)["params"]
    want = model.apply({"params": params}, *args)
    state = state_dict_numpy_from_jax({"hand_transformer": params}, {})
    port = PT.Transformer(d, 4, 2, 2, 64)
    port.load_state_dict({k[len("hand_transformer."):]: T(np.array(v))
                          for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = port(T(src), torch.zeros(2, s, d), T(query), T(tgt_mask), T(mem_mask))
    for gv, wv in zip(got, want):
        assert torch.isfinite(gv).all()
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=2e-5)
    np.testing.assert_allclose(got[3][:, :, 3].numpy(), 1.0 / s, atol=1e-6)


@pytest.mark.parametrize("k_hand,k_obj", [(600, 200), (32, 16)])
def test_masks_equal_jax(k_hand, k_obj):
    for port, jax_m in (
        (PT.get_mano_tgt_mask(17, 16), JT.get_mano_tgt_mask(17, 16)),
        (PT.get_mano_memory_mask(17, k_hand, k_obj), JT.get_mano_memory_mask(17, k_hand, k_obj)),
        (PT.get_manoshape_memory_mask(k_hand, k_obj), JT.get_manoshape_memory_mask(k_hand, k_obj)),
    ):
        assert port.dtype == torch.bool
        np.testing.assert_array_equal(port.numpy(), np.asarray(jax_m))


# ---- geometry ops ----------------------------------------------------------

def test_rotations_golden_and_jax(golden):
    g = golden("rotations")
    np.testing.assert_allclose(PR.rot6d2mat(T(g["x6d"])).numpy(), g["mats"], atol=1e-5)
    np.testing.assert_allclose(PR.mat2aa(T(g["mats"])).numpy(), g["aa_back"], atol=1e-4)
    np.testing.assert_allclose(PR.batch_rodrigues(T(g["aa"])).numpy(),
                               g["rodrigues"].reshape(-1, 3, 3), atol=1e-5)
    rng = np.random.RandomState(0)
    aa = rng.randn(50, 3).astype(np.float32)
    aa[0] = 0.0  # the sin_theta == 0 lane
    mats = JR.batch_rodrigues(jnp.asarray(aa))
    np.testing.assert_allclose(PR.batch_rodrigues(T(aa)).numpy(), np.asarray(mats), atol=1e-6)
    np.testing.assert_allclose(PR.mat2aa(T(np.asarray(mats))).numpy(),
                               np.asarray(JR.mat2aa(mats)), atol=1e-5)
    q = rng.randn(20, 4).astype(np.float32)
    np.testing.assert_allclose(PR.quat2aa(T(q)).numpy(), np.asarray(JR.quat2aa(jnp.asarray(q))),
                               atol=1e-5)
    x6 = rng.randn(30, 6).astype(np.float32)
    np.testing.assert_allclose(PR.rot6d2mat(T(x6)).numpy(),
                               np.asarray(JR.rot6d2mat(jnp.asarray(x6))), atol=1e-6)


def test_nerf_encoding_matches_jax_and_layout():
    x = np.asarray([[0.3, -0.7, 1.1]], np.float32)
    enc = nerf_positional_encoding(T(x), 5).numpy()
    assert enc.shape == (1, 30)
    np.testing.assert_allclose(enc[0, :3], np.sin(x[0]), rtol=1e-6)  # sin(x*f0)
    np.testing.assert_allclose(enc[0, 3:6], np.cos(x[0]), rtol=1e-6)  # cos(x*f0)
    np.testing.assert_allclose(enc[0, 6:9], np.sin(2 * x[0]), rtol=1e-6)
    pts = np.random.RandomState(1).randn(2, 17, 3).astype(np.float32)
    np.testing.assert_allclose(nerf_positional_encoding(T(pts), 5).numpy(),
                               np.asarray(jax_nerf(jnp.asarray(pts), 5)), atol=1e-6)


def test_u8_wire_decode_is_bit_exact():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=-1)
    got = pwire.decode_inputs({"img": T(u8)})["img"].numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), to_float_image(u8).view(np.uint32))
    want = np.asarray(jwire.decode_inputs({"img": jnp.asarray(u8)})["img"])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(pwire.quantize_image_u8(got), u8)
    f32 = {"img": T(got)}
    assert pwire.decode_inputs(f32) is f32


# ---- MANO --------------------------------------------------------------------

@pytest.fixture(scope="module")
def mano_buffers():
    m = make_synthetic_mano(0)
    return ManoBuffers.from_model(m), JaxManoBuffers.from_model(m)


def test_mano_forward_golden_and_jax(golden, mano_buffers):
    g = golden("mano_forward")
    port, jbuf = mano_buffers
    for betas, suffix in ((g["betas"], ""), (None, "_template")):
        verts, joints = mano_forward(port, T(g["pose"]), None if betas is None else T(betas))
        np.testing.assert_allclose(verts.numpy(), g["verts" + suffix], atol=2e-2)  # mm
        np.testing.assert_allclose(joints.numpy(), g["joints" + suffix], atol=2e-2)
        jv, jj = jax_mano_forward(jbuf, jnp.asarray(g["pose"]),
                                  None if betas is None else jnp.asarray(betas))
        np.testing.assert_allclose(verts.numpy(), np.asarray(jv), atol=1e-3)
        np.testing.assert_allclose(joints.numpy(), np.asarray(jj), atol=1e-3)


def test_mano_head_pred_matches_jax(mano_buffers):
    port, jbuf = mano_buffers
    rng = np.random.RandomState(2)
    pose6d = rng.randn(2, 3, 16, 6).astype(np.float32)
    shape = (rng.randn(2, 3, 10) * 0.5).astype(np.float32)
    got = mano_head_pred(port, T(pose6d), T(shape))
    want = jax_mano_head_pred(jbuf, jnp.asarray(pose6d), jnp.asarray(shape))
    for k in ("verts3d", "joints3d", "mano_pose"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


# ---- synthetic inputs ----------------------------------------------------

@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "dexycb"])
def test_synthetic_inputs_are_the_jax_packages_draws(tiny):
    over = SYNTHETIC_TINY_OVERRIDES if tiny else {}
    got = synthetic_batch(get_config("dexycb", **over), 3, seed=5)
    want = jax_synthetic_batch(jax_get_config("dexycb", **over), 3, seed=5, train=False)
    assert set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ---- config ----------------------------------------------------------------

def test_config_fields_are_the_jax_packages_and_unported_presets_refuse():
    """Every preset derives the JAX package's fields; a setting neither
    package has is refused."""
    for setting in ("dexycb", "dexycb_full", "ho3d", "ho3d_render"):
        got = get_config(setting, compute_dtype="bfloat16")
        want = jax_get_config(setting, compute_dtype="bfloat16")
        for f in got.__dataclass_fields__:
            assert getattr(got, f) == getattr(want, f), (setting, f)
        assert got.multiscale_dim == want.multiscale_dim, setting
    with pytest.raises(ValueError, match="unknown setting"):
        get_config("freihand")
