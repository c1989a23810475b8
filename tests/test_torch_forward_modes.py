"""The port's eval forward in the dense-scan ("full") and coarse2fine
sampler modes against ``HOISDF.apply``, and the port's nearest-gather
sampler against a JAX sampler composed of the functions that the JAX
package's fused route calls (its CPU model ignores ``infer_gather_nearest``).

Tiny config, batch 2, f32 on both sides, one torch thread.  Tolerances: the
same selected lattice points (sets, per field and image); every output
within 1e-4 absolute + 1e-4 relative (``torch_port_util.FORWARD_TOL``);
the nearest sampler's selected sdf within 1e-5 absolute.  The full scan runs
in four chunks of the 16^3 lattice, so the running merge runs; coarse2fine
probes 4^3 cells (coarse_bins=4) and keeps 16 of them (1,024 points >= K).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_tpu.models.hoisdf import MLP as JaxMLP
from hoisdf_tpu.ops import grid_sample as jgs
from hoisdf_tpu.ops.nerf import nerf_positional_encoding
from hoisdf_tpu.ops.pallas.sdf_mlp import fold_weight_norm, sdf_mlp_reference
from hoisdf_tpu.ops.point_sampling import sdf_guided_sample_hierarchical

from torch_port_util import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_forward_matches_jax,
    forward_pair,
    forward_setup,
    lattice_ids,
    one_torch_thread,
    port_model,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODES = {
    "full": dict(sdf_infer_mode="full", sdf_infer_chunk=1024),
    "coarse2fine": dict(sdf_infer_mode="coarse2fine", coarse_bins=4, coarse_keep_cells=16),
}


@pytest.fixture(scope="module")
def setup():
    return forward_setup()


@pytest.mark.parametrize("mode", list(MODES))
def test_eval_forward_matches_jax(setup, mode):
    got, want, pcfg = forward_pair(setup, **MODES[mode])
    assert_forward_matches_jax(got, want, pcfg)


def _jax_nearest_sampler(setup, pyramid, center, cam, bbox, scale, k, which):
    """The JAX fused route's sampler, on the CPU: the nearest multi-level
    gather, ``linear_sdfin``, ``sdf_mlp_reference`` on the folded decoder."""
    cfg, params = setup["jcfg"], setup["params"]
    lin = JaxMLP((512, cfg.hidden_dim), relu_last=True)
    folded = fold_weight_norm(params[f"{which}_sdf_decoder"])

    def sdf_fn(pts):
        cam_pts = pts / scale + center[:, None, :]
        grid = jgs.pixels_to_grid(jgs.project_points(cam_pts, cam), cfg.input_img_shape)
        feats = jgs.multiscale_point_features(pyramid, grid, cfg.multiscale_layers,
                                              nearest=True, slice_gather=True)
        fea = lin.apply({"params": params["linear_sdfin"]}, feats)
        dec_in = jnp.concatenate(
            [fea, nerf_positional_encoding(pts, cfg.nerf_num_freqs), pts], axis=-1)
        sdf = sdf_mlp_reference(dec_in.reshape(-1, dec_in.shape[-1]), folded)
        return sdf.reshape(pts.shape[0], pts.shape[1])

    levels = cfg.hier_levels_obj if which == "obj" and cfg.hier_levels_obj else cfg.hier_levels
    return sdf_guided_sample_hierarchical(
        sdf_fn, center, cam, bbox, sdf_scale=scale, num_points=k, bins_n=cfg.bins_n,
        levels=levels, clamp=cfg.clamping_distance)


def test_nearest_sampler_matches_the_jax_fused_routes_functions(setup):
    import dataclasses

    pcfg = dataclasses.replace(setup["pcfg"], infer_gather_nearest=True)
    model = port_model(pcfg, setup["params"], setup["stats"])
    x = {k: torch.from_numpy(v) for k, v in setup["inputs"].items()}
    with torch.inference_mode():
        img = x["img"].permute(0, 3, 1, 2)
        feat, skips = model.backbone_net["resnet"](img)
        pyr, _ = model.decoder_net["resnet_decoder"](feat, skips)
        pyramid = {k: v.permute(0, 2, 3, 1).contiguous() for k, v in pyr.items()}
        jpyr = {k: jnp.asarray(v.numpy()) for k, v in pyramid.items()}
        for which, center, bbox, scale, k in (
                ("hand", "mano_root", "bbox_hand", pcfg.hand_sdf_scale, pcfg.num_samp_hand),
                ("obj", "obj_center_cam", "bbox_obj", pcfg.obj_sdf_scale, pcfg.num_samp_obj)):
            pts, sdf, _ = model.sdf_infer(pyramid, x[center], x["cam_intr"], x[bbox], scale, k,
                                          which)
            want_pts, want_sdf = _jax_nearest_sampler(
                setup, jpyr, jnp.asarray(setup["inputs"][center]),
                jnp.asarray(setup["inputs"]["cam_intr"]), jnp.asarray(setup["inputs"][bbox]),
                scale, k, which)
            ids, want_ids = (lattice_ids(p, pcfg.bins_n) for p in (pts.numpy(),
                                                                    np.asarray(want_pts)))
            np.testing.assert_array_equal(np.sort(ids, 1), np.sort(want_ids, 1), err_msg=which)
            order, want_order = np.argsort(ids, 1), np.argsort(want_ids, 1)
            np.testing.assert_allclose(
                np.take_along_axis(sdf.numpy()[..., 0], order, 1),
                np.take_along_axis(np.asarray(want_sdf)[..., 0], want_order, 1),
                atol=1e-5, rtol=0, err_msg=which)
            # the nearest probes pick other points than the bilinear ones
            bil = dataclasses.replace(pcfg, infer_gather_nearest=False)
            model.cfg = bil
            bil_pts, _, _ = model.sdf_infer(pyramid, x[center], x["cam_intr"], x[bbox], scale,
                                            k, which)
            model.cfg = pcfg
            assert not np.array_equal(np.sort(lattice_ids(bil_pts.numpy(), pcfg.bins_n), 1),
                                      np.sort(ids, 1)), which


@pytest.mark.parametrize("items", [
    ["sdf_infer_mode=full"],
    ["sdf_infer_mode=coarse2fine", "coarse_bins=4", "coarse_keep_cells=16"],
])
def test_evaluate_main_writes_results_in_a_sampler_mode(items, tmp_path):
    """``python -m hoisdf_torch.evaluate --synthetic --cpu --cfg
    sdf_infer_mode=...`` writes the results that an Evaluator fed by the
    tiny model's eval step in that mode gives (the same text: exact).  At
    the tiny 16^3 lattice "full" selects what the default "hier" does; the
    coarse2fine case's outputs differ from hier's, so it shows that the
    ``--cfg`` items reach the model."""
    from hoisdf_torch import evaluate as PE
    from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, get_config, parse_cfg_overrides
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.models.hoisdf import build_model
    from hoisdf_torch.train import make_eval_step

    argv = ["--synthetic", "--cpu", "--batches", "1", "--batch-size", "2",
            "--out", str(tmp_path / "main")]
    path = PE.main(argv + [a for item in items for a in ("--cfg", item)])
    cfg = get_config("dexycb", **SYNTHETIC_TINY_OVERRIDES, **parse_cfg_overrides(items))
    assert cfg.sdf_infer_mode == items[0].split("=")[1]
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    step = make_eval_step(cfg, build_model(cfg), mano, device="cpu")
    direct = PE.Evaluator(cfg, mano, device="cpu")
    for inputs, targets, templates, _ in PE.synthetic_batches(cfg, 1, 2):
        direct.feed(step(inputs), targets, inputs, templates)
    (tmp_path / "direct").mkdir()
    with open(path) as f, open(direct.write_results(str(tmp_path / "direct"))) as g:
        written = f.read()
        assert written == g.read()
    values = [float(line.split(":")[1]) for line in written.splitlines() if " :  " in line]
    assert len(values) == 5 and np.isfinite(values).all()


# ---- the CUDA graph's gate (models/forward_graph.py) ---------------------------


def _tiny_model(seed=0):
    from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, get_config
    from hoisdf_torch.models.hoisdf import build_model

    return build_model(get_config("dexycb", **SYNTHETIC_TINY_OVERRIDES), seed)


@pytest.fixture(scope="module")
def tiny_model():
    return _tiny_model()


@pytest.fixture
def gated(tiny_model, monkeypatch):
    """The tiny model with a stub body, on a batch the gate takes for one on
    the card: each case turns one of the other conditions off."""
    from hoisdf_torch.models import forward_graph
    from hoisdf_torch.ops.kernels import reset_graph_counts

    model = tiny_model.eval()
    calls = []
    monkeypatch.setattr(model, "eager_forward", lambda batch, **kw: calls.append(kw) or {})
    monkeypatch.setattr(forward_graph, "on_card", lambda batch: True)
    reset_graph_counts()
    return model, calls


@pytest.mark.parametrize("case", ["train", "grad", "presampled", "export"])
def test_the_gate_keeps_the_eager_path(gated, monkeypatch, case):
    import contextlib

    from hoisdf_torch.models import forward_graph
    from hoisdf_torch.ops.kernels import graph_counts

    model, calls = gated
    mode, kwargs = torch.inference_mode(), {}
    if case == "train":
        model.train()
    elif case == "grad":
        mode = contextlib.nullcontext()
    elif case == "presampled":
        kwargs = dict(use_presampled=True, dist_range=0.01)
    else:
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with mode:
        model({"img": torch.zeros(1, 8, 8, 3)}, **kwargs)
    assert len(calls) == 1 and calls[0].get("use_presampled", False) == (case == "presampled")
    assert graph_counts == {"captures": 0, "replays": 0, "eager": 1}
    assert model not in forward_graph._STATES


def test_untraced_sees_autograd_and_the_modes_over_the_ops():
    from torch.utils.flop_counter import FlopCounterMode

    from hoisdf_torch.models.forward_graph import on_card, untraced

    assert not untraced()  # autograd on
    with torch.inference_mode():
        assert untraced()
        with FlopCounterMode(display=False):
            assert not untraced()
        with torch.device("cpu"):
            assert not untraced()
    assert not on_card({"img": torch.zeros(1)})
    assert not on_card({"img": torch.zeros(1), "n": 3})


def test_forward_graphs_follow_the_weights_addresses():
    """In-place loads keep a module's graphs; a parameter or buffer replaced,
    given other storage or moved drops them."""
    from hoisdf_torch.models.forward_graph import ForwardGraphs

    model = _tiny_model()
    other = {k: v + 1 for k, v in model.state_dict().items()}
    graphs = ForwardGraphs(model)
    assert not graphs.sharded
    assert len(graphs.slots) == len([*model.parameters(), *model.buffers()])
    model.load_state_dict(other)
    assert graphs.current()
    bias = model.linear_handcls.layers[-1].bias
    bias.data = bias.data.clone()
    assert not graphs.current()
    graphs = ForwardGraphs(model)
    model.linear_handcls.layers[-1].bias = torch.nn.Parameter(bias.detach().clone())
    assert not graphs.current()
    graphs = ForwardGraphs(model)
    model.load_state_dict(other, assign=True)
    assert not graphs.current()
    graphs = ForwardGraphs(model)
    model.to(torch.float64)
    assert not graphs.current()


def test_device_cache_holds_what_it_returns_while_asked():
    from hoisdf_torch.ops.device_cache import device_cache, held

    @device_cache(maxsize=1)
    def const(n):
        return torch.full((2,), float(n))

    kept = []
    with held(kept):
        a = const(1)
        assert const(1) is a
        const(2)  # evicts const(1) from the cache
    const(3)
    assert len(kept) == 3 and kept[0] is a and kept[1] is a
