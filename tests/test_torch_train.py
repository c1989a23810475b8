"""The port's train path against the JAX package's, at the tiny config, f32.

One train step of each branch (presampled and field-guided) from the same
bridged weights and BatchNorm statistics, against
``hoisdf_tpu.train.make_train_step``.  Random streams cannot match (a torch
generator does not give JAX's bits), so both sides run without them:
``dist_range=0`` makes the presample jitter exactly zero, and every dropout is
an identity (the port's dropout p = 0; flax's ``nn.Dropout`` patched to an
identity for the JAX compile).  The dropout itself is tested on its own.

JAX's gradients are read from its optimizer's first moment after one step
(mu = 0.1 g); the frozen BN parameters have none there (they are masked out)
and are checked to stay unchanged instead.

Tolerances, with their reasons:
- losses: 1e-4 relative + 1e-6 absolute (f32, other summation orders; the
  measured gap is a few 1e-6).
- gradients: over all trainable parameters together, 1e-3 relative in norm;
  per tensor, 3e-2 relative in norm + 1e-5 absolute.  The loose per-tensor
  bound is the computation's own conditioning, not the port's: a ReLU whose
  input lies within rounding of zero switches, and BatchNorm on the tiny
  maps amplifies it; the port alone, run on 1 and on 8 CPU threads, differs
  by up to 1 % per tensor.  Gradients that are zero in exact arithmetic (the
  biases of convolutions followed by train-mode BatchNorm) are f32 noise of
  ~1e-6 to 1e-5 on each side; each side's is held under a floor of
  ceil(log2 N) eps_f32 ||sum |g_i| ||, the pairwise-sum error bound of the
  N terms that cancel (``torch_port_util.BNCancelledBiases``).  The module
  runs at one torch thread, so the outcome does not depend on the worker.
- parameters after AdamW: the first Adam step moves each element by about
  lr * g / (|g| + 1e-8).  Where both sides' gradients share a sign and
  exceed 1e-5 in size the updates agree to 1e-6; elsewhere (a gradient
  within noise of zero) they may differ by up to 2 lr.
- running statistics: 1e-4 relative + 1e-6 absolute.

The comparison (``torch_port_util.check_train_step``) is shared with the ho3d
presets' train tests.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hoisdf_torch import train as ptrain
from hoisdf_torch.data.synthetic import split_inputs_targets as p_split
from hoisdf_torch.data.synthetic import synthetic_batch as p_synthetic_batch
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.models.initializers import apply_reference_init
from hoisdf_torch.models.layers import BatchNorm2d, Dropout
from hoisdf_torch.models.mano_head import mano_head_gt
from hoisdf_torch.ops import wire
from hoisdf_torch.utils import checkpoint as ckpt
from hoisdf_torch.weights import state_dict_numpy_from_jax
from hoisdf_tpu import train as jtrain
from hoisdf_tpu.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.models.mano_head import mano_head_gt as jax_mano_head_gt
from hoisdf_tpu.ops import wire as jwire
from hoisdf_tpu.tools.convert_torch_ckpt import convert_state_dict, load_torch_state

from torch_port_util import (BRANCHES, check_train_step, configs, one_torch_thread,  # noqa: F401
                             port_train_state, train_setup)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup(one_torch_thread):
    jcfg, pcfg = configs(reference_init=False)
    return train_setup(jcfg, pcfg)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_train_step_matches_jax(setup, branch):
    check_train_step(setup, branch)


def test_running_variance_takes_flax_rule_biased():
    """new = 0.9 old + 0.1 biased batch variance (torch's own BN would take
    the unbiased one); the output is normalised with the batch statistics."""
    bn = BatchNorm2d(3).train()
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    y = bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 * torch.ones(3) + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(y, (x - mean[None, :, None, None])
                               / torch.sqrt(var[None, :, None, None] + 1e-5))
    bn.eval()
    torch.testing.assert_close(bn(x), (x - bn.running_mean[None, :, None, None])
                               / torch.sqrt(bn.running_var[None, :, None, None] + 1e-5))


def test_dropout_rate_scaling_and_repeatability():
    drop = Dropout(0.2).train()
    x = torch.ones(200, 500)
    y = drop(x, torch.Generator().manual_seed(5))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01  # 100,000 draws: sd 0.0013
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    torch.testing.assert_close(y, drop(x, torch.Generator().manual_seed(5)), rtol=0, atol=0)
    assert not torch.equal(y, drop(x, torch.Generator().manual_seed(6)))
    assert torch.equal(drop.eval()(x), x)


def test_model_dropout_is_on_in_train_mode_only():
    """With dropout, two train-mode forwards from different generators differ
    and two from equal ones agree; eval mode ignores the generator."""
    cfg = configs()[1]
    model = build_model(cfg, 0)
    batch = {k: torch.from_numpy(v) for k, v in
             p_split(p_synthetic_batch(cfg, 1, seed=1, train=True))[0].items()}

    def run(seed, train):
        model.train(train)
        with torch.no_grad():
            return model(batch, use_presampled=True, dist_range=0.0,
                         generator=torch.Generator().manual_seed(seed))["hand_off"]

    assert torch.equal(run(0, True), run(0, True))
    assert not torch.equal(run(0, True), run(1, True))
    assert torch.equal(run(0, False), run(1, False))


def test_adamw_update_is_optax_adamw():
    """The same gradients through torch's AdamW (make_optimizer, lr set per
    step) and optax's adamw on the JAX package's schedule give the same
    parameters over three steps, the lr dropping at each, up to f32 rounding
    of the two formulas (3 ulp)."""
    jcfg, pcfg = configs(lr_drop=1)
    lin = torch.nn.Linear(4, 3)
    rng = np.random.RandomState(0)
    w0 = {"kernel": rng.randn(4, 3).astype(np.float32), "bias": rng.randn(3).astype(np.float32)}
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0["kernel"].T.copy()))
        lin.bias.copy_(torch.from_numpy(w0["bias"]))
    opt = ptrain.make_optimizer(pcfg, lin)
    tx = optax.adamw(jtrain.make_lr_schedule(jcfg, 1), b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=1e-2)
    jp = {k: jnp.asarray(v) for k, v in w0.items()}
    jo = tx.init(jp)
    for step in range(3):
        g = {"kernel": rng.randn(4, 3).astype(np.float32), "bias": rng.randn(3).astype(np.float32)}
        lin.weight.grad = torch.from_numpy(g["kernel"].T.copy())
        lin.bias.grad = torch.from_numpy(g["bias"])
        for group in opt.param_groups:
            group["lr"] = ptrain.lr_for_step(pcfg, step, 1)
        opt.step()
        up, jo = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jo, jp)
        jp = optax.apply_updates(jp, up)
    np.testing.assert_allclose(lin.weight.detach().numpy().T, np.asarray(jp["kernel"]),
                               rtol=4e-7, atol=0)
    np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(jp["bias"]),
                               rtol=4e-7, atol=0)


@pytest.mark.parametrize("epoch", [0, 8, 9, 17, 18, 40, 69, 200])
def test_lr_for_epoch_matches_jax(epoch):
    jcfg, pcfg = configs()
    assert ptrain.lr_for_epoch(pcfg, epoch) == jtrain.lr_for_epoch(jcfg, epoch)
    sched = jtrain.make_lr_schedule(jcfg, 7)
    for step in (epoch * 7, epoch * 7 + 6):
        np.testing.assert_allclose(ptrain.lr_for_step(pcfg, step, 7), float(sched(step)),
                                   rtol=1e-6)


def test_presample_gate_matches_jax():
    jcfg, pcfg = configs()
    for epoch in (0, 39, 40, 55):
        for ratio in (0.0, 0.3, 0.31, 0.7, 0.71, 0.99):
            for p in (0.0, 0.39, 0.4, 0.9):
                assert ptrain.presample_gate(pcfg, epoch, ratio, p) == \
                    jtrain.presample_gate(jcfg, epoch, ratio, p), (epoch, ratio, p)


def test_train_batch_is_the_jax_packages_draws():
    jcfg, pcfg = configs(classifier_branch=True)
    got = p_synthetic_batch(pcfg, 3, seed=4, train=True)
    want = synthetic_batch(jcfg, 3, seed=4, train=True)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    gi, gt = p_split(got)
    wi, wt = split_inputs_targets(want)
    assert set(gi) == set(wi) and set(gt) == set(wt)


def test_u8_train_wire_bit_for_bit():
    jcfg, _ = configs()
    inputs, targets = split_inputs_targets(synthetic_batch(jcfg, 2, seed=6, train=True))
    inputs["img"] = wire.quantize_image_u8(inputs["img"]).astype(np.float32) / 255.0
    targets["obj_seg"] = targets["obj_seg"] * 0.5  # not binary: stays f32
    got_in, got_tg = wire.encode_batch(inputs, targets)
    want_in, want_tg = jwire.encode_batch(inputs, targets)
    for got, want in ((got_in, want_in), (got_tg, want_tg)):
        assert set(got) == set(want)
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_tg["hand_seg"].dtype == np.uint8 and got_tg["obj_seg"].dtype == np.float32
    dec = wire.decode_targets({k: torch.from_numpy(v) for k, v in got_tg.items()})
    jdec = jwire.decode_targets({k: jnp.asarray(v) for k, v in want_tg.items()})
    for k in dec:
        assert dec[k].dtype == torch.float32 or k not in ("hand_seg", "obj_seg")
        np.testing.assert_array_equal(dec[k].numpy(), np.asarray(jdec[k]), err_msg=k)
    img = wire.decode_inputs({"img": torch.from_numpy(got_in["img"])})["img"]
    np.testing.assert_array_equal(img.numpy(), inputs["img"])


def test_mano_head_gt_matches_jax():
    mano = make_synthetic_mano(0)
    params = (np.random.RandomState(7).randn(3, 58) * 0.2).astype(np.float32)
    got = mano_head_gt(ManoBuffers.from_model(mano), torch.from_numpy(params))
    want = jax_mano_head_gt(JaxManoBuffers.from_model(mano), jnp.asarray(params))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


def test_reference_init_distributions():
    """The original's train-mode init: decoder convs N(0, 0.001), transformer
    and SDF linears N(0, 0.01), biases 0; weight-norm (g, v), attention
    in_proj, norm scales, the backbone and the heads untouched."""
    cfg = configs()[1]
    raw = build_model(cfg, 0)
    model = apply_reference_init(build_model(cfg, 0), torch.Generator().manual_seed(3))
    sd, sd0 = model.state_dict(), raw.state_dict()
    dec = "decoder_net.resnet_decoder."
    enc0 = "hand_transformer.encoder.layers.0."
    assert abs(sd[dec + "conv1.0.weight"].std().item() - 0.001) < 3e-4
    assert abs(sd[dec + "deconv1.0.weight"].std().item() - 0.001) < 3e-4
    assert sd[dec + "conv1.0.bias"].abs().max() == 0
    assert abs(sd[enc0 + "linear1.weight"].std().item() - 0.01) < 3e-3
    assert sd[enc0 + "linear1.bias"].abs().max() == 0
    assert abs(sd[enc0 + "self_attn.out_proj.weight"].std().item() - 0.01) < 3e-3
    assert abs(sd["hand_sdf_decoder.linh4.weight"].std().item() - 0.01) < 3e-3
    for k in ("hand_sdf_decoder.linh0.weight_v", "hand_sdf_decoder.linh0.weight_g",
              enc0 + "self_attn.in_proj_weight", "backbone_net.resnet.conv1.weight",
              "linear_pose.layers.0.weight", enc0 + "norm1.weight", dec + "conv1.1.weight"):
        assert torch.equal(sd[k], sd0[k]), k


def test_entry_points_turn_tf32_off():
    """Every entry point sets the port's precision: no TF32 in cuBLAS or cuDNN,
    whatever the flags were before."""
    cfg = configs()[1]
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = [f.allow_tf32 for f in flags]
    makers = (lambda: ptrain.create_train_state(cfg, build_model(cfg, 0), device="cpu"),
              lambda: ptrain.make_train_step(cfg, mano, device="cpu"),
              lambda: ptrain.make_eval_step(cfg, build_model(cfg, 0), mano, device="cpu"))
    try:
        for make in makers:
            for f in flags:
                f.allow_tf32 = True
            make()
            assert not any(f.allow_tf32 for f in flags)
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b


def test_checkpoint_round_trip_and_converter(setup, tmp_path):
    """A snapshot in the original layout: read back by the JAX package's
    converter into the same flax trees, and resumed into a fresh state."""
    pcfg, params, stats, mano, inputs, targets, _ = setup
    state = port_train_state(pcfg, params, stats)
    step = ptrain.make_train_step(pcfg, ManoBuffers.from_model(mano), device="cpu")
    state, _ = step(state, inputs, targets, None, 0.0, use_presampled=True)
    path = ckpt.save_snapshot(str(tmp_path), 3, state)
    assert os.path.basename(path) == "snapshot_3.pth.tar"
    assert ckpt.latest_epoch(str(tmp_path)) == 3

    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"epoch", "network", "optimizer", "step"}
    assert all(k.startswith("module.") for k in raw["network"])
    conv_params, conv_stats = convert_state_dict(load_torch_state(path))
    want = state_dict_numpy_from_jax(conv_params, conv_stats)
    sd = state.model.state_dict()
    assert set(want) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)

    fresh = port_train_state(pcfg, params, stats)
    assert ckpt.restore_snapshot(str(tmp_path), fresh) == 3
    assert fresh.step == state.step == 1
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    got_opt, want_opt = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    for i, s in want_opt["state"].items():
        for name, v in s.items():
            assert torch.equal(got_opt["state"][i][name], v), (i, name)


def test_train_loop_synthetic_trains_and_resumes(tmp_path):
    """``train_loop.main --synthetic`` on the CPU: two iterations, a finite
    loss, a snapshot; then ``--continue`` resumes from it."""
    import json

    from hoisdf_torch import train_loop

    args = ["--synthetic", "--cpu", "--iters-per-epoch", "2", "--batch-size", "2",
            "--point_sampling_epoch", "0", "--run_dir_name", "t",
            "--cfg", f"output_dir={tmp_path}", "--cfg", "transfer_dtype=uint8"]
    train_loop.main(args + ["--end_epoch", "1"])
    out = tmp_path / "t"
    assert (out / "model_dump" / "snapshot_0.pth.tar").exists()
    rows = [json.loads(line) for line in
            (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
    assert rows and all(np.isfinite(r["train_total"]) for r in rows)
    train_loop.main(args + ["--end_epoch", "2", "--continue"])
    assert (out / "model_dump" / "snapshot_1.pth.tar").exists()
    log = (out / "log" / "train_logs.txt").read_text()
    assert "resumed from epoch 0" in log and "training done" in log
    snap = torch.load(out / "model_dump" / "snapshot_1.pth.tar", weights_only=True)
    assert snap["step"] == 4
