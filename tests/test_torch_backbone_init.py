"""``train_loop --backbone-init`` of the port (``load_backbone_init``)
against the JAX package's graft: a shape-correct random torchvision
ResNet-18 state dict (``tests/test_ckpt_convert.py``'s) grafted by the port
straight from the ``.pth``, and by ``convert_torchvision_resnet`` plus the
JAX package's ``load_backbone_init`` on a JAX state holding the same
weights (carried over by ``convert_state_dict`` and back by
``state_dict_from_jax``).  Both states must then be equal bit for bit, the
backbone the file's and everything outside it unchanged.  Then the CLI on
the CPU, and the refusals."""

import numpy as np
import optax
import pytest
import torch

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, get_config
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.train import create_train_state
from hoisdf_torch.train_loop import load_backbone_init, main
from hoisdf_torch.weights import state_dict_from_jax
from hoisdf_tpu.tools.convert_torch_ckpt import convert_state_dict, convert_torchvision_resnet
from hoisdf_tpu.train import TrainState as JaxTrainState
from hoisdf_tpu.train_loop import load_backbone_init as jax_load_backbone_init
from hoisdf_tpu.utils import checkpoint as jax_ckpt

from test_ckpt_convert import _fake_torchvision_resnet18_state
from torch_port_util import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PREFIX = "backbone_net.resnet."


def _torchvision_pth(path):
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in
             _fake_torchvision_resnet18_state().items()}
    rng = np.random.RandomState(1)  # BN away from (1, 0, 0, 1), so each field shows
    for k, v in state.items():
        if v.dtype == torch.float32 and v.dim() == 1 and not k.startswith("fc."):
            state[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
    torch.save(state, path)
    return state


@pytest.fixture(scope="module")
def cfg():
    return get_config("dexycb", **SYNTHETIC_TINY_OVERRIDES)


def test_graft_matches_the_jax_graft(cfg, tmp_path):
    tv = _torchvision_pth(tmp_path / "resnet18.pth")
    state = create_train_state(cfg, build_model(cfg, 0), device="cpu")
    before = {k: v.clone() for k, v in state.module.state_dict().items()}
    params, stats = convert_state_dict({k: v.numpy() for k, v in before.items()})
    jstate = JaxTrainState(step=0, params=params, batch_stats=stats, opt_state={},
                           tx=optax.identity())

    assert load_backbone_init(state, str(tmp_path / "resnet18.pth")) is state
    bb_params, bb_stats = convert_torchvision_resnet({k: v.numpy() for k, v in tv.items()})
    jax_ckpt.save_snapshot(str(tmp_path / "jax"), 0, {  # as convert_torch_ckpt --torchvision
        "params": bb_params, "batch_stats": bb_stats, "opt_state": {}, "step": 0})
    jstate = jax_load_backbone_init(jstate, str(tmp_path / "jax"))

    got = state.module.state_dict()
    want = state_dict_from_jax(jstate.params, jstate.batch_stats)
    assert set(want) <= set(got)
    for k, w in want.items():
        assert torch.equal(got[k], w.to(got[k].dtype)), k
    grafted = [k for k in got if k.startswith(PREFIX) and "num_batches" not in k]
    assert len(grafted) == len([k for k in tv if not k.startswith("fc.")
                                and "num_batches" not in k])
    for k in grafted:
        assert torch.equal(got[k], tv[k[len(PREFIX):]]), k
    for k, v in got.items():
        if not k.startswith(PREFIX) or "num_batches" in k:
            assert torch.equal(v, before[k]), k


def test_graft_refuses_what_is_not_this_backbone(cfg, tmp_path):
    tv = _torchvision_pth(tmp_path / "ok.pth")
    state = create_train_state(cfg, build_model(cfg, 0), device="cpu")
    for name, bad in (("extra", {**tv, "layer5.0.conv1.weight": torch.zeros(1)}),
                      ("missing", {k: v for k, v in tv.items() if k != "bn1.weight"}),
                      ("shape", {**tv, "conv1.weight": torch.zeros(64, 3, 3, 3)})):
        torch.save(bad, tmp_path / f"{name}.pth")
        with pytest.raises(ValueError, match="conv1|bn1|layer5"):
            load_backbone_init(state, str(tmp_path / f"{name}.pth"))


def test_train_loop_cli_grafts_the_backbone(tmp_path, caplog):
    _torchvision_pth(tmp_path / "resnet18.pth")
    main(["--synthetic", "--cpu", "--end_epoch", "1", "--iters-per-epoch", "1",
          "--batch-size", "1", "--backbone-init", str(tmp_path / "resnet18.pth"),
          "--cfg", f"output_dir={tmp_path / 'out'}"])
    assert (tmp_path / "out" / "run" / "model_dump" / "snapshot_0.pth.tar").exists()
    log = (tmp_path / "out" / "run" / "log" / "train_logs.txt").read_text()
    assert "backbone initialized from" in log
