"""The eval forward's CUDA graph (``models/forward_graph.py``) on the card,
against ``HOISDF.eager_forward``: the dexycb preset at full width, bf16,
batch 22.

Every replay is held bitwise to the eager forward on the same weights and
batch (the graph runs the same kernels on the same inputs): in each sampler
setting with the SDF supervision queries on and off, with two forwards in
flight before any read, after an in-place ``load_state_dict``, after a
parameter is replaced, and at a second batch size.  A replay adds the
launches its capture counted; ``graph_counts`` counts each forward once;
a warmed ``Predictor`` only replays; a train step never captures.  Each
case skips without an NVIDIA card; on one: ``python -m pytest
tests/test_torch_forward_graph.py -q``.
"""

import pytest
import torch

from hoisdf_torch.config import get_config
from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models import forward_graph
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.ops.kernels import (
    graph_counts,
    launch_counts,
    reset_graph_counts,
    reset_launch_counts,
)
from hoisdf_torch.predictor import INPUT_KEYS, Predictor
from hoisdf_torch.train import create_train_state, disable_tf32, make_eval_step, make_train_step

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA card")

BATCH = 22
# the sampler settings of chip_smoke's sampler phase, and the default cascade
SETTINGS = {
    "hier": {},
    "full": dict(sdf_infer_mode="full"),
    "coarse2fine": dict(sdf_infer_mode="coarse2fine"),
    "unmerged": dict(merged_field_queries=False),
    "paired": dict(paired_sdf_infer=True, hier_levels_obj=None),
    "nearest": dict(infer_gather_nearest=True),
}


def _model(seed: int = 0, **over):
    disable_tf32()
    cfg = get_config("dexycb", compute_dtype="bfloat16", **over)
    return build_model(cfg, seed).cuda().eval()


def _batch(cfg, seed: int, size: int = BATCH):
    inputs, _ = split_inputs_targets(synthetic_batch(cfg, size, seed=seed))
    return {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _counts(eager: int, captures: int, replays: int):
    return {"captures": captures, "replays": replays, "eager": eager}


@pytest.fixture(scope="module")
def hier():
    model = _model()
    batches = [_batch(model.cfg, seed) for seed in range(3)]
    with torch.inference_mode():
        model(batches[0])
        model(batches[0])  # captured on the first batch
    return model, batches


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_replay_equals_the_eager_forward_bitwise(setting):
    model = _model(**SETTINGS[setting])
    a, b = _batch(model.cfg, 1), _batch(model.cfg, 2)
    reset_graph_counts()
    with torch.inference_mode():
        for supervise in (True, False):
            warm = model(a, supervise_sdf=supervise)
            captured = model(a, supervise_sdf=supervise)
            replayed = model(b, supervise_sdf=supervise)
            _assert_equal(warm, model.eager_forward(a, supervise_sdf=supervise))
            _assert_equal(captured, warm)
            _assert_equal(replayed, model.eager_forward(b, supervise_sdf=supervise))
            assert ("hand_sdf_pred" in replayed) == supervise
    assert graph_counts == _counts(eager=2, captures=2, replays=2)


def test_outputs_outlive_the_next_replay(hier):
    model, (a, b, c) = hier
    with torch.inference_mode():
        first = model(b)
        second = model(c)  # both in flight, nothing read yet
        _assert_equal(first, model.eager_forward(b))
        _assert_equal(second, model.eager_forward(c))
        _assert_equal(model(a), model.eager_forward(a))


def test_an_in_place_load_state_dict_is_seen_by_the_next_replay(hier):
    model, (_, b, _) = hier
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.inference_mode():
        before = model(b)
    model.load_state_dict(build_model(model.cfg, 1).state_dict())
    reset_graph_counts()
    with torch.inference_mode():
        after = model(b)
        assert graph_counts == _counts(eager=0, captures=0, replays=1)
        _assert_equal(after, model.eager_forward(b))
        assert not torch.equal(after["hand_off"], before["hand_off"])
    model.load_state_dict(saved)
    with torch.inference_mode():
        _assert_equal(model(b), before)


def test_a_replaced_parameter_drops_the_graphs(hier):
    model, (a, b, _) = hier
    bias = model.linear_handcls.layers[-1].bias
    old = bias.data
    bias.data = old.clone()
    reset_graph_counts()
    try:
        with torch.inference_mode():
            model(a)  # warms up again
            model(a)  # captures again
            _assert_equal(model(b), model.eager_forward(b))
        assert graph_counts == _counts(eager=1, captures=1, replays=1)
    finally:
        bias.data = old
        with torch.inference_mode():
            model(a)
            model(a)


def test_a_new_batch_size_captures_a_second_graph(hier):
    model, (a, _, _) = hier
    small = [_batch(model.cfg, seed, size=BATCH // 2) for seed in (5, 6)]
    reset_graph_counts()
    with torch.inference_mode():
        model(small[0])
        model(small[0])
        got = model(small[1])
        _assert_equal(got, model.eager_forward(small[1]))
        _assert_equal(model(a), model.eager_forward(a))
    assert graph_counts == _counts(eager=1, captures=1, replays=2)
    assert got["hand_off"].shape[1] == BATCH // 2
    assert len(forward_graph.graphs_of(model).graphs) == 2


def test_a_replay_adds_the_eager_forwards_launches(hier):
    model, (a, b, _) = hier
    with torch.inference_mode():
        reset_launch_counts()
        model.eager_forward(b)
        eager = dict(launch_counts)
        reset_launch_counts()
        model(b)
        replayed = dict(launch_counts)
    assert eager["sdf_mlp"] > 0 and eager["gather_lerp"] > 0
    assert replayed == eager


def test_the_eval_step_captures_once_and_a_train_step_never():
    model = _model()
    cfg = model.cfg
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    step = make_eval_step(cfg, model, mano, device="cuda")
    inputs, _ = split_inputs_targets(synthetic_batch(cfg, BATCH, seed=3))
    reset_graph_counts()
    outs = [step(inputs) for _ in range(5)]
    assert graph_counts == _counts(eager=1, captures=1, replays=3)
    for out in outs[1:]:
        _assert_equal(out, outs[0])

    train_cfg = get_config("dexycb")
    state = create_train_state(train_cfg, build_model(train_cfg, 0), 10, device="cuda")
    train_step = make_train_step(train_cfg, mano, device="cuda")
    inputs, targets = split_inputs_targets(synthetic_batch(train_cfg, 2, seed=4, train=True))
    reset_graph_counts()
    for use_presampled in (False, True):
        train_step(state, inputs, targets, None, 0.01, use_presampled=use_presampled)
    assert graph_counts == _counts(eager=2, captures=0, replays=0)


def test_a_warmed_predictor_only_replays():
    cfg = get_config("dexycb", compute_dtype="bfloat16")
    pred = Predictor(cfg, BATCH, "uint8", device="cuda")
    reset_graph_counts()
    pred.warmup()
    assert graph_counts == _counts(eager=1, captures=1, replays=0)
    frames = {k: v for k, v in synthetic_batch(cfg, 3, seed=8).items() if k in INPUT_KEYS}
    served = [pred.predict(frames) for _ in range(2)]
    assert graph_counts == _counts(eager=1, captures=1, replays=2)
    for k, v in served[0].items():
        assert v.shape[0] == 3 and (v == served[1][k]).all(), k
