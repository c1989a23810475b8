"""The port's in-program spans (``hoisdf_torch/utils/profiling.py``) on the
CPU: nothing is recorded without a profiler; under ``torch.profiler`` the
eval and train steps record the model's stages nested under the step, the
batching server records each request under one id and the threads the
profiler misses, the spans map onto the trace's clock, and
``capture_trace`` writes the server's spans into the trace it exports.

One tiny f32 model (``SYNTHETIC_TINY_OVERRIDES``, the hier cascade cut to
((4, 16), (2, 32))), batch 2, one torch thread; no JAX.
"""

import glob
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, get_config
from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.predictor import INPUT_KEYS, BatchingServer, Predictor
from hoisdf_torch.train import create_train_state, make_eval_step, make_train_step
from hoisdf_torch.utils import profiling

from torch_port_util import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BATCH = 2
MODEL_STAGES = ("model.backbone", "model.decoder", "model.sampler", "model.field_queries",
                "model.tokens", "model.transformers", "model.heads")
DISPATCHER = ("serve.wait_first", "serve.collect", "serve.assemble", "serve.pipeline_full",
              "predictor.predict_async")
COMPLETER = ("serve.wait_step", "serve.scatter")


@pytest.fixture(scope="module")
def tiny_cfg():
    return get_config("dexycb", **SYNTHETIC_TINY_OVERRIDES, compute_dtype="float32",
                      hier_levels=((4, 16), (2, 32)), hier_levels_obj=None)


@pytest.fixture(scope="module")
def mano():
    return ManoBuffers.from_model(make_synthetic_mano(0), torch.device("cpu"))


@pytest.fixture(scope="module")
def eval_step(tiny_cfg, mano, one_torch_thread):
    step = make_eval_step(tiny_cfg, build_model(tiny_cfg), mano, device="cpu")
    inputs, _ = split_inputs_targets(synthetic_batch(tiny_cfg, BATCH, seed=5))
    step(inputs)  # warm
    return step, inputs


@pytest.fixture(scope="module")
def pred(tiny_cfg, one_torch_thread):
    p = Predictor(tiny_cfg, batch_size=BATCH, device="cpu")
    p.warmup()
    return p


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.RECORDER.reset()
    yield
    profiling.RECORDER.reset()


def _profiled(fn):
    """Run ``fn`` under a CPU profiler, after one range of its own (the
    profiler's first range on a thread opens slowly) -> (the Chrome trace's
    events, the recorder's spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            pass
        fn()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"spans_{os.getpid()}_{threading.get_native_id()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return events, profiling.RECORDER.spans()


def _annotations(events):
    return [(ev["name"], ev["ts"]) for ev in events if ev.get("cat") == "user_annotation"]


def _serve(pred, tiny_cfg, n):
    frames = {k: v for k, v in synthetic_batch(tiny_cfg, n, seed=9).items() if k in INPUT_KEYS}
    with BatchingServer(pred, max_wait_ms=2.0) as srv:
        futs = [srv.submit({k: v[i] for k, v in frames.items()}) for i in range(n)]
        for fut in futs:
            fut.result(timeout=60)


def test_without_a_profiler_nothing_is_recorded(eval_step):
    step, inputs = eval_step
    assert profiling.span("eval.step") is profiling.span("model.backbone", rid=3)
    with profiling.span("outer"):
        profiling.record("serve.queued", 0, 10, rid=1)
    step(inputs)
    assert profiling.RECORDER.spans() == [] and profiling.RECORDER.dropped == 0


def test_the_eval_step_records_the_model_stages_under_eval_step(eval_step):
    step, inputs = eval_step
    _, spans = _profiled(lambda: step(inputs))
    parents = {s.name: s.parent for s in spans}
    assert parents["eval.step"] is None
    for name in ("eval.decode", "eval.mano", "model.sdf_supervise", *MODEL_STAGES):
        assert parents[name] == "eval.step", name
    outer = next(s for s in spans if s.name == "eval.step")
    me = threading.get_native_id()
    for s in spans:
        assert s.tid == me and s.traced and outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    # the stages in the forward's order
    starts = [next(s.start_ns for s in spans if s.name == n) for n in MODEL_STAGES]
    assert starts == sorted(starts)


def test_the_train_step_records_its_stages(tiny_cfg, mano):
    batch = synthetic_batch(tiny_cfg, BATCH, seed=6, train=True)
    inputs, targets = split_inputs_targets(batch)
    for k in ("hand_pre_points", "obj_pre_points"):
        inputs[k] = batch[k]
    state = create_train_state(tiny_cfg, build_model(tiny_cfg), 10, device="cpu")
    step = make_train_step(tiny_cfg, mano, device="cpu")
    _, spans = _profiled(lambda: step(state, inputs, targets, None, 0.01, use_presampled=True))
    parents = {s.name: s.parent for s in spans}
    for name in ("train.forward", "train.losses", "train.backward", "train.optimizer"):
        assert parents[name] == "train.step", name
    for name in MODEL_STAGES:
        assert parents[name] == "train.forward", name


def test_the_server_records_each_request_and_the_threads_the_profiler_misses(pred, tiny_cfg):
    n = 5
    events, spans = _profiled(lambda: _serve(pred, tiny_cfg, n))
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    submits = by["serve.submit"]
    assert len(submits) == n and all(s.traced for s in submits)
    rids = sorted(s.rid for s in submits)
    assert len(set(rids)) == n
    for name in ("serve.queued", "serve.request"):
        assert sorted(s.rid for s in by[name]) == rids, name
    queued = {s.rid: s for s in by["serve.queued"]}
    for req in by["serve.request"]:
        q = queued[req.rid]
        assert req.start_ns == q.start_ns <= q.end_ns <= req.end_ns
    dispatcher = {s.tid for s in by["serve.collect"]}
    completer = {s.tid for s in by["serve.scatter"]}
    assert len(dispatcher) == len(completer) == 1 and dispatcher != completer
    for name in DISPATCHER:
        assert {s.tid for s in by[name]} == dispatcher and not any(s.traced for s in by[name])
    for name in COMPLETER:
        assert {s.tid for s in by[name]} == completer
    for name in ("predictor.fill", "predictor.step", "predictor.pack", "eval.step"):
        assert {s.parent for s in by[name]} <= {"predictor.predict_async", "predictor.step"}
    # the profiler itself saw none of the server's threads' ranges
    seen = {name for name, _ in _annotations(events)}
    assert "serve.submit" in seen and not seen & set(DISPATCHER + COMPLETER)


def test_mapped_spans_land_on_their_own_ranges(eval_step):
    step, inputs = eval_step

    def steps():
        for _ in range(3):
            step(inputs)

    events, spans = _profiled(steps)
    clock = profiling.trace_clock(_annotations(events))
    assert clock is not None and 0 < clock.pairs <= sum(s.traced for s in spans)
    ranges = {}
    for ev in events:
        if ev.get("cat") == "user_annotation":
            ranges.setdefault(ev["name"], []).append((ev["ts"], ev["ts"] + ev["dur"]))
    placed = profiling.on_trace_clock(_annotations(events))[1]
    errors = []
    for name, own in ranges.items():
        mine = sorted((s.start * 1e6, s.end * 1e6) for s in placed if s.name == name)
        if mine:
            assert len(mine) == len(own), name
            errors += [max(abs(s - ts), abs(e - te)) for (s, e), (ts, te) in zip(mine, sorted(own))]
    # a thread preempted while a range opens misplaces that span alone
    assert len(errors) == len(spans) and clock.spread_us < 50
    assert np.median(errors) < 50 and np.mean(np.array(errors) < 50) >= 0.9, sorted(errors)


def test_the_clock_pairs_the_newest_spans_of_each_name():
    spans = [profiling.Span("a", 1, t, t + 5, None, None, True) for t in (100, 9000, 9500)]
    clock = profiling.trace_clock([("a", 2009.0), ("a", 2009.5), ("b", 1.0)], spans)
    assert clock.pairs == 2 and clock.offset_us == pytest.approx(2000.0) and clock.worst_us == 0


def test_the_buffer_is_bounded_and_counts_what_it_drops():
    rec = profiling.Recorder(capacity=3)
    for i in range(5):
        rec.add(profiling.Span("s", 1, i, i + 1, None, i, False))
    assert [s.rid for s in rec.spans()] == [2, 3, 4] and rec.dropped == 2


def test_interval_overlap():
    assert profiling.union([(3, 4), (0, 1), (0.5, 2), (5, 5)]) == [(0, 2), (3, 4)]
    assert profiling.overlap([(0, 2), (1, 3), (10, 11)], [(1.5, 2.5), (2.75, 10.5)]) == \
        pytest.approx(1.0 + 0.25 + 0.5)


def test_capture_trace_writes_the_servers_threads_into_the_trace(pred, tiny_cfg, tmp_path):
    with profiling.capture_trace(str(tmp_path)):
        _serve(pred, tiny_cfg, 4)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    timed = [ev for ev in events if ev.get("ph") == "X" and ev.get("cat") != "span"]
    lo = min(ev["ts"] for ev in timed)
    hi = max(ev["ts"] + ev["dur"] for ev in timed)
    mine = [ev for ev in events if ev.get("cat") == "span"]
    assert {ev["name"] for ev in mine} >= set(DISPATCHER + COMPLETER)
    assert all(lo <= ev["ts"] <= ev["ts"] + ev["dur"] <= hi for ev in mine)
    names = {ev["args"]["name"] for ev in events if ev.get("name") == "thread_name"}
    assert {"spans: serve.dispatcher", "spans: serve.completer"} <= names
    begins = [ev for ev in events if ev.get("ph") == "b" and ev["name"] == "serve.request"]
    assert sorted(ev["id"] for ev in begins) == sorted({ev["args"]["rid"] for ev in begins})
    assert len(begins) == 4 and trace["spanClock"]["pairs"] >= 1
    assert np.isfinite(trace["spanClock"]["offset_us"])
