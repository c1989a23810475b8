"""The readers of the program's spans (``benchmark/metrics/``): each on a
synthetic trace and span buffer against the value worked out by hand, and
in traced CPU runs of the tiny serving and eval cells, where the serving
front end's two readers read and the device's idle readers read nothing."""

import math
import os

import pytest

from benchmark import core, shared
from benchmark.tests.tiny import TINY_F32, run_cell
from benchmark.trace import DeviceTrace
from hoisdf_torch.utils import profiling

T0 = 1000.0  # the window's start on the trace's clock, s
HOST_NS = 5e9  # the host clock's reading at T0, ns
MAIN, DISPATCHER, COMPLETER = 11, 12, 13


def reader(name):
    return core.load_module(os.path.join(core.ROOT, "benchmark", "metrics", f"{name}.py"),
                            "test_reader_" + name.replace(".", "_")).read


def _ns(t):
    return int(round((t - T0) * 1e9 + HOST_NS))


@pytest.fixture
def recorder():
    profiling.RECORDER.reset()
    yield profiling.RECORDER
    profiling.RECORDER.reset()


def _span(name, tid, start, end, rid=None, traced=False):
    return profiling.Span(name, tid, _ns(start), _ns(end), None, rid, traced)


def _serving(recorder):
    """One second of serving on the trace's clock: the device busy from
    0.2 to 0.5 s; the dispatcher waits for a first request, collects,
    assembles, enqueues and blocks on a full pipeline; six requests, one
    submitted before the window."""
    t = T0
    spans = [_span("serve.wait_first", DISPATCHER, t, t + 0.1),
             _span("serve.collect", DISPATCHER, t + 0.1, t + 0.15),
             _span("serve.assemble", DISPATCHER, t + 0.15, t + 0.16),
             _span("predictor.predict_async", DISPATCHER, t + 0.16, t + 0.3),
             _span("serve.pipeline_full", DISPATCHER, t + 0.3, t + 0.6),
             _span("serve.wait_first", DISPATCHER, t + 0.6, t + 1.0),
             # another thread's call is not the dispatcher's
             _span("predictor.predict_async", MAIN, t + 0.6, t + 0.9),
             _span("serve.wait_step", COMPLETER, t + 0.3, t + 0.55),
             _span("serve.queued", DISPATCHER, t - 0.1, t + 0.05, rid=5)]
    host = []
    for rid, ms in enumerate((1, 2, 3, 4, 5)):
        start = t + 0.05 + 0.1 * rid
        spans.append(_span("serve.submit", MAIN, start, start + 1e-4, rid=rid, traced=True))
        spans.append(_span("serve.queued", DISPATCHER, start, start + ms / 1e3, rid=rid))
        # the profiler's own range of the submit, stamped 2 us late
        host.append(("serve.submit", start + 2e-6, start + 1e-4))
    for s in spans:
        recorder.add(s)
    trace = DeviceTrace([("kernel", t + 0.2, t + 0.5)], host, (t, t + 1.0))
    return shared.layer_context(trace=trace, phase="serve")


def test_the_serving_readers_on_a_synthetic_second(recorder):
    ctx = _serving(recorder)
    assert reader("serve.queue_wait_ms")(ctx) == pytest.approx(4.8, abs=1e-6)
    assert reader("serve.pipeline_full_share")(ctx) == pytest.approx(30.0, abs=1e-6)
    # idle under collect 0.05 + assemble 0.01 + predict_async 0.04 + full 0.1
    assert reader("device_idle_host.serve")(ctx) == pytest.approx(20.0, abs=1e-6)
    # with the idle under wait_first (0.1 + 0.4 s), the device's whole idle
    assert reader("device_idle.serve")(ctx) == pytest.approx(70.0)


@pytest.mark.parametrize("phase", ["eval", "train"])
def test_the_step_readers_on_a_synthetic_window(phase):
    host = [(f"{phase}.step", T0, T0 + 0.3), (f"{phase}.step", T0 + 0.4, T0 + 0.7),
            ("aten::mm", T0 + 0.05, T0 + 0.06)]
    trace = DeviceTrace([("kernel", T0 + 0.1, T0 + 0.45), ("copy", T0 + 0.2, T0 + 0.5)],
                        host, (T0, T0 + 1.0))
    ctx = shared.layer_context(trace=trace, phase=phase)
    # idle inside the steps: 0.0-0.1 and 0.5-0.7 s
    assert reader(f"device_idle_host.{phase}")(ctx) == pytest.approx(30.0, abs=1e-6)
    other = "train" if phase == "eval" else "eval"
    assert reader(f"device_idle_host.{other}")(ctx) is None


def test_the_readers_read_nothing_without_the_programs_spans_or_a_device(recorder):
    trace = DeviceTrace([("kernel", T0 + 0.2, T0 + 0.5)], [], (T0, T0 + 1.0))
    for name, phase in (("serve.queue_wait_ms", "serve"), ("serve.pipeline_full_share", "serve"),
                        ("device_idle_host.serve", "serve"), ("device_idle_host.eval", "eval"),
                        ("device_idle_host.train", "train")):
        assert reader(name)(shared.layer_context(trace=trace, phase=phase)) is None, name
    ctx = _serving(recorder)
    ctx.trace.device = []  # a CPU run
    assert reader("device_idle_host.serve")(ctx) is None
    assert reader("serve.pipeline_full_share")(ctx) == pytest.approx(30.0, abs=1e-6)


@pytest.mark.parametrize("cell,kind", [("dexycb.serve", "poisson_serve"),
                                       ("dexycb.eval", "eval_stream")])
def test_traced_cpu_runs_read_the_serving_spans_and_no_idle(cell, kind):
    rc, line, _ = run_cell(cell, kind, trace=1, config=TINY_F32, seed=2147483711)
    assert rc == 0 and line["correct"], line["compare"]
    metrics = line["metrics"]
    assert not any(n.startswith("device_idle") for n in metrics)
    if kind == "poisson_serve":
        for name in ("serve.queue_wait_ms", "serve.pipeline_full_share"):
            assert math.isfinite(metrics[name]["value"]) and metrics[name]["value"] >= 0, name
