"""The benchmark's counts: the kernel bounds of the port's kernel table, the
launches and rows of a dexycb eval step as the port passes them, and the
idle share of a hand-made device timeline."""

import pytest

from benchmark import counts
from benchmark.core import reference_config
from benchmark.trace import DeviceTrace
from hoisdf_torch.config import get_config

PK = counts.PEAKS["NVIDIA H100 80GB HBM3"]


def _close(a, b, rel):
    assert abs(a - b) <= rel * abs(b), (a, b)


def test_bounds_reproduce_the_kernel_table():
    d = get_config("dexycb", compute_dtype="bfloat16")
    h = get_config("ho3d")
    # kernel A: 0.125 ms at 78,848 bf16 rows, 0.444 for a step's 8, 6.549 f32
    # (the table took 67 TFLOP/s for f32, this file NVIDIA's 66.9)
    _close(counts.sdf_mlp_bound_s(d, 78848, "bfloat16", PK) * 1e3, 0.125, 0.005)
    _close(counts.eval_step_bounds(d, 22, PK, True)["sdf_mlp"] * 1e3, 0.444, 0.005)
    _close(counts.train_step_bounds(h, 22, PK, True)["sdf_mlp"] * 1e3, 6.549, 0.005)
    # kernel B at 22 x 3,584 points: 0.060 (dexycb), 0.240 (ho3d); backward
    # at 22 x 800: 0.048, 0.190
    _close(counts.gather_bound_s(d, 22, 3584, "bfloat16", PK) * 1e3, 0.060, 0.01)
    _close(counts.gather_bound_s(h, 22, 3584, "bfloat16", PK) * 1e3, 0.240, 0.01)
    _close(counts.gather_bwd_bound_s(d, 22, 800, PK) * 1e3, 0.048, 0.01)
    _close(counts.gather_bwd_bound_s(h, 22, 800, PK) * 1e3, 0.190, 0.01)


def test_eval_step_flops_match_the_port_count():
    from benchmark.counts.flops import eval_step_flops

    cfg = reference_config(get_config("dexycb", compute_dtype="bfloat16"))
    per_frame = eval_step_flops(cfg, 22, True) / 22
    _close(per_frame, 80.803491068e9, 1e-4)  # the port's FlopCounterMode count


def test_rows_and_launches_equal_what_the_port_passes(monkeypatch):
    """A dexycb eval step at the published widths (batch 1 on the CPU,
    f32): 8 launches of A whose rows per frame are the counts', and 11 of B."""
    import hoisdf_torch.models.hoisdf as hoisdf
    import hoisdf_torch.ops.grid_sample as grid_sample
    from benchmark.inputs.frames import make_batch
    from benchmark.inputs.seeds import rng
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.train import make_eval_step

    cfg = get_config("dexycb", compute_dtype="float32", transfer_dtype="uint8")
    rows, gathers = [], []
    mlp, gather = hoisdf.sdf_mlp, grid_sample.gather_lerp
    monkeypatch.setattr(hoisdf, "sdf_mlp", lambda x, w: rows.append(x.shape[0]) or mlp(x, w))
    monkeypatch.setattr(grid_sample, "gather_lerp",
                        lambda g, f, n=False: gathers.append(g.shape[1]) or gather(g, f, n))
    model = hoisdf.build_model(cfg, 0)
    step = make_eval_step(cfg, model, ManoBuffers.from_model(make_synthetic_mano(0)),
                          device="cpu")
    step(make_batch(cfg, 1, rng(1, "frames")))
    assert rows == counts.sampler_rows(cfg)
    assert sum(rows) * 22 == 278784
    launches = counts.eval_step_launches(cfg, True)
    assert (len(rows), len(gathers)) == (launches["sdf_mlp"], launches["gather_lerp"]) == (8, 11)


def test_timeline_union_and_idle_share():
    # kernels on two streams overlap; gaps before, between and after
    dev = [("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 6.0, 7.0), ("d", 6.5, 6.8)]
    host = [("launch", 0.0, 10.0), ("wait", 4.2, 5.8)]
    tr = DeviceTrace(dev, host, (0.0, 10.0))
    assert tr.union() == [(1.0, 4.0), (6.0, 7.0)]
    assert tr.busy_s() == pytest.approx(4.0)
    assert tr.gaps() == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    assert dict(tr.idle_by_host()) == pytest.approx({"launch": 4.0, "wait": 2.0})
    assert tr.kernel_seconds(lambda n: True) == pytest.approx(2.0 + 2.0 + 1.0 + 0.3)
    # clipped to the window
    assert DeviceTrace(dev, host, (2.5, 6.2)).busy_s() == pytest.approx(1.5 + 0.2)
