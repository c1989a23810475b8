"""``hoisdf-torch-bench`` (``hoisdf_torch/bench.py``) on the CPU: the
headline's last line at ``--cpu``, the SDF MLP op's FLOP formula against
``FlopCounterMode``'s count of the plain MLP, the percentiles, the sweep's
record, the serving and train modes at the tiny size, and the refusal to
run without a card unless ``--cpu`` is given.  One torch thread; about 40 s
in all."""

import json

import numpy as np
import pytest
import torch

from hoisdf_torch import bench
from hoisdf_torch.ops.kernels.gather_lerp import gather_lerp
from hoisdf_torch.ops.kernels.sdf_mlp import prepare_weights, sdf_mlp, sdf_mlp_plain
from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HEADLINE_FIELDS = {
    "metric", "value", "unit", "p50_ms_per_frame", "p90_ms_per_frame", "device_ms", "host_ms",
    "launches", "launches_sdf_mlp", "launches_gather_lerp", "flops_per_frame", "mfu",
    "peak_flops", "peak_gib", "setting", "batch", "dtype", "sampler", "wire", "runs", "spread",
    "device", "power_limit_w"}


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def test_cpu_headline_prints_every_field(capsys):
    assert bench.main(["--cpu", "--iters", "2", "--runs", "2"]) == 0
    last = _lines(capsys)[-1]
    assert HEADLINE_FIELDS <= set(last)
    assert "vs_baseline" not in last
    assert (last["metric"], last["unit"]) == ("eval_fps", "frames/s")
    assert (last["setting"], last["batch"], last["dtype"], last["sampler"], last["wire"],
            last["runs"]) == ("dexycb", 4, "float32", "hier", "uint8", 2)
    assert last["mfu"] is None and "no card" in last["mfu_note"]
    assert last["flops_per_frame"] > 0
    assert last["device"] is None and last["power_limit_w"] is None
    assert last["device_ms"] is None and last["peak_gib"] is None
    assert last["launches_sdf_mlp"] == last["launches_gather_lerp"] == 0  # plain versions
    lo, hi = last["spread"]["fps"]
    assert 0 < lo <= last["value"] <= hi
    lo, hi = last["spread"]["p50_ms_per_frame"]
    assert lo <= last["p50_ms_per_frame"] <= hi
    assert last["p50_ms_per_frame"] * 4 == pytest.approx(last["p50_ms_per_batch"])


def test_sdf_mlp_flop_formula_is_the_plain_mlps_count():
    """The op's registered formula, 2 x rows x sum(in x out) with the skip
    concat's widened input, equals FlopCounterMode's count of the plain
    MLP's matrix products, at ragged widths and row counts; the gather
    counts 0."""
    from torch.utils.flop_counter import FlopCounterMode

    g = torch.Generator().manual_seed(0)
    for rows, in_dim, h in ((33, 7, (16, 12, 10, 8)), (1, 5, (9, 9, 3, 4)), (0, 3, (4, 4, 4, 4))):
        shapes = [(in_dim, h[0]), (h[0],), (h[0], h[1]), (h[1],), (h[1] + in_dim, h[2]), (h[2],),
                  (h[2], h[3]), (h[3],), (h[3], 1), (1,)]
        w = prepare_weights([torch.randn(s, generator=g) for s in shapes], torch.float32)
        x = torch.randn(rows, in_dim, generator=g)
        with FlopCounterMode(display=False) as through_op:
            got = sdf_mlp(x, w)
        with FlopCounterMode(display=False) as plain:
            want = sdf_mlp_plain(x, w.plain)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        expect = 2 * rows * (in_dim * h[0] + h[0] * h[1] + (h[1] + in_dim) * h[2] + h[2] * h[3]
                             + h[3])
        assert through_op.get_total_flops() == plain.get_total_flops() == expect
        assert set(through_op.get_flop_counts()["Global"]) == {torch.ops.hoisdf_torch.sdf_mlp}
    maps = [torch.randn(2, 4, 4, 3, generator=g), torch.randn(2, 2, 2, 5, generator=g)]
    with FlopCounterMode(display=False) as counter:
        gather_lerp(torch.rand(2, 6, 2, generator=g) * 2 - 1, maps)
    assert counter.get_total_flops() == 0


def test_percentiles_are_numpys():
    lat = [7.0, 1.0, 3.0, 10.0, 2.0, 9.0, 4.0, 8.0, 6.0, 5.0]
    got = bench.percentiles(lat)
    for q in (50, 95, 99):
        assert got[f"p{q}_ms"] == float(np.percentile(lat, q))
    # not the index pick lat[int(len(lat) * p)] of a sorted list
    assert got["p50_ms"] == 5.5 != sorted(lat)[len(lat) // 2]
    assert bench.percentiles([], (50, 90)) == {"p50_ms": None, "p90_ms": None}


def test_peak_flops_table():
    assert bench.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989.4e12
    assert bench.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 66.9e12
    assert bench.peak_flops("NVIDIA H100 PCIe", "bfloat16") == 756e12
    assert bench.peak_flops("NVIDIA A100-SXM4-80GB", "bfloat16") is None


def test_record_writes_only_the_torch_sweep_file(tmp_path, capsys):
    assert bench.main(["--cpu", "--batch-sweep", "1,2", "--iters", "1", "--warmup", "1",
                       "--runs", "1", "--record", "--root", str(tmp_path)]) == 0
    written = sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*")
                     if p.is_file())
    assert written == ["docs/torch_eval_batch_sweep_dexycb.json"]
    doc = json.loads((tmp_path / written[0]).read_text())
    assert [r["batch"] for r in doc["rows"]] == [1, 2]
    assert all(r["fps"] > 0 and r["flops_per_frame"] > 0 and r["mfu"] is None for r in doc["rows"])
    assert doc["device"] == "cpu" and doc["batch_opt"] in (1, 2)
    last = _lines(capsys)[-1]
    assert last["metric"] == "eval_batch_sweep" and last["rows"] == doc["rows"]


def test_serving_and_train_modes_at_the_tiny_size(capsys):
    assert bench.main(["--cpu", "--serve", "--serve-seconds", "1", "--serve-poisson", "3",
                       "--train", "--train-batch", "1"]) == 0
    lines = {ln["metric"] + ln.get("branch", ""): ln for ln in _lines(capsys)}
    served = lines["serve_fps"]
    assert served["clients"] == 12 and served["frames_served"] > 0
    assert served["responses"] == served["frames_served"] and served["bad_responses"] == 0
    assert not served["errors"] and served["threads_alive"] == 0
    poisson = lines["serve_poisson_goodput"]
    assert poisson["offered_hz"] == 3.0 and poisson["completed"] == poisson["submitted"] > 0
    assert poisson["dropped"] == 0
    for branch in ("presampled", "field_guided"):
        train = lines["train_ms" + branch]
        assert train["finite"] and len(train["ms"]) == 3
        assert train["value"] == float(np.median(train["ms"]))


def test_without_cpu_and_without_a_card_it_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--iters", "1"])
    assert exc.value.code not in (0, None)
