"""The harness on the CPU: the manifest and every file it names, a cell
added as one data file, the command's refusals, traced runs, and planted
faults that the comparison has to catch."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import core, faults
from benchmark.tests.tiny import TINY_F32, run_cell

ROOT = core.ROOT
MANIFEST = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_manifest_keys_names_and_units():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"] and 1 <= MANIFEST["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_resolves_to_its_files(cell):
    c = core.resolve_cell(cell)
    assert os.path.exists(os.path.join(ROOT, "benchmark", "kinds", f"{c.kind}.py"))
    assert c.config["reduced"] == [] and set(c.limits) == {
        "eval_stream": {"outputs", "mano", "select", "select_frame"},
        "poisson_serve": {"outputs", "mano", "select", "select_frame"},
        "train_mix": {"loss", "grad", "change", "select", "select_frame"}}[c.kind]
    reported = [m["name"] for m in c.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(core.metric_reader(c, m["name"]))
    entry = next(e for e in MANIFEST["configs"] if e["name"] == c.entry["config"])
    assert os.path.exists(os.path.join(ROOT, entry["file"]))


def test_a_new_cell_is_one_data_file(tmp_path):
    """A cell of an existing kind, added as its file and its manifest entry
    in a copy of the benchmark, runs through the harness."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    manifest = json.loads(json.dumps(MANIFEST))
    spec = core.load_json(os.path.join(ROOT, "benchmark", "workloads", "dexycb.eval.json"))
    spec["why"] = "a copy of dexycb.eval"
    (tmp_path / "benchmark" / "workloads" / "dexycb.eval_copy.json").write_text(json.dumps(spec))
    manifest["workloads"].append({"name": "dexycb.eval_copy", "config": "dexycb",
                                  "traffic": "eval_stream", "chips": 1, "why": spec["why"]})
    for m in manifest["end_to_end"]:
        if m["name"] == "eval_fps":
            m["workloads"].append("dexycb.eval_copy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    rc, line, _ = run_cell("dexycb.eval_copy", "eval_stream", root=str(tmp_path))
    assert rc == 0 and set(line["metrics"]) == {"eval_fps", "setup_s"}


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_correct_on_the_card(card_device, cell):
    """The command itself, a short window of each cell on the card."""
    res = subprocess.run(MANIFEST["command"] + ["--workload", cell, "--seed", "2147483999",
                                                "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert res.returncode == 0 and line["correct"], line["compare"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


def test_the_command_refuses_without_a_card(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "dexycb.eval", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert "{" not in out.out and "CUDA is not available" in out.err
    assert run.main(["--workload", "no.such.cell", "--seed", "1", "--seconds", "1"]) == 2


def test_a_directory_with_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(MANIFEST["command"] + ["--workload", "dexycb.eval", "--seed", "1",
                                                "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "{" not in res.stdout


@pytest.mark.parametrize("cell,kind", [("dexycb.eval", "eval_stream"),
                                       ("dexycb.serve", "poisson_serve")])
def test_traced_runs_report_what_a_cpu_can_read(cell, kind):
    rc, line, err = run_cell(cell, kind, trace=1, config=TINY_F32)
    assert rc == 0 and line["correct"]
    names = set(line["metrics"])
    assert names and names <= {m["name"] for m in MANIFEST["per_layer"]}
    # no device number from a CPU run
    assert not any("idle" in n or "roofline" in n or "device" in n for n in names)
    assert line["device"]["busy_s"] == 0 and "breakdown" in line
    assert list(line)[-1] == "compare" and err.rstrip().splitlines()[-1].startswith("compare")


# ---- faults planted under the timed path: correct has to come out false -------------

@pytest.mark.parametrize("cell,kind,fault,number", [
    ("dexycb.eval", "eval_stream", None, None),
    ("dexycb.eval", "eval_stream", faults.altered_eval, "mano"),
    ("dexycb.eval", "eval_stream", faults.half_eval, "outputs"),
    ("dexycb.eval", "eval_stream", faults.one_frame_select, "select_frame"),
    ("dexycb.serve", "poisson_serve", None, None),
    ("dexycb.serve", "poisson_serve", faults.altered_serve, "mano"),
    ("dexycb.serve", "poisson_serve", faults.half_serve, "outputs"),
    ("dexycb.serve", "poisson_serve", faults.one_frame_select, "select_frame"),
    ("ho3d.train", "train_mix", faults.unchanged_state, "change"),
    ("ho3d.train", "train_mix", faults.half_train, "loss"),
    ("ho3d.train", "train_mix", faults.one_frame_select, "select_frame"),
])
def test_planted_faults_come_out_incorrect(cell, kind, fault, number):
    rc, line, _ = run_cell(cell, kind, config=TINY_F32, fault=fault)
    assert rc == 0
    if fault is None:
        assert line["correct"], line["compare"]
        return
    assert not line["correct"]
    cmp = line["compare"][number]
    assert cmp["value"] > cmp["limit"], line["compare"]


def _replayed(carry: bool):
    """An eval step that runs the model once a batch and replays its outputs
    after that, as a captured graph would: the checked pass sees no forward.
    With ``carry`` its outputs carry the selection and the head inputs."""
    from benchmark import shared

    def hook(what, obj):
        if what == "model":
            hook.model = obj
        if what != "eval_step":
            return obj
        cache = {}

        def replay(batch):
            key = id(batch["img"])
            if key not in cache:
                reader = shared.ProgramReader(hook.model)
                out = dict(obj(batch))
                read = reader.take()
                reader.remove()
                if carry:
                    out.update({shared.OUTPUT_READS[k]: v for k, v in read.items()})
                cache[key] = out
            return cache[key]
        return replay
    return hook


@pytest.mark.parametrize("carry", [False, True])
def test_a_step_that_hides_its_forward_is_judged_by_its_outputs(carry):
    rc, line, err = run_cell("dexycb.eval", "eval_stream", config=TINY_F32,
                             fault=_replayed(carry))
    assert rc == 0 and line["correct"] == carry, line["compare"]
    if not carry:
        assert "saw no forward" in err
