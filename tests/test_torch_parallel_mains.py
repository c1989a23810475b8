"""The port's data-parallel entry points on 2 gloo CPU ranks: ``torchrun ...
-m hoisdf_torch.train_loop --zero zero1`` writes one snapshot that the
one-process port loads, ``evaluate.main`` at 2 ranks writes the results of
1 rank, and both dry runs of ``hoisdf_torch.parallel.dryrun`` pass."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_util as U
from hoisdf_torch import evaluate, train_loop
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.parallel import dryrun
from hoisdf_torch.train import create_train_state
from hoisdf_torch.utils import checkpoint as ckpt
from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _results(path) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            key, _, value = line.partition(" : ")
            out[key.strip()] = float(value)
    return out


def _evaluate_main(mesh, argv):
    return evaluate.main(argv)


def test_evaluate_main_two_ranks_writes_the_one_rank_results(tmp_path):
    """Synthetic eval at 2 ranks (a batch of 5 rounded down to 4, 2 rows a
    rank, the predictions gathered to rank 0) against 1 rank at 4: the same
    keys, every value within 1e-5 relative (the eval forward at 2 rows and
    at 4 rounds alike up to the last bits)."""
    one = evaluate.main(["--synthetic", "--cpu", "--batch-size", "4",
                         "--out", str(tmp_path / "one")])
    paths = U.run_ranks(_evaluate_main, 2, tmp_path,
                        ["--synthetic", "--cpu", "--batch-size", "5",
                         "--out", str(tmp_path / "two")])
    assert paths == [str(tmp_path / "two" / "results.txt")] * 2
    assert os.listdir(tmp_path / "two") == ["results.txt"]
    got, want = _results(paths[0]), _results(one)
    assert set(got) == set(want) and len(want) >= 5
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_torchrun_train_loop_zero1_writes_a_snapshot_the_one_process_port_loads(tmp_path):
    """torchrun, 2 CPU ranks, ZeRO-1: one epoch of 2 steps, one snapshot in
    the one-process layout (rank 0 alone writes the logs and the
    snapshot), which a one-process state restores."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "hoisdf_torch.train_loop", "--synthetic", "--cpu", "--zero", "zero1",
           "--end_epoch", "1", "--iters-per-epoch", "2", "--batch-size", "1",
           "--run_dir_name", "t", "--cfg", f"output_dir={tmp_path}"]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    run = tmp_path / "t"
    assert sorted(os.listdir(run / "model_dump")) == ["snapshot_0.pth.tar"]
    log = (run / "log" / "train_logs.txt").read_text()
    assert "sharded train state over 2 ranks (zero1)" in log and "training done" in log
    assert log.count("itr 1/2") == 1  # rank 0's lines only
    cfg = U.tiny_config(train_batch_size=1)
    state = create_train_state(cfg, build_model(cfg, 1), 2, device="cpu")
    assert ckpt.restore_snapshot(str(run / "model_dump"), state) == 0
    assert state.step == 2
    snap = torch.load(run / "model_dump" / "snapshot_0.pth.tar", weights_only=True)
    assert len(snap["optimizer"]["state"]) == len(state.optimizer.param_groups[0]["params"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, snap["network"]["module." + k]), k


def test_train_loop_multihost_needs_the_group_environment(monkeypatch, tmp_path):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_loop.main(["--synthetic", "--cpu", "--multihost"])
    with pytest.raises(ValueError, match="process group"):
        train_loop.main(["--synthetic", "--cpu", "--zero", "fsdp", "--end_epoch", "1",
                         "--cfg", f"output_dir={tmp_path}"])


@pytest.mark.parametrize("argv,expect", [(["--nproc", "2"], "every rank read the losses"),
                                         (["--hosts", "2"], "disjoint loader shards")])
def test_dryrun(argv, expect, capsys):
    assert dryrun.main(argv) == 0
    assert expect in capsys.readouterr().out


def _fails_on_rank_1(mesh):
    import torch.distributed as dist

    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()  # rank 0 waits for a peer that never comes


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*rank 1 gives up"):
        U.run_ranks(_fails_on_rank_1, 2, tmp_path, timeout=120)
