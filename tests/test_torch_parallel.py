"""The port's data-parallel train path on 2 gloo CPU ranks against its own
one-process step on the global batch, at the tiny config, f32.

The JAX package's mesh step sees one global array, so its BatchNorm takes
the global batch's statistics and its count-normalised losses divide by the
global counts; the port's ranks must compute that same step.  All the checks
that need a group run in one session of two ranks (``torch_parallel_util.
session``), started once for the module; each test reads its part.

The train steps (modes off, zero1 and fsdp; presampled and field-guided; two
steps each) run from the same seeded weights as a one-process reference at
batch 4, dropout off and no jitter, each rank on its 2 rows.  The reference
records its ReLU patterns and its sampler's selections, and every rank
imposes its rows of them (``chip_smoke.relu_pattern(shard=...)``,
``recorded_selections``): BN statistics summed in another order flip ReLUs
that lie within rounding of zero, and one flip moves a tiny model's
gradient by ~3e-3 in norm.  Tolerances, with their reasons:
- losses, both steps: 1e-4 relative + 1e-6 absolute (measured: a few 1e-6
  at the first step, up to 5e-5 at the second).
- gradients of the first step: 1e-3 relative in norm per tensor + 1e-6 and
  1e-4 over all tensors (measured 3e-5 and 1.5e-5; the scalar SDF beta of
  the field-guided branch, a sum of terms that cancel, 4.4e-4).  Of the
  second: 3e-2 per tensor + 1e-5 and 1e-3 over all, the first step's
  tolerances for the JAX package in ``test_torch_train.py``: the first Adam
  step moves an element whose gradient is rounding noise (the biases below)
  by +-lr on each side at random, so the two sides start the second step
  from parameters that differ by up to 2 lr there (the one-process port
  alone, on 1 and on 6 threads, differs by 0.5 % per tensor at its second
  step; a tensor whose gradient is itself noise, of norm 1e-8, differs by
  its whole size and is held by the absolute term).
- a bias whose convolution feeds a train-mode BN has a gradient that is f32
  noise; each side's is held under ``BNCancelledBiases``' floor (the ranks'
  terms summed over the world size) instead.
- running statistics after both steps: within lr of the reference's,
  elementwise (measured 4e-5): a convolution bias that the first step moved
  by +-lr at random shifts its BN's batch mean at the second by as much,
  and the momentum takes a tenth of it.
- parameters after both steps: within 10 lr, elementwise (measured 4 lr,
  those biases; two Adam steps move an element by at most ~3.2 lr each).
"""

import os

import numpy as np
import pytest
import torch

import torch_parallel_util as U
from chip_smoke import TIE_REL
from hoisdf_torch.data.loader import DataLoader
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.parallel.mesh import Mesh, rows_of, shard_batch
from hoisdf_torch.train import create_train_state, is_frozen, lr_for_step, make_train_step
from hoisdf_torch.utils import checkpoint as ckpt
from torch_data_fixtures import ToyDataset
from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BRANCHES = ("presampled", "field_guided")
MODES = ("off", "zero1", "fsdp")


@pytest.fixture(scope="module")
def cfg():
    return U.tiny_config()


@pytest.fixture(scope="module")
def session(one_torch_thread, cfg, tmp_path_factory):
    """The one-process references, then the 2-rank session."""
    tmp = tmp_path_factory.mktemp("parallel")
    batch = U.global_batch(cfg, 4)
    refs, summaries = {}, {}
    for branch in BRANCHES:
        ref = U.train_run(None, cfg, batch, [branch == "presampled"] * 2, record=True)
        refs[branch] = str(tmp / f"ref_{branch}.pt")
        torch.save(ref, refs[branch])
        summaries[branch] = {"steps": [{k: s[k] for k in ("losses", "bn_terms")}
                                       for s in ref["steps"]],
                             "state": {k: v for k, v in ref["state"].items()
                                       if k.endswith(("running_mean", "running_var"))}}
        del ref
    # the one-process snapshot that the ranks resume
    state = create_train_state(cfg, build_model(cfg, 0), U.STEPS_PER_EPOCH, device="cpu")
    make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)), device="cpu")(
        state, *batch, None, 0.0, use_presampled=True)
    model_dir = tmp / "snapshots"
    ckpt.save_snapshot(str(model_dir / "single"), 9, state)
    ranks = U.run_ranks(U.session, 2, tmp, cfg, {"steps": batch}, refs, str(model_dir))
    for path in refs.values():
        os.remove(path)
    return {"ranks": ranks, "refs": summaries, "batch": batch, "model_dir": model_dir,
            "single": state}


# ---- the train steps -----------------------------------------------------------------

def _check_steps(session, cfg, zero, branch):
    ref = session["refs"][branch]
    ranks = [r["steps"][(zero, branch)] for r in session["ranks"]]
    got = ranks[0]
    lr = lr_for_step(cfg, 0, U.STEPS_PER_EPOCH)
    for i, (step_ref, step_got) in enumerate(zip(ref["steps"], got["steps"])):
        # every rank reads the global batch's losses
        assert all(r["steps"][i]["losses"] == step_got["losses"] for r in ranks)
        assert set(step_got["losses"]) == set(step_ref["losses"])
        for k, v in step_ref["losses"].items():
            np.testing.assert_allclose(step_got["losses"][k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        floors = U.floors_of(U.global_terms([r["steps"][i]["bn_terms"] for r in ranks]))
        ref_floors = U.floors_of(step_ref["bn_terms"])
        assert set(floors) == set(ref_floors) and floors
        rel, atol, total_tol = (1e-3, 1e-6, 1e-4) if i == 0 else (3e-2, 1e-5, 1e-3)
        err2 = ref2 = 0.0
        for k, (err, norm_ref, norm_got, _) in step_got["grad_errors"].items():
            if k in floors:
                assert norm_got <= floors[k] and norm_ref <= ref_floors[k], (i, k)
                continue
            assert err <= rel * norm_ref + atol, (i, k, err, norm_ref)
            err2, ref2 = err2 + err ** 2, ref2 + norm_ref ** 2
        assert np.sqrt(err2 / ref2) <= total_tol, (i, np.sqrt(err2 / ref2))
        if i == 0:  # the ranks' own ReLU decisions differ from the imposed ones at near-ties
            for r in ranks:
                ties = r["steps"][0]["relu_ties"]
                assert ties and all(n == 0 or near <= TIE_REL * top for n, near, top, _ in ties)
    for k, (err, norm_ref, _, max_abs) in got["state_errors"].items():
        if k.endswith(("running_mean", "running_var")):
            assert max_abs <= lr, (k, max_abs)
        elif not k.endswith("num_batches_tracked"):
            assert max_abs <= 10 * lr + 1e-6, (k, max_abs)


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("zero", MODES)
def test_two_ranks_step_equals_one_rank_on_the_global_batch(session, cfg, zero, branch):
    _check_steps(session, cfg, zero, branch)


def test_frozen_bns_stay_frozen_under_every_mode(session):
    """The backbone's frozen BN affines end both steps where the reference's
    do (their initial values) in every mode."""
    for zero in MODES:
        errs = session["ranks"][0]["steps"][(zero, "presampled")]["state_errors"]
        frozen = [k for k in errs if is_frozen(k) and k.endswith((".weight", ".bias"))]
        assert frozen and all(errs[k][3] == 0.0 for k in frozen), zero


# ---- BatchNorm and the count-normalised losses ---------------------------------------

def test_batchnorm_two_ranks_equal_one_rank_on_the_concatenated_batch(session):
    """Forward, input and affine gradients, and running statistics of the
    global batch (sum, sum of squares and count all-reduced)."""
    want = U.bn_run(None)
    ranks = [r["bn"] for r in session["ranks"]]
    tol = dict(rtol=1e-5, atol=1e-6)
    for key in ("y", "dx"):
        torch.testing.assert_close(torch.cat([r[key] for r in ranks]), want[key], **tol)
    for r in ranks:
        for key in ("dweight", "dbias", "running_mean", "running_var"):
            torch.testing.assert_close(r[key], want[key], **tol)
    # the flax rule: the biased variance of the global batch
    x, _ = U.bn_inputs()
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ranks[1]["running_var"], 0.9 + 0.1 * var, **tol)
    torch.testing.assert_close(ranks[1]["running_mean"], 0.1 * mean, **tol)


def test_count_normalised_losses_divide_by_the_global_count(session):
    """Rank 0 holds every joint member and rank 1 none; the part labels are
    valid at 7 and 1 points of rank 0's rows, at 4 and 0 of rank 1's.  The
    mean over ranks of the losses, and of their gradients (what DDP
    averages), is the global ratio; the mean of per-rank ratios is not."""
    from hoisdf_torch.losses import joint_vote_loss, sdf_part_classifier_loss

    cfg = U.tiny_config(classifier_branch=True)
    want = U.uneven_run(None, cfg)
    ranks = [r["uneven"] for r in session["ranks"]]
    assert ranks[0]["members"] > 0 and ranks[1]["members"] == 0
    assert [r["valid"] for r in ranks] == [8, 4]
    for key in ("loss_joint_3d", "sdf_cls_loss"):
        np.testing.assert_allclose(np.mean([r[key] for r in ranks]), want[key], rtol=1e-6)
    torch.testing.assert_close(torch.cat([r["doff"] for r in ranks], dim=1) / 2, want["doff"],
                               rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(torch.cat([r["dlogits"] for r in ranks]) / 2, want["dlogits"],
                               rtol=1e-5, atol=1e-9)
    # per-rank ratios, as DDP alone would average them, miss it
    t = U.uneven_inputs(cfg)
    halves = [slice(0, 2), slice(2, 4)]
    local_vote = [float(joint_vote_loss(cfg, t["points"][h], t["off"][:, h], t["cls"][:, h],
                                        t["joints"][h])[0]) for h in halves]
    local_nll = [float(sdf_part_classifier_loss(t["logits"][h], t["labels"][h]))
                 for h in halves]
    assert abs(np.mean(local_vote) - want["loss_joint_3d"]) > 1e-2 * want["loss_joint_3d"]
    assert abs(np.mean(local_nll) - want["sdf_cls_loss"]) > 1e-2 * want["sdf_cls_loss"]


def test_ranks_draw_different_dropout_masks(session):
    masks = [r["dropout"] for r in session["ranks"]]
    assert not torch.equal(masks[0], masks[1])
    torch.testing.assert_close(masks[0], U.dropout_run(None), rtol=0, atol=0)


# ---- ZeRO-1 and FSDP -------------------------------------------------------------

def test_zero1_and_fsdp_keep_a_share_of_the_state_per_rank(session):
    """DDP keeps everything on each rank; ZeRO-1 about half the moments (whole
    parameters, greedy by size); FSDP about half the moments and the
    parameters (every parameter sharded on dim 0, padded)."""
    per_rank = [{zero: r["steps"][(zero, "presampled")]["held"] for zero in MODES}
                for r in session["ranks"]]
    for mem in per_rank:
        assert mem["off"]["moments"] == mem["off"]["moments_full"]
        assert mem["off"]["params"] == mem["off"]["params_full"]
        assert mem["zero1"]["params"] == mem["zero1"]["params_full"]
        for zero, keys in (("zero1", ("moments",)), ("fsdp", ("moments", "params"))):
            for k in keys:
                share = mem[zero][k] / mem[zero][f"{k}_full"]
                assert 0.4 <= share <= 0.6, (zero, k, share)
    for zero in ("zero1", "fsdp"):  # together the ranks hold it all
        assert sum(m[zero]["moments"] for m in per_rank) >= per_rank[0][zero]["moments_full"]


@pytest.mark.parametrize("source", ["zero1", "fsdp", "single"])
def test_snapshots_resume_across_modes_and_world_sizes(session, source):
    """A 2-rank zero1 or fsdp snapshot, and a one-process one, resume at 2
    ranks in both modes: the model whole, every rank's moments its part of
    the file's (held once: ZeRO-1's wrapper keeps no copy), and the step."""
    for zero in ("zero1", "fsdp"):
        for rank in session["ranks"]:
            epoch, step, same_model, moments, copies = rank["snapshots"][(source, zero)]
            assert (epoch, step) == ((9, 1) if source == "single" else (0, 1))
            assert same_model and moments, (source, zero)
            assert copies == 0, (source, zero, copies)


@pytest.mark.parametrize("zero", ["zero1", "fsdp"])
def test_two_rank_snapshot_has_the_one_process_layout_and_loads_there(session, cfg, zero):
    model_dir = session["model_dir"]
    single = torch.load(ckpt.snapshot_path(str(model_dir / "single"), 9), weights_only=True)
    snap = torch.load(ckpt.snapshot_path(str(model_dir / zero), 0), weights_only=True)
    assert set(snap) == set(single)
    assert set(snap["network"]) == set(single["network"])
    assert all(k.startswith("module.") and not k.startswith("module.module.")
               for k in snap["network"])
    assert set(snap["optimizer"]["state"]) == set(single["optimizer"]["state"])
    for i, s in single["optimizer"]["state"].items():
        for k, v in s.items():
            assert snap["optimizer"]["state"][i][k].shape == v.shape, (i, k)
    fresh = create_train_state(cfg, build_model(cfg, 1), U.STEPS_PER_EPOCH, device="cpu")
    assert ckpt.restore_snapshot(str(model_dir / zero), fresh) == 0 and fresh.step == 1
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, snap["network"]["module." + k]), k
    opt = fresh.optimizer.state_dict()["state"]
    for i, s in snap["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(opt[i][k], v), (i, k)


# ---- the loader's default shard ---------------------------------------------------

def test_loader_default_shard_follows_the_group(session):
    """Under a group of 2 the default shard is (rank, 2), the batches those of
    the explicit shard (disjoint, equal length, from the epoch's one
    permutation); (0, 1) given keeps the whole dataset."""
    ranks = [r["loader"] for r in session["ranks"]]
    whole = U.loader_run(None)["default"]
    for rank, got in enumerate(ranks):
        assert got["default"]["shard"] == (rank, 2)
        assert got["explicit"] == whole
        dl = DataLoader(ToyDataset(), 4, shuffle=True, seed=1, num_workers=2, shard_id=rank,
                        num_shards=2)
        assert got["default"]["len"] == len(dl)
        for epoch, ids in enumerate(got["default"]["ids"]):
            dl.set_epoch(epoch)
            assert ids == np.concatenate([b["x"][:, 0] for b in dl]).astype(int).tolist()
    for epoch in (0, 1):
        a, b = (set(r["default"]["ids"][epoch]) for r in ranks)
        assert not a & b and len(a) == len(b) == 23 // 2
    assert ranks[0]["default"]["ids"][0] != ranks[0]["default"]["ids"][1]


def test_loader_default_shard_without_a_group_is_the_identity():
    got = U.loader_run(None)
    assert got["default"]["shard"] == got["explicit"]["shard"] == (0, 1)
    assert got["default"]["ids"] == got["explicit"]["ids"]
    assert sorted(got["default"]["ids"][0]) == list(range(23))


# ---- the mesh helpers ----------------------------------------------------------------

def test_shard_batch_takes_contiguous_rows():
    batch = {"a": np.arange(12).reshape(6, 2), "b": torch.arange(6)}
    for rank in range(3):
        mesh = Mesh(rank=rank, world=3)
        got = shard_batch(batch, mesh)
        np.testing.assert_array_equal(got["a"], batch["a"][2 * rank:2 * rank + 2])
        assert got["b"].tolist() == [2 * rank, 2 * rank + 1]
    assert rows_of(6, Mesh()) == slice(0, 6)
    with pytest.raises(ValueError, match="split"):
        rows_of(5, Mesh(rank=0, world=2))


def test_one_process_without_a_group_calls_no_collective(cfg, monkeypatch):
    """No group: the train step (both branches) and the snapshot never reach
    torch.distributed's collectives."""
    import torch.distributed as dist

    def forbidden(*args, **kwargs):
        raise AssertionError("a collective was called without a group")

    for name in ("all_reduce", "broadcast", "all_gather", "all_gather_object", "barrier",
                 "reduce_scatter_tensor", "all_gather_into_tensor"):
        monkeypatch.setattr(dist, name, forbidden)
    batch = U.global_batch(cfg, 2)
    state = create_train_state(cfg, build_model(cfg, 0), U.STEPS_PER_EPOCH, device="cpu")
    assert state.mesh is None and state.module is state.model
    step = make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)), device="cpu")
    for pre in (True, False):
        step(state, *batch, None, 0.0, use_presampled=pre)
    with pytest.raises(ValueError, match="process group"):
        create_train_state(cfg, build_model(cfg, 0), device="cpu", zero="zero1")


def test_unused_parameters_are_the_object_classifier_head_in_both_branches():
    """DDP looks for unused parameters only under classifier_branch: then the
    object SDF decoder's classifier head is the one parameter set without a
    gradient, in either branch; without it every parameter takes one."""
    for over, unused in (({}, set()), ({"classifier_branch": True},
                                       {"obj_sdf_decoder.classifier_head.weight",
                                        "obj_sdf_decoder.classifier_head.bias"})):
        cfg = U.tiny_config(**over)
        batch = U.global_batch(cfg, 2)
        for pre in (True, False):
            state = create_train_state(cfg, build_model(cfg, 0), device="cpu")
            make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)), device="cpu")(
                state, *batch, None, 0.0, use_presampled=pre)
            got = {n for n, p in state.model.named_parameters() if p.grad is None}
            assert got == unused, (over, pre, got)
