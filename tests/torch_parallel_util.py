"""Data-parallel runs of the port for the tests: ranks started by spawn
(``hoisdf_torch.parallel.dryrun.run_ranks``: gloo CPU processes at one torch
thread, joined through a ``file://`` store under the test's directory), the
child functions they run, and the JAX-free half of the train-step
comparison (``BNCancelledBiases``).  Imports torch, numpy and the port only
(never JAX), so a spawned child stays out of the JAX package and conftest.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, get_config
from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.models.layers import Dropout
from hoisdf_torch.parallel import dryrun
from hoisdf_torch.parallel.mesh import Mesh, shard_batch
from hoisdf_torch.train import create_train_state, make_train_step

STEPS_PER_EPOCH = 10


def run_ranks(fn, world: int, tmp_path, *args, **kw):
    """``fn(mesh, *args)`` on ``world`` gloo CPU ranks at one torch thread
    each (``hoisdf_torch.parallel.dryrun.run_ranks``)."""
    return dryrun.run_ranks(fn, world, str(tmp_path), *args, threads=1, **kw)


class BNCancelledBiases:
    """Records, during one port train step, the gradient terms of every bias
    whose layer feeds a train-mode BatchNorm directly.  Such a bias's
    gradient is a sum of N = B*H*W terms (the gradient at the layer's output)
    that train-mode BN makes cancel to zero in exact arithmetic, so in f32 it
    is rounding noise on both sides and the two sides' noise cannot be
    compared.  :meth:`floors` gives each such bias a noise floor instead:
    ``ceil(log2 N) * eps_f32 * ||sum_i |g_i| ||`` over its channels, the
    error bound of a pairwise f32 sum of the terms that cancel (a summation
    tree of depth log2 N rounds each partial sum once per level)."""

    def __init__(self, model):
        import torch

        from hoisdf_torch.models.layers import BatchNorm2d

        self.terms = {}  # bias name -> (per-channel sum of |g|, N)
        outputs, handles = {}, []

        def layer_hook(name):
            def hook(module, inputs, out):
                outputs[id(out)] = (name, out)
            return hook

        def bn_hook(module, inputs):
            x = inputs[0]
            name, out = outputs.get(id(x), (None, None))
            if module.training and out is x and x.requires_grad:
                x.register_hook(lambda g, name=name: self._record(name, g))

        for name, m in model.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)) and m.bias is not None:
                handles.append(m.register_forward_hook(layer_hook(f"{name}.bias")))
            elif isinstance(m, BatchNorm2d):
                handles.append(m.register_forward_pre_hook(bn_hook))
        self._handles = handles

    def _record(self, name, g):
        g = g.detach().double()
        s = g.abs().sum(dim=(0, 2, 3)).numpy()
        prev_s, prev_n = self.terms.get(name, (0.0, 0))
        self.terms[name] = (prev_s + s, prev_n + g.numel() // g.shape[1])

    def close(self):
        for h in self._handles:
            h.remove()

    def floors(self) -> dict:
        return floors_of(self.terms)


def floors_of(terms) -> dict:
    """:meth:`BNCancelledBiases.floors` of recorded ``terms``."""
    eps = float(np.finfo(np.float32).eps)
    return {name: int(np.ceil(np.log2(n))) * eps * float(np.linalg.norm(s))
            for name, (s, n) in terms.items()}


def global_terms(terms_by_rank) -> dict:
    """The terms of the global batch's bias gradients from each rank's
    (``BNCancelledBiases.terms`` of a data-parallel step): the gradient
    averaged over the ranks sums every rank's terms over the world size."""
    world = len(terms_by_rank)
    return {name: (sum(t[name][0] for t in terms_by_rank) / world,
                   sum(t[name][1] for t in terms_by_rank)) for name in terms_by_rank[0]}


# ---- the train step on a global batch ------------------------------------------

def tiny_config(setting: str = "dexycb", **over):
    return get_config(setting, **{**SYNTHETIC_TINY_OVERRIDES, "hier_levels_obj": None, **over})


def global_batch(cfg, n: int, seed: int = 3):
    """(inputs, targets) of a synthetic train batch of ``n`` rows."""
    return split_inputs_targets(synthetic_batch(cfg, n, seed=seed, train=True))


def _full_grads(module) -> Dict[str, torch.Tensor]:
    from hoisdf_torch.parallel.zero import gather_full

    return {n: gather_full(p.grad, name=n).detach().clone()
            for n, p in module.named_parameters() if p.grad is not None}


def train_run(mesh: Optional[Mesh], cfg, batch, branches, zero: str = "off", ref=None, *,
              weights=None, record: bool = False, keep=()):
    """Steps of the port's train step from build_model's seeded weights (or
    ``weights``), dropout off, no jitter, one per entry of ``branches``
    (True: presampled), on the rank's rows of the global ``batch`` (all of
    it without ``mesh``).

    Without ``mesh`` (the one-process reference), with ``record``, the ReLU
    patterns and the sampler's selections are recorded step by step, and it
    returns per step the losses, the gradients, the BN-cancelled biases'
    terms and the records, and the final state dict.  On a rank, ``ref``
    names a file holding such a reference (or another package's gradients
    and state under the port's names): its ReLU patterns and selections,
    where it has them, are imposed, each rank on its rows, and the rank
    returns per step its losses, terms and ReLU ties, and (rank 0) each
    tensor's gradient error against the reference's (``grad_errors``), the
    final state's (``state_errors``) and the final tensors named in
    ``keep``: small results in place of whole gradients."""
    from chip_smoke import recorded_selections, relu_pattern
    from hoisdf_torch.parallel.zero import full_model_state

    model = build_model(cfg, 0)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    distributed = mesh is not None and mesh.distributed
    state = create_train_state(cfg, model, STEPS_PER_EPOCH, device="cpu",
                               mesh=mesh if distributed else None, zero=zero)
    step = make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)), device="cpu")
    inputs, targets = batch
    shard, reference = None, None
    if distributed:
        inputs, targets = shard_batch(inputs, mesh), shard_batch(targets, mesh)
        shard = (mesh.rank, mesh.world)
        if ref is not None:
            reference = torch.load(ref, mmap=True, weights_only=False)
    steps = []
    for i, pre in enumerate(branches):
        mode = sel = None
        if record:
            mode, sel = relu_pattern(), recorded_selections()
        elif reference is not None and "relu_masks" in reference["steps"][i]:
            want = reference["steps"][i]
            mode = relu_pattern(want["relu_masks"], shard=shard)
            rows = slice(mesh.rank * len(inputs["img"]), (mesh.rank + 1) * len(inputs["img"]))
            if want["selections"]:
                sel = recorded_selections([p[rows] for p in want["selections"]])
        cancelled = BNCancelledBiases(state.module)
        with (mode or contextlib.nullcontext()), (sel or contextlib.nullcontext()) as seen:
            state, losses = step(state, inputs, targets, None, 0.0, use_presampled=pre)
        cancelled.close()
        entry = {"losses": {k: float(v) for k, v in losses.items()},
                 "bn_terms": cancelled.terms}
        grads = _full_grads(state.module)
        if record:
            entry.update(grads=grads, relu_masks=mode.masks,
                         selections=[s["points"] for s in seen])
        elif reference is not None:
            entry["relu_ties"] = mode.ties if mode is not None else None
            if mesh.rank == 0:
                entry["grad_errors"] = tensor_errors(grads, reference["steps"][i]["grads"])
        steps.append(entry)
    final = full_model_state(state)
    if reference is None:
        return {"steps": steps, "state": final}
    out = {"steps": steps, "held": held_share(state)}
    if mesh.rank == 0:
        out["state_errors"] = tensor_errors(final, reference["state"])
        out["kept"] = {k: final[k] for k in keep}
    return out


def train_runs(mesh: Mesh, cfg, batch, branches, refs, weights=None, keep=()):
    """:func:`train_run` in each mode of ``refs`` (mode -> reference file)."""
    return {zero: train_run(mesh, cfg, batch, branches, zero, path, weights=weights, keep=keep)
            for zero, path in refs.items()}


def held_share(state) -> dict:
    """The elements of the AdamW moments and of the parameters this rank
    holds, beside the model's."""
    from torch.distributed.tensor import DTensor

    def local(v):
        return v.to_local() if isinstance(v, DTensor) else v

    opt = state.optimizer.optim if state.zero == "zero1" else state.optimizer
    trainable = sum(p.numel() for p in state.optimizer.param_groups[0]["params"])
    return {"moments": sum(local(v).numel() for s in opt.state.values()
                           for k, v in s.items() if k in ("exp_avg", "exp_avg_sq")),
            "params": sum(local(p).numel() for p in state.module.parameters()),
            "moments_full": 2 * trainable,
            "params_full": sum(p.numel() for p in build_model(state.module.cfg, 0).parameters())}


def tensor_errors(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> dict:
    """Per tensor of ``want``: (||got - want||, ||want||, ||got||, max |got -
    want|), in f64."""
    out = {}
    for k, w in want.items():
        g, w = got[k].double(), torch.as_tensor(w).double()
        d = g - w
        out[k] = (float(d.norm()), float(w.norm()), float(g.norm()),
                  float(d.abs().max()) if d.numel() else 0.0)
    return out


# ---- the other checks of a data-parallel session -----------------------------

BN_SHAPE = (4, 3, 5, 6)  # the global batch of the BatchNorm check


def bn_inputs():
    """(x, the weights of the loss sum(w * y)) of the BatchNorm check."""
    g = torch.Generator().manual_seed(11)
    return (torch.randn(BN_SHAPE, generator=g) * 2 + 0.5,
            torch.randn(BN_SHAPE, generator=g))


def bn_run(mesh: Optional[Mesh]):
    """``models.layers.BatchNorm2d`` in train mode on the rank's rows of
    :func:`bn_inputs` (all of them without a group), with a drawn affine:
    the output, the input's gradient, the affine's gradients summed over the
    ranks (the gradient of the global loss) and the running statistics."""
    from hoisdf_torch.models.layers import BatchNorm2d
    from hoisdf_torch.parallel.mesh import all_reduce_sum

    x, w = bn_inputs()
    if mesh is not None:
        rows = slice(mesh.rank * 2, mesh.rank * 2 + 2)
        x, w = x[rows], w[rows]
    bn = BatchNorm2d(3).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.5, -0.7, 0.3]))
        bn.bias.copy_(torch.tensor([0.1, 0.2, -0.3]))
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * w).sum().backward()
    gw, gb = bn.weight.grad, bn.bias.grad
    if mesh is not None:
        gw, gb = all_reduce_sum(gw), all_reduce_sum(gb)
    return {"y": y.detach(), "dx": x.grad, "dweight": gw, "dbias": gb,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def uneven_inputs(cfg):
    """Inputs of the count-normalised losses on a global batch of 4 where
    rows 0-1 (rank 0's) have every point near a joint and rows 2-3 (rank
    1's) none, and part labels valid at 7, 1, 4 and 0 points of the rows."""
    g = torch.Generator().manual_seed(5)
    b, p, j, layers = 4, 6, 20, 2
    joints = torch.randn(b, j, 3, generator=g) * 40.0  # mm
    near = joints[:, :p] / 1000.0 + torch.randn(b, p, 3, generator=g) * 1e-3
    points = torch.where(torch.arange(b)[:, None, None] < 2, near, near + 5.0)
    off = torch.randn(layers, b, p, j * 3, generator=g) * 0.01
    cls = torch.randn(layers, b, p, j, generator=g)
    logits = torch.randn(b, 8, 6, generator=g)
    labels = torch.randint(0, 6, (b, 8), generator=g)
    for row, n_valid in enumerate((7, 1, 4, 0)):
        labels[row, n_valid:] = -1
    return {"points": points, "off": off, "cls": cls, "joints": joints, "logits": logits,
            "labels": labels}


def uneven_run(mesh: Optional[Mesh], cfg):
    """``joint_vote_loss``'s membership-normalised term and
    ``sdf_part_classifier_loss`` on the rank's rows of :func:`uneven_inputs`
    (all of them without a group): the losses and their inputs' gradients."""
    from hoisdf_torch.losses import joint_vote_loss, sdf_part_classifier_loss

    t = uneven_inputs(cfg)
    if mesh is not None:
        rows = slice(mesh.rank * 2, mesh.rank * 2 + 2)
        t = {k: v[:, rows] if k in ("off", "cls") else v[rows] for k, v in t.items()}
    off = t["off"].clone().requires_grad_(True)
    logits = t["logits"].clone().requires_grad_(True)
    joint_3d, *_ = joint_vote_loss(cfg, t["points"], off, t["cls"], t["joints"])
    nll = sdf_part_classifier_loss(logits, t["labels"])
    (joint_3d + nll).backward()
    members = float((torch.linalg.vector_norm(
        t["points"][:, :, None] - t["joints"][:, None] / 1000.0, dim=-1) < cfg.hand_cls_dist)
        .sum())
    return {"loss_joint_3d": float(joint_3d), "sdf_cls_loss": float(nll), "doff": off.grad,
            "dlogits": logits.grad, "members": members,
            "valid": int((t["labels"] >= 0).sum())}


def dropout_run(mesh: Optional[Mesh], seed: int = 7):
    """The mask a rank's generator (seeded by ``rank_seed``) draws for one
    Dropout on the same input."""
    from hoisdf_torch.parallel.mesh import rank_seed

    rank = 0 if mesh is None else mesh.rank
    gen = torch.Generator().manual_seed(rank_seed(seed, rank))
    return Dropout(0.2).train()(torch.ones(64, 64), gen) != 0


def local_moments_match(state, optimizer_sd) -> bool:
    """Whether every moment this rank holds equals its part of a whole
    (one-process layout) optimizer state dict."""
    from hoisdf_torch.parallel.zero import _like

    params = state.optimizer.param_groups[0]["params"]
    held = state.optimizer.optim.state if state.zero == "zero1" else state.optimizer.state
    seen = 0
    for i, p in enumerate(params):
        if p not in held:
            continue
        seen += 1
        for k in ("exp_avg", "exp_avg_sq"):
            want = _like(optimizer_sd["state"][i][k], held[p][k])
            got = held[p][k]
            if state.zero == "fsdp":
                got, want = got.to_local(), want.to_local()
            if not torch.equal(got, want):
                return False
        if float(held[p]["step"]) != float(optimizer_sd["state"][i]["step"]):
            return False
    return seen > 0


def wrapper_state_elements(state) -> int:
    """Tensor elements that ZeRO-1's wrapper holds in its own ``state``
    (beside its local optimizer's): none, or the moments are held twice."""
    if state.zero != "zero1":
        return 0
    return sum(v.numel() for s in state.optimizer.state.values() if isinstance(s, dict)
               for v in s.values() if torch.is_tensor(v) and v.dim() > 0)


def snapshot_run(mesh: Mesh, cfg, batch, model_dir: str):
    """One step in zero1 and in fsdp, each saved as a snapshot (rank 0
    writes); then each snapshot, and the one-process one the parent wrote
    as epoch 9 of ``model_dir/single``, resumed into both states: whether
    the model is the file's, every rank's moments its part of the file's,
    and ZeRO-1's wrapper holding no second copy of them."""
    import os

    from hoisdf_torch.parallel.zero import full_model_state
    from hoisdf_torch.utils import checkpoint as ckpt

    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    states = {}
    for zero in ("zero1", "fsdp"):
        states[zero] = state = create_train_state(cfg, build_model(cfg, 0), STEPS_PER_EPOCH,
                                                  device="cpu", mesh=mesh, zero=zero)
        make_train_step(cfg, mano, device="cpu")(
            state, shard_batch(batch[0], mesh), shard_batch(batch[1], mesh), None, 0.0,
            use_presampled=True)
        ckpt.save_snapshot(os.path.join(model_dir, zero), 0, state)
    torch.distributed.barrier()
    resumed = {}
    for source, epoch in (("zero1", 0), ("fsdp", 0), ("single", 9)):
        snap = torch.load(ckpt.snapshot_path(os.path.join(model_dir, source), epoch),
                          map_location="cpu", weights_only=True)
        network = ckpt._strip_prefix(snap["network"])
        for zero, state in states.items():
            state.step = -1
            got = ckpt.restore_snapshot(os.path.join(model_dir, source), state)
            same_model = all(torch.equal(v, network[k])
                             for k, v in full_model_state(state).items())
            resumed[(source, zero)] = (got, state.step, same_model,
                                       local_moments_match(state, snap["optimizer"]),
                                       wrapper_state_elements(state))
    return resumed


def loader_run(mesh: Optional[Mesh]):
    """The loader's shard by default and with (0, 1) given, and the sample
    ids of its two epochs' batches, on a 23-sample toy dataset."""
    from hoisdf_torch.data.loader import DataLoader

    from torch_data_fixtures import ToyDataset

    out = {}
    for name, kw in (("default", {}), ("explicit", {"shard_id": 0, "num_shards": 1})):
        dl = DataLoader(ToyDataset(), 4, shuffle=True, seed=1, num_workers=2, **kw)
        ids = []
        for epoch in (0, 1):
            dl.set_epoch(epoch)
            ids.append(np.concatenate([b["x"][:, 0] for b in dl]).astype(int).tolist())
        out[name] = {"shard": (dl.shard_id, dl.num_shards), "ids": ids, "len": len(dl)}
    return out


def gather_full_run(mesh: Mesh):
    """``parallel.zero.gather_full`` on an FSDP-sharded ``Linear(3, 5)``: its
    weight [5, 3] and bias [5] split into shards of 3 and 2 rows on two
    ranks.  The whole parameters (the same seeded values on every rank),
    each rank's shard rows, the parameters gathered through the port's
    ``Mesh`` and through the tensor's own mesh, the error that a replicated
    DTensor raises, and whether a plain tensor passes through as itself."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Replicate, distribute_tensor

    from hoisdf_torch.parallel.zero import gather_full

    lin = torch.nn.Linear(3, 5)
    with torch.no_grad():
        for i, p in enumerate(lin.parameters()):
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(i)))
    whole = {n: p.detach().clone() for n, p in lin.named_parameters()}
    dmesh = init_device_mesh("cpu", (mesh.world,))
    fully_shard(lin, mesh=dmesh)
    params = dict(lin.named_parameters())
    out = {"whole": whole,
           "local_rows": {n: p.to_local().shape[0] for n, p in params.items()},
           "through_mesh": {n: gather_full(p, mesh, name=n) for n, p in params.items()},
           "own_mesh": {n: gather_full(p, name=n) for n, p in params.items()}}
    try:
        gather_full(distribute_tensor(torch.ones(4), dmesh, [Replicate()]), name="ones")
        out["replicated_error"] = None
    except ValueError as exc:
        out["replicated_error"] = str(exc)
    plain = torch.ones(3)
    out["plain_passes"] = gather_full(plain, mesh) is plain
    return out


def session(mesh: Mesh, cfg, batches, refs, model_dir: str):
    """Every check of ``tests/test_torch_parallel.py`` that needs a group,
    in one run of the ranks: the train steps of each mode against the
    references in ``refs`` (branch -> file), then the other checks."""
    out = {"steps": {}}
    for branch, path in refs.items():
        branches = [branch == "presampled"] * 2
        for zero in ("off", "zero1", "fsdp"):
            out["steps"][(zero, branch)] = train_run(mesh, cfg, batches["steps"], branches,
                                                     zero, path)
    out["bn"] = bn_run(mesh)
    out["uneven"] = uneven_run(mesh, tiny_config(classifier_branch=True))
    out["dropout"] = dropout_run(mesh)
    out["snapshots"] = snapshot_run(mesh, cfg, batches["steps"], model_dir)
    out["loader"] = loader_run(mesh)
    out["gather_full"] = gather_full_run(mesh)
    return out
