"""Training entry point of the port (``hoisdf_tpu/train_loop.py``), in one
process or data parallel over ranks that ``torchrun`` starts, on a dataset or
on synthetic batches.

The epoch loop of the original's ``main/train.py``: the host-side branch gate
(presampled or field-guided points) and jitter distance per step, the stepped
learning rate, the u8 train wire (``--cfg transfer_dtype=uint8``), per-step
loss logging with speed, scalars every 400 iterations, a finite-loss check
that reads each step's loss a few steps late (so the host does not wait on the
card every step), a snapshot every 5 epochs (every epoch after the
point-sampling switch, and the last), and ``--continue`` from the latest
snapshot.  At each snapshot an eval pass: with ``--synthetic`` one seeded
batch through the Evaluator; on DexYCB with ``annotation_dir`` set, the test
split (metrics when ``simple_object_models_dir`` gives the templates); both
dump the first batch's heads beside the ground truth as a PNG.

The dataset (DexYCB or HO3D, by the preset) is read from the paths of the
config through the port's loader (``num_data_workers`` workers of
``data_worker_mode``), shuffled per epoch, the tail dropped.  The model then
has the preset's full size unless ``--cfg`` overrides say otherwise;
``--synthetic`` takes the tiny model.

Data parallel: under ``torchrun`` (``WORLD_SIZE`` > 1, or ``--multihost``)
every rank starts the process group from the environment, runs on
``cuda:{LOCAL_RANK}`` (or the CPU with ``--cpu``, on gloo) and takes
``train_batch_size`` rows of a global batch of ``train_batch_size x world``:
its loader shard, or its rows of each synthetic global batch.  The step has
the JAX package's global-batch semantics (``train.make_train_step``), with
the state in DDP or sharded by ``--zero`` (``parallel/zero.py``).  Every
rank seeds its generator for its rank and draws the branch gate from the
same stream.  Rank 0 alone writes the logs, ``cfg.txt``, the scalars, the
debug images and the snapshots (gathered whole, in the one-process layout);
the synthetic eval at a snapshot runs on every rank, the dataset's only in
one process, as the JAX package's.

``--backbone-init PATH`` grafts a torchvision-layout ImageNet ResNet state
dict (``.pth``) into the fresh state's backbone before ``--continue``
(:func:`load_backbone_init`; the original's model-zoo init,
common/nets/resnet.py:89-98), on every rank before the state is made data
parallel.

Usage:
    python -m hoisdf_torch.train_loop --setting dexycb --run_dir_name demo \\
        --synthetic --end_epoch 2 --iters-per-epoch 4 --batch-size 2 [--cpu]
    python -m hoisdf_torch.train_loop --setting ho3d --cfg data_dir=... \\
        --cfg fast_data_dir=... --cfg annotation_dir=...
    torchrun --nproc_per_node=N -m hoisdf_torch.train_loop --setting dexycb \\
        [--zero zero1|fsdp] --cfg data_dir=... --cfg annotation_dir=...
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import logging
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, Config, get_config, parse_cfg_overrides
from hoisdf_torch.data.loader import DataLoader
from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_torch.evaluate import Evaluator, dataset_batches, evaluate_batches, open_dataset
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.mano.model import load_mano_npz, make_synthetic_mano
from hoisdf_torch.models.hoisdf import build_model
from hoisdf_torch.ops import wire
from hoisdf_torch.parallel.mesh import init_distributed, make_mesh, rank_seed, shard_batch
from hoisdf_torch.train import (ZERO_MODES, create_train_state, make_data_parallel,
                                make_eval_step, make_train_step, presample_gate)
from hoisdf_torch.utils import checkpoint as ckpt_util
from hoisdf_torch.utils.logger import colorlogger
from hoisdf_torch.utils.timer import Timer

LOSS_LAG = 4  # steps between a step and the host's read of its loss


class ScalarWriter:
    """Append-only JSONL scalar log (``metrics.jsonl``), mirrored to
    TensorBoard event files when ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # TensorBoard is optional
            return
        self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        self._f.write(json.dumps({"step": step, **{k: float(v) for k, v in scalars.items()}})
                      + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def add_image(self, step: int, tag: str, img) -> None:
        """A [H, W] or [H, W, C] u8 image to TensorBoard (a no-op without it)."""
        if self._tb is not None:
            arr = np.asarray(img)
            self._tb.add_image(tag, arr[..., None] if arr.ndim == 2 else arr, step,
                               dataformats="HWC")

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def dump_debug_images(out_dir: str, step: int, preds: Mapping, targets: Mapping,
                      writer: Optional[ScalarWriter] = None) -> str:
    """The first sample's predicted heatmap and hand / object segmentations
    beside the ground-truth masks, each scaled to 0-255, as one PNG
    ``debug_{step:08d}.png`` (the original's TensorBoard image grids,
    main/train.py:302-440), mirrored to ``writer``.  Returns the path."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    heads = preds["decoder_heads"][0]
    heads = heads.float().cpu().numpy() if isinstance(heads, torch.Tensor) else np.asarray(heads)

    def norm255(x):
        lo, hi = x.min(), x.max()
        return ((x - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)

    panels = [norm255(heads[..., i]) for i in range(3)]
    if "hand_seg" in targets:
        panels += [norm255(np.asarray(targets[k][0])) for k in ("hand_seg", "obj_seg")]
    grid = np.concatenate(panels, axis=1)
    path = os.path.join(out_dir, f"debug_{step:08d}.png")
    Image.fromarray(grid).save(path)
    if writer is not None:
        writer.add_image(step, "debug/heads", grid)
    return path


def eval_synthetic(cfg: Config, eval_step, mano: ManoBuffers, device) -> Tuple[Dict, Dict]:
    """One seeded synthetic batch of 2 through the eval step and the
    Evaluator, with 100-vertex random templates -> (preds, targets)."""
    inputs, targets = split_inputs_targets(synthetic_batch(cfg, 2, seed=999))
    preds = eval_step(inputs)
    templates = np.random.RandomState(0).randn(2, 100, 3).astype(np.float32) * 0.05
    Evaluator(cfg, mano, device=device).feed(preds, targets, inputs, templates)
    return preds, targets


BACKBONE_PREFIX = "backbone_net.resnet."


def load_backbone_init(state, path: str):
    """Graft a torchvision-layout ImageNet ResNet state dict (``.pth``) into
    the backbone of a one-process ``state`` (``backbone_net.resnet.*``), in
    place, and return the state.  ``fc.*`` and ``num_batches_tracked`` are
    dropped, as the JAX package's ``convert_torchvision_resnet`` drops them;
    any other key the backbone lacks, any backbone key the file lacks, and
    any shape that differs raise.  Nothing outside the backbone changes."""
    if state.zero == "fsdp":
        raise ValueError("load_backbone_init takes the state before FSDP shards it")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    own = {k[len(BACKBONE_PREFIX):]: v for k, v in state.module.state_dict().items()
           if k.startswith(BACKBONE_PREFIX) and not k.endswith("num_batches_tracked")}
    graft = {k: v for k, v in raw.items()
             if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    unmapped = sorted(set(graft) - set(own))
    missing = sorted(set(own) - set(graft))
    if unmapped or missing:
        raise ValueError(f"{path}: not a torchvision ResNet of this backbone; "
                         f"unmapped={unmapped[:10]} missing={missing[:10]}")
    for k, v in graft.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the backbone "
                             f"{tuple(own[k].shape)}")
    with torch.no_grad():
        for k, v in graft.items():
            own[k].copy_(v)
    return state


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--setting", default="dexycb")
    p.add_argument("--run_dir_name", default="run")
    p.add_argument("--continue", dest="continue_train", action="store_true")
    p.add_argument("--end_epoch", type=int, default=None)
    p.add_argument("--point_sampling_epoch", type=int, default=None)
    p.add_argument("--lr_drop", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic batches at the tiny model size instead of a dataset")
    p.add_argument("--backbone-init", default=None, metavar="PTH",
                   help="initialize the ResNet backbone from a torchvision ImageNet state "
                        "dict (.pth, fc.* dropped); offline equivalent of "
                        "common/nets/resnet.py:89-98")
    p.add_argument("--iters-per-epoch", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--zero", choices=ZERO_MODES, default="off",
                   help="shard the AdamW moments (zero1: ZeroRedundancyOptimizer) or the "
                        "moments and the parameters (fsdp: FSDP2's fully_shard) over the "
                        "data-parallel ranks (parallel/zero.py); 'off' replicates them in "
                        "DDP like the reference's DataParallel; needs torchrun")
    p.add_argument("--multihost", action="store_true",
                   help="start the process group from torchrun's environment before any "
                        "use of the card, and fail without it (ranks on several hosts: "
                        "torchrun --nnodes ... --rdzv-endpoint ...); a run with WORLD_SIZE "
                        "above 1 starts it anyway")
    p.add_argument("--cfg", action="append", default=[], metavar="KEY=VALUE",
                   help="config field override (repeatable); VALUE is JSON with a "
                        "plain-string fallback")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.backbone_init and not os.path.isfile(args.backbone_init):
        raise SystemExit(f"train_loop: --backbone-init {args.backbone_init}: not a file "
                         "(a torchvision ResNet state dict, .pth)")
    overrides = dict(SYNTHETIC_TINY_OVERRIDES) if args.synthetic else {}
    for key, value in (("end_epoch", args.end_epoch),
                       ("point_sampling_epoch", args.point_sampling_epoch),
                       ("lr_drop", args.lr_drop), ("train_batch_size", args.batch_size)):
        if value is not None:
            overrides[key] = value
    overrides.update(parse_cfg_overrides(args.cfg))
    cfg = get_config(args.setting, **overrides)
    if args.multihost or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(cpu=args.cpu)  # before any use of the card
    mesh = make_mesh("cpu" if args.cpu else None)
    if args.zero != "off" and not mesh.distributed:
        raise ValueError(f"--zero {args.zero} needs a process group: start the ranks with "
                         "torchrun")
    device, rank0 = mesh.device, mesh.rank == 0

    out_root = os.path.join(cfg.output_dir, args.run_dir_name)
    log_dir = os.path.join(out_root, "log")
    model_dir = os.path.join(out_root, "model_dump")
    writer = None
    if rank0:
        os.makedirs(model_dir, exist_ok=True)
        logger = colorlogger(log_dir, "train_logs.txt")
        writer = ScalarWriter(os.path.join(out_root, "tensorboard"))
        with open(os.path.join(log_dir, "cfg.txt"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
        with open(os.path.join(log_dir, "args.txt"), "w") as f:
            json.dump(vars(args), f, indent=2)
    else:  # the other ranks log nothing
        logger = logging.getLogger(f"hoisdf_torch.train_loop.rank{mesh.rank}")
        logger.addHandler(logging.NullHandler())
        logger.propagate = False

    mano_model = (load_mano_npz(cfg.mano_model_path) if cfg.mano_model_path
                  else make_synthetic_mano(0))
    mano_left = load_mano_npz(cfg.mano_left_path) if cfg.mano_left_path else None
    mano = ManoBuffers.from_model(mano_model)
    loaders = []  # closed at the end (process workers)

    if args.synthetic:
        iters_per_epoch = args.iters_per_epoch or 8

        def batches(epoch):  # the rank's rows of each global batch
            for i in range(iters_per_epoch):
                yield shard_batch(synthetic_batch(cfg, cfg.train_batch_size * mesh.world,
                                                  seed=epoch * 10000 + i, train=True), mesh)
    else:  # the loader's shard is the rank's (data/loader.py)
        loader = DataLoader(open_dataset(cfg, "train", mano_model, mano_left, seed=cfg.seed),
                            cfg.train_batch_size, shuffle=True,
                            num_workers=cfg.num_data_workers, drop_last=True, seed=cfg.seed,
                            worker_mode=cfg.data_worker_mode)
        loaders.append(loader)
        iters_per_epoch = args.iters_per_epoch or len(loader)

        def batches(epoch):
            loader.set_epoch(epoch)
            yield from loader
    eval_loader = None
    if not args.synthetic and cfg.dataset == "dexycb" and cfg.annotation_dir and mesh.world == 1:
        # the whole test split, in order, the tail kept (common/base.py:205-211); data
        # parallel, evaluate a snapshot with evaluate.main instead, as the JAX package
        eval_loader = DataLoader(open_dataset(cfg, "test", mano_model, mano_left, seed=cfg.seed),
                                 cfg.eval_batch_size, num_workers=cfg.num_data_workers,
                                 drop_last=False, shard_id=0, num_shards=1,
                                 worker_mode=cfg.data_worker_mode)
        loaders.append(eval_loader)

    state = create_train_state(cfg, build_model(cfg, cfg.seed), iters_per_epoch, device=device)
    if args.backbone_init:
        load_backbone_init(state, args.backbone_init)
        logger.info(f"backbone initialized from {args.backbone_init}")
    state = make_data_parallel(state, mesh, args.zero)
    if args.zero != "off":
        logger.info(f"sharded train state over {mesh.world} ranks ({args.zero})")
    start_epoch = 0
    if args.continue_train:
        resumed = ckpt_util.restore_snapshot(model_dir, state)
        if resumed is not None:
            start_epoch = resumed + 1
            logger.info(f"resumed from epoch {resumed}")
    train_step = make_train_step(cfg, mano, device=device)
    eval_step = make_eval_step(cfg, state.module, mano, device=device)
    generator = torch.Generator(device=device).manual_seed(rank_seed(cfg.seed + 1, mesh.rank))
    host_rng = np.random.default_rng(cfg.seed + 2)  # the branch gate: one stream on every rank
    tot_timer, step_timer = Timer(), Timer()
    loss_window: "collections.deque" = collections.deque()
    total = float("nan")
    debug_dir = os.path.join(out_root, "debug_images")

    def check_finite(l_epoch, l_itr, l_losses) -> float:
        """Read a lagged step's losses; on a non-finite total, save the state
        (after the update, up to LOSS_LAG steps past the fault) and stop."""
        t = float(l_losses["total"])
        if np.isfinite(t):
            return t
        crash = {k: float(v) for k, v in l_losses.items()}
        logger.error(f"non-finite loss at epoch {l_epoch} itr {l_itr} "
                     f"(read {LOSS_LAG} steps late): {crash}")
        crash_dir = os.path.join(model_dir, "crash_postupdate_diagnostic")
        ckpt_util.save_snapshot(crash_dir, l_epoch, state)  # every rank: the losses are global
        if rank0:
            with open(os.path.join(crash_dir, "CRASH.json"), "w") as f:
                json.dump({"epoch": l_epoch, "itr": l_itr, "losses": crash,
                           "note": f"state saved after the update, up to {LOSS_LAG} steps "
                                   "past the fault; resume from the last regular snapshot"},
                          f, indent=2)
        raise FloatingPointError(f"non-finite training loss: {crash}")

    def evaluate_snapshot() -> None:
        state.model.eval()  # the next train step puts it back in train mode
        if args.synthetic:  # on every rank: an FSDP model gathers its shards
            preds, targets = eval_synthetic(cfg, eval_step, mano, device)
            if rank0:
                dump_debug_images(debug_dir, state.step, preds, targets, writer)
        elif eval_loader is not None:
            ev = Evaluator(cfg, mano, device=device)
            batches = dataset_batches(cfg, eval_loader, cfg.eval_batch_size,
                                      cfg.simple_object_models_dir)
            evaluate_batches(cfg, eval_step, ev, batches, cfg.eval_batch_size,
                             lambda p, t: dump_debug_images(debug_dir, state.step, p, t, writer))
            results = {k: v / max(ev.total, 1) for k, v in ev.results.items()}
            writer.add_scalars(state.step, results)
            logger.info("eval: " + " ".join(f"{k}={v:.3f}" for k, v in results.items()))

    try:
        for epoch in range(start_epoch, cfg.end_epoch):
            for itr, batch_np in enumerate(batches(epoch)):
                tot_timer.tic()
                use_pre, dist_range = presample_gate(
                    cfg, epoch, itr / max(iters_per_epoch, 1), float(host_rng.random()))
                inputs, targets = split_inputs_targets(batch_np)
                inputs.pop("obj_cls", None)
                if cfg.transfer_dtype == "uint8":
                    inputs, targets = wire.encode_batch(inputs, targets)
                step_timer.tic()
                state, losses = train_step(state, inputs, targets, generator, dist_range,
                                           use_presampled=use_pre)
                loss_window.append((epoch, itr, losses))
                if len(loss_window) > LOSS_LAG:
                    total = check_finite(*loss_window.popleft())
                step_timer.toc()
                if itr % 400 == 0 and writer is not None:
                    writer.add_scalars(state.step, {f"train_{k}": v for k, v in losses.items()})
                tot_timer.toc()
                logger.info(
                    "Epoch %d/%d itr %d/%d: speed %.2f(%.2f)s/itr %.2fh/epoch loss[-%d] %.4f"
                    % (epoch, cfg.end_epoch, itr, iters_per_epoch, tot_timer.average_time,
                       step_timer.average_time, tot_timer.average_time * iters_per_epoch / 3600,
                       LOSS_LAG, total))
            while loss_window:  # epoch boundary: drain the lagged checks
                total = check_finite(*loss_window.popleft())
            save_gap = 1 if epoch >= cfg.point_sampling_epoch else 5
            if epoch % save_gap == 0 or epoch == cfg.end_epoch - 1:
                ckpt_util.save_snapshot(model_dir, epoch, state)
                logger.info(f"snapshot saved at epoch {epoch}")
                evaluate_snapshot()
    finally:
        if writer is not None:
            writer.close()
        for loader in loaders:
            loader.close()
    logger.info("training done")


if __name__ == "__main__":
    main()
