"""Multi-process dry runs of the data-parallel train path on the CPU (the
port's counterparts of ``__graft_entry__.dryrun_multichip`` and
``scripts/dryrun_multihost.py``), and :func:`run_ranks`, which starts the
ranks of a run by spawn for them, the tests and ``chip_smoke.py``.

    python -m hoisdf_torch.parallel.dryrun --nproc N
        N gloo CPU ranks at the tiny config, each on its rows of a global
        synthetic batch: a presampled and a field-guided step (DDP), then one
        presampled step from a fresh FSDP state; every rank must read the
        same finite losses.
    python -m hoisdf_torch.parallel.dryrun --hosts 2
        2 "hosts" x 2 local ranks on one file store: each rank's loader
        takes its shard of a 32-sample synthetic dataset by default (the
        group's rank and size), the shards must be disjoint and cover the
        dataset, and every rank must read the same loss after one step.

Each run takes some tens of seconds; it prints one line and exits 0, or
names the rank that failed, with its traceback, and exits 1.
"""

from __future__ import annotations

import argparse
import faulthandler
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import numpy as np
import torch


def _child(fn, rank: int, world: int, local_world: int, store: str, out: str, backend: str,
           device: Optional[str], threads: Optional[int], args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % local_world),
                      LOCAL_WORLD_SIZE=str(local_world), GROUP_RANK=str(rank // local_world))
    faulthandler.enable()  # a rank that crashes prints where
    if threads is not None:
        torch.set_num_threads(threads)
    import torch.distributed as dist

    from hoisdf_torch.parallel.mesh import make_mesh

    code = 0
    try:
        dev = torch.device(device if device is not None else f"cuda:{rank % local_world}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world)
        result = fn(make_mesh(dev), *args)
        dist.barrier()
        dist.destroy_process_group()
        payload = ("ok", result)
    except BaseException:  # noqa: BLE001 -- handed to the parent, which fails the run
        payload, code = ("error", traceback.format_exc()), 1
    with open(out, "wb") as f:
        pickle.dump(payload, f)
    sys.stdout.flush()
    os._exit(code)  # no interpreter teardown: a rank whose peer failed may hold a dead group


def run_ranks(fn: Callable, world: int, workdir: str, *args, backend: str = "gloo",
              device: Optional[str] = "cpu", local_world: Optional[int] = None,
              threads: Optional[int] = None, timeout: float = 900) -> List:
    """``fn(mesh, *args)`` on ``world`` ranks started by spawn -> each rank's
    result, in rank order.  The ranks join one ``backend`` group through a
    file store in a new directory under ``workdir``; ``local_world`` ranks
    make a "host" (``LOCAL_RANK``, ``GROUP_RANK``; default all of them);
    ``device`` is every rank's (None: ``cuda:{LOCAL_RANK}``); ``threads``
    sets torch's intra-op threads.  ``fn`` and ``args`` must pickle (``fn``
    a module-level function).  A rank that raises, dies or outlives
    ``timeout`` fails the run with its traceback, and the others are
    stopped."""
    ctx = multiprocessing.get_context("spawn")
    run_dir = tempfile.mkdtemp(prefix="ranks_", dir=workdir)
    store = os.path.join(run_dir, "store")
    outs = [os.path.join(run_dir, f"rank{r}.pkl") for r in range(world)]
    local_world = local_world or world
    procs = [ctx.Process(target=_child, args=(fn, r, world, local_world, store, outs[r], backend,
                                              device, threads, args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failures = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            if os.path.exists(out):
                with open(out, "rb") as f:
                    status, value = pickle.load(f)
                if status != "ok":
                    failures.append(f"rank {r} failed:\n{value}")
            elif p.is_alive():
                failures.append(f"rank {r} did not finish (a peer failed, or {timeout} s passed)")
            else:
                failures.append(f"rank {r} died with exit code {p.exitcode}")
        if failures:
            raise RuntimeError("\n".join(failures))
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f)[1])
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)


# ---- the dry runs ----------------------------------------------------------------

def tiny_config(**over):
    from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, get_config

    return get_config("dexycb", **{**SYNTHETIC_TINY_OVERRIDES, **over})


class SyntheticDataset:
    """One synthetic train sample per index, the same on every rank."""

    def __init__(self, cfg, n: int = 32):
        self.cfg, self.n = cfg, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int, epoch: int = 0):
        from hoisdf_torch.data.synthetic import synthetic_batch

        b = synthetic_batch(self.cfg, 1, seed=1000 * epoch + idx, train=True)
        return {k: v[0] for k, v in b.items()}


def _train_parts(cfg, mesh, zero: str):
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.models.hoisdf import build_model
    from hoisdf_torch.train import create_train_state, make_train_step

    state = create_train_state(cfg, build_model(cfg, 0), 10, device=mesh.device, mesh=mesh,
                               zero=zero)
    return state, make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)),
                                  device=mesh.device)


def _steps_child(mesh, rows_per_rank: int) -> dict:
    """Both branches (DDP), then one FSDP step, on the rank's rows."""
    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
    from hoisdf_torch.parallel.mesh import rank_seed, shard_batch

    cfg = tiny_config()
    batch = synthetic_batch(cfg, rows_per_rank * mesh.world, seed=0, train=True)
    inputs, targets = split_inputs_targets(shard_batch(batch, mesh))
    gen = torch.Generator().manual_seed(rank_seed(cfg.seed + 1, mesh.rank))
    losses = {}
    state, step = _train_parts(cfg, mesh, "off")
    for name, pre, dist_range in (("presampled", True, 0.03), ("field_guided", False, 0.0)):
        _, out = step(state, inputs, targets, gen, dist_range, use_presampled=pre)
        losses[name] = float(out["total"])
    state, step = _train_parts(cfg, mesh, "fsdp")
    _, out = step(state, inputs, targets, gen, 0.03, use_presampled=True)
    losses["fsdp"] = float(out["total"])
    return losses


def _hosts_child(mesh) -> dict:
    """The loader's default shard, then one step on its first batch."""
    from hoisdf_torch.data.loader import DataLoader
    from hoisdf_torch.data.synthetic import split_inputs_targets

    cfg = tiny_config(train_batch_size=2)
    loader = DataLoader(SyntheticDataset(cfg), cfg.train_batch_size, shuffle=True,
                        num_workers=2, drop_last=True, seed=0)
    if (loader.shard_id, loader.num_shards) != (mesh.rank, mesh.world):
        raise AssertionError(f"rank {mesh.rank}: the loader's shard is "
                             f"{(loader.shard_id, loader.num_shards)}")
    order = loader._order().tolist()
    inputs, targets = split_inputs_targets(next(iter(loader)))
    state, step = _train_parts(cfg, mesh, "off")
    _, out = step(state, inputs, targets, None, 0.03, use_presampled=True)
    return {"order": order, "loss": float(out["total"]), "host": int(os.environ["GROUP_RANK"]),
            "local_rank": mesh.local_rank}


def dryrun_steps(nproc: int, workdir: str) -> dict:
    """``--nproc``: every rank's losses must be one set of finite numbers."""
    results = run_ranks(_steps_child, nproc, workdir, 2, threads=1)
    for r, res in enumerate(results):
        if not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"rank {r}: a loss is not finite: {res}")
        if res != results[0]:
            raise AssertionError(f"ranks 0 and {r} disagree: {results[0]} vs {res}")
    return results[0]


def dryrun_hosts(hosts: int, workdir: str, local_ranks: int = 2) -> dict:
    """``--hosts``: disjoint loader shards that cover the dataset, one loss."""
    world = hosts * local_ranks
    results = run_ranks(_hosts_child, world, workdir, local_world=local_ranks, threads=1)
    orders = [set(r["order"]) for r in results]
    if sum(len(o) for o in orders) != len(set().union(*orders)):
        raise AssertionError(f"the loader shards overlap: {orders}")
    if set().union(*orders) != set(range(32 // world * world)) or len(
            {len(o) for o in orders}) != 1:
        raise AssertionError(f"the loader shards do not cover the dataset evenly: {orders}")
    losses = {r["loss"] for r in results}
    if len(losses) != 1 or not np.isfinite(next(iter(losses))):
        raise AssertionError(f"the ranks disagree on the loss: {[r['loss'] for r in results]}")
    return {"loss": results[0]["loss"], "hosts": sorted({r["host"] for r in results}),
            "samples_per_rank": len(orders[0])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--nproc", type=int, help="ranks of the train-step dry run")
    mode.add_argument("--hosts", type=int, help="hosts of 2 local ranks each (loader shards)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="hoisdf_dryrun_") as workdir:
        try:
            if args.nproc:
                out = dryrun_steps(args.nproc, workdir)
                print(f"dryrun --nproc {args.nproc}: ok, every rank read the losses {out}")
            else:
                out = dryrun_hosts(args.hosts, workdir)
                print(f"dryrun --hosts {args.hosts}: ok, disjoint loader shards of "
                      f"{out['samples_per_rank']} samples covering the dataset, every rank "
                      f"read the loss {out['loss']}")
        except (RuntimeError, AssertionError) as exc:
            print(f"dryrun: FAILED\n{exc}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
