"""Where a data-parallel train step's peak device memory goes, per mode.

Two gloo ranks share one card (as chip_smoke's ``two_ranks`` line runs
them), each with half of a batch-22 dexycb batch.  Each rank first runs a
small matmul forward and backward, so that cuBLAS's workspaces (one per
handle, the backward's thread has its own) are held before any mode; then
it records the caching allocator's history
(``torch.cuda.memory._record_memory_history``) from before the train state
is made to the end of one presampled step, in DDP (``off``), ZeRO-1 and
FSDP in turn, replays the trace to the moment of peak allocation, and
prints the allocations live there, summed by the innermost Python frames
that made them; then, per pair of modes, the sites whose bytes at the peak
differ, largest difference first.

    python3 scripts/probe_zero_memory.py [--modes off,zero1] [--top 12] [--out FILE]

Needs a CUDA card; ``--out`` writes every rank's numbers as JSON.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _site(frames, depth: int = 3) -> str:
    """The innermost ``depth`` Python frames of an allocation, outside the
    allocator's own wrappers."""
    py = [f for f in frames if f.get("filename", "").endswith(".py")
          and "torch/cuda/memory.py" not in f["filename"]]
    return " <- ".join(f"{os.path.basename(f['filename'])}:{f['line']}:{f['name']}"
                       for f in py[:depth]) or "(no python frame)"


def peak_allocations(snapshot, device: int, depth: int = 3):
    """Replay the device's trace: (peak bytes, {site: bytes live at the peak})
    counting only what was allocated after recording began."""
    live, total, best, at_peak = {}, 0, -1, {}
    for ev in snapshot["device_traces"][device]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            total += ev["size"]
            if total > best:
                best, at_peak = total, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    sites = collections.Counter()
    for size, frames in at_peak.values():
        sites[_site(frames, depth)] += size
    return best, sites


def _child(mesh, cfg, modes, top):
    import torch

    import chip_smoke
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.parallel.mesh import shard_batch
    from hoisdf_torch.train import create_train_state, make_train_step

    dev = mesh.device
    w = torch.randn(64, 64, device=dev, requires_grad=True)
    (w @ w).sum().backward()  # cuBLAS's workspaces, held from here on
    del w
    base = chip_smoke._plain_model(cfg)
    inputs, targets = chip_smoke._train_batches(cfg, 22, 1)[0]
    inputs, targets = shard_batch(inputs, mesh), shard_batch(targets, mesh)
    step = make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)), device=dev)
    out = {}
    for mode in modes:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.memory._record_memory_history(max_entries=2_000_000)
        state = create_train_state(cfg, copy.deepcopy(base), 100, device=dev, mesh=mesh,
                                   zero=mode)
        after_state = torch.cuda.memory_allocated(dev)
        step(state, inputs, targets, None, 0.0, use_presampled=True)
        torch.cuda.synchronize(dev)
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        peak, sites = peak_allocations(snap, dev.index or 0, depth=4)
        out[mode] = {"all_sites": dict(sites),"max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                     "allocated_before_gib": before / 2**30,
                     "state_gib": (after_state - before) / 2**30,
                     "replayed_peak_gib": peak / 2**30,
                     "sites_gib": {k: v / 2**30 for k, v in sites.most_common(top)}}
        del state
    return out


def main():
    import torch

    from hoisdf_torch.config import get_config
    from hoisdf_torch.ops.kernels import build
    from hoisdf_torch.parallel.dryrun import run_ranks

    p = argparse.ArgumentParser()
    p.add_argument("--modes", default="off,zero1,fsdp")
    p.add_argument("--top", type=int, default=14)
    p.add_argument("--out", default=None, help="write every rank's numbers here as JSON")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_zero_memory needs a CUDA card")
    build.build()
    cfg = get_config("dexycb")
    with tempfile.TemporaryDirectory() as wd:
        ranks = run_ranks(_child, 2, wd, cfg, args.modes.split(","), args.top,
                          backend="gloo", device="cuda:0", timeout=900)
    for r, res in enumerate(ranks):
        for mode, v in res.items():
            print(json.dumps({"rank": r, "mode": mode,
                              **{k: v[k] for k in v if k not in ("sites_gib", "all_sites")}}))
            for site, gib in v["sites_gib"].items():
                print(f"   {gib:8.4f} GiB  {site}")
        modes = list(res)
        for a, b in zip(modes, modes[1:]):
            sa, sb = res[a]["all_sites"], res[b]["all_sites"]
            diff = sorted(((sb.get(k, 0) - sa.get(k, 0), k) for k in set(sa) | set(sb)),
                          key=lambda d: -abs(d[0]))
            print(f"rank {r}: {b} - {a} at the peak, by site "
                  f"(total {sum(d for d, _ in diff) / 2**30:+.4f} GiB)")
            for d, k in diff[:args.top]:
                if d:
                    print(f"   {d / 2**30:+8.4f} GiB  {k}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(ranks, f, indent=1)


if __name__ == "__main__":
    main()
