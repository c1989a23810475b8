"""Per-batch times of the port's data loader on a DexYCB fixture tree.

    python3 scripts/probe_torch_loader.py [--batches 12] [--workers 15]
        [--modes thread,process] [--backends native,pil] [--one-blas-thread]

Writes a DexYCB tree in the small split's layout at 640 x 480
(``tests/torch_data_fixtures.py``) to a temporary directory, then times one
shuffled epoch of the train split per (backend, mode) with no consumer work,
host clock, and prints one JSON line each: the start-up ms and every batch's
ms, so that a slow batch in steady state shows where it falls.
``--one-blas-thread`` sets ``OMP_NUM_THREADS``, ``OPENBLAS_NUM_THREADS`` and
``MKL_NUM_THREADS`` to 1 before the loaders start (spawned workers inherit
them).  ``--trace`` also records, for each sample, the worker's process id
and its wall-clock start and end, and prints per batch the workers that
served it (and all that had served so far) and the ms each sample took
inside its worker.  ``chip_smoke.py``'s data phase reports the same loader's
means.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TracedDataset:
    """A dataset whose samples carry ``_trace`` = [pid, start s, end s] (wall
    clock, comparable across processes)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int, epoch: int = 0):
        import numpy as np

        t0 = time.time()
        out = self.dataset.__getitem__(idx, epoch=epoch)
        out["_trace"] = np.array([os.getpid(), t0, time.time()])
        return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, default=12)
    p.add_argument("--batch-size", type=int, default=22)
    p.add_argument("--workers", type=int, default=15)
    p.add_argument("--modes", default="thread,process")
    p.add_argument("--backends", default="native,pil")
    p.add_argument("--one-blas-thread", action="store_true")
    p.add_argument("--trace", action="store_true")
    args = p.parse_args(argv)
    if args.one_blas_thread:
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ[var] = "1"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from torch_data_fixtures import write_dexycb

    from hoisdf_torch.config import get_config
    from hoisdf_torch.data.dexycb import DexYCBDataset
    from hoisdf_torch.data.loader import DataLoader
    from hoisdf_torch.mano.model import make_synthetic_mano

    with tempfile.TemporaryDirectory() as tmp:
        tree = write_dexycb(os.path.join(tmp, "dexycb"), n_train=args.batches * args.batch_size,
                            n_test=1, cut=True, n_hand=1000, n_obj=400)
        for backend in args.backends.split(","):
            cfg = get_config("dexycb", native_pipeline={"native": "on", "pil": "off"}[backend],
                             **tree)
            ds = DexYCBDataset(cfg, "train", make_synthetic_mano(0))
            if args.trace:
                ds = TracedDataset(ds)
            for mode in args.modes.split(","):
                t0 = time.perf_counter()
                with DataLoader(ds, args.batch_size, shuffle=True, num_workers=args.workers,
                                drop_last=True, worker_mode=mode) as loader:
                    start_ms = (time.perf_counter() - t0) * 1e3
                    per_batch, traces, seen = [], [], set()
                    t0 = time.perf_counter()
                    for batch in loader:
                        per_batch.append((time.perf_counter() - t0) * 1e3)
                        if args.trace:
                            tr = batch["_trace"]
                            seen |= set(tr[:, 0].tolist())
                            ms = (tr[:, 2] - tr[:, 1]) * 1e3
                            traces.append({"pids": len(set(tr[:, 0].tolist())),
                                           "pids_seen": len(seen),
                                           "sample_ms_mean": float(ms.mean()),
                                           "sample_ms_max": float(ms.max())})
                        t0 = time.perf_counter()
                line = {"backend": backend, "mode": mode, "workers": args.workers,
                        "one_blas_thread": args.one_blas_thread, "cpu_count": os.cpu_count(),
                        "startup_ms": start_ms, "batch_ms": per_batch}
                if args.trace:
                    line["trace"] = traces
                print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
