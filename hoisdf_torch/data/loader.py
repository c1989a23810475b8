"""The data loader (``hoisdf_tpu/data/loader.py``): samples decoded by a pool
of threads or processes, batches stacked ahead of the consumer, and the tail
padding of the eval loop.

The order is the JAX package's: each epoch's permutation is keyed on
``(seed, epoch)`` only, and a shard takes ``order[shard_id::num_shards]``
trimmed to ``len // num_shards`` samples, so that every shard steps the same
number of batches.  The shard defaults to the data-parallel group's (rank,
world size), resolved at first use (``jax.process_index()`` /
``process_count()`` in the JAX package); without a group it is ``(0, 1)``,
the whole dataset.  A sample is ``dataset.__getitem__(index, epoch=epoch)``, so the
dataset's per-sample random streams do not depend on which worker draws it.

Thread workers suit the PIL pipeline, whose decode and warps release the GIL.
Process workers start by ``spawn`` (a process that holds a CUDA context must
not fork), each with its own copy of the dataset, and live until
:meth:`DataLoader.close`.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

# The dataset of a process worker, set once by the pool's initializer in the
# worker (never in the parent).
_WORKER_DATASET = None
# How long a process worker waits for the rest of its pool to start.
WORKER_START_TIMEOUT_S = 600.0


def _init_worker(dataset, started) -> None:
    """Keep the dataset, then wait until every worker of the pool holds its
    own (``started`` is a barrier of the pool's size), so that the start-up
    probe returns only once the whole pool can serve."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    started.wait(WORKER_START_TIMEOUT_S)


def _process_fetch(args) -> dict:
    i, epoch = args
    return _WORKER_DATASET.__getitem__(int(i), epoch=epoch)


def _process_probe(_) -> int:
    return 0


def _default_shard() -> Tuple[int, int]:
    """(rank, world size) of the data-parallel group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def pad_batch(d: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """Pad every array's leading dim to ``n`` by repeating its last row, so a
    short tail batch runs at the full batch shape; :func:`trim_batch` drops
    the rows again before the metrics."""
    return {k: np.concatenate([v] + [v[-1:]] * (n - v.shape[0]), axis=0)
            if v.shape[0] < n else v for k, v in d.items()}


def trim_batch(d: Dict, n: int) -> Dict:
    """Drop pad rows: slice every value's leading dim back to ``n``."""
    return {k: v[:n] for k, v in d.items()}


class DataLoader:
    """Batches of ``dataset`` as dicts of stacked numpy arrays.

    ``shuffle`` draws each epoch's order from ``(seed, epoch)``
    (:meth:`set_epoch` picks the epoch); ``drop_last`` drops a short tail
    batch; ``shard_id`` / ``num_shards`` (both or neither; default the
    group's rank and size, ``(0, 1)`` without a group) take one shard of the
    order; ``worker_mode`` is ``"thread"`` or
    ``"process"``; ``prefetch_batches`` batches are stacked ahead.  An error
    in a worker is raised in the consuming loop."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, num_workers: int = 8,
                 drop_last: bool = False, seed: int = 0, prefetch_batches: int = 2,
                 shard_id: Optional[int] = None, num_shards: Optional[int] = None,
                 worker_mode: str = "thread"):
        if (shard_id is None) != (num_shards is None):
            raise ValueError("pass both shard_id and num_shards, or neither")
        if shard_id is not None and not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        # None: the group's (rank, world size), resolved at first use
        self._shard = None if shard_id is None else (int(shard_id), int(num_shards))
        self.worker_mode = worker_mode
        self.epoch = 0
        self._pool = None
        if worker_mode == "process":
            ctx = multiprocessing.get_context("spawn")
            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=ctx, initializer=_init_worker,
                initargs=(dataset, ctx.Barrier(self.num_workers)))
            # start every worker now (the initializer's barrier holds the
            # probes until the last is up), so that a dataset that fails to
            # pickle or to import fails here and not inside the first epoch
            list(self._pool.map(_process_probe, range(self.num_workers)))

    @property
    def shard_id(self) -> int:
        return self._resolve_shard()[0]

    @property
    def num_shards(self) -> int:
        return self._resolve_shard()[1]

    def _resolve_shard(self) -> Tuple[int, int]:
        if self._shard is None:
            self._shard = _default_shard()
        return self._shard

    def close(self) -> None:
        """Shut the process workers down (a no-op for thread workers)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self) -> "DataLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _shard_len(self) -> int:
        return len(self.dataset) // self.num_shards

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_id::self.num_shards][: self._shard_len()]
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order, epoch = self._order(), self.epoch
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        if self.worker_mode == "process":
            if self._pool is None:
                raise RuntimeError("DataLoader.close() was called; its workers are gone")
            pool, owned = self._pool, False

            def run(ids):
                return pool.map(_process_fetch, [(int(i), epoch) for i in ids])
        else:
            pool, owned = ThreadPoolExecutor(self.num_workers), True

            def run(ids):
                return pool.map(lambda i: self.dataset.__getitem__(int(i), epoch=epoch), ids)

        def put(item) -> bool:
            """A bounded put that gives up once the consumer has gone, so an
            abandoned iterator does not strand the producer on a full queue."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    samples = list(run(order[b * self.batch_size:(b + 1) * self.batch_size]))
                    if not put({k: np.stack([s[k] for s in samples]) for k in samples[0]}):
                        return
                put(None)
            except BaseException as exc:  # noqa: BLE001 -- handed to the consumer, which raises it
                put(exc)
            finally:
                if owned:
                    pool.shutdown(wait=False, cancel_futures=True)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
