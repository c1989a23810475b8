"""The port's DataLoader against the JAX package's: the same batches in the
same order for shuffled and plain epochs, with and without ``drop_last``,
for every shard of two and three, and in both worker modes (the port's
process workers start by spawn, the JAX package's fork); errors reach the
consumer and an abandoned epoch releases its producer."""

import gc
import os
import threading
import time

import numpy as np
import pytest

from hoisdf_torch.data.loader import DataLoader, pad_batch, trim_batch
from hoisdf_tpu.data import loader as J

from torch_data_fixtures import StartMarkingDataset, ToyDataset, assert_samples_equal


def _epochs(loader, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("shards", [None, (0, 2), (1, 2), (2, 3)])
def test_batches_equal_jax(shuffle, drop_last, shards):
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, seed=5, num_workers=2)
    if shards is not None:
        kw.update(shard_id=shards[0], num_shards=shards[1])
    port, jax_loader = DataLoader(ToyDataset(), **kw), J.DataLoader(ToyDataset(), **kw)
    assert len(port) == len(jax_loader)
    got, want = _epochs(port), _epochs(jax_loader)
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) == len(port)
        for g, w in zip(g_epoch, w_epoch):
            assert_samples_equal(g, w)
    if shuffle:
        assert not np.array_equal(got[0][0]["x"], got[1][0]["x"])


def test_process_workers_equal_jax_and_thread_workers():
    kw = dict(batch_size=4, shuffle=True, seed=3, num_workers=2, drop_last=True)
    with DataLoader(ToyDataset(), worker_mode="process", **kw) as port:
        got = _epochs(port)
    want = _epochs(J.DataLoader(ToyDataset(), worker_mode="process", **kw))
    threads = _epochs(DataLoader(ToyDataset(), worker_mode="thread", **kw))
    for g_epoch, w_epoch, t_epoch in zip(got, want, threads):
        assert len(g_epoch) == len(w_epoch) == 5
        for g, w, t in zip(g_epoch, w_epoch, t_epoch):
            assert_samples_equal(g, w)
            assert_samples_equal(g, t)
    with pytest.raises(RuntimeError, match="close"):
        list(port)


def test_every_process_worker_has_started_when_the_loader_returns(tmp_path):
    """The start-up probe returns only once every worker holds its dataset
    (each worker's copy writes a file when it is unpickled there), and the
    batches are those of thread workers."""
    marks = tmp_path / "marks"
    marks.mkdir()
    kw = dict(batch_size=4, shuffle=True, seed=3, num_workers=4, drop_last=True)
    with DataLoader(StartMarkingDataset(str(marks)), worker_mode="process", **kw) as dl:
        assert len([m for m in os.listdir(marks) if m.startswith("started")]) == 4
        got = _epochs(dl)
    want = _epochs(DataLoader(ToyDataset(), worker_mode="thread", **kw))
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) == 5
        for g, w in zip(g_epoch, w_epoch):
            assert_samples_equal(g, w)


def test_arguments_are_checked():
    with pytest.raises(ValueError, match="both"):
        DataLoader(ToyDataset(), 4, shard_id=1)
    with pytest.raises(ValueError, match="not in"):
        DataLoader(ToyDataset(), 4, shard_id=2, num_shards=2)
    with pytest.raises(ValueError, match="worker_mode"):
        DataLoader(ToyDataset(), 4, worker_mode="fiber")


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_worker_error_reaches_the_consumer(worker_mode):
    with DataLoader(ToyDataset(fail_at=5), 4, num_workers=2, worker_mode=worker_mode) as dl:
        with pytest.raises(ValueError, match="boom at idx 5"):
            for _ in dl:
                pass


def test_abandoned_epoch_releases_its_producer():
    before = threading.active_count()
    for _ in range(5):
        it = iter(DataLoader(ToyDataset(), 2, prefetch_batches=1))
        next(it)  # the producer now waits on a full queue
        it.close()
    gc.collect()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before + 1, threading.active_count()
    assert len(list(DataLoader(ToyDataset(), 4))) == 6


def test_pad_and_trim_equal_jax():
    batch = {"a": np.arange(6.0).reshape(3, 2), "b": np.arange(3)}
    assert_samples_equal(pad_batch(batch, 5), J.pad_batch(batch, 5))
    assert_samples_equal(trim_batch(pad_batch(batch, 5), 3), batch)
