"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

With ``num_workers=0`` the main process reads and batchifies: NDArray
samples stack on their own device (``stack``), numpy or Python samples
become one NDArray on ``current_context()``. With workers, a pool of
forked processes reads and batchifies to numpy
(``default_mp_batchify_fn``) and the main process moves each batch to
``current_context()``: a forked worker never touches CUDA, so its
dataset must hold host data (numpy, or NDArrays on the CPU). 64-bit
numpy data narrows to 32 bits as ``nd.array`` narrows it, which is what
the JAX package's batches hold.
"""
from __future__ import annotations

import multiprocessing
import pickle

import numpy as _np
import torch

from ...ndarray import ndarray as _nd
from . import sampler as _sampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch."""
    if isinstance(data[0], _nd.NDArray):
        return _nd.invoke("stack", list(data), {"axis": 0})
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    return _nd.array(_np.asarray(data))


def default_mp_batchify_fn(data):
    """Worker-side batchify: numpy (the main process places it)."""
    if isinstance(data[0], tuple):
        return [default_mp_batchify_fn(i) for i in zip(*data)]
    arr = [x.asnumpy() if isinstance(x, _nd.NDArray) else _np.asarray(x)
           for x in data]
    return _np.stack(arr, axis=0)


_worker_dataset = None
_worker_batchify = None


def _worker_init(dataset_bytes, batchify_bytes):
    global _worker_dataset, _worker_batchify
    # one intra-op thread, as torch's own DataLoader workers run: a forked
    # child that enters the OpenMP pool its parent started hangs
    torch.set_num_threads(1)
    _worker_dataset = pickle.loads(dataset_bytes)
    _worker_batchify = pickle.loads(batchify_bytes)


def _worker_fn(samples):
    return _worker_batchify([_worker_dataset[i] for i in samples])


def _as_nd(batch):
    if isinstance(batch, (list, tuple)):
        return [_as_nd(b) for b in batch]
    if isinstance(batch, _np.ndarray):
        return _nd.array(batch)
    return batch


class DataLoader:
    """Loads mini-batches from a Dataset, optionally with worker
    processes."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = _sampler.RandomSampler(len(dataset)) if shuffle \
                    else _sampler.SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = _sampler.BatchSampler(
                sampler, batch_size, last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        if prefetch is None:
            prefetch = 2 * self._num_workers
        # at least one batch in flight, or the pool makes no progress
        self._prefetch = max(1 if self._num_workers else 0, int(prefetch))
        if batchify_fn is None:
            self._batchify_fn = default_mp_batchify_fn \
                if self._num_workers > 0 else default_batchify_fn
        else:
            self._batchify_fn = batchify_fn

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._batchify_fn([self._dataset[i] for i in batch])
            return
        yield from self._mp_iter()

    def _mp_iter(self):
        """A pool of forked workers with bounded in-flight prefetch."""
        ds = pickle.dumps(self._dataset)
        bf = pickle.dumps(self._batchify_fn)
        ctx = multiprocessing.get_context("fork")
        with ctx.Pool(self._num_workers, initializer=_worker_init,
                      initargs=(ds, bf)) as pool:
            batches = list(self._batch_sampler)
            inflight = []
            it = iter(batches)
            for _ in range(min(self._prefetch, len(batches))):
                inflight.append(pool.apply_async(_worker_fn, (next(it),)))
            while inflight:
                batch = inflight.pop(0).get()
                try:
                    inflight.append(pool.apply_async(_worker_fn,
                                                     (next(it),)))
                except StopIteration:
                    pass
                yield _as_nd(batch)

    def __len__(self):
        return len(self._batch_sampler)
