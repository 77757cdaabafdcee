"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``):
Dataset with its lazy ``transform``/``transform_first``, ``filter``,
``take`` and ``sample``, SimpleDataset, ArrayDataset and
RecordFileDataset (records through the ``.idx``; the JAX package's
native scanner waits for ROADMAP A5b)."""
from __future__ import annotations

import os

from ...ndarray import ndarray as _nd

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: __getitem__ + __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        kept = []
        for i in range(len(self)):
            item = self[i]
            if fn(item):
                kept.append(item)
        return SimpleDataset(kept)

    def take(self, count):
        return _TakenDataset(self, count)

    def sample(self, sampler):
        return _SampledDataset(self, list(sampler))

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _TakenDataset(Dataset):
    def __init__(self, data, count):
        self._data = data
        self._count = min(count, len(data))

    def __len__(self):
        return self._count

    def __getitem__(self, idx):
        if idx >= self._count:
            raise IndexError
        return self._data[idx]


class _SampledDataset(Dataset):
    def __init__(self, data, indices):
        self._data = data
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    """Picklable closure transforming only the first element."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Zip of equal-length arrays/lists."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; got %d vs %d" % (
                    len(data), self._length)
            if isinstance(data, _nd.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The raw records of a RecordIO (.rec) file with its .idx, in the
    index's order."""

    def __init__(self, filename):
        from ... import recordio
        self._filename = filename
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
