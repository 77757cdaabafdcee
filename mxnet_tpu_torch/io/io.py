"""Data iterators (counterpart of a subset of ``mxnet_tpu/io/io.py``).

``NDArrayIter`` batches in-memory arrays (numpy arrays, tensors, or
dicts of them) in order, into CPU tensors; the executor copies each
batch to its device. The last partial batch is padded from the start
(``last_batch_handle="pad"``, the default) or dropped (``"discard"``).
With ``shuffle=True`` every ``reset`` (the constructor's included)
shuffles the order with ``numpy.random.shuffle``, as the JAX package
does, so under one ``numpy.random.seed`` both give the same batches.
"""
from __future__ import annotations

import collections

import numpy as _np
import torch

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape", "dtype",
                                                   "layout"])):
    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [tuple(d.shape) for d in self.data] if self.data else []
        return "DataBatch: data shapes: %s" % shapes


class DataIter:
    """Base iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _as_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    return _np.asarray(v)


def _init_data(data, allow_empty, default_name):
    if data is None:
        data = []
    if not isinstance(data, (list, dict)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("NDArrayIter needs data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    return collections.OrderedDict((k, _as_numpy(v))
                                   for k, v in data.items())


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays, in order or shuffled."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard"):
            raise ValueError("last_batch_handle must be 'pad' or 'discard', "
                             "got %r" % (last_batch_handle,))
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = next(iter(self.data.values())).shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = _np.arange(self.num_data)
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data.items()]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label.items()]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        self.cursor = -1

    def iter_next(self):
        self.cursor += 1
        return self.cursor < self.num_batches

    def _take(self, arrays):
        start = self.cursor * self.batch_size
        end = min(start + self.batch_size, self.num_data)
        sel = self.idx[start:end]
        pad = self.batch_size - len(sel)
        if pad > 0:
            sel = _np.concatenate([sel, self.idx[:pad]])
        return [torch.from_numpy(_np.ascontiguousarray(v[sel]))
                for v in arrays.values()]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = (self.cursor + 1) * self.batch_size
        if end > self.num_data and self.last_batch_handle == "pad":
            return end - self.num_data
        return 0

    def getindex(self):
        start = self.cursor * self.batch_size
        return self.idx[start:min(start + self.batch_size, self.num_data)]
