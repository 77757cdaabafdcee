"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``).

``NDArrayIter`` batches in-memory arrays (numpy arrays, tensors, or
dicts of them) in order, into CPU tensors (``HostBatch``: they also
answer ``as_in_context``, ``asnumpy`` and ``context``, the NDArray calls
a Gluon loop makes on a batch); the executor copies each batch to its
device. The last partial batch is padded from the start
(``last_batch_handle="pad"``, the default) or dropped (``"discard"``).
With ``shuffle=True`` every ``reset`` (the constructor's included)
shuffles the order with ``numpy.random.shuffle``, as the JAX package
does, so under one ``numpy.random.seed`` both give the same batches.
``ResizeIter`` gives a fixed number of batches an epoch from another
iterator, resetting it when it runs out; ``PrefetchingIter`` pulls
batches on a thread of its own through a
:class:`~mxnet_tpu_torch.data.pipeline.PrefetchQueue`. ``LibSVMIter``
parses a LibSVM file once into a host CSR arena and gives each batch as
a ``CSRNDArray`` on the current context (the card unless the caller
asks for the CPU).
"""
from __future__ import annotations

import collections
import threading

import numpy as _np
import torch

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "LibSVMIter"]


class HostBatch(torch.Tensor):
    """A batch on the host: a CPU tensor (torch ops on it return plain
    tensors) that answers the NDArray calls of a Gluon loop."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def _plain(self):
        return self.as_subclass(torch.Tensor)

    def as_in_context(self, context):
        """An NDArray of the batch on ``context``."""
        from ..context import resolve_device
        from ..ndarray.ndarray import NDArray
        return NDArray(self._plain().to(resolve_device(context)),
                       ctx=context)

    def asnumpy(self):
        return self._plain().numpy()

    @property
    def context(self):
        from ..context import cpu
        return cpu()


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
    """Iterate over in-memory arrays, in order or shuffled.

    ``last_batch_handle`` takes any value, as the JAX package's: with
    ``"discard"`` an epoch is ``n // batch_size`` batches; with any other
    (``"pad"``, ``"roll_over"``, ...) it is ``ceil(n / batch_size)``
    batches and the tail batch is filled from the start of the epoch's
    order, and only ``"pad"`` reports that fill as the batch's pad."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
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
                .as_subclass(HostBatch) for v in arrays.values()]

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


class ResizeIter(DataIter):
    """``size`` batches an epoch from ``data_iter``, which is reset and
    read again when it runs out first."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Batches of one or more iterators pulled ahead on a thread; with
    several, each batch joins their data and labels."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, list):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._depth = prefetch_depth
        self._queue = None
        self._thread = None
        self._start()

    def _start(self):
        # the worker holds THIS generation's queue, so a worker left over
        # from before a reset can never feed the new one
        from ..data.pipeline import PrefetchQueue
        pq = self._queue = PrefetchQueue(self._depth)

        def worker():
            while not pq.stopped:
                try:
                    batches = [i.next() for i in self.iters]
                except StopIteration:
                    pq.put_sentinel()
                    return
                except Exception as e:
                    pq.put(e)
                    return
                if not pq.put(batches):
                    return

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    @staticmethod
    def _renamed(renames, iters, attr):
        if renames is None:
            return sum([getattr(i, attr) for i in iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     if isinstance(r, dict) else d
                     for d in getattr(i, attr)]
                    for r, i in zip(renames, iters)], [])

    @property
    def provide_data(self):
        return self._renamed(self.rename_data, self.iters, "provide_data")

    @property
    def provide_label(self):
        return self._renamed(self.rename_label, self.iters, "provide_label")

    def reset(self):
        # the inner iterators are reset only once the worker is gone
        self._queue.shutdown(self._thread, timeout=5.0)
        for i in self.iters:
            i.reset()
        self._start()

    def next(self):
        batches = self._queue.get()
        if len(batches) == 1:
            return batches[0]
        return DataBatch(
            data=sum([b.data for b in batches], []),
            label=sum([(b.label or []) for b in batches], []),
            pad=max(b.pad or 0 for b in batches))

    def iter_next(self):
        try:
            self._peek = self.next()
            return True
        except StopIteration:
            return False

    def queue_depth(self):
        return self._queue.qsize()

    def close(self):
        """Stop the worker (``reset()`` starts a new one)."""
        if self._queue is not None:
            self._queue.shutdown(self._thread, timeout=5.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class LibSVMIter(DataIter):
    """A zero-based LibSVM file as CSR batches. Each line is an optional
    label token and ``index:value`` pairs; blank lines and lines that
    start with ``#`` are skipped. ``num_parts``/``part_index`` take
    contiguous line ranges. The label is each line's leading token, or
    with ``label_libsvm`` the rows of a second LibSVM file (then the
    label batch is CSR too, of width ``prod(label_shape)``). The last
    batch wraps around to the start of the part (``round_batch=True``
    only) and ``getpad`` counts the wrapped rows. The part is parsed
    once into one host CSR arena (numpy); each batch's CSR data and its
    labels go to the current context."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=128, num_parts=1,
                 part_index=0, round_batch=True, **kwargs):
        super().__init__(batch_size)
        if isinstance(data_shape, int):
            data_shape = (data_shape,)
        if isinstance(label_shape, int):
            label_shape = (label_shape,)
        if len(data_shape) != 1:
            raise ValueError("dimension of data_shape is expected to be 1")
        if num_parts <= 0 or not 0 <= part_index < num_parts:
            raise ValueError("bad num_parts/part_index: %r/%r"
                             % (num_parts, part_index))
        if not round_batch:
            raise ValueError("LibSVMIter supports round_batch=True only")
        self._data_shape = tuple(data_shape)
        self._label_shape = tuple(label_shape)
        self.round_batch = round_batch
        self._vals, self._idxs, self._ptr, labels = self._parse(
            data_libsvm, num_parts, part_index)
        self.num_data = len(self._ptr) - 1
        width = int(_np.prod(self._label_shape))
        if label_libsvm and label_libsvm != "NULL":
            if width <= 1:
                raise ValueError("label_shape is not expected to be (1,) "
                                 "when label_libsvm is set")
            lv, li, lp, _ = self._parse(label_libsvm, num_parts, part_index)
            if len(lp) - 1 != self.num_data:
                raise ValueError("label file row count %d != data rows %d"
                                 % (len(lp) - 1, self.num_data))
            self._lab = (lv, li, lp)
        else:
            if width > 1:
                raise ValueError("label_shape is expected to be (1,) when "
                                 "label_libsvm is NULL")
            self._lab = _np.asarray(labels, dtype=_np.float32) \
                .reshape(-1, 1)
        self.reset()

    @staticmethod
    def _parse(path, num_parts, part_index):
        with open(path, "r") as f:
            lines = [ln.strip() for ln in f]
        lines = [ln for ln in lines if ln and not ln.startswith("#")]
        n = len(lines)
        lo, hi = part_index * n // num_parts, (part_index + 1) * n // num_parts
        vals, idxs, ptr, labels = [], [], [0], []
        for ln in lines[lo:hi]:
            toks = ln.split()
            k = 0
            if toks and ":" not in toks[0]:
                labels.append(float(toks[0]))
                k = 1
            else:
                labels.append(0.0)
            for t in toks[k:]:
                i, v = t.split(":")
                idxs.append(int(i))
                vals.append(float(v))
            ptr.append(len(vals))
        return (_np.asarray(vals, _np.float32), _np.asarray(idxs, _np.int64),
                _np.asarray(ptr, _np.int64), labels)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self._data_shape,
                         _np.float32)]

    @property
    def provide_label(self):
        # a leading-token label is (batch,); a label file's (batch,) +
        # label_shape
        shp = self._label_shape if isinstance(self._lab, tuple) else ()
        return [DataDesc("softmax_label", (self.batch_size,) + tuple(shp),
                         _np.float32)]

    def reset(self):
        self.cursor = -1

    def iter_next(self):
        self.cursor += 1
        return self.cursor * self.batch_size < self.num_data

    @staticmethod
    def _csr_rows(vals, idxs, ptr, rows, width):
        """Rows of the arena as one CSRNDArray on the current context."""
        from ..ndarray import sparse as _sp
        counts = ptr[rows + 1] - ptr[rows]
        bptr = _np.zeros(len(rows) + 1, dtype=_np.int64)
        _np.cumsum(counts, out=bptr[1:])
        take = _np.concatenate(
            [_np.arange(ptr[r], ptr[r + 1]) for r in rows]) \
            if len(rows) else _np.zeros((0,), _np.int64)
        return _sp.csr_matrix((vals[take], idxs[take], bptr),
                              shape=(len(rows), width))

    def _rows(self):
        start = self.cursor * self.batch_size
        rows = _np.arange(start, min(start + self.batch_size, self.num_data))
        if len(rows) < self.batch_size:
            # wrap modulo the part, so a part smaller than a batch works
            extra = _np.arange(self.batch_size - len(rows)) % self.num_data
            rows = _np.concatenate([rows, extra])
        return rows

    def getdata(self):
        return [self._csr_rows(self._vals, self._idxs, self._ptr,
                               self._rows(), self._data_shape[0])]

    def getlabel(self):
        rows = self._rows()
        if isinstance(self._lab, tuple):
            lv, li, lp = self._lab
            return [self._csr_rows(lv, li, lp, rows,
                                   int(_np.prod(self._label_shape)))]
        from ..ndarray import ndarray as _nd
        return [_nd.array(self._lab[rows, 0])]

    def getpad(self):
        return max(0, (self.cursor + 1) * self.batch_size - self.num_data)
