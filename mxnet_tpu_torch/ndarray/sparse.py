"""Sparse NDArrays: row_sparse and CSR (counterpart of
``mxnet_tpu/ndarray/sparse.py``).

The storage formats are the reference's: row_sparse keeps
``indices[i] -> data[i, :]`` pairs beside the dense logical shape, CSR
keeps ``indptr``, ``indices`` and ``data``; each part is a tensor on
the array's device. Indices read back as int32 (``.indices``), as the
JAX package's do with 64-bit types off. What runs sparse, never
touching the dense logical shape: ``retain``, ``write_rows``, the
optimizers' lazy row updates (``optimizer.py``), ``dot`` of a CSR matrix
(or its transpose) with a dense one, and ``add`` of two row_sparse
arrays (the kvstore's reduce). Everything else reads ``_data``, a dense
tensor made on first use: the reference's storage fallback.

``dot`` and ``add`` sum without float atomics, so a card gives the same
bits on every call: the terms of each output row are put in order (a
CSR row's entries as stored; for the transpose a stable sort by column,
so each column's terms come in row-major entry order) and added one
after another from zero, the order in which the JAX package's
scatter-add sums them on the CPU (:func:`_segment_sum`).

``cast_storage(dense, "row_sparse")`` finds the rows that hold a
nonzero on the device and copies only that ``(rows,)`` occupancy vector
to the host to pick them (the row count sets the result's shape), then
gathers the kept rows on the device.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import normalize_dtype
from ..context import current_context, resolve_device
from . import ndarray as _ndarray
from .ndarray import NDArray, _ctx_of

__all__ = ["RowSparseNDArray", "CSRNDArray", "csr_matrix",
           "row_sparse_array", "cast_storage", "dot", "zeros", "retain",
           "write_rows"]


def _tensor(x, device, dtype=None):
    """A numpy array, tensor or NDArray as a tensor on ``device``."""
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(_np.ascontiguousarray(_np.asarray(x)))
    return x.to(device=device, dtype=dtype)


def _values(x, ctx, dtype=None):
    """Stored values as a tensor on ``ctx``: host data goes through
    ``nd.array``, so 64-bit types narrow to 32 bits as there."""
    if isinstance(x, (NDArray, torch.Tensor)):
        return _tensor(x, resolve_device(ctx), normalize_dtype(dtype))
    return _ndarray.array(x, ctx=ctx, dtype=dtype)._data


class BaseSparseNDArray(NDArray):
    """Shared base: ``_data`` is the dense view, made on first use, so
    every inherited NDArray method works on a sparse array by falling
    back to dense."""

    __slots__ = ("_dense_cache",)

    @property
    def _data(self):
        if self._dense_cache is None:
            self._dense_cache = self._make_dense()
        return self._dense_cache

    def _invalidate(self):
        self._dense_cache = None

    def _init_common(self, shape, ctx):
        self._shape = tuple(int(s) for s in shape)
        self._ctx = ctx or _ctx_of(self._values)
        self._ag = None
        self._version = 0
        self._dense_cache = None

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def size(self):
        n = 1
        for s in self._shape:
            n *= s
        return n

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def data(self):
        return NDArray(self._values, ctx=self._ctx)

    @property
    def indices(self):
        return NDArray(self._indices.to(torch.int32), ctx=self._ctx)

    def todense(self):
        return NDArray(self._data, ctx=self._ctx)

    def asnumpy(self):
        return self.todense().asnumpy()

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        raise ValueError("cast %s -> %s not supported" % (self.stype,
                                                          stype))

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__, "x".join(
            str(s) for s in self._shape), self._ctx)


class RowSparseNDArray(BaseSparseNDArray):
    """row_sparse: ``indices[i] -> data[i, :]`` and the dense logical
    shape. ``data`` and ``indices`` are tensors (or NDArrays) on one
    device."""

    __slots__ = ("_indices", "_values", "_shape")

    def __init__(self, data, indices, shape, ctx=None):
        self._values = data._data if isinstance(data, NDArray) else data
        self._indices = _tensor(indices, self._values.device, torch.int64)
        self._init_common(shape, ctx)

    def _make_dense(self):
        dense = torch.zeros(self._shape, dtype=self._values.dtype,
                            device=self._values.device)
        dense[self._indices] = self._values
        return dense

    @property
    def stype(self):
        return "row_sparse"

    def retain(self, row_ids):
        return retain(self, row_ids)



class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows: ``indptr``, column ``indices``, ``data``."""

    __slots__ = ("_indptr", "_indices", "_values", "_shape")

    def __init__(self, data, indptr, indices, shape, ctx=None):
        self._values = data._data if isinstance(data, NDArray) else data
        dev = self._values.device
        self._indptr = _tensor(indptr, dev, torch.int64)
        self._indices = _tensor(indices, dev, torch.int64)
        self._init_common(shape, ctx)

    def _row_ids(self):
        counts = self._indptr[1:] - self._indptr[:-1]
        return torch.repeat_interleave(
            torch.arange(self._shape[0], device=self._values.device),
            counts, output_size=self._values.shape[0])

    def _make_dense(self):
        dense = torch.zeros(self._shape, dtype=self._values.dtype,
                            device=self._values.device)
        dense[self._row_ids(), self._indices] = self._values
        return dense

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self):
        return NDArray(self._indptr.to(torch.int32), ctx=self._ctx)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` or a dense array,
    on ``ctx`` (default the current context)."""
    ctx = ctx or current_context()
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(_values(data, ctx, dtype), indptr, indices,
                          shape, ctx=ctx)
    dense = arg1.asnumpy() if isinstance(arg1, NDArray) else arg1
    return _csr_from_dense(_np.asarray(dense), ctx)


def _csr_from_dense(dense_np, ctx):
    rows, cols = _np.nonzero(dense_np)
    indptr = _np.zeros(dense_np.shape[0] + 1, dtype=_np.int64)
    _np.add.at(indptr, rows + 1, 1)
    return CSRNDArray(_values(dense_np[rows, cols], ctx),
                      _np.cumsum(indptr), cols, dense_np.shape, ctx=ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` or a dense array, on
    ``ctx`` (default the current context)."""
    ctx = ctx or current_context()
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(_values(data, ctx, dtype), indices, shape,
                                ctx=ctx)
    dense = arg1.asnumpy() if isinstance(arg1, NDArray) else arg1
    return _rsp_from_dense(_np.asarray(dense), ctx)


def _rsp_from_dense(dense_np, ctx):
    nz = _np.where(_np.any(dense_np != 0,
                           axis=tuple(range(1, dense_np.ndim))))[0]
    return RowSparseNDArray(_values(dense_np[nz], ctx), nz,
                            dense_np.shape, ctx=ctx)


def zeros(stype, shape, ctx=None, dtype=None):
    """An empty row_sparse or CSR array of ``shape`` (no stored row or
    entry), or the dense zeros for any other ``stype``."""
    if stype not in ("row_sparse", "csr"):
        return _ndarray.zeros(shape, ctx=ctx, dtype=dtype)
    ctx = ctx or current_context()
    dev = resolve_device(ctx)
    dt = normalize_dtype(dtype) or torch.float32
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            empty, shape, ctx=ctx)
    return CSRNDArray(torch.zeros(0, dtype=dt, device=dev),
                      torch.zeros(shape[0] + 1, dtype=torch.int64,
                                  device=dev), empty, shape, ctx=ctx)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _segment_sum(terms, starts, counts, targets, nout):
    """``out[targets[i]] = 0 + terms[starts[i]] + ... + terms[starts[i]
    + counts[i] - 1]``, added in that order, into zeros of ``(nout,) +
    terms.shape[1:]``; ``targets`` are distinct. Step k adds the k-th
    term of every segment that has one (the segments sorted by count,
    so those are a prefix), and no two terms ever race for an output:
    the result is the same on every call and every device. Only the
    histogram of the counts is read to the host."""
    out = torch.zeros((nout,) + tuple(terms.shape[1:]), dtype=terms.dtype,
                      device=terms.device)
    if terms.shape[0] == 0:
        return out
    perm = torch.argsort(counts, descending=True, stable=True)
    live = (counts.numel() - torch.cumsum(torch.bincount(counts), 0)) \
        .tolist()
    first = starts[perm]
    acc = torch.zeros((counts.numel(),) + tuple(terms.shape[1:]),
                      dtype=terms.dtype, device=terms.device)
    for k, n in enumerate(live):
        if n == 0:
            break
        acc[:n] += terms.index_select(0, first[:n] + k)
    out[targets[perm]] = acc
    return out


def _sorted_segments(keys):
    """A stable sort of ``keys`` -> (the order, each distinct key, its
    first position in the sorted keys, its count)."""
    skeys, order = torch.sort(keys, stable=True)
    uniq, counts = torch.unique_consecutive(skeys, return_counts=True)
    return order, uniq, torch.cumsum(counts, 0) - counts, counts


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``csr @ dense`` and ``csr.T @ dense`` summed sparse, on the
    operands' device (:func:`_segment_sum`): ``out[row] += val *
    d[col]`` over each row's entries, and for the transpose ``out[col]
    += val * d[row]`` into ``(lhs.shape[1], d.shape[1])``. A row_sparse
    operand is made dense; any other pair goes to the ``dot`` op."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray) \
            and not isinstance(rhs, BaseSparseNDArray):
        d = rhs._data
        vals, cols = lhs._values, lhs._indices
        if transpose_a:
            order, uniq, starts, counts = _sorted_segments(cols)
            terms = vals[order, None] * d[lhs._row_ids()[order]]
            out = _segment_sum(terms, starts, counts, uniq, lhs.shape[1])
        else:
            ptr = lhs._indptr
            out = _segment_sum(vals[:, None] * d[cols], ptr[:-1],
                               ptr[1:] - ptr[:-1],
                               torch.arange(lhs.shape[0], device=d.device),
                               lhs.shape[0])
        return NDArray(out, ctx=lhs._ctx)
    if isinstance(lhs, RowSparseNDArray):
        lhs = lhs.todense()
    if isinstance(rhs, BaseSparseNDArray):
        rhs = rhs.todense()
    return _ndarray.invoke("dot", [lhs, rhs], {"transpose_a": transpose_a,
                                               "transpose_b": transpose_b})


def add(lhs, rhs):
    """``lhs + rhs``. Two row_sparse arrays add sparse: the union of
    their stored rows (only the index vectors go to the host), each row
    summed on the device in the order lhs's values, then rhs's. Any
    other pair adds dense."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        dev = lhs._values.device
        idx = torch.cat([lhs._indices, rhs._indices.to(dev)])
        uniq, inv = _np.unique(idx.cpu().numpy(), return_inverse=True)
        order, segs, starts, counts = _sorted_segments(
            _tensor(inv.reshape(-1), dev, torch.int64))
        vals = torch.cat([lhs._values, rhs._values.to(dev)])
        summed = _segment_sum(vals[order], starts, counts, segs, len(uniq))
        return RowSparseNDArray(summed, uniq, lhs.shape, ctx=lhs._ctx)
    a = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return a + b



def cast_storage(arr, stype):
    """Between dense, row_sparse and csr (the reference's
    ``cast_storage``). Dense to row_sparse copies one ``(rows,)``
    occupancy vector to the host, not the matrix."""
    if stype == arr.stype:
        return arr
    if stype == "default":
        return arr.todense()
    if stype == "row_sparse" and not isinstance(arr, BaseSparseNDArray):
        g = arr._data.detach()
        occ = (g != 0).reshape(g.shape[0], -1).any(dim=1) \
            if g.dim() > 1 else g != 0
        rows = torch.from_numpy(_np.nonzero(occ.cpu().numpy())[0])
        rows = rows.to(g.device)
        return RowSparseNDArray(g.index_select(0, rows), rows, arr.shape,
                                ctx=arr._ctx)
    dense = arr.asnumpy()
    if stype == "row_sparse":
        return _rsp_from_dense(dense, arr._ctx)
    if stype == "csr":
        if dense.ndim != 2:
            raise ValueError("csr requires 2-D")
        return _csr_from_dense(dense, arr._ctx)
    raise ValueError(stype)


def write_rows(rsp, rows, new_vals):
    """Overwrite or insert rows of a RowSparseNDArray in place, keeping
    it sparse (the reference's row_sparse weight update on the server).
    ``rows`` must be unique."""
    dev = rsp._values.device
    wi = rsp._indices.cpu().numpy()
    ri = _np.asarray(rows.cpu() if isinstance(rows, torch.Tensor)
                     else rows, dtype=_np.int64)
    uniq = _np.unique(_np.concatenate([wi, ri]))
    out = torch.zeros((len(uniq),) + tuple(rsp.shape[1:]),
                      dtype=rsp.dtype, device=dev)
    if len(wi):
        out[_tensor(_np.searchsorted(uniq, wi), dev)] = rsp._values
    out[_tensor(_np.searchsorted(uniq, ri), dev)] = _tensor(
        new_vals, dev, rsp.dtype)
    rsp._indices = _tensor(uniq, dev, torch.int64)
    rsp._values = out
    rsp._invalidate()
    return rsp


def retain(rsp, row_ids):
    """``sparse_retain``: the rows ``row_ids`` of ``rsp`` (zeros where it
    stores none), by a sorted search over the stored indices."""
    dev = rsp._values.device
    ids = _tensor(row_ids, dev, torch.int64)
    idx, vals = rsp._indices, rsp._values
    if vals.shape[0] == 0:
        return RowSparseNDArray(
            torch.zeros((ids.shape[0],) + tuple(rsp.shape[1:]),
                        dtype=rsp.dtype, device=dev), ids, rsp.shape,
            ctx=rsp._ctx)
    order = torch.argsort(idx)
    sidx, svals = idx[order], vals[order]
    pos = torch.searchsorted(sidx, ids).clamp(0, sidx.shape[0] - 1)
    hit = sidx[pos] == ids
    picked = svals[pos]
    out = torch.where(hit.reshape((-1,) + (1,) * (picked.dim() - 1)),
                      picked, torch.zeros_like(picked))
    return RowSparseNDArray(out, ids, rsp.shape, ctx=rsp._ctx)
