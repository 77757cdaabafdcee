"""The binary ``.params`` format (counterpart of
``mxnet_tpu/ndarray/serialization.py``, whose bytes it writes and reads
unchanged; numpy only).

MXNet's versioned NDArray list format (src/ndarray/ndarray.cc:1583-1795):

file container  : uint64 magic 0x112, uint64 reserved, then the dmlc
                  vector encodings — uint64 count + per-array payloads,
                  uint64 count + (uint64 len + bytes) per name.
per-array (V2)  : uint32 0xF993fac9; int32 storage type; [sparse only:
                  storage shape]; shape; int32 dev_type + int32 dev_id;
                  int32 mshadow type flag; [sparse only: per-aux int32
                  type flag + shape]; raw data bytes; [aux data bytes].
shapes          : uint32 ndim + int64 * ndim (nnvm::TShape wire form).
legacy (V1/V0)  : magic 0xF993fac8 (shape follows) or a raw uint32 ndim
                  with uint32 dims — both read, never written.

A file written by either package loads in the other, and in MXNet.
Arrays are written from and read to host numpy arrays whatever device
they came from (every record says ``kCPU, 0``); the caller places them.
Sparse records round-trip here as tuples, which the NDArray layer turns
into ``sparse.RowSparseNDArray`` and ``sparse.CSRNDArray``.
"""
import struct

import numpy as _np

from ..base import MXNetError

NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
LIST_MAGIC = 0x112

# mshadow type flags (mshadow/base.h)
_TYPE_FLAGS = [
    (_np.dtype(_np.float32), 0),
    (_np.dtype(_np.float64), 1),
    (_np.dtype(_np.float16), 2),
    (_np.dtype(_np.uint8), 3),
    (_np.dtype(_np.int32), 4),
    (_np.dtype(_np.int8), 5),
    (_np.dtype(_np.int64), 6),
]
_DTYPE_TO_FLAG = {d: f for d, f in _TYPE_FLAGS}
_FLAG_TO_DTYPE = {f: d for d, f in _TYPE_FLAGS}

# NDArrayStorageType (include/mxnet/ndarray.h)
_STYPE_DEFAULT = 1
_STYPE_ROW_SPARSE = 2
_STYPE_CSR = 3
_STYPE_NAMES = {_STYPE_DEFAULT: "default", _STYPE_ROW_SPARSE: "row_sparse",
                _STYPE_CSR: "csr"}
_NUM_AUX = {_STYPE_DEFAULT: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}


def _write_shape(out, shape):
    out += struct.pack("<I", len(shape))
    out += struct.pack("<%dq" % len(shape), *shape)


def _read(f, n):
    data = f.read(n)
    if len(data) != n:
        raise MXNetError("truncated NDArray file")
    return data


def _read_shape(f):
    (ndim,) = struct.unpack("<I", _read(f, 4))
    return struct.unpack("<%dq" % ndim, _read(f, 8 * ndim)) if ndim else ()


def _to_flag(dtype):
    """The mshadow flag of a numpy dtype (or a dtype name); raises for a
    dtype the table lacks, bfloat16 among them."""
    try:
        dtype = _np.dtype(dtype)
    except TypeError:
        raise MXNetError("dtype %s has no mshadow type flag (the reference "
                         "format cannot represent it)" % dtype) from None
    if dtype not in _DTYPE_TO_FLAG:
        raise MXNetError("dtype %s has no mshadow type flag (the reference "
                         "format cannot represent it)" % dtype)
    return _DTYPE_TO_FLAG[dtype]


def save_array(out, arr):
    """Append one array's V2 record to bytearray ``out``.

    ``arr``: numpy array (dense), or tuple ("row_sparse", data, indices,
    shape) / ("csr", data, indptr, indices, shape).
    """
    out += struct.pack("<I", NDARRAY_V2_MAGIC)
    if isinstance(arr, _np.ndarray):
        if arr.ndim == 0:
            # reference-lineage MXNet has no 0-d arrays; an ndim-0 shape on
            # the wire means "none" and carries no payload, so scalars are
            # projected to shape (1,)
            arr = arr.reshape(1)
        out += struct.pack("<i", _STYPE_DEFAULT)
        _write_shape(out, arr.shape)
        out += struct.pack("<ii", 1, 0)  # Context: kCPU=1, dev_id 0
        out += struct.pack("<i", _to_flag(arr.dtype))
        out += _np.ascontiguousarray(arr).tobytes()
        return

    kind = arr[0]
    if kind == "row_sparse":
        _, data, indices, shape = arr
        out += struct.pack("<i", _STYPE_ROW_SPARSE)
        _write_shape(out, data.shape)        # storage shape
        _write_shape(out, shape)             # logical shape
        out += struct.pack("<ii", 1, 0)
        out += struct.pack("<i", _to_flag(data.dtype))
        out += struct.pack("<i", _to_flag(indices.dtype))
        _write_shape(out, indices.shape)
        out += _np.ascontiguousarray(data).tobytes()
        out += _np.ascontiguousarray(indices).tobytes()
    elif kind == "csr":
        _, data, indptr, indices, shape = arr
        out += struct.pack("<i", _STYPE_CSR)
        _write_shape(out, data.shape)
        _write_shape(out, shape)
        out += struct.pack("<ii", 1, 0)
        out += struct.pack("<i", _to_flag(data.dtype))
        # aux order: indptr then indices (ndarray.h kIndPtr=0, kIdx=1)
        out += struct.pack("<i", _to_flag(indptr.dtype))
        _write_shape(out, indptr.shape)
        out += struct.pack("<i", _to_flag(indices.dtype))
        _write_shape(out, indices.shape)
        out += _np.ascontiguousarray(data).tobytes()
        out += _np.ascontiguousarray(indptr).tobytes()
        out += _np.ascontiguousarray(indices).tobytes()
    else:
        raise MXNetError("unknown array record kind %r" % (kind,))


def _read_dense_payload(f, shape):
    (_dev_type, _dev_id) = struct.unpack("<ii", _read(f, 8))
    (flag,) = struct.unpack("<i", _read(f, 4))
    dtype = _FLAG_TO_DTYPE[flag]
    n = int(_np.prod(shape)) if shape else 1
    data = _np.frombuffer(_read(f, dtype.itemsize * n), dtype=dtype)
    return data.reshape(shape).copy()


def load_array(f):
    """Read one array record. Returns numpy (dense) or the tuple forms of
    :func:`save_array` (sparse)."""
    (magic,) = struct.unpack("<I", _read(f, 4))
    if magic != NDARRAY_V2_MAGIC:
        # V1: magic then TShape; V0: the magic IS ndim, dims are uint32
        if magic == NDARRAY_V1_MAGIC:
            shape = _read_shape(f)
        else:
            ndim = magic
            if ndim > 8:  # not a plausible legacy record
                raise MXNetError("invalid NDArray record magic 0x%x" % magic)
            shape = struct.unpack("<%dI" % ndim, _read(f, 4 * ndim))
        if not shape:
            return _np.zeros((), _np.float32)
        return _read_dense_payload(f, shape)

    (stype,) = struct.unpack("<i", _read(f, 4))
    if stype not in _NUM_AUX:
        raise MXNetError("unknown storage type %d" % stype)
    nad = _NUM_AUX[stype]
    sshape = _read_shape(f) if nad else None
    shape = _read_shape(f)
    if not shape:
        return _np.zeros((), _np.float32)
    if nad == 0:
        return _read_dense_payload(f, shape)

    (_dev_type, _dev_id) = struct.unpack("<ii", _read(f, 8))
    (flag,) = struct.unpack("<i", _read(f, 4))
    dtype = _FLAG_TO_DTYPE[flag]
    aux = []
    for _ in range(nad):
        (aflag,) = struct.unpack("<i", _read(f, 4))
        ashape = _read_shape(f)
        aux.append((_FLAG_TO_DTYPE[aflag], ashape))
    n = int(_np.prod(sshape)) if sshape else 0
    data = _np.frombuffer(_read(f, dtype.itemsize * n),
                          dtype=dtype).reshape(sshape).copy()
    aux_data = []
    for adtype, ashape in aux:
        an = int(_np.prod(ashape)) if ashape else 0
        aux_data.append(_np.frombuffer(
            _read(f, adtype.itemsize * an), dtype=adtype)
            .reshape(ashape).copy())
    if stype == _STYPE_ROW_SPARSE:
        return ("row_sparse", data, aux_data[0], shape)
    return ("csr", data, aux_data[0], aux_data[1], shape)


def save_file(fname, arrays, names):
    """Write the list container (reference NDArray::Save, ndarray.cc:1785)."""
    out = bytearray()
    out += struct.pack("<QQ", LIST_MAGIC, 0)
    out += struct.pack("<Q", len(arrays))
    for a in arrays:
        save_array(out, a)
    out += struct.pack("<Q", len(names))
    for name in names:
        raw = name.encode("utf-8")
        out += struct.pack("<Q", len(raw))
        out += raw
    with open(fname, "wb") as f:
        f.write(out)


def load_file(fname):
    """Read the list container -> (arrays, names)."""
    with open(fname, "rb") as f:
        magic, _reserved = struct.unpack("<QQ", _read(f, 16))
        if magic != LIST_MAGIC:
            raise MXNetError("%s is not an NDArray list file "
                             "(magic 0x%x)" % (fname, magic))
        (count,) = struct.unpack("<Q", _read(f, 8))
        arrays = [load_array(f) for _ in range(count)]
        (n_names,) = struct.unpack("<Q", _read(f, 8))
        names = []
        for _ in range(n_names):
            (ln,) = struct.unpack("<Q", _read(f, 8))
            names.append(_read(f, ln).decode("utf-8"))
    return arrays, names
