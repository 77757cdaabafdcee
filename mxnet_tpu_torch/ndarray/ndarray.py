"""Eager NDArray (counterpart of ``mxnet_tpu/ndarray/ndarray.py``).

An ``NDArray`` holds one ``torch.Tensor`` on an explicit device and its
Context. Every op goes through :func:`invoke`, the registry op on the
tensors, recorded for autograd inside ``autograd.record()`` and run
under ``torch.no_grad()`` outside it.

An NDArray is immutable to its ops, as the JAX package's is: ``x += y``
makes a new tensor and rebinds ``x`` to it, and ``x[key] = v`` writes a
copy. A true in-place write on a tensor that a recorded op saved would
break torch's backward (its version counter). The one in-place writer
is the Gluon Trainer, which updates parameter tensors under
``torch.no_grad()``; so a view taken of a parameter (``reshape``,
``transpose``, ``x[...]`` are views where torch makes them) before a
step shows the step, where a JAX array would not.

``array``, ``zeros``, ``ones``, ``full``, ``empty`` and ``arange`` place
their result on ``ctx``, else on ``current_context()``, which is
``cuda:0`` unless a ``with mxnet_tpu_torch.cpu():`` scope says
otherwise; without a card that raises. ``save`` and ``load`` write and
read the ``.params`` format (``serialization.py``).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import normalize_dtype
from ..context import Context, current_context, resolve_device
from .. import autograd as _autograd
from ..ops import registry as _registry

__all__ = ["NDArray", "array", "zeros", "zeros_like", "ones", "full",
           "arange", "empty", "concat", "invoke", "waitall", "save", "load"]

_NARROW = {_np.dtype(_np.int64): "int32", _np.dtype(_np.uint64): "int32",
           _np.dtype(_np.float64): "float32"}


def _ctx_of(t):
    if t.device.type == "cuda":
        return Context("gpu", t.device.index or 0)
    return Context("cpu", 0)


class NDArray:
    """Multi-dimensional, fixed-size array on a device context."""

    __slots__ = ("_data", "_ctx", "_ag", "_version", "__weakref__")

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        self._data = data
        self._ctx = ctx or _ctx_of(data)
        self._ag = None
        self._version = 0

    # ------------------------------------------------------------------ meta
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def data(self):
        """The torch tensor."""
        return self._data

    @property
    def grad(self):
        return None if self._ag is None else self._ag.grad

    # ------------------------------------------------------------ conversion
    def asnumpy(self):
        """A host copy (bfloat16 widened to float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type != "cpu":
            return t.cpu().numpy()
        return t.numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def astype(self, dtype, copy=True):
        if not copy and self.dtype == normalize_dtype(dtype):
            return self
        return invoke("Cast", [self], {"dtype": dtype})

    def copy(self):
        return invoke("_copy", [self], {})

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._rebind(self._data.detach().to(other._data.device,
                                                 other._data.dtype))
            return other
        if isinstance(other, Context):
            return self.as_in_context(other)
        raise TypeError("copyto: expected NDArray or Context")

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return NDArray(self._data.to(resolve_device(context)), ctx=context)

    as_in_ctx = as_in_context

    def tolist(self):
        return self.asnumpy().tolist()

    # ----------------------------------------------------------------- sync
    def wait_to_read(self):
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    # ------------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        _autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._data).detach(),
                             ctx=self._ctx)], grad_req)

    def detach(self):
        return NDArray(self._data.detach(), ctx=self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _autograd.backward([self], [out_grad] if out_grad is not None
                           else None, retain_graph=retain_graph,
                           train_mode=train_mode)

    # ------------------------------------------------------------- mutation
    def _rebind(self, new_data):
        """Point this NDArray at ``new_data``. A marked variable stays a
        leaf of its own (its gradient sink kept), as in the JAX package."""
        if self._ag is not None and self._ag.grad is not None:
            new_data = _autograd._as_leaf(new_data)
        self._data = new_data
        self._version += 1

    def __setitem__(self, key, value):
        v = value._data if isinstance(value, NDArray) else value
        with torch.no_grad():
            if key is None or (isinstance(key, slice)
                               and key == slice(None)):
                new = torch.empty_like(self._data)
                new.copy_(torch.as_tensor(v, dtype=self.dtype,
                                          device=self._data.device)
                          .expand(self.shape))
            else:
                new = self._data.detach().clone()
                new[_norm_index(key)] = torch.as_tensor(
                    v, dtype=self.dtype, device=new.device)
        self._rebind(new)

    def __getitem__(self, key):
        key = _norm_index(key)
        with _autograd.grad_mode():
            out = self._data[key]
        return NDArray(out, ctx=self._ctx)

    def __len__(self):
        return self.shape[0]

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    # ------------------------------------------------------------ operators
    def __add__(self, other):
        return _binary("broadcast_add", "_plus_scalar", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __iadd__(self, other):
        self._rebind(self.__add__(other)._data)
        return self

    def __sub__(self, other):
        return _binary("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _binary_r("broadcast_sub", "_rminus_scalar", self, other)

    def __isub__(self, other):
        self._rebind(self.__sub__(other)._data)
        return self

    def __mul__(self, other):
        return _binary("broadcast_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __imul__(self, other):
        self._rebind(self.__mul__(other)._data)
        return self

    def __truediv__(self, other):
        return _binary("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _binary_r("broadcast_div", "_rdiv_scalar", self, other)

    def __itruediv__(self, other):
        self._rebind(self.__truediv__(other)._data)
        return self

    def __pow__(self, other):
        return _binary("broadcast_power", "_power_scalar", self, other)

    def __rpow__(self, other):
        return _binary_r("broadcast_power", "_rpower_scalar", self, other)

    def __neg__(self):
        return invoke("negative", [self], {})

    def __abs__(self):
        return invoke("abs", [self], {})

    def __eq__(self, other):
        if other is None:
            return False
        return _binary("broadcast_equal", "_equal_scalar", self, other)

    def __ne__(self, other):
        if other is None:
            return True
        return _binary("broadcast_not_equal", "_not_equal_scalar", self,
                       other)

    def __gt__(self, other):
        return _binary("broadcast_greater", "_greater_scalar", self, other)

    def __ge__(self, other):
        return _binary("broadcast_greater_equal", "_greater_equal_scalar",
                       self, other)

    def __lt__(self, other):
        return _binary("broadcast_lesser", "_lesser_scalar", self, other)

    def __le__(self, other):
        return _binary("broadcast_lesser_equal", "_lesser_equal_scalar",
                       self, other)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(s) for s in self.shape),
            self._ctx)

    # ------------------------------------------------ fluent method wrappers
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return invoke("Reshape", [self], {"shape": shape, **kwargs})

    def reshape_like(self, other, **kwargs):
        return invoke("reshape_like", [self, other], kwargs)

    def flatten(self):
        return invoke("Flatten", [self], {})

    def transpose(self, axes=None):
        return invoke("transpose", [self], {"axes": axes})

    @property
    def T(self):
        return self.transpose()

    def swapaxes(self, dim1, dim2):
        return invoke("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def expand_dims(self, axis):
        return invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return invoke("squeeze", [self], {"axis": axis})

    def broadcast_to(self, shape):
        return invoke("broadcast_to", [self], {"shape": shape})

    def broadcast_like(self, other):
        return invoke("broadcast_like", [self, other], {})

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", [self], {"axis": axis, "begin": begin,
                                             "end": end})

    def sum(self, axis=None, keepdims=False):
        return invoke("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return invoke("mean", [self], {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False):
        return invoke("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return invoke("min", [self], {"axis": axis, "keepdims": keepdims})

    def prod(self, axis=None, keepdims=False):
        return invoke("prod", [self], {"axis": axis, "keepdims": keepdims})

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", [self], {"ord": ord, "axis": axis,
                                       "keepdims": keepdims})

    def clip(self, a_min, a_max):
        return invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def abs(self):
        return invoke("abs", [self], {})

    def sqrt(self):
        return invoke("sqrt", [self], {})

    def square(self):
        return invoke("square", [self], {})

    def exp(self):
        return invoke("exp", [self], {})

    def log(self):
        return invoke("log", [self], {})

    def relu(self):
        return invoke("relu", [self], {})

    def sigmoid(self):
        return invoke("sigmoid", [self], {})

    def tanh(self):
        return invoke("tanh", [self], {})

    def softmax(self, axis=-1):
        return invoke("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", [self], {"axis": axis})

    def dot(self, other, **kw):
        return invoke("dot", [self, other], kw)

    def pick(self, index, axis=-1, keepdims=False):
        return invoke("pick", [self, index], {"axis": axis,
                                              "keepdims": keepdims})

    def slice(self, begin, end, step=None):
        return invoke("slice", [self], {"begin": begin, "end": end,
                                        "step": step})

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def one_hot(self, depth, **kw):
        return invoke("one_hot", [self], {"depth": depth, **kw})

    def argmax(self, axis=None, keepdims=False):
        return invoke("argmax", [self], {"axis": axis, "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return invoke("argmin", [self], {"axis": axis, "keepdims": keepdims})

    def argsort(self, axis=-1, is_ascend=True):
        return invoke("argsort", [self], {"axis": axis,
                                          "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return invoke("sort", [self], {"axis": axis, "is_ascend": is_ascend})

    def topk(self, **kw):
        return invoke("topk", [self], kw)

    def sign(self):
        return invoke("sign", [self], {})

    def flip(self, axis):
        return invoke("flip", [self], {"axis": axis})

    def tile(self, reps):
        return invoke("tile", [self], {"reps": reps})

    def repeat(self, repeats, axis=None):
        return invoke("repeat", [self], {"repeats": repeats, "axis": axis})

    def pad(self, **kw):
        return invoke("pad", [self], kw)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("split", [self], {"num_outputs": num_outputs,
                                        "axis": axis,
                                        "squeeze_axis": squeeze_axis})

    def tostype(self, stype):
        if stype == "default":
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)


def _binary(op_name, scalar_op, lhs, rhs):
    if isinstance(rhs, NDArray):
        return invoke(op_name, [lhs, rhs], {})
    return invoke(scalar_op, [lhs], {"scalar": float(rhs)})


def _binary_r(op_name, rscalar_op, lhs, rhs):
    """rhs OP lhs, rhs a scalar or an NDArray (the reflected operators)."""
    if isinstance(rhs, NDArray):
        return invoke(op_name, [rhs, lhs], {})
    return invoke(rscalar_op, [lhs], {"scalar": float(rhs)})


def _norm_index(key):
    if isinstance(key, NDArray):
        return key._data.long()
    if isinstance(key, tuple):
        return tuple(_norm_index(k) for k in key)
    return key


# ---------------------------------------------------------------------------
# op invocation
# ---------------------------------------------------------------------------

def _recorded(tensors):
    """Whether autograd records this call: recording, and a floating
    input that a gradient reaches."""
    return _autograd.is_recording() and any(
        t.requires_grad and t.is_floating_point() for t in tensors)


def invoke(op_name, inputs, params, out=None):
    """Run registry op ``op_name`` on the NDArrays ``inputs``: recorded
    inside ``autograd.record()``, else under ``torch.no_grad()``. An
    op's hidden aux outputs (BatchNorm's moving statistics, in training)
    rebind its aux inputs; only the visible outputs are returned."""
    op = _registry.get(op_name)
    params = {k: v for k, v in params.items()
              if v is not None or k == "axis"}
    req_ctx = params.pop("ctx", None)
    tensors = [x._data if isinstance(x, NDArray) else torch.as_tensor(x)
               for x in inputs]
    if "_training" in op.param_names and "_training" not in params:
        params["_training"] = _autograd.is_training()
    if "ctx" in op.param_names:
        params["ctx"] = resolve_device(req_ctx)
    with _autograd.grad_mode():
        if op.is_random and _recorded(tensors):
            # as the JAX package records a random op: one key from the
            # chain, which the op's draws fold (site 0, 1, ...)
            from .. import random as _random
            with _random.trace_scope(_random.next_key()):
                out_data = op.fn(*tensors, **params)
        else:
            out_data = op.fn(*tensors, **params)
    outs = out_data if isinstance(out_data, tuple) else (out_data,)
    if isinstance(req_ctx, Context):
        ctx = req_ctx
    elif inputs and isinstance(inputs[0], NDArray):
        ctx = inputs[0]._ctx
    else:
        ctx = _ctx_of(outs[0])
    if op.aux_outputs:
        if params.get("_training", True):
            for i, o in zip(op.aux_inputs, op.aux_outputs):
                if i < len(inputs) and isinstance(inputs[i], NDArray):
                    inputs[i]._rebind(outs[o].detach())
        outs = outs[:op.resolve_num_visible_outputs(params)]
    out_nds = [NDArray(d, ctx=ctx) for d in outs]
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, o in zip(targets, out_nds):
            t._rebind(o._data)
        return out
    return out_nds[0] if len(out_nds) == 1 else tuple(out_nds)


def imperative_invoke(op_name, *inputs, out=None, **params):
    """:func:`invoke` with the inputs as arguments and the
    hyper-parameters as keywords."""
    return invoke(op_name, list(inputs), params, out=out)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def _dtype_of(src, dtype):
    if dtype is not None:
        return normalize_dtype(dtype)
    return normalize_dtype(_NARROW.get(src.dtype, src.dtype.name))


def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (default ``current_context()``) from an
    NDArray, numpy array, tensor or nested list. A list defaults to
    float32; 64-bit numpy data narrows to 32 bits, as in the JAX
    package."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data.detach()
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach()
        dt = normalize_dtype(dtype) or t.dtype
    else:
        src = _np.asarray(source_array)
        if dtype is None and not isinstance(source_array, _np.ndarray):
            dtype = "float32"
        dt = _dtype_of(src, dtype)
        t = torch.from_numpy(_np.ascontiguousarray(src))
    ctx = ctx or current_context()
    return NDArray(t.to(device=resolve_device(ctx), dtype=dt, copy=True),
                   ctx=ctx)


def _creation(op, shape, ctx, dtype, **kw):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    ctx = ctx or current_context()
    return invoke(op, [], dict(shape=shape, dtype=dtype or "float32",
                               ctx=ctx, **kw))


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _creation("_zeros", shape, ctx, dtype)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _creation("_ones", shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=None):
    return _creation("_full", shape, ctx, dtype, value=val)


def zeros_like(other):
    return NDArray(torch.zeros_like(other._data).detach(), ctx=other.context)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return invoke("_arange", [], {"start": start, "stop": stop,
                                  "step": step, "repeat": repeat,
                                  "dtype": dtype or "float32", "ctx": ctx})


def concat(*data, dim=1):
    return invoke("Concat", list(data), {"dim": dim})


def waitall():
    """Wait for every queued kernel of this process."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def asnumpy_all(*arrays):
    """Several arrays (NDArrays, tensors) to the host in one wait: the
    card's queue is drained once, then each is copied. Values already on
    the host (numpy, scalars) pass through."""
    ts = [a._data if isinstance(a, NDArray) else a for a in arrays]
    if any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
           for t in ts):
        torch.cuda.synchronize()
    out = []
    for t in ts:
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            t = t.cpu().numpy().copy() if t.device.type == "cpu" \
                else t.cpu().numpy()
        out.append(_np.asarray(t))
    return tuple(out)


def _to_record(a):
    """An NDArray as a record for the file: a host numpy array, or the
    sparse tuple forms of ``serialization.save_array``; a dtype outside
    the mshadow table (bfloat16, bool, ...) raises as the format does."""
    from .serialization import _to_flag
    if a.stype == "row_sparse":
        return ("row_sparse", a.data.asnumpy(), a.indices.asnumpy(),
                a.shape)
    if a.stype == "csr":
        return ("csr", a.data.asnumpy(), a.indptr.asnumpy(),
                a.indices.asnumpy(), a.shape)
    name = str(a.dtype).replace("torch.", "")
    if a.dtype in (torch.bfloat16, torch.bool):
        _to_flag(name)
    return a.asnumpy()


def save(fname, data):
    """Write NDArrays (one, a list, or a name -> NDArray dict) in the
    ``.params`` format (``serialization.py``), the JAX package's and
    MXNet's bytes; row_sparse and csr arrays keep their storage."""
    from . import serialization as _ser
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        keys = list(data.keys())
        arrays = [data[k] for k in keys]
    else:
        keys = []
        arrays = list(data)
    _ser.save_file(fname, [_to_record(a) for a in arrays], keys)


def _from_record(rec, ctx):
    if isinstance(rec, _np.ndarray):
        return array(rec, ctx=ctx, dtype=_dtype_of(rec, None))
    from . import sparse as _sp
    if rec[0] == "row_sparse":
        _, data, indices, shape = rec
        return _sp.row_sparse_array((data, indices), shape=shape, ctx=ctx)
    _, data, indptr, indices, shape = rec
    return _sp.csr_matrix((data, indices, indptr), shape=shape, ctx=ctx)


def load(fname, ctx=None):
    """Read a ``.params`` file: a list of NDArrays, or a name -> NDArray
    dict when the file names its arrays. Dense, row_sparse and csr
    records load. They land on ``ctx`` (default ``current_context()``);
    64-bit data narrows to 32 bits as :func:`array` narrows it."""
    from . import serialization as _ser
    arrays, names = _ser.load_file(fname)
    out = [_from_record(rec, ctx) for rec in arrays]
    if not names:
        return out
    return dict(zip(names, out))
