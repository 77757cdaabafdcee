"""Gluon Parameter, Constant and ParameterDict (counterpart of
``mxnet_tpu/gluon/parameter.py``).

A Parameter owns one NDArray on one device and, unless its ``grad_req``
is 'null', a gradient NDArray marked into autograd
(``autograd.mark_variables``): its tensor is a torch leaf that
``backward`` differentiates. A shape with 0 entries is completed at the
first forward (deferred initialization): each layer's
``_layer_infer_shape`` fills it from its input's shape as the forward
reaches the layer. Initializers are the port's (``initializer.py``),
which draw from their own ``torch.Generator``, not numpy's global state
as the JAX package's do, so a test that compares the two packages
carries the weights across (``gluon.utils.params_from_reference``).
``_keep_f32`` exempts a parameter from the compute-dtype downcast of a
hybridized call (BatchNorm's affine parameters and statistics).
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..base import MXNetError, dtype_name, normalize_dtype
from ..context import Context, current_context
from .. import autograd as _autograd
from .. import initializer as _init
from ..ndarray import ndarray as _nd

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its deferred shape inference completed."""


class Parameter:
    """A trainable weight tracked by Blocks and the Trainer."""

    _keep_f32 = False

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = normalize_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._stype = stype
        self._grad_stype = grad_stype
        self._data = None
        self._grad = None
        self._deferred_init = None   # (init, default_init, ctx list)
        self._trainer = None

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self._shape, dtype_name(self.dtype))

    # ------------------------------------------------------------------ meta
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        if len(self._shape) != len(new_shape) or not all(
                s == 0 or s == n for s, n in zip(self._shape, new_shape)):
            raise MXNetError("Expected shape %s is incompatible with given "
                             "shape %s" % (self._shape, tuple(new_shape)))
        self._shape = tuple(new_shape)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
            if self._data is not None:
                self._data._ag = None
                self._data._data = self._data._data.detach()
        elif self._data is not None:
            self._init_grad()

    @property
    def stype(self):
        return self._stype

    @property
    def grad_stype(self):
        return self._grad_stype

    # ------------------------------------------------------------------ init
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if self._data is not None and not force_reinit:
            return
        if default_init is None:
            default_init = _init.Uniform()
        if ctx is None:
            ctx = current_context()
        ctx = [ctx] if isinstance(ctx, Context) else list(ctx)
        if len(set(ctx)) > 1:
            raise MXNetError("Parameter %s: one device per Parameter in the "
                             "port; data parallelism over several is ROADMAP "
                             "A6" % self.name)
        own_init = init or self.init
        if self._shape is None or any(s == 0 for s in self._shape):
            if self.allow_deferred_init:
                self._deferred_init = (own_init, default_init, ctx)
                return
            raise ValueError("Cannot initialize Parameter '%s' because it "
                             "has invalid shape: %s." % (self.name,
                                                         self._shape))
        self._finish_init(own_init, default_init, ctx)

    def _finish_init(self, own_init, default_init, ctx):
        self._ctx_list = list(ctx)
        arr = _nd.zeros(self._shape, dtype=self.dtype, ctx=ctx[0])
        desc = _init.InitDesc(self.name)
        if own_init is not None:
            # a parameter's own init bypasses the name-suffix dispatch
            own = _init.create(own_init)
            desc.global_init = own
            own._init_weight(desc, arr._data)
        else:
            dflt = _init.create(default_init)
            desc.global_init = dflt
            dflt(desc, arr._data)
        self._data = arr
        self._deferred_init = None
        if self._grad_req != "null":
            self._init_grad()

    def _finish_deferred_init(self, shape):
        """Complete a deferred init once the forward reveals the shape."""
        self.shape = shape
        if self._deferred_init is None:
            return
        own_init, default_init, ctx = self._deferred_init
        self._finish_init(own_init, default_init, ctx)

    def _init_grad(self):
        self._grad = _nd.zeros_like(self._data)
        _autograd.mark_variables([self._data], [self._grad],
                                 self._grad_req)

    # ------------------------------------------------------------------ data
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass." % self.name)
        raise RuntimeError(
            "Parameter '%s' has not been initialized. Note that you should "
            "initialize parameters and create Trainer with "
            "Block.collect_params() instead of Block.params" % self.name)

    def data(self, ctx=None):
        self._check_initialized()
        return self._data

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        if self._grad_req == "null":
            raise RuntimeError("Cannot get gradient array for Parameter '%s' "
                               "because grad_req='null'" % self.name)
        self._check_initialized()
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._data is None and self._deferred_init is not None:
            return list(self._deferred_init[2])
        self._check_initialized()
        return [self._data.context]

    def set_data(self, data):
        """Set the value: copied in place into the existing tensor when
        one of the same shape exists (the tensor stays the same object),
        else placed on the parameter's device."""
        if self._data is not None:
            ctx = self._data.context
        elif self._deferred_init is not None:
            ctx = self._deferred_init[2][0]
        else:
            ctx = data.context if isinstance(data, _nd.NDArray) \
                else current_context()
        if not isinstance(data, _nd.NDArray):
            data = _nd.array(data, ctx=ctx)
        if self._shape is not None and not any(s == 0 for s in self._shape):
            if tuple(data.shape) != tuple(self._shape):
                raise MXNetError("set_data: shape %s != parameter shape %s"
                                 % (data.shape, self._shape))
        else:
            self._shape = tuple(data.shape)
        if self._data is None:
            self._data = _nd.NDArray(
                data._data.detach().to(ctx.torch_device, self.dtype,
                                       copy=True), ctx=ctx)
            self._ctx_list = [ctx]
            self._deferred_init = None
            if self._grad_req != "null":
                self._init_grad()
            return
        with torch.no_grad():
            self._data._data.copy_(data._data)
        self._data._version += 1

    def zero_grad(self):
        if self._grad is not None:
            with torch.no_grad():
                self._grad._data.zero_()

    def cast(self, dtype):
        self.dtype = normalize_dtype(dtype)
        if self._data is None:
            return
        self._data = _nd.NDArray(self._data._data.detach().to(self.dtype),
                                 ctx=self._data.context)
        if self._grad_req != "null":
            self._init_grad()

    def var(self):
        """Symbol variable for this parameter (symbolic export path)."""
        from .. import symbol as _sym
        return _sym.Variable(self.name, shape=self._shape,
                             dtype=dtype_name(self.dtype))


def _merge_shapes(existing, given):
    """A shared parameter's shape from its existing one and a new
    request, 0 unknown on either side (upstream MXNet's rule: a tied
    ``Dense(params=embedding.params)`` asks for (vocab, 0) of a known
    (vocab, dim) weight; the JAX package refuses that request)."""
    if existing is None or len(existing) != len(given):
        return given
    # a clash of two known sizes is left for the shape setter to refuse
    return tuple(s if n == 0 else n for s, n in zip(existing, given))


class Constant(Parameter):
    """Non-differentiable parameter with a fixed value."""

    def __init__(self, name, value):
        if not isinstance(value, _nd.NDArray):
            value = _nd.array(value, ctx=Context("cpu"))
        self.value = value

        class _CInit(_init.Initializer):
            def _init_weight(self2, _, arr):
                self2._set(arr, value._data)

            __call__ = _init_weight
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_CInit())


class ParameterDict:
    """Prefix-scoped dict of Parameters."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        return "%s(\n%s\n)" % (
            type(self).__name__,
            "\n".join("  " + repr(p) for p in self._params.values()))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """Get or create a Parameter named ``prefix + name``."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if v is None:
                continue
            if k == "shape":
                param.shape = _merge_shapes(param.shape, v)
            elif k == "dtype":
                param.dtype = normalize_dtype(v)
            elif k == "init" and param.init is None:
                param.init = v
            elif k in ("grad_req", "lr_mult", "wd_mult",
                       "allow_deferred_init"):
                setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError("No constant named '%s'." % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    "Cannot update self with other because they have "
                    "different Parameters with the same name '%s'" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = _init.Uniform()
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for _, v in self.items():
            v.zero_grad()

    def setattr(self, name, value):
        for _, v in self.items():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Write every parameter to a ``.params`` file under its full
        name less ``strip_prefix``."""
        arg_dict = {}
        for param in self.values():
            weight = param.data()
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be stripped before saving, but "
                    "Parameter's name '%s' does not start with it"
                    % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = weight
        _nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set parameters from a ``.params`` file (an ``arg:``/``aux:``
        tag before a name is dropped; ``restore_prefix`` goes before
        it). A parameter keeps its device; one not yet allocated lands on
        ``ctx`` (default ``current_context()``)."""
        from ..context import cpu
        arg_dict = _nd.load(filename, ctx=cpu())
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise IOError("Parameter '%s' is missing in file '%s'"
                                  % (name, filename))
        for name, arr in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in ParameterDict" % (name, filename))
                continue
            _set_loaded(self[name], arr, ctx)


def _set_loaded(param, arr, ctx):
    """Set a value read from a file: a parameter keeps its device; one
    not yet allocated lands on ``ctx`` (the first of a list; default
    ``current_context()``)."""
    if param._data is None and param._deferred_init is None:
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        arr = arr.as_in_context(ctx or current_context())
    param.set_data(arr)
