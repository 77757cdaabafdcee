"""Gluon Block and HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

``hybrid_forward(F, x, *args, **params)`` is called with one of three
``F`` namespaces:

* eager (an un-hybridized call on NDArrays): ``F`` is
  ``mxnet_tpu_torch.ndarray``, one :func:`ndarray.invoke` per op;
* hybridized (after ``hybridize()``, on NDArrays): the whole forward,
  children included, runs once on raw tensors with ``F`` a namespace of
  registry functions, with no NDArray wrapper per op (the counterpart of
  the JAX package's traced ``_F_JAX``). Each call draws one key from
  the random chain, which its random ops fold (``random.trace_scope``),
  as the JAX package feeds one to its program. Parameters are bound from the
  call's trace context; BatchNorm's moving statistics are written back
  after the call (``_apply_aux``). Under ``config.compute_dtype`` the
  float32 parameters and inputs are cast to the compute dtype inside the
  call, except those marked ``_keep_f32``. torch records the ops for
  ``autograd`` inside ``record()``; there is no compile step, and no
  ``torch.compile``. Each input signature (shapes, dtypes, training
  mode, compute dtype, kernel tier) is recorded in ``_cached_graph``,
  as the JAX package keys its programs, though no program is kept per
  entry; ``static_alloc`` and the other ``hybridize`` keywords are
  taken and ignored, as there;
* symbolic (a ``Symbol`` input): ``F`` is ``mxnet_tpu_torch.symbol``, and
  the parameters are their ``var()``s, so the Symbol's JSON is the JAX
  package's.

Deferred shapes are completed layer by layer: each layer's
``_layer_infer_shape`` fills its parameters' shapes from its input as
the forward reaches it, and the parameter is allocated there. No probe
forward runs (the JAX package's ``jax.eval_shape`` has no cost; a
forward here would). ``save_parameters``, ``load_parameters`` and
``export`` write and read the ``.params`` format, the JAX package's
bytes.
"""
from __future__ import annotations

import re
import threading

import torch

from ..base import MXNetError
from .. import autograd as _autograd
from .. import random as _random
from ..ndarray import ndarray as _nd
from ..ops import registry as _registry
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


# ---------------------------------------------------------------------------
# Name scoping
# ---------------------------------------------------------------------------

class _BlockScope:
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """The prefix and params of a new Block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name_manager().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *a):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class _NameManager:
    """Per-process counters of top-level block names (``gpt0_``,
    ``gpt1_``, ...)."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name is not None:
            return name
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return "%s%d" % (hint, count)


_global_name_manager = _NameManager()


def _name_manager():
    return _global_name_manager


# ---------------------------------------------------------------------------
# The hybridized call's context and F namespace
# ---------------------------------------------------------------------------

class _TraceCtx:
    """One hybridized call: the parameters bound so far (full name ->
    tensor, cast to the compute dtype where it applies), and the aux
    updates its ops produced."""

    __slots__ = ("bound", "owner", "aux_updates", "training", "cdt")

    def __init__(self, training, cdt):
        self.bound = {}
        self.owner = {}            # id(bound tensor) -> Parameter
        self.aux_updates = {}      # Parameter name -> (Parameter, tensor)
        self.training = training
        self.cdt = cdt

    def bind(self, param):
        t = self.bound.get(param.name)
        if t is None:
            t = param.data()._data
            if self.cdt is not None and t.dtype == torch.float32 \
                    and not param._keep_f32 and t.numel():
                t = t.to(self.cdt)
            self.bound[param.name] = t
            self.owner[id(t)] = param
        return t


_trace_state = threading.local()


def _current_trace():
    return getattr(_trace_state, "ctx", None)


class _trace_scope:
    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        self.prev = getattr(_trace_state, "ctx", None)
        _trace_state.ctx = self.ctx
        return self.ctx

    def __exit__(self, *a):
        _trace_state.ctx = self.prev


class _TorchF:
    """Registry ops on raw tensors (the hybridized ``F``). ``F.contrib.X``
    is the op ``_contrib_X``. An op's aux updates are collected into the
    active trace context instead of rebinding arrays."""

    def __init__(self, prefix=""):
        self._prefix = prefix

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        if name == "contrib" and not self._prefix:
            sub = _TorchF("_contrib_")
            self.__dict__[name] = sub
            return sub
        try:
            op = _registry.get(self._prefix + name)
        except KeyError:
            raise AttributeError(self._prefix + name) from None
        fn = _torch_op_fn(op)
        fn.__name__ = name
        self.__dict__[name] = fn
        return fn

    def __repr__(self):
        return "<hybridized F (torch)%s>" % (" contrib" if self._prefix
                                             else "")


def _torch_op_fn(op):
    wants_training = "_training" in op.param_names

    def fn(*args, name=None, **kwargs):
        arrs = [a for a in args if a is not None]
        kwargs.pop("ctx", None)
        params = {k: v for k, v in kwargs.items() if v is not None}
        tctx = _current_trace()
        training = tctx.training if tctx is not None \
            else _autograd.is_training()
        if wants_training and "_training" not in params:
            params["_training"] = training
        out = op.fn(*arrs, **params)
        if not op.aux_outputs:
            return out
        outs = out if isinstance(out, tuple) else (out,)
        if training and tctx is not None:
            for i, o in zip(op.aux_inputs, op.aux_outputs):
                if i < len(arrs):
                    p = tctx.owner.get(id(arrs[i]))
                    if p is not None:
                        tctx.aux_updates[p.name] = (p, outs[o])
        outs = outs[:op.resolve_num_visible_outputs(params)]
        return outs[0] if len(outs) == 1 else outs
    return fn


_F_TORCH = _TorchF()


def _apply_aux(aux_updates):
    """Write a call's aux updates (BatchNorm's moving statistics) into
    their Parameters."""
    for p, val in aux_updates.values():
        if p._data is not None:
            p._data._rebind(val.detach().to(p._data.dtype))


def _flatten(obj, leaves):
    """Leaves of a nest of lists/tuples, and its structure."""
    if isinstance(obj, (list, tuple)):
        return (type(obj), tuple(_flatten(o, leaves) for o in obj))
    leaves.append(obj)
    return None


def _unflatten(tree, it):
    if tree is None:
        return next(it)
    kind, kids = tree
    return kind(_unflatten(k, it) for k in kids)


def _wrap(obj):
    """Tensors in a nest of lists/tuples as NDArrays."""
    if isinstance(obj, torch.Tensor):
        return _nd.NDArray(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_wrap(o) for o in obj)
    return obj


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block:
    """Base class for all neural network layers and models."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = []
        self._forward_pre_hooks = []

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        if not self._children:
            return "%s()" % type(self).__name__
        modstr = "\n".join("  (%s): %s" % (key, _indent(repr(block), 2))
                           for key, block in self._children.items())
        return "%s(\n%s\n)" % (type(self).__name__, modstr)

    def __setattr__(self, name, value):
        if not name.startswith("_"):
            existing = self.__dict__.get(name)
            if isinstance(value, Block):
                if existing is not None and not isinstance(existing, Block):
                    raise TypeError(
                        "Changing attribute type for %s from %s to Block is "
                        "not allowed." % (name, type(existing)))
                self.register_child(value, name)
            elif isinstance(value, Parameter):
                if name in self._reg_params \
                        and self._reg_params[name] is not value:
                    raise MXNetError("Overriding Parameter attribute %s is "
                                     "not allowed." % name)
                self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """All Parameters of this block and its children, regex-filtered
        by ``select``."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)
        return hook

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)
        return hook

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            from .. import initializer
            init = initializer.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for param in self._reg_params.values():
            param.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def save_parameters(self, filename):
        """Write this block's parameters to a ``.params`` file under
        their structural names (``features.0.weight``), the JAX
        package's bytes."""
        params = self._collect_params_with_prefix()
        _nd.save(filename, {key: val.data() for key, val in params.items()
                            if val._data is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Set this block's parameters from a ``.params`` file: one of
        structural names (``save_parameters``) or of full names
        (``ParameterDict.save``, ``export``). Values take each
        parameter's dtype (``cast_dtype`` changes nothing, as in the JAX
        package); a parameter keeps its device, and one not yet
        allocated lands on ``ctx`` (default ``current_context()``)."""
        from ..context import cpu
        loaded = _nd.load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if loaded and not any("." in k for k in loaded.keys()):
            # full names: restore the prefix only if the file's names
            # were stripped of it
            stripped = not any(k.split(":", 1)[-1].startswith(self.prefix)
                               for k in loaded.keys()) if self.prefix \
                else False
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra,
                                       self.prefix if stripped else "")
            return
        if not allow_missing:
            for name in params.keys():
                if name not in loaded:
                    raise IOError("Parameter '%s' is missing in file '%s'"
                                  % (name, filename))
        from .parameter import _set_loaded
        for name in loaded:
            if name not in params:
                if not ignore_extra:
                    raise IOError(
                        "Parameter '%s' loaded from '%s' is not present in "
                        "the Block" % (name, filename))
                continue
            _set_loaded(params[name], loaded[name], ctx)

    save_params = save_parameters
    load_params = load_parameters

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def __call__(self, *args):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Run ``inputs`` through the block and print (and return) one
        row per block called: name, type, output shapes and the count
        of its own parameters, then the total."""
        rows = []
        registered = []

        def _register(blk):
            def hook(block, ins, outs):
                outs_ = outs if isinstance(outs, (list, tuple)) else [outs]
                n_params = 0
                for p in block._reg_params.values():
                    if p.shape is not None:
                        n = 1
                        for d in p.shape:
                            n *= int(d)
                        n_params += n
                rows.append((block.name, type(block).__name__,
                             [tuple(o.shape) for o in outs_
                              if hasattr(o, "shape")], n_params))
            blk._forward_hooks.append(hook)
            registered.append((blk, hook))
        self.apply(_register)
        try:
            self(*inputs)
        finally:
            for blk, hook in registered:
                blk._forward_hooks.remove(hook)
        lines = ["%-30s %-20s %-28s %10s" % ("Layer", "Type", "Output Shape",
                                             "Params")]
        total = 0
        for name, typ, shapes, n in rows:
            total += n
            lines.append("%-30s %-20s %-28s %10d"
                         % (name, typ, ",".join(map(str, shapes)), n))
        lines.append("Total params: %d" % total)
        text = "\n".join(lines)
        print(text)
        return text


def _indent(s, num_spaces):
    lines = s.split("\n")
    if len(lines) == 1:
        return s
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line
                                    for line in lines)


# ---------------------------------------------------------------------------
# HybridBlock
# ---------------------------------------------------------------------------

class HybridBlock(Block):
    """A Block with a ``hybrid_forward(F, x, *args, **params)``, run
    eagerly, hybridized or symbolically (see the module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_graph = set()
        self._flags = {}

    def hybridize(self, active=True, **kwargs):
        self._active = active
        self._flags = kwargs
        self._cached_graph = set()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._cached_graph = set()
        super().cast(dtype)

    # ------------------------------------------------- deferred shape infer
    def _layer_infer_shape(self, *args):
        """Complete this layer's own deferred parameter shapes from its
        input shapes. Library layers override; the default serves blocks
        whose own parameters never defer (containers, user models)."""
        deferred = [p.name for p in self._reg_params.values()
                    if p._deferred_init is not None]
        if deferred:
            raise DeferredInitializationError(
                "%s cannot infer shapes of %s; override _layer_infer_shape "
                "or initialize with explicit shapes." % (self.name,
                                                         deferred))

    def _maybe_infer_shape(self, *args):
        if any(p._deferred_init is not None
               for p in self._reg_params.values()):
            self._layer_infer_shape(*[tuple(a.shape) if hasattr(a, "shape")
                                      else a for a in args])

    def infer_shape(self, *args):
        """Complete every deferred parameter shape from example inputs:
        one forward without gradient, each layer completing its own."""
        # a fixed key: completing shapes draws nothing from the chain
        with _autograd.pause(), torch.no_grad(), \
                _random.trace_scope(_random.prng_key(0)):
            self._call_cached(*args) if self._active else self(*args)

    # --------------------------------------------------------------- forward
    def forward(self, x, *args):
        if isinstance(x, torch.Tensor):
            # inside a hybridized call: raw tensors, parameters bound
            self._maybe_infer_shape(x, *args)
            tctx = _current_trace()
            params = {n: (tctx.bind(p) if tctx is not None
                          else p.data()._data)
                      for n, p in self._reg_params.items()}
            return self.hybrid_forward(_F_TORCH, x, *args, **params)
        if isinstance(x, _nd.NDArray):
            if self._active:
                return self._call_cached(x, *args)
            self._maybe_infer_shape(x, *args)
            params = {n: p.data() for n, p in self._reg_params.items()}
            from .. import ndarray as F
            return self.hybrid_forward(F, x, *args, **params)
        from ..symbol.symbol import Symbol
        if isinstance(x, Symbol):
            from .. import symbol as F
            params = {n: p.var() for n, p in self._reg_params.items()}
            return self.hybrid_forward(F, x, *args, **params)
        raise TypeError("HybridBlock input must be NDArray, Symbol or "
                        "torch.Tensor, got %s" % type(x))

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # ----------------------------------------------------------- the call
    def _call_cached(self, *args):
        """The hybridized call: one pass of the whole forward on raw
        tensors. Its input signature is recorded in ``_cached_graph``,
        keyed as the JAX package keys its compiled programs; nothing is
        compiled here, so an entry holds no program."""
        from ..base import normalize_dtype
        from .. import config as _config
        from ..kernels import tier as _ktier
        leaves = []
        tree = _flatten(list(args), leaves)
        training = _autograd.is_training()
        cdt = _config.compute_dtype(default=None)
        self._cached_graph.add((
            tree, tuple((a.shape, a.dtype) if isinstance(a, _nd.NDArray)
                        else ("static", repr(a)) for a in leaves),
            training, cdt, _ktier.tier()))
        cdt_t = normalize_dtype(cdt) if cdt is not None else None
        call = []
        for a in leaves:
            if isinstance(a, _nd.NDArray):
                a = a._data
                if cdt_t is not None and a.dtype == torch.float32:
                    a = a.to(cdt_t)
            call.append(a)
        tctx = _TraceCtx(training, cdt_t)
        # one key a call, random op inside or not, as the JAX package
        # feeds its compiled program; its random ops fold it
        with _autograd.grad_mode(), _trace_scope(tctx), \
                _random.trace_scope(_random.next_key()):
            out = self.forward(*_unflatten(tree, iter(call)))
        _apply_aux(tctx.aux_updates)
        return _wrap(out)

    # ---------------------------------------------------------------- export
    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-NNNN.params`` (every
        parameter as ``arg:<full name>``, moving statistics included,
        as the JAX package writes them); returns the Symbol."""
        from .. import symbol as _sym
        data = _sym.Variable("data")
        with _autograd.pause():
            out = self(data)
        if isinstance(out, (list, tuple)):
            out = _sym.Group(list(out))
        with open("%s-symbol.json" % path, "w") as f:
            f.write(out.tojson())
        _nd.save("%s-%04d.params" % (path, epoch),
                 {"arg:%s" % name: param.data()
                  for name, param in self.collect_params().items()
                  if param._data is not None})
        return out
