"""Graph executor: bind a Symbol, run it forward and backward.

Counterpart of ``mxnet_tpu/executor.py``. The JAX package traces the
Symbol DAG into one pure function and jits it; the port walks the same
DAG eagerly, op by op, in topological order (:func:`_graph_eval_fn`),
under torch autograd when a gradient is wanted. Auxiliary states
(BatchNorm's moving statistics) are explicit inputs and their updates
explicit outputs, committed after each training forward, as there.
Every forward draws one key from the random chain for the graph's
random ops (Dropout), as there.

:class:`Executor` is ``bind``'s result: ``forward(is_train=...)`` and
``backward(out_grads=None)`` (the default head gradient is ones, as in
the JAX package's fused forward-backward), with gradients written or
added into the caller's ``args_grad`` tensors per ``grad_req``. Values
are torch tensors on the executor's device; inputs and parameters are
copied into the bound tensors in place, so references to
``arg_dict``/``grad_dict`` entries stay live. Gradient mirroring
(``MXNET_BACKWARD_DO_MIRROR``) is not ported.
"""
from __future__ import annotations

import numpy as _np
import torch

from . import random as _random
from .base import MXNetError, normalize_dtype
from .config import override
from .context import resolve_device
from .kernels import graph_fuse as _gfuse
from .kernels import tier as _tier

__all__ = ["Executor", "simple_bind", "_graph_eval_fn"]


def _graph_eval_fn(symbol):
    """Build eval(arg_vals, aux_vals, training) -> (outputs, aux_updates).

    The kernel-tier fusion plan is made here, once, under the caller's
    tier; every call of ``eval`` runs under that same tier, whichever
    thread calls it (the JAX package fixes the tier when it traces).
    """
    nodes = symbol._topo()
    entries = list(symbol._entries)
    kernel_tier = _tier.tier()
    kplan, kdeferred = _gfuse.plan(nodes, entries)

    def eval_fn(arg_vals, aux_vals, training):
        values = {}
        aux_updates = {}

        def route_aux(node, out):
            # route aux output slots back to their aux variable names
            if node.op.aux_outputs:
                outs = out if isinstance(out, tuple) else (out,)
                for in_slot, out_slot in zip(node.op.aux_inputs,
                                             node.op.aux_outputs):
                    src, _ = node.inputs[in_slot]
                    if src.is_variable and src.name in aux_vals:
                        aux_updates[src.name] = outs[out_slot]

        def force(node):
            """Plain evaluation of one node: the normal path, and the
            lazy fallback for deferred fusion interiors."""
            ins = [read(s, oi) for (s, oi) in node.inputs]
            params = dict(node.params)
            if "_training" in node.op.param_names:
                params["_training"] = training
            out = node.op.fn(*ins, **params)
            values[id(node)] = out
            route_aux(node, out)
            return out

        def read(src, oi):
            if src.is_variable:
                if src.name in arg_vals:
                    return arg_vals[src.name]
                if src.name in aux_vals:
                    return aux_vals[src.name]
                raise MXNetError("unbound variable %r" % src.name)
            if id(src) in values:
                v = values[id(src)]
            else:
                # deferred fusion interior read outside its pattern
                # (the guard declined the kernel): evaluate it unfused
                v = force(src)
            return v[oi] if isinstance(v, tuple) else v

        with override(kernel_tier=kernel_tier):
            for node in nodes:
                if node.is_variable or id(node) in kdeferred:
                    continue
                kp = kplan.get(id(node))
                if kp is not None and _gfuse.try_eval(
                        kp, node, read, values, route_aux, training):
                    continue
                force(node)
            outputs = [read(n, oi) for (n, oi) in entries]
        # force and read refer to each other: break the cycle, or it
        # keeps every activation and input of this call alive until the
        # garbage collector runs
        del force, read
        return outputs, aux_updates

    return eval_fn


def _as_tensor(v, device=None, dtype=None):
    """numpy array, torch tensor, Python scalar/list or anything with
    ``.asnumpy()`` -> tensor (on ``device``, in ``dtype`` when given)."""
    if not isinstance(v, torch.Tensor):
        if hasattr(v, "asnumpy"):
            v = v.asnumpy()
        v = torch.from_numpy(_np.ascontiguousarray(_np.asarray(v)))
    return v.detach().to(device=device, dtype=dtype)


def _by_name(names, values, what):
    if isinstance(values, dict):
        missing = [n for n in names if n not in values]
        if missing:
            raise MXNetError("bind: %s missing for %s" % (what, missing))
        return {n: values[n] for n in names}
    values = list(values or [])
    if len(values) != len(names):
        raise MXNetError("bind: need %d %s (%s), got %d"
                         % (len(names), what, names, len(values)))
    return dict(zip(names, values))


def _grad_reqs(grad_req, names):
    """One request, a list in argument order or a dict -> {name: req}."""
    if isinstance(grad_req, str):
        return {k: grad_req for k in names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(names, grad_req))
    return {k: grad_req.get(k, "null") for k in names}


class Executor:
    """A bound computation graph on one device."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._device = resolve_device(ctx)
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        dev = self._device
        self.arg_dict = {k: _as_tensor(v, dev) for k, v in _by_name(
            self._arg_names, args, "args").items()}
        self.aux_dict = {k: _as_tensor(v, dev) for k, v in _by_name(
            self._aux_names, aux_states or ({} if not self._aux_names
                                            else None), "aux_states").items()}
        req = _grad_reqs(grad_req, self._arg_names)
        if args_grad is None:
            self.grad_dict = {}
        elif isinstance(args_grad, dict):
            self.grad_dict = {k: _as_tensor(v, dev)
                              for k, v in args_grad.items()}
        else:
            self.grad_dict = {k: _as_tensor(v, dev) for k, v in
                              zip(self._arg_names, args_grad)
                              if v is not None}
        for k in self._arg_names:
            if k not in self.grad_dict:
                req[k] = "null"
            elif req.get(k, "null") not in ("write", "add", "null"):
                raise MXNetError("grad_req %r for %r: must be write, add or "
                                 "null" % (req[k], k))
        self._grad_req = req
        self._req_args = [k for k in self._arg_names
                          if req.get(k, "null") != "null"]
        self._eval_fn = _graph_eval_fn(symbol)
        self.outputs = []
        self._pending = None   # (outputs under autograd, {name: leaf})

    # ---------------------------------------------------------- accessors
    @property
    def arg_arrays(self):
        return [self.arg_dict[k] for k in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(k) for k in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[k] for k in self._aux_names]

    @property
    def arg_names(self):
        return self._arg_names

    @property
    def aux_names(self):
        return self._aux_names

    @property
    def output_dict(self):
        return dict(zip(self._output_names, self.outputs))

    # ---------------------------------------------------------------- run
    def set_inputs(self, **kwargs):
        """Copy input values (by argument name) into the bound tensors."""
        for k, v in kwargs.items():
            if k in self.arg_dict:
                dst = self.arg_dict[k]
                dst.copy_(_as_tensor(v, dst.device, dst.dtype)
                          .reshape(dst.shape))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values into the bound tensors in place."""
        for params, dst, what in ((arg_params, self.arg_dict, "arg"),
                                  (aux_params or {}, self.aux_dict, "aux")):
            for k, v in params.items():
                if k in dst:
                    with torch.no_grad():
                        dst[k].copy_(_as_tensor(v, dst[k].device,
                                                dst[k].dtype))
                elif not allow_extra_params:
                    raise MXNetError("unknown %s %r" % (what, k))

    def _run(self, training, leaves=None, key=None):
        """One evaluation of the graph. The graph's random ops fold one
        key: ``key`` when given (the grouped step stages its keys on the
        device), else one drawn from the random chain, as the JAX
        package's executor feeds one to every forward."""
        vals = dict(self.arg_dict)
        vals.update(leaves or {})
        with _random.trace_scope(_random.next_key() if key is None
                                 else key):
            return self._eval_fn(vals, self.aux_dict, training)

    def forward(self, is_train=False, **kwargs):
        """Run the graph; with ``is_train`` and arguments that want a
        gradient, keep the autograd graph for :meth:`backward`. Aux
        updates are committed after a training forward."""
        self.set_inputs(**kwargs)
        self._pending = None
        if is_train and self._req_args:
            leaves = {k: self.arg_dict[k].detach().requires_grad_(True)
                      for k in self._req_args}
            with torch.enable_grad():
                outs, auxu = self._run(True, leaves)
            self._pending = (outs, leaves)
        else:
            with torch.no_grad():
                outs, auxu = self._run(bool(is_train))
        if is_train:
            for k, v in auxu.items():
                self.aux_dict[k] = v.detach()
        self.outputs = [o.detach() for o in outs]
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs (head gradients ``out_grads``, ones
        by default) into ``grad_dict`` per ``grad_req``."""
        if not self._req_args:
            return
        if self._pending is not None:
            outs, leaves = self._pending
            self._pending = None
        elif out_grads is not None:
            # as the JAX package: the forward runs again, aux untouched
            leaves = {k: self.arg_dict[k].detach().requires_grad_(True)
                      for k in self._req_args}
            with torch.enable_grad():
                outs, _ = self._run(True, leaves)
        else:
            raise MXNetError("backward called before forward(is_train=True)")
        if out_grads is None:
            ograds = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (torch.Tensor, _np.ndarray)) \
                    or hasattr(out_grads, "asnumpy"):
                out_grads = [out_grads]
            ograds = [_as_tensor(g, o.device, o.dtype)
                      for g, o in zip(out_grads, outs)]
        pairs = [(o, g) for o, g in zip(outs, ograds) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[k] for k in names],
                [g for _, g in pairs], allow_unused=True)
        with torch.no_grad():
            for k, g in zip(names, grads):
                buf = self.grad_dict[k]
                g = torch.zeros_like(buf) if g is None else g.to(buf.dtype)
                if self._grad_req[k] == "add":
                    buf.add_(g)
                else:
                    buf.copy_(g)


def simple_bind(symbol, ctx=None, grad_req="write", type_dict=None,
                **shapes):
    """Infer every shape from the given ones, allocate zeros on the
    executor's device (gradient buffers where ``grad_req`` is not
    'null'), bind."""
    dev = resolve_device(ctx)
    arg_shapes, _, aux_shapes = symbol.infer_shape(
        **{k: v for k, v in shapes.items() if isinstance(v, (tuple, list))})
    types = {k: normalize_dtype(v) for k, v in (type_dict or {}).items()}
    arg_names = symbol.list_arguments()
    args = {n: torch.zeros(s, dtype=types.get(n, torch.float32), device=dev)
            for n, s in zip(arg_names, arg_shapes)}
    req = _grad_reqs(grad_req, arg_names)
    grads = {k: torch.zeros_like(args[k]) for k in arg_names
             if req.get(k, "null") != "null"}
    aux = {n: torch.zeros(s, device=dev) for n, s in
           zip(symbol.list_auxiliary_states(), aux_shapes)}
    return Executor(symbol, dev, args, grads, req, aux)
