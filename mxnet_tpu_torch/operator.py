"""Custom operators written in Python (``mt.operator``; counterpart of
``mxnet_tpu/operator.py``): ``CustomOp`` with ``assign``,
``CustomOpProp``, ``register``, ``get_prop_cls`` and ``make_prop``.

A registered Prop describes the op (arguments, outputs, shapes and
types); ``Custom(..., op_type=name)`` (``mt.sym.Custom``,
``mt.nd.Custom``; :mod:`.ops.custom_op`) runs its ``CustomOp`` on the
host in any mode: eagerly, in a bound executor and inside
``Module.fit``'s train step. Keyword arguments given at a call site
reach the Prop's constructor as strings, as in the JAX package (they
cross the reference's C boundary as ``char*``).
"""
from __future__ import annotations

import numpy as _np

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_cls",
           "make_prop"]

_REGISTRY = {}


class CustomOp:
    """Base class of a custom operator's forward and backward."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as the request says: nothing for
        ``null``, a copy for ``write``/``inplace``, a sum for ``add``."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise ValueError("unknown req %r" % req)


class CustomOpProp:
    """A custom op's signature: its arguments, outputs, auxiliary states,
    shapes and types, and the operator it creates."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        t = in_type[0] if in_type else _np.float32
        return ([t] * len(self.list_arguments()),
                [t] * len(self.list_outputs()),
                [t] * len(self.list_auxiliary_states()))

    def infer_storage_type(self, in_stype):
        return (in_stype, ["default"] * len(self.list_outputs()),
                ["default"] * len(self.list_auxiliary_states()))

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a CustomOpProp subclass under ``op_type=reg_name``."""
    def deco(prop_cls):
        _REGISTRY[reg_name] = prop_cls
        return prop_cls
    return deco


def get_prop_cls(op_type):
    try:
        return _REGISTRY[op_type]
    except KeyError:
        raise KeyError("custom op %r is not registered (have: %s)"
                       % (op_type, sorted(_REGISTRY))) from None


def make_prop(op_type, kwargs):
    """The Prop of ``op_type``, its call-site keywords as strings."""
    return get_prop_cls(op_type)(**{k: str(v) for k, v in kwargs.items()})
