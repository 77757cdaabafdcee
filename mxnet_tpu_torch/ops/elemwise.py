"""Elementwise operators (counterpart of a subset of
``mxnet_tpu/ops/elemwise.py``): the broadcasting binary ops and their
comparisons under their MXNet names, their scalar forms behind the
Symbol's and the NDArray's operators, the unary math the Gluon layers
and losses reach, ``clip``, ``where``, ``BlockGrad``, Cast and the
detection losses' ``smooth_l1``. The JAX package's elemwise
``make_loss`` is shadowed there by ``MakeLoss``'s alias of the same name
(its registry resolves ``make_loss`` to ``MakeLoss``), so the port
registers only ``MakeLoss`` (:mod:`.nn`) under both names.

A comparison returns the lhs dtype (1 or 0), as the JAX op does. A
scalar is rounded to the data's dtype before the op, as the JAX op
rounds it.
"""
from __future__ import annotations

import torch

from ..base import normalize_dtype
from .registry import alias, register

_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "equal": lambda a, b: (a == b).to(a.dtype),
    "not_equal": lambda a, b: (a != b).to(a.dtype),
    "greater": lambda a, b: (a > b).to(a.dtype),
    "greater_equal": lambda a, b: (a >= b).to(a.dtype),
    "lesser": lambda a, b: (a < b).to(a.dtype),
    "lesser_equal": lambda a, b: (a <= b).to(a.dtype),
}


def _binary_op(name, f):
    def op(lhs, rhs):
        return f(lhs, rhs)
    op.__name__ = "broadcast_" + name
    register("broadcast_" + name)(op)
    alias("broadcast_" + name, "elemwise_" + name, "_" + name)


for _name, _f in _BINARY.items():
    _binary_op(_name, _f)

alias("broadcast_add", "broadcast_plus", "_plus")
alias("broadcast_sub", "broadcast_minus", "_minus")
alias("broadcast_div", "_true_divide")
alias("broadcast_maximum", "maximum")
alias("broadcast_minimum", "minimum")
alias("broadcast_power", "pow")


def _scalar_op(name, f):
    def op(data, *, scalar=1.0):
        return f(data, float(torch.tensor(scalar, dtype=data.dtype)))
    op.__name__ = name
    register(name)(op)


_scalar_op("_plus_scalar", torch.add)
_scalar_op("_minus_scalar", torch.sub)
_scalar_op("_rminus_scalar", lambda a, s: s - a)
_scalar_op("_mul_scalar", torch.mul)
_scalar_op("_div_scalar", torch.div)
_scalar_op("_rdiv_scalar", lambda a, s: s / a)
_scalar_op("_power_scalar", torch.pow)
_scalar_op("_rpower_scalar", lambda a, s: torch.pow(s, a))
_scalar_op("_equal_scalar", lambda a, s: (a == s).to(a.dtype))
_scalar_op("_not_equal_scalar", lambda a, s: (a != s).to(a.dtype))
_scalar_op("_greater_scalar", lambda a, s: (a > s).to(a.dtype))
_scalar_op("_greater_equal_scalar", lambda a, s: (a >= s).to(a.dtype))
_scalar_op("_lesser_scalar", lambda a, s: (a < s).to(a.dtype))
_scalar_op("_lesser_equal_scalar", lambda a, s: (a <= s).to(a.dtype))

_UNARY = {
    "abs": torch.abs,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
    "tanh": torch.tanh,
    "negative": torch.neg,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
}


def _unary_op(name, f):
    def op(data):
        return f(data)
    op.__name__ = name
    register(name)(op)


for _name, _f in _UNARY.items():
    _unary_op(_name, _f)

alias("negative", "_np_negative")
alias("relu", "_relu")


@register("clip")
def clip(data, *, a_min=None, a_max=None):
    return torch.clamp(data, a_min, a_max)


@register("_copy")
def _copy(data):
    return data.clone()


alias("_copy", "identity")


@register("BlockGrad")
def block_grad(data):
    return data.detach()


alias("BlockGrad", "stop_gradient")


@register("where")
def where(condition, x, y):
    """Elementwise select; a 1-D condition over N-D operands selects
    whole rows along axis 0, as the JAX op does."""
    cond = condition.to(torch.bool)
    if cond.dim() == 1 and x.dim() > 1:
        if cond.shape[0] != x.shape[0]:
            raise ValueError("where: 1-D condition length %d must equal "
                             "x.shape[0]=%d" % (cond.shape[0], x.shape[0]))
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond, x, y)


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("Cast")
def cast(data, *, dtype="float32"):
    return data.to(normalize_dtype(dtype))


alias("Cast", "cast")


@register("smooth_l1")
def smooth_l1(data, *, scalar=1.0):
    """``0.5 s^2 x^2`` where ``|x| < 1 / s^2``, else ``|x| - 0.5 / s^2``,
    with ``s = scalar`` (the JAX op's formula; torch autograd gives its
    gradient)."""
    s2 = float(scalar) * float(scalar)
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * s2 * torch.square(data),
                       torch.abs(data) - 0.5 / s2)
