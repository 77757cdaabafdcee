"""Elementwise operators (counterpart of ``mxnet_tpu/ops/elemwise.py``):
the broadcasting binary ops (arithmetic, ``mod``, ``hypot``, the
comparisons and the logical ops) under their MXNet names, their scalar
forms behind the Symbol's and the NDArray's operators, the unary math
table, ``clip``, ``where``, ``BlockGrad``, Cast, the detection losses'
``smooth_l1``, ``add_n`` and the legacy capitalised names
(``_Plus`` ... ``_RPowerScalar``). The JAX package's elemwise
``make_loss`` is shadowed there by ``MakeLoss``'s alias of the same name
(its registry resolves ``make_loss`` to ``MakeLoss``), so the port
registers only ``MakeLoss`` (:mod:`.nn`) under both names.

A comparison or a logical op returns the lhs dtype (1 or 0), as the
JAX op does. A scalar is rounded to the data's dtype before the op, as
the JAX op rounds it, so an integer tensor stays integer.

The semantics are the JAX package's, not torch's: ``mod`` takes the
divisor's sign (``jnp.mod``: ``torch.remainder``'s rule, spelled out
from ``fmod`` so both devices round alike), ``round`` and ``rint`` round
half to even, ``sign`` keeps NaN and -0.0, ``gamma`` is
``exp(gammaln(x))`` (it drops the sign for negative non-integers,
ROADMAP §C R11) and ``erfinv`` is XLA's single-precision polynomial
(:func:`random.erfinv`). ``rint``, ``reciprocal`` and ``degrees`` of an
integer tensor are f32, as ``jnp``'s.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import normalize_dtype
from .registry import alias, register


def _mod(a, b):
    """``jnp.mod``: the remainder with the divisor's sign."""
    m = torch.fmod(a, b)
    return torch.where((m != 0) & ((m < 0) != (b < 0)), m + b, m)


def _logical(f):
    return lambda a, b: f(a != 0, b != 0).to(a.dtype)

_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "mod": _mod,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
    "equal": lambda a, b: (a == b).to(a.dtype),
    "not_equal": lambda a, b: (a != b).to(a.dtype),
    "greater": lambda a, b: (a > b).to(a.dtype),
    "greater_equal": lambda a, b: (a >= b).to(a.dtype),
    "lesser": lambda a, b: (a < b).to(a.dtype),
    "lesser_equal": lambda a, b: (a <= b).to(a.dtype),
    "logical_and": _logical(torch.logical_and),
    "logical_or": _logical(torch.logical_or),
    "logical_xor": _logical(torch.logical_xor),
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


def _scalar(data, scalar):
    """``scalar`` rounded to the data's dtype on the host: an int for an
    integer tensor, else a float."""
    return torch.tensor(scalar, dtype=data.dtype).item()


def _scalar_op(name, f):
    def op(data, *, scalar=1.0):
        return f(data, _scalar(data, scalar))
    op.__name__ = name
    register(name)(op)


_scalar_op("_plus_scalar", torch.add)
_scalar_op("_minus_scalar", torch.sub)
_scalar_op("_rminus_scalar", lambda a, s: s - a)
_scalar_op("_mul_scalar", torch.mul)
_scalar_op("_div_scalar", torch.div)
# a Python number over a tensor is torch's reciprocal times the number,
# not the quotient: divide two tensors instead
_scalar_op("_rdiv_scalar", lambda a, s: torch.div(torch.full_like(a, s), a))
_scalar_op("_mod_scalar", _mod)
_scalar_op("_rmod_scalar", lambda a, s: _mod(torch.full_like(a, s), a))
_scalar_op("_power_scalar", torch.pow)
_scalar_op("_rpower_scalar", lambda a, s: torch.pow(s, a))
_scalar_op("_maximum_scalar", torch.clamp_min)
_scalar_op("_minimum_scalar", torch.clamp_max)
_scalar_op("_equal_scalar", lambda a, s: (a == s).to(a.dtype))
_scalar_op("_not_equal_scalar", lambda a, s: (a != s).to(a.dtype))
_scalar_op("_greater_scalar", lambda a, s: (a > s).to(a.dtype))
_scalar_op("_greater_equal_scalar", lambda a, s: (a >= s).to(a.dtype))
_scalar_op("_lesser_scalar", lambda a, s: (a < s).to(a.dtype))
_scalar_op("_lesser_equal_scalar", lambda a, s: (a <= s).to(a.dtype))

def _sign(x):
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def _f32(f):
    """``f`` of an integer tensor taken in f32, as ``jnp`` promotes it."""
    return lambda x: f(x if x.is_floating_point() else x.float())


def _cbrt(x):
    """The real cube root, rounded once from f64 (torch has no cbrt)."""
    return torch.pow(x.double().abs(), 1.0 / 3.0).copysign(
        x.double()).to(x.dtype)


_UNARY = {
    "abs": torch.abs,
    "sign": _sign,
    "rint": _f32(torch.round),
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "round": torch.round,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": _f32(lambda x: x * (180.0 / math.pi)),
    "radians": _f32(lambda x: x * (math.pi / 180.0)),
    "negative": torch.neg,
    "reciprocal": _f32(torch.reciprocal),
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "relu": torch.relu,
    "erf": torch.erf,
    "erfinv": _random.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "logical_not": lambda x: (x == 0).to(x.dtype),
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


@register("add_n")
def add_n(*args):
    """The inputs summed elementwise, left to right."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


alias("add_n", "ElementWiseSum")

# the legacy capitalised names of the JAX package's alias table
# (``mxnet_tpu/ops/legacy_aliases.py``) and the gradient-accumulation node
for _legacy, _new in {
    "_Plus": "elemwise_add", "_Minus": "elemwise_sub",
    "_Mul": "elemwise_mul", "_Div": "elemwise_div",
    "_Mod": "_mod", "_Power": "_power",
    "_Maximum": "_maximum", "_Minimum": "_minimum",
    "_Hypot": "_hypot",
    "_Equal": "_equal", "_Not_Equal": "_not_equal",
    "_Greater": "_greater", "_Greater_Equal": "_greater_equal",
    "_Lesser": "_lesser", "_Lesser_Equal": "_lesser_equal",
    "_Logical_And": "_logical_and", "_Logical_Or": "_logical_or",
    "_Logical_Xor": "_logical_xor",
    "_PlusScalar": "_plus_scalar", "_MinusScalar": "_minus_scalar",
    "_RMinusScalar": "_rminus_scalar", "_MulScalar": "_mul_scalar",
    "_DivScalar": "_div_scalar", "_RDivScalar": "_rdiv_scalar",
    "_ModScalar": "_mod_scalar", "_RModScalar": "_rmod_scalar",
    "_PowerScalar": "_power_scalar", "_RPowerScalar": "_rpower_scalar",
    "_MaximumScalar": "_maximum_scalar",
    "_MinimumScalar": "_minimum_scalar",
    "_EqualScalar": "_equal_scalar",
    "_NotEqualScalar": "_not_equal_scalar",
    "_GreaterScalar": "_greater_scalar",
    "_GreaterEqualScalar": "_greater_equal_scalar",
    "_LesserScalar": "_lesser_scalar",
    "_LesserEqualScalar": "_lesser_equal_scalar",
    "_grad_add": "elemwise_add",
}.items():
    alias(_new, _legacy)
