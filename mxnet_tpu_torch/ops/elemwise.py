"""Elementwise operators (counterpart of a subset of
``mxnet_tpu/ops/elemwise.py``): the broadcasting add and multiply under
their MXNet names, their scalar forms behind the Symbol's ``+`` and
``*``, and Cast."""
from __future__ import annotations

import torch

from ..base import normalize_dtype
from .registry import alias, register


@register("broadcast_add")
def broadcast_add(lhs, rhs):
    return lhs + rhs


alias("broadcast_add", "elemwise_add", "_add", "broadcast_plus", "_plus")


@register("broadcast_mul")
def broadcast_mul(lhs, rhs):
    return lhs * rhs


alias("broadcast_mul", "elemwise_mul", "_mul")


def _scalar_op(name, f):
    # the scalar is rounded to the data's dtype, as the JAX op rounds it
    def op(data, *, scalar=1.0):
        return f(data, float(torch.tensor(scalar, dtype=data.dtype)))
    op.__name__ = name
    register(name)(op)


_scalar_op("_plus_scalar", torch.add)
_scalar_op("_mul_scalar", torch.mul)


@register("Cast")
def cast(data, *, dtype="float32"):
    return data.to(normalize_dtype(dtype))


alias("Cast", "cast")
