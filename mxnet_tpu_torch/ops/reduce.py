"""Reductions (counterpart of a subset of ``mxnet_tpu/ops/reduce.py``):
``sum``, ``mean``, ``prod``, ``max`` and ``min`` with the JAX op's
``axis``/``keepdims``/``exclude``, ``norm``, ``broadcast_to`` and
``broadcast_like``. An empty axis tuple reduces nothing, as in numpy
(torch reads ``dim=()`` as every axis)."""
from __future__ import annotations

import torch

from .registry import alias, register


def _axes(data, axis, exclude=False):
    """The reduced axes as a tuple of non-negative ints (None: all)."""
    if axis is None:
        return None
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = tuple(a % data.dim() for a in ax) if data.dim() else ()
    if exclude:
        ax = tuple(i for i in range(data.dim()) if i not in ax)
    return ax


def _reduce(name, f):
    def op(data, *, axis=None, keepdims=False, exclude=False):
        ax = _axes(data, axis, exclude)
        if ax is None:
            ax = tuple(range(data.dim()))
            if not keepdims:
                return f(data.reshape(-1), (0,), False)
        if not ax:
            return data.clone()
        return f(data, ax, keepdims)
    op.__name__ = name
    register(name)(op)


def _prod(x, ax, keep):
    for a in sorted(ax, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keep)
    return x


_reduce("sum", lambda x, ax, k: torch.sum(x, dim=ax, keepdim=k))
_reduce("mean", lambda x, ax, k: torch.mean(x, dim=ax, keepdim=k))
_reduce("prod", _prod)
_reduce("max", lambda x, ax, k: torch.amax(x, dim=ax, keepdim=k))
_reduce("min", lambda x, ax, k: torch.amin(x, dim=ax, keepdim=k))
alias("sum", "sum_axis")
alias("max", "max_axis")
alias("min", "min_axis")


@register("norm")
def norm(data, *, ord=2, axis=None, keepdims=False):
    ax = _axes(data, axis)
    if ax is None:
        ax = tuple(range(data.dim()))
    if ord == 1:
        return torch.sum(torch.abs(data), dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), dim=ax,
                                keepdim=keepdims))


@register("broadcast_to")
def broadcast_to(data, *, shape):
    # MXNet semantics: 0 in the target shape keeps that dim
    tgt = tuple(s if s != 0 else data.shape[i] for i, s in enumerate(shape))
    return data.expand(tgt)


@register("broadcast_like")
def broadcast_like(lhs, rhs):
    return lhs.expand(rhs.shape)
