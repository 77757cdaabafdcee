"""Reductions (counterpart of ``mxnet_tpu/ops/reduce.py``): ``sum``,
``mean``, ``prod``, ``max``, ``min``, ``nansum`` and ``nanprod`` with
the JAX op's ``axis``/``keepdims``/``exclude``, ``norm``,
``square_sum``, ``argmax``/``argmin``/``argmax_channel`` (f32 indices,
the first of equal values, a NaN counting as the largest and the
smallest value, as ``jnp``'s), ``cumsum``, ``broadcast_to``,
``broadcast_axis`` and ``broadcast_like``. An empty axis tuple reduces
nothing, as in numpy (torch reads ``dim=()`` as every axis)."""
from __future__ import annotations

import torch

from ..base import normalize_dtype
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
_reduce("nansum", lambda x, ax, k: torch.nansum(x, dim=ax, keepdim=k))
_reduce("nanprod", lambda x, ax, k: _prod(
    torch.where(torch.isnan(x), torch.ones_like(x), x), ax, k))
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


@register("square_sum")
def square_sum(data, *, axis=None, keepdims=False):
    ax = _axes(data, axis)
    if ax is None:
        ax = tuple(range(data.dim()))
    return torch.sum(torch.square(data), dim=ax, keepdim=keepdims)


def _arg(f):
    def op(data, *, axis=None, keepdims=False):
        if axis is None:
            out = f(data.reshape(-1), 0)
            if keepdims:
                out = out.reshape((1,) * data.dim())
        else:
            out = f(data, axis, keepdim=keepdims)
        return out.to(torch.float32)
    return op


register("argmax")(_arg(torch.argmax))
register("argmin")(_arg(torch.argmin))


@register("argmax_channel")
def argmax_channel(data):
    return torch.argmax(data, -1).to(torch.float32)


@register("cumsum")
def cumsum(data, *, axis=None, dtype=None):
    """The running sum (over the flattened data when ``axis`` is None),
    in ``dtype`` or else the data's own."""
    x = data.reshape(-1) if axis is None else data
    return torch.cumsum(x, 0 if axis is None else axis,
                        dtype=normalize_dtype(dtype) or data.dtype)


@register("broadcast_to")
def broadcast_to(data, *, shape):
    # MXNet semantics: 0 in the target shape keeps that dim
    tgt = tuple(s if s != 0 else data.shape[i] for i, s in enumerate(shape))
    return data.expand(tgt)


@register("broadcast_axis")
def broadcast_axis(data, *, axis, size):
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    tgt = list(data.shape)
    for a, n in zip(axis, size):
        tgt[a] = n
    return data.expand(tgt)


alias("broadcast_axis", "broadcast_axes")


@register("broadcast_like")
def broadcast_like(lhs, rhs):
    return lhs.expand(rhs.shape)
