"""Creation ops (counterpart of ``mxnet_tpu/ops/init_ops.py``): ``_zeros``
(and its alias ``_zeros_without_dtype``), ``_ones``, ``_full``,
``_arange``, ``_linspace`` (``jnp.linspace``'s arithmetic) and
``_eye``. They take no tensor
input; ``ctx`` (a Context, a torch.device or a device string) places
the result, on the CPU when it is None."""
from __future__ import annotations

import torch

from ..base import normalize_dtype
from .registry import alias, register


def _dev(ctx):
    if ctx is None:
        return torch.device("cpu")
    return getattr(ctx, "torch_device", None) or torch.device(ctx)


def _shape(shape):
    return tuple(shape) if hasattr(shape, "__len__") else (int(shape),)


@register("_zeros")
def zeros(*, shape=(), dtype="float32", ctx=None):
    return torch.zeros(_shape(shape), dtype=normalize_dtype(dtype or
                                                            "float32"),
                       device=_dev(ctx))


alias("_zeros", "_zeros_without_dtype")


@register("_ones")
def ones(*, shape=(), dtype="float32", ctx=None):
    return torch.ones(_shape(shape), dtype=normalize_dtype(dtype or
                                                           "float32"),
                      device=_dev(ctx))


@register("_full")
def full(*, shape=(), value=0.0, dtype="float32", ctx=None):
    return torch.full(_shape(shape), value,
                      dtype=normalize_dtype(dtype or "float32"),
                      device=_dev(ctx))


@register("_arange")
def arange(*, start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
           ctx=None, infer_range=False):
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=torch.float64,
                       device=_dev(ctx)).to(normalize_dtype(dtype or
                                                            "float32"))
    if repeat != 1:
        out = out.repeat_interleave(int(repeat))
    return out


@register("_linspace")
def linspace(*, start=0.0, stop=1.0, num=50, endpoint=True,
             dtype="float32", ctx=None):
    from .matrix import linspace as _linspace
    dt = normalize_dtype(dtype or "float32")
    ct = dt if dt.is_floating_point else torch.float32
    out = _linspace(start, stop, int(num), endpoint, ct, _dev(ctx))
    if not dt.is_floating_point:
        out = torch.floor(out)
    return out.to(dt)


@register("_eye")
def eye(*, N, M=0, k=0, dtype="float32", ctx=None):
    """Ones on the ``k``-th diagonal of an (N, M or N) matrix."""
    dev = _dev(ctx)
    rows = torch.arange(int(N), device=dev)[:, None]
    cols = torch.arange(int(M) if M else int(N), device=dev)[None, :]
    return (cols - rows == int(k)).to(normalize_dtype(dtype or "float32"))
