"""Creation ops (counterpart of a subset of ``mxnet_tpu/ops/init_ops.py``):
``_zeros``, ``_ones``, ``_full`` and ``_arange``. They take no tensor
input; ``ctx`` (a Context, a torch.device or a device string) places
the result, on the CPU when it is None."""
from __future__ import annotations

import torch

from ..base import normalize_dtype
from .registry import register


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
