"""Row gather by clipped integer ids.

Counterpart of ``mxnet_tpu/kernels/take.py``. ``take_rows`` gathers rows
of a ``(vocab, dim)`` table; out-of-range ids clip to ``[0, vocab-1]``
(``jnp.take``'s clip mode, where torch indexing would raise). The
gather is the hand-written CUDA kernel ``csrc/take_rows.cu`` (the TPU
kernel ``mxk_take_rows``); :func:`gather_pages` is the tier-dispatched
call-site of the paged-KV decode step.

The wrapper launches the kernel for a CUDA table, and raises on what
the kernel does not take; a CPU table takes :func:`_plain_take`, the
same function in plain torch. Every launch adds one to ``launches``;
nothing else does. ``take_rows`` is differentiable: its backward
(:class:`_TakeRows`) scatter-adds the cotangent rows at the clipped ids
into a zero table (``index_add_``), the vjp of the clipped ``jnp.take``;
the ids get no gradient.

Guard: the JAX package's reasons, except its "not lane-aligned
(multiple of 128)" rule for the embedding dim, which is the TPU's
(8, 128) layout. The CUDA kernel copies rows of any width (16-byte
vectors where the width allows, 4- or 2-byte words otherwise), so the
port drops that reason and adds none.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError, dtype_name
from . import _build
from . import tier as _tier

__all__ = ["take_rows", "gather_pages", "eligible", "shape_key_shapes",
           "DEFAULT_CONFIG", "OP_NAME", "launches", "reset_launches"]

OP_NAME = "take_rows"
# CUDA launch shape: threads per block (one block per gathered row)
DEFAULT_CONFIG = {"threads": 128}

_DTYPES = (torch.float32, torch.bfloat16)

launches = 0
_count_lock = threading.Lock()

_SIGNATURES = {
    "mxk_take_rows": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p)),
    "mxk_error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}


def reset_launches():
    global launches
    with _count_lock:
        launches = 0


# ------------------------------------------------------------------ guard
def eligible(weight_shape, weight_dtype, idx_shape, idx_dtype):
    """Strict guard; None when dispatchable, else the reason."""
    if len(weight_shape) != 2:
        return "weight must be (vocab, dim) 2-D, got %d-D" % \
            len(weight_shape)
    if weight_dtype not in _DTYPES:
        return "weight dtype must be f32 or bf16, got %s" % \
            dtype_name(weight_dtype)
    if weight_shape[0] < 1:
        return "empty vocab"
    if len(idx_shape) not in (1, 2):
        return "indices must be 1-D or 2-D, got %d-D" % len(idx_shape)
    if idx_dtype == torch.bool or idx_dtype.is_complex:
        return "indices dtype %s not castable to int32" % \
            dtype_name(idx_dtype)
    n = 1
    for d in idx_shape:
        n *= d
    if n < 1:
        return "empty index set"
    return None


def shape_key_shapes(weight_shape, idx_shape):
    """Tuner key: (vocab, dim) table and the flattened index count."""
    n = 1
    for d in idx_shape:
        n *= d
    return (tuple(weight_shape), (n,))


# ----------------------------------------------------------------- kernel
def _plain_take(weight, idx):
    """``weight[clip(idx, 0, V-1)]``: the kernel's function in plain
    torch (ids cast to int32 first, as the JAX package casts them)."""
    ids = idx.to(torch.int32).long().clamp(0, weight.shape[0] - 1)
    return weight[ids]


def _launch(weight, ids, config):
    """Launch csrc/take_rows.cu on the current stream of weight's
    device; ``ids`` is a contiguous int32 vector on that device."""
    global launches
    if weight.dtype not in _DTYPES:
        raise MXNetError("take_rows kernel: dtype must be f32 or bf16, got "
                         "%s" % dtype_name(weight.dtype))
    if weight.dim() != 2 or not weight.is_contiguous():
        raise MXNetError("take_rows kernel: weight must be a contiguous "
                         "(vocab, dim) table, got shape %s strides %s"
                         % (tuple(weight.shape), weight.stride()))
    if (ids.dtype != torch.int32 or ids.dim() != 1
            or ids.device != weight.device or not ids.is_contiguous()):
        raise MXNetError("take_rows kernel: ids must be a contiguous int32 "
                         "vector on %s" % weight.device)
    lib = _build.load("take_rows", _SIGNATURES)
    out = torch.empty((ids.shape[0], weight.shape[1]), dtype=weight.dtype,
                      device=weight.device)
    with torch.cuda.device(weight.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mxk_take_rows(
            weight.data_ptr(), ids.data_ptr(), out.data_ptr(),
            weight.shape[0], ids.shape[0],
            weight.shape[1] * weight.element_size(),
            int(config["threads"]), stream)
    if err != 0:
        raise MXNetError("take_rows kernel launch failed: CUDA error %d (%s)"
                         % (err, lib.mxk_error_string(err).decode()))
    with _count_lock:
        launches += 1
    return out


# ------------------------------------------------------------------ public
def take_rows(weight, idx, *, config=None):
    """Gather rows of a (vocab, dim) table by integer index.

    ``idx`` may be 1-D or 2-D; the output is ``idx.shape + (dim,)``,
    bitwise ``weight[clip(idx.to(int32), 0, vocab-1)]``. Raises on guard
    failure."""
    reason = eligible(tuple(weight.shape), weight.dtype, tuple(idx.shape),
                      idx.dtype)
    if reason is not None:
        raise ValueError("take_rows guard: %s" % reason)
    if weight.device.type not in ("cpu", "meta", "cuda"):
        raise MXNetError("take_rows: no kernel for %s tensors"
                         % weight.device.type)
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    ids = idx.to(device=weight.device, dtype=torch.int32).reshape(-1)
    out = _TakeRows.apply(weight, ids.contiguous(), cfg)
    return out.reshape(tuple(idx.shape) + (weight.shape[1],))


class _TakeRows(torch.autograd.Function):
    """Forward: the clipped gather of int32 ids, the kernel for a CUDA
    table and :func:`_plain_take` for a CPU one. Backward: the cotangent
    rows added into a zero table at the clipped ids."""

    @staticmethod
    def forward(ctx, weight, ids, config):
        ctx.save_for_backward(ids)
        ctx.vocab = weight.shape[0]
        if weight.device.type == "cuda":
            return _launch(weight, ids, config)
        return _plain_take(weight, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        dw = torch.zeros((ctx.vocab, g.shape[1]), dtype=g.dtype,
                         device=g.device)
        dw.index_add_(0, ids.long().clamp(0, ctx.vocab - 1), g)
        return dw, None, None


def gather_pages(table, idx):
    """Tier-dispatched row gather for the paged-KV decode step.

    ``table`` is one layer's flat page store ``(rows, dim)``; ``idx``
    the block-table expansion ``(max_slots, max_context)`` of flat row
    ids. The kernel when the tier and the guard allow, else the same
    clipped gather in plain torch: one numerics contract either way."""
    reason = eligible(tuple(table.shape), table.dtype, tuple(idx.shape),
                      idx.dtype)
    go, cfg = _tier.should_dispatch(
        OP_NAME, shape_key_shapes(tuple(table.shape), tuple(idx.shape)),
        dtype_name(table.dtype), DEFAULT_CONFIG, guard_reason=reason)
    if go:
        return take_rows(table, idx, config=cfg)
    return _plain_take(table, idx)
