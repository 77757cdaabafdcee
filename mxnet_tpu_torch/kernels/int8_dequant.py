"""Fused int8 dequantize -> per-channel affine -> activation epilogue.

Counterpart of ``mxnet_tpu/kernels/int8_dequant.py``. The int8 serving
path (``mxnet_tpu_torch/quant``) computes each FullyConnected or
Convolution site as ``int8 x int8 -> int32`` and then needs one
bandwidth-bound pass over the int32 accumulator: ``act(f32(acc) * sc +
sh)`` with per-output-channel f32 coefficients (the dequantization scale
folded with the inference BatchNorm affine and the bias), act relu or
identity, f32 out. That pass is the hand-written CUDA kernel
``csrc/int8_dequant.cu`` (the TPU kernel ``mxk_int8_dequant``).

The accumulator is a row-major (R, S) matrix in one of two forms, as in
the JAX package: ``per_row=True`` (conv, NCHW viewed (N*C, H*W)), where
row r takes coefficient r % C from C = ``sc.numel()`` values (the JAX
wrapper's (R, 1) column is the case C = R; the kernel never needs the
N-fold tiling), and ``per_row=False`` (FC, and conv as the GEMM gives it,
(N*OH*OW, O)), with S coefficients, one per column.

The affine rounds once, as XLA's contracted FMA does in the JAX package:
the kernel computes ``fmaf``, and the plain version
(:func:`_plain_dequant`) computes in f64 and rounds to f32 at the end.

The wrapper launches the kernel for a CUDA tensor and raises on what the
kernel does not take; a CPU tensor takes the plain version. Every launch
adds one to ``launches`` and to its form's and activation's entry in
``launches_by_kernel``; nothing else does. Inference only: no gradient.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError, dtype_name
from . import _build

__all__ = ["dequant_epilogue", "eligible", "shape_key_shapes",
           "DEFAULT_CONFIG", "OP_NAME", "launches", "launches_by_kernel",
           "reset_launches"]

OP_NAME = "int8_dequant"
# CUDA launch shape: threads per block, and the grid-stride loop's cap on
# blocks (as bn_act)
DEFAULT_CONFIG = {"threads": 256, "max_blocks": 2048}

_ACTS = ("relu", "identity")

launches = 0
launches_by_kernel = {"column/relu": 0, "column/identity": 0,
                      "row/relu": 0, "row/identity": 0}
_count_lock = threading.Lock()

_SIGNATURES = {
    "mxk_int8_dequant": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p)),
    "mxk_error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}


def reset_launches():
    global launches
    with _count_lock:
        launches = 0
        for k in launches_by_kernel:
            launches_by_kernel[k] = 0


# ------------------------------------------------------------------ guard
def eligible(shape, act="relu"):
    """Strict guard; returns None when dispatchable, else the reason."""
    if len(shape) != 2:
        return "accumulator view must be 2-D, got %d-D" % len(shape)
    if act not in _ACTS:
        return "unsupported activation %r" % (act,)
    if shape[0] < 1 or shape[1] < 1:
        return "empty tensor"
    return None


def shape_key_shapes(shape):
    """Shapes the tuner keys this op on: the 2-D accumulator view."""
    return (tuple(shape),)


# ----------------------------------------------------------------- kernel
def _plain_dequant(acc2, sc, sh, per_row, act):
    """act(f32(acc2) * sc + sh) with one rounding to f32: the kernel's
    function in plain torch. The int32 -> f32 conversion rounds as the
    kernel's does; the product of two f32 values is exact in f64, so the
    f64 sum rounds once there and once more to f32."""
    R, S = acc2.shape
    a = acc2.float().double()
    if per_row:
        C = sc.numel()
        y = (a.reshape(R // C, C, S) * sc.double().reshape(1, C, 1)
             + sh.double().reshape(1, C, 1)).reshape(R, S)
    else:
        y = a * sc.double().reshape(1, S) + sh.double().reshape(1, S)
    y = y.float()
    if act == "relu":
        y = torch.relu(y)
    return y


def _check(acc2, sc, sh, per_row, act):
    if acc2.dtype != torch.int32:
        raise MXNetError("int8_dequant kernel: the accumulator must be "
                         "int32, got %s" % dtype_name(acc2.dtype))
    if acc2.dim() != 2 or not acc2.is_contiguous():
        raise MXNetError("int8_dequant kernel: the accumulator must be a "
                         "contiguous 2-D view, got shape %s strides %s"
                         % (tuple(acc2.shape), acc2.stride()))
    R, S = acc2.shape
    C = sc.numel()
    if per_row:
        if C < 1 or R % C:
            raise MXNetError("int8_dequant kernel: per-row coefficients "
                             "must divide the %d rows, got %d" % (R, C))
    elif C != S:
        raise MXNetError("int8_dequant kernel: per-column coefficients "
                         "must number %d, got %d" % (S, C))
    for nm, v in (("sc", sc), ("sh", sh)):
        if (v.dtype != torch.float32 or v.device != acc2.device
                or v.numel() != C or not v.is_contiguous()):
            raise MXNetError("int8_dequant kernel: %s must be %d contiguous "
                             "f32 values on %s" % (nm, C, acc2.device))
    if act not in _ACTS:
        raise MXNetError("int8_dequant kernel: unsupported activation %r"
                         % (act,))


def _launch(acc2, sc, sh, per_row, act, config):
    """Launch csrc/int8_dequant.cu on the current stream of acc2's
    device -> a new f32 (R, S) tensor."""
    global launches
    _check(acc2, sc, sh, per_row, act)
    lib = _build.load("int8_dequant", _SIGNATURES)
    y = torch.empty(acc2.shape, dtype=torch.float32, device=acc2.device)
    R, S = acc2.shape
    with torch.cuda.device(acc2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mxk_int8_dequant(
            acc2.data_ptr(), sc.data_ptr(), sh.data_ptr(), y.data_ptr(),
            R * S, S, sc.numel(), 1 if per_row else 0,
            1 if act == "relu" else 0, int(config["threads"]),
            int(config["max_blocks"]), stream)
    if err != 0:
        raise MXNetError("int8_dequant kernel launch failed: CUDA error %d "
                         "(%s)" % (err, lib.mxk_error_string(err).decode()))
    with _count_lock:
        launches += 1
        launches_by_kernel["%s/%s" % ("row" if per_row else "column",
                                      act)] += 1
    return y


def dequant_epilogue(acc2, sc, sh, *, per_row, act="relu", config=None):
    """``act(f32(acc2) * sc + sh)`` in one pass -> f32, acc2's shape.

    ``acc2`` is the int32 accumulator viewed 2-D: (N*C, H*W) for conv
    (``per_row=True``: C coefficients, row r takes entry r % C; an (R, 1)
    column as the JAX package passes is C = R) or (rows, S) for FC and
    for conv as (N*OH*OW, O) (``per_row=False``: S coefficients, a (1, S)
    row). A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version.
    """
    reason = eligible(tuple(acc2.shape), act=act)
    if reason is not None:
        raise ValueError("dequant_epilogue guard: %s" % reason)
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    sc, sh = sc.reshape(-1), sh.reshape(-1)
    if acc2.device.type == "cuda":
        return _launch(acc2, sc, sh, per_row, act, cfg)
    if acc2.device.type == "cpu":
        return _plain_dequant(acc2, sc, sh, per_row, act)
    raise MXNetError("int8_dequant: no kernel for %s tensors"
                     % acc2.device.type)
