"""Fused per-feature scale + bias + activation for the transformer MLP.

Counterpart of ``mxnet_tpu/kernels/mlp.py``. ``act(x * scale + bias)``
over the ``(rows, features)`` view, f32 arithmetic and one rounding to
x's dtype, is the hand-written CUDA kernel ``csrc/scale_bias_act.cu``
(the TPU kernel ``mxk_scale_bias_act``); ``scale`` and ``bias`` are
optional ``(features,)`` vectors and the activation is ReLU, erf GeLU or
identity. The executor's fusion pass (``kernels/graph_fuse.py``) runs
``FullyConnected(no_bias)`` and then this kernel for every
``FullyConnected(+bias) -> relu | gelu`` it finds.

The wrapper launches the kernel for a CUDA tensor, and raises on what
the kernel does not take; a CPU tensor takes
:func:`_plain_scale_bias_act`, the same function in plain torch. Every
launch adds one to ``launches``; nothing else does.

The gradient is :class:`_ScaleBiasAct`'s backward, which differentiates
:func:`_reference` (product, sum and activation in x's dtype) as the
JAX package's ``custom_vjp`` does: gradients for x, scale and bias, in
plain torch, with no kernel of its own.

Guard: the JAX package's reasons, unchanged (none is about the TPU).
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from ..base import MXNetError, dtype_name
from ..ops.registry import register
from . import _build

__all__ = ["fused_scale_bias_act", "eligible", "shape_key_shapes",
           "DEFAULT_CONFIG", "OP_NAME", "launches", "reset_launches"]

OP_NAME = "scale_bias_act"
# CUDA launch shape: threads per block and the grid-stride loop's cap
DEFAULT_CONFIG = {"threads": 256, "max_blocks": 2048}

_ACTS = ("gelu", "relu", "identity")
_ACT_CODE = {"identity": 0, "relu": 1, "gelu": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()

_SIGNATURES = {
    "mxk_scale_bias_act": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)),
    "mxk_error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}


def reset_launches():
    global launches
    with _count_lock:
        launches = 0


# ------------------------------------------------------------------ guard
def eligible(shape, dtype, act="gelu", scale_shape=None, bias_shape=None):
    """Strict guard; None when dispatchable, else the reason."""
    if len(shape) < 2:
        return "data must be >= 2-D (rows, features), got %d-D" % len(shape)
    if dtype not in _DTYPE_CODE:
        return "dtype must be f32 or bf16, got %s" % dtype_name(dtype)
    if act not in _ACTS:
        return "unsupported activation %r" % (act,)
    F_ = shape[-1]
    for nm, s in (("scale", scale_shape), ("bias", bias_shape)):
        if s is not None and tuple(s) != (F_,):
            return "%s shape %s != (features,)=(%d,)" % (nm, tuple(s), F_)
    if F_ < 1:
        return "empty feature dim"
    return None


def shape_key_shapes(shape):
    """Tuner key: the flattened (rows, features) view."""
    rows = 1
    for d in shape[:-1]:
        rows *= d
    return ((rows, shape[-1]),)


# ----------------------------------------------------------------- kernel
def _act(y, act):
    if act == "gelu":
        return F.gelu(y)
    if act == "relu":
        return torch.relu(y)
    return y


def _plain_scale_bias_act(x, scale, bias, act):
    """act(x * scale + bias) in f32, one rounding to x's dtype: the
    kernel's function in plain torch."""
    y = x.float()
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return _act(y, act).to(x.dtype)


def _reference(x, scale, bias, act):
    """The JAX package's ``_reference``: the same function in x's dtype;
    its vjp is the fused op's gradient."""
    y = x
    if scale is not None:
        y = y * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return _act(y, act)


def _launch(x, scale, bias, act, config):
    """Launch csrc/scale_bias_act.cu on the current stream of x's
    device; x is contiguous, scale/bias f32 (features,) vectors or
    None."""
    global launches
    if x.dtype not in _DTYPE_CODE:
        raise MXNetError("scale_bias_act kernel: dtype must be f32 or bf16, "
                         "got %s" % dtype_name(x.dtype))
    if x.dim() < 2 or not x.is_contiguous() or x.numel() == 0:
        raise MXNetError("scale_bias_act kernel: x must be a contiguous, "
                         "non-empty (..., features) tensor, got shape %s "
                         "strides %s" % (tuple(x.shape), x.stride()))
    if act not in _ACT_CODE:
        raise MXNetError("scale_bias_act kernel: unsupported activation %r"
                         % (act,))
    f = x.shape[-1]
    for nm, v in (("scale", scale), ("bias", bias)):
        if v is not None and (v.dtype != torch.float32 or v.device != x.device
                              or tuple(v.shape) != (f,)
                              or not v.is_contiguous()):
            raise MXNetError("scale_bias_act kernel: %s must be %d "
                             "contiguous f32 values on %s" % (nm, f,
                                                              x.device))
    lib = _build.load("scale_bias_act", _SIGNATURES)
    y = torch.empty_like(x)
    vec = 4 if (f % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
                and y.data_ptr() % (4 * y.element_size()) == 0) else 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mxk_scale_bias_act(
            x.data_ptr(), None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            x.numel(), f, _DTYPE_CODE[x.dtype], _ACT_CODE[act], vec,
            int(config["threads"]), int(config["max_blocks"]), stream)
    if err != 0:
        raise MXNetError("scale_bias_act kernel launch failed: CUDA error %d "
                         "(%s)" % (err, lib.mxk_error_string(err).decode()))
    with _count_lock:
        launches += 1
    return y


def _epilogue(x, scale, bias, act, config):
    if x.device.type == "cuda":
        sc = None if scale is None else scale.float().contiguous()
        b = None if bias is None else bias.float().contiguous()
        return _launch(x.contiguous(), sc, b, act, config)
    if x.device.type in ("cpu", "meta"):
        return _plain_scale_bias_act(x, scale, bias, act)
    raise MXNetError("scale_bias_act: no kernel for %s tensors"
                     % x.device.type)


class _ScaleBiasAct(torch.autograd.Function):
    """Forward: the kernel (its plain version on the CPU). Backward: the
    vjp of :func:`_reference`, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, act, config):
        ctx.act = act
        ctx.save_for_backward(x, scale, bias)
        return _epilogue(x, scale, bias, act, config)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        leaves = [None if t is None else t.detach().requires_grad_(True)
                  for t in (x, scale, bias)]
        want = [t for t in leaves if t is not None]
        with torch.profiler.record_function("scale_bias_act.backward"), \
                torch.enable_grad():
            y = _reference(*leaves, ctx.act)
            grads = iter(torch.autograd.grad(y, want, g))
        out = [None if t is None else next(grads) for t in leaves]
        return out[0], out[1], out[2], None, None


# ------------------------------------------------------------------ public
def fused_scale_bias_act(x, scale=None, bias=None, *, act="gelu",
                         config=None):
    """``act(x * scale + bias)`` with per-feature f32 coefficients in one
    pass; ``scale``/``bias`` are optional (features,) vectors. Raises on
    guard failure."""
    reason = eligible(tuple(x.shape), x.dtype, act=act,
                      scale_shape=None if scale is None else scale.shape,
                      bias_shape=None if bias is None else bias.shape)
    if reason is not None:
        raise ValueError("fused_scale_bias_act guard: %s" % reason)
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    return _ScaleBiasAct.apply(x, scale, bias, act, cfg)


@register("_contrib_FusedScaleBiasGeLU")
def _contrib_fused_scale_bias_gelu(data, scale=None, bias=None, *,
                                   act_type="gelu"):
    """Per-feature scale+bias+activation as a registered op."""
    return fused_scale_bias_act(data, scale, bias, act=act_type)
