"""Fused BatchNorm -> (+residual) -> activation epilogue.

Counterpart of ``mxnet_tpu/kernels/bn_act.py``. The per-channel f32
coefficients ``sc = gamma * rsqrt(var + eps)`` and ``sh = beta - mean *
sc`` are computed with plain torch (:func:`_coefs`); the bandwidth-bound
pass ``act(x * sc + sh [+ residual])`` over the activation tensor is the
hand-written CUDA kernel ``csrc/bn_act.cu`` (forms ``bn_act`` and
``bn_act_res``, the TPU kernels ``mxk_bn_act`` / ``mxk_bn_act_res``).

The wrapper launches the kernel for a CUDA tensor, and raises on what
the kernel does not take; a CPU tensor takes :func:`_plain_epilogue`,
the same function in plain torch. Every launch adds one to ``launches``
and to its form's entry in ``launches_by_kernel``; nothing else does.

The gradient (:class:`_BnAct`'s backward) differentiates
:func:`_reference`, the unfused BatchNorm -> (+residual) -> act op
composition, recomputed from the saved inputs, as the JAX package's
``_fused_bwd`` does; it launches no kernel. The statistic outputs carry
no gradient.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError, dtype_name
from . import _build

__all__ = ["fused_bn_act", "eligible", "shape_key_shapes", "DEFAULT_CONFIG",
           "OP_NAME", "launches", "launches_by_kernel", "reset_launches"]

OP_NAME = "bn_act"
# CUDA launch shape: threads per block, and the cap on blocks past which
# the kernel's grid-stride loops take the rest (the default, 2^31 - 1, is
# CUDA's largest grid: every block one pass, which ran faster on the H100
# than one wave of resident blocks looping)
DEFAULT_CONFIG = {"threads": 256, "max_blocks": 2147483647}

_ACTS = ("relu", "identity")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
launches_by_kernel = {"bn_act": 0, "bn_act_res": 0}
_count_lock = threading.Lock()

_SIGNATURES = {
    "mxk_bn_act": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
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
def eligible(shape, dtype, axis=1, act="relu", residual_shape=None):
    """Strict guard; None when dispatchable, else the JAX package's
    reason string."""
    if len(shape) != 4:
        return "data must be NCHW 4-D, got %d-D" % len(shape)
    if axis % len(shape) != 1:
        return "channel axis must be 1 (NCHW), got %d" % axis
    if dtype not in _DTYPE_CODE:
        return "dtype must be f32 or bf16, got %s" % dtype_name(dtype)
    if act not in _ACTS:
        return "unsupported activation %r" % (act,)
    if residual_shape is not None and tuple(residual_shape) != tuple(shape):
        return "residual shape %s != data shape %s" % (
            tuple(residual_shape), tuple(shape))
    if shape[0] * shape[1] < 1 or shape[2] * shape[3] < 1:
        return "empty tensor"
    return None


def shape_key_shapes(shape):
    """Shapes the tier keys this op on: the flattened (rows, cols) view."""
    N, C, H, W = shape
    return ((N * C, H * W),)


# ----------------------------------------------------------- coefficients
def _coefs(data, gamma, beta, moving_mean, moving_var, *, eps, momentum,
           fix_gamma, use_global_stats, training):
    """f32 per-channel (sc, sh) and the BatchNorm statistic outputs
    (mean, var, new_moving_mean, new_moving_var), with the statistics of
    ``ops.nn.batch_norm``: low-precision training data through its
    widened f32 sums."""
    from ..ops import nn as _nn
    g32 = torch.ones_like(gamma, dtype=torch.float32) if fix_gamma \
        else gamma.float()
    b32 = beta.float()
    if training and not use_global_stats:
        if data.dtype in (torch.bfloat16, torch.float16):
            mean, var = _nn._bn_lowp_stats(data, (0, 2, 3))
        else:
            mean = data.mean((0, 2, 3))
            var = data.var((0, 2, 3), correction=0)
        new_mean = moving_mean * momentum + mean * (1.0 - momentum)
        new_var = moving_var * momentum + var * (1.0 - momentum)
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    sc = torch.rsqrt(var.float() + eps) * g32
    sh = b32 - mean.float() * sc
    return sc, sh, mean, var, new_mean, new_var


# ----------------------------------------------------------------- kernel
def _plain_epilogue(x, sc, sh, r, act):
    """act(x * sc + sh [+ r]) in f32, one rounding to x's dtype: the
    kernel's function in plain torch."""
    shape = (1, x.shape[1], 1, 1)
    y = x.float() * sc.reshape(shape) + sh.reshape(shape)
    if r is not None:
        y = y + r.float()
    if act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x, sc, sh, r, act):
    if x.dtype not in _DTYPE_CODE:
        raise MXNetError("bn_act kernel: dtype must be f32 or bf16, got %s"
                         % dtype_name(x.dtype))
    if x.dim() != 4 or not x.is_contiguous():
        raise MXNetError("bn_act kernel: x must be contiguous NCHW, got "
                         "shape %s strides %s" % (tuple(x.shape),
                                                  x.stride()))
    C = x.shape[1]
    for nm, v in (("sc", sc), ("sh", sh)):
        if (v.dtype != torch.float32 or v.device != x.device
                or v.numel() != C or not v.is_contiguous()):
            raise MXNetError("bn_act kernel: %s must be %d contiguous f32 "
                             "values on %s" % (nm, C, x.device))
    if r is not None and (r.shape != x.shape or r.dtype != x.dtype
                          or r.device != x.device
                          or not r.is_contiguous()):
        raise MXNetError("bn_act kernel: residual must match x (%s %s on "
                         "%s, contiguous)" % (tuple(x.shape), x.dtype,
                                              x.device))
    if act not in _ACTS:
        raise MXNetError("bn_act kernel: unsupported activation %r"
                         % (act,))


def _launch(x, sc, sh, r, act, config):
    """Launch csrc/bn_act.cu on the current stream of x's device."""
    global launches
    _check(x, sc, sh, r, act)
    lib = _build.load("bn_act", _SIGNATURES)
    y = torch.empty_like(x)
    N, C, H, W = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mxk_bn_act(
            x.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            None if r is None else r.data_ptr(), y.data_ptr(),
            x.numel(), H * W, C, _DTYPE_CODE[x.dtype],
            1 if act == "relu" else 0, int(config["threads"]),
            int(config["max_blocks"]), stream)
    if err != 0:
        raise MXNetError("bn_act kernel launch failed: CUDA error %d (%s)"
                         % (err, lib.mxk_error_string(err).decode()))
    with _count_lock:
        launches += 1
        launches_by_kernel["bn_act" if r is None else "bn_act_res"] += 1
    return y


def _epilogue(x, sc, sh, r, act, config):
    if x.device.type == "cuda":
        return _launch(x, sc, sh, r, act, config)
    if x.device.type == "cpu":
        return _plain_epilogue(x, sc, sh, r, act)
    raise MXNetError("bn_act: no kernel for %s tensors" % x.device.type)


def _reference(data, gamma, beta, moving_mean, moving_var, residual, act,
               **kw):
    """The unfused op composition the backward differentiates."""
    from ..ops import nn as _nn
    out = _nn.batch_norm(data, gamma, beta, moving_mean, moving_var,
                         eps=kw["eps"], momentum=kw["momentum"],
                         fix_gamma=kw["fix_gamma"],
                         use_global_stats=kw["use_global_stats"], axis=1,
                         _training=kw["training"])[0]
    if residual is not None:
        out = out + residual
    return torch.relu(out) if act == "relu" else out


class _BnAct(torch.autograd.Function):
    """Forward: the coefficients in plain torch, then the kernel (its
    plain version on the CPU). Backward: the vjp of :func:`_reference`
    for data, gamma, beta and the residual."""

    @staticmethod
    def forward(ctx, data, gamma, beta, moving_mean, moving_var, residual,
                kw, act, config):
        ctx.kw, ctx.act = kw, act
        ctx.save_for_backward(data, gamma, beta, moving_mean, moving_var,
                              residual)
        with torch.profiler.record_function("bn_act.coefs"):
            sc, sh, mean, var, new_mean, new_var = _coefs(
                data, gamma, beta, moving_mean, moving_var, **kw)
        out = _epilogue(data, sc, sh, residual, act, config)
        ctx.mark_non_differentiable(mean, var, new_mean, new_var)
        return out, mean, var, new_mean, new_var

    @staticmethod
    def backward(ctx, g, *_stat_grads):
        data, gamma, beta, mm, mv, residual = ctx.saved_tensors
        leaves = [None if t is None else t.detach().requires_grad_(True)
                  for t in (data, gamma, beta, residual)]
        want = [t for t in leaves if t is not None]
        with torch.profiler.record_function("bn_act.backward"), \
                torch.enable_grad():
            y = _reference(leaves[0], leaves[1], leaves[2], mm, mv,
                           leaves[3], ctx.act, **ctx.kw)
            # fix_gamma leaves gamma out of the graph: its gradient is 0
            grads = iter(torch.autograd.grad(y, want, g, allow_unused=True))
        dd, dg, db, dr = [None if t is None else next(grads) for t in leaves]
        if dg is None:
            dg = torch.zeros_like(gamma)
        return dd, dg, db, None, None, dr, None, None, None


# ------------------------------------------------------------------ public
def fused_bn_act(data, gamma, beta, moving_mean, moving_var, residual=None,
                 *, eps=1e-3, momentum=0.9, fix_gamma=True,
                 use_global_stats=False, act="relu", training=True,
                 config=None):
    """BatchNorm -> (+residual) -> act in one epilogue pass.

    Same 5-output contract as the registered BatchNorm op,
    ``(out, batch_mean, batch_var, new_moving_mean, new_moving_var)``,
    with ``out`` already activated.
    """
    reason = eligible(tuple(data.shape), data.dtype, act=act,
                      residual_shape=None if residual is None
                      else tuple(residual.shape))
    if reason is not None:
        raise ValueError("fused_bn_act guard: %s" % reason)
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    kw = dict(eps=float(eps), momentum=float(momentum),
              fix_gamma=bool(fix_gamma),
              use_global_stats=bool(use_global_stats),
              training=bool(training))
    return _BnAct.apply(data, gamma, beta, moving_mean, moving_var,
                        residual, kw, act, cfg)


# ------------------------------------------------- the registered op surface
from ..ops.registry import register as _register  # noqa: E402
from ..ops.registry import set_op_meta as _set_op_meta  # noqa: E402


@_register("_contrib_FusedBNAct", num_outputs=5)
def _contrib_fused_bn_act(data, gamma, beta, moving_mean, moving_var,
                          residual=None, *, eps=1e-3, momentum=0.9,
                          fix_gamma=True, use_global_stats=False,
                          act="relu", _training=True):
    """BatchNorm -> (+residual) -> act as a registered op
    (``nd.contrib.FusedBNAct``, ``F.contrib.FusedBNAct``): the five
    outputs of :func:`fused_bn_act`, the activated one visible, the
    moving statistics written back through the aux slots (3, 4). A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes its plain
    version."""
    return fused_bn_act(data, gamma, beta, moving_mean, moving_var,
                        residual, eps=eps, momentum=momentum,
                        fix_gamma=fix_gamma,
                        use_global_stats=use_global_stats, act=act,
                        training=_training)


_set_op_meta("_contrib_FusedBNAct", aux_inputs=(3, 4), aux_outputs=(3, 4),
             num_visible_outputs=1)
