"""The legacy flash-attention forward and the ``_contrib_FlashAttention`` op.

Counterpart of ``mxnet_tpu/ops/pallas_flash.py``. :func:`flash_attention`
over (B, H, T, D) is the hand-written CUDA kernel ``csrc/flash_fwd.cu``
(the TPU kernel at ``pallas_flash.py:121``): q scaled before the dot,
f32 running max, sum and accumulator, scores masked to -1e30 before the
max (tail, and ``kv <= q + (tk - tq)`` when causal), each probability
rounded to V's dtype before the PV product, output
``acc / max(l, 1e-30)``, so a fully masked row (causal with tq > tk) is
exactly 0. ``block_q``/``block_k`` are recorded for the call: they chose
the TPU's tiles and do not change the function; the CUDA kernel keeps
its own K/V tile of 64 rows (``KV_TILE``), at which its running max
moves, so where a bf16 p rounds. The plain version is
:func:`~mxnet_tpu_torch.parallel.blockwise_attention` over the caller's
``block_k`` blocks, as the TPU kernel walks them: a CPU tensor takes
it, and the gradient (:class:`_FlashFwd`'s backward) differentiates it,
recomputed from q, k, v, as the JAX package's ``_bwd`` does; the
backward launches no kernel. Every launch of the forward adds
one to ``launches``; nothing else does.

The registered op keeps the JAX package's dispatch: the kernel tier's
``kernels.attention.attend_or_none`` first (``mxk_flash_attn``), and
this kernel where the tier is off or its guard declines the site.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..base import MXNetError, dtype_name
from ..kernels import _build
from ..parallel import blockwise_attention
from .registry import register

__all__ = ["flash_attention", "launches", "reset_launches", "KV_TILE"]

KV_TILE = 64          # the CUDA kernel's K/V tile: its running max step
MAX_HEAD_DIM = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()

_SIGNATURES = {
    "mxk_flash_fwd": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p)),
    "mxk_error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}


def reset_launches():
    global launches
    with _count_lock:
        launches = 0


def _launch(q, k, v, causal):
    """Launch csrc/flash_fwd.cu on the current stream of q's device."""
    global launches
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError("flash_fwd kernel: dtype must be f32 or bf16, got "
                         "%s" % dtype_name(q.dtype))
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if (t.dim() != 4 or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise MXNetError("flash_fwd kernel: %s must be a contiguous "
                             "(B, H, T, D) %s tensor on %s"
                             % (nm, dtype_name(q.dtype), q.device))
    B, H, tq, d = q.shape
    tk = k.shape[2]
    if (tuple(k.shape) != (B, H, tk, d) or v.shape != k.shape
            or d > MAX_HEAD_DIM or q.numel() == 0 or k.numel() == 0):
        raise MXNetError("flash_fwd kernel: q %s, k %s, v %s (non-empty, "
                         "head_dim <= %d)" % (tuple(q.shape), tuple(k.shape),
                                              tuple(v.shape), MAX_HEAD_DIM))
    lib = _build.load("flash_fwd", _SIGNATURES)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mxk_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H,
            tq, tk, d, 1 if causal else 0, 1.0 / math.sqrt(d),
            _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise MXNetError("flash_fwd kernel launch failed: CUDA error %d (%s)"
                         % (err, lib.mxk_error_string(err).decode()))
    with _count_lock:
        launches += 1
    return o


class _FlashFwd(torch.autograd.Function):
    """Forward: the kernel (its plain version on the CPU). Backward: the
    vjp of the plain blockwise attention over ``block_k`` blocks."""

    @staticmethod
    def forward(ctx, q, k, v, block_k, causal):
        ctx.save_for_backward(q, k, v)
        ctx.block_k, ctx.causal = block_k, causal
        if q.device.type == "cuda":
            return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal)
        if q.device.type in ("cpu", "meta"):
            return blockwise_attention(q, k, v, block_size=block_k,
                                       causal=causal)
        raise MXNetError("flash_fwd: no kernel for %s tensors"
                         % q.device.type)

    @staticmethod
    def backward(ctx, g):
        q, k, v = [t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors]
        with torch.profiler.record_function("flash_fwd.backward"), \
                torch.enable_grad():
            o = blockwise_attention(q, k, v, block_size=ctx.block_k,
                                    causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, block_q=128, block_k=128, causal=False):
    """Flash attention over (B, H, T, D): the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors; f32 accumulation
    whatever the input dtype; fully masked rows are 0."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q/k/v must be (B, H, T, D)")
    return _FlashFwd.apply(q, k, v, int(block_k), bool(causal))


@register("_contrib_FlashAttention")
def _contrib_flash_attention(q, k, v, *, causal=False, block_q=128,
                             block_k=128):
    """(B, H, T, D) flash attention as a registered op: the tier's
    ``flash_attn`` when the policy and its guard allow, else the legacy
    flash forward with the caller's block sizes (the guard's reason is
    recorded in ``tier.stats()['fallback']``)."""
    from ..kernels import attention as _attn
    out = _attn.attend_or_none(q, k, v, causal=bool(causal))
    if out is not None:
        return out
    return flash_attention(q, k, v, block_q, block_k, bool(causal))
