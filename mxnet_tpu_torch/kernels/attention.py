"""Flash attention, dense (with its backward) and paged.

Counterpart of ``mxnet_tpu/kernels/attention.py``. One online-softmax
recurrence (f32 running max, sum and accumulator; masked scores -1e30
BEFORE the max so an excluded position contributes an exact 0.0; output
``acc / max(l, 1e-30)``) behind two tier ops, each a hand-written CUDA
kernel:

* ``flash_attn`` (``csrc/flash_attn.cu``, the TPU kernel
  ``mxk_flash_attn``): causal self-attention over dense ``(B, H, T, D)``
  tensors, with causal tile pruning. It serves prefill.
* ``flash_attn_paged`` (``csrc/flash_attn_paged.cu``,
  ``mxk_flash_attn_paged``): ``(S, W, C)`` queries over the flat
  ``(rows, C)`` page store through the ``(S, MP)`` block table; query
  row ``w`` of slot ``s`` sees positions ``t <= positions[s] + w``. It
  serves the decode step (W = 1) and the chunked-prefill chunk (S = 1).

The paged op's non-finite contract is the JAX kernel's. That kernel
visits every listed page of a slot and adds ``p @ V`` with p = 0 at
masked positions, so:

* a non-finite V value at a position masked for row ``w`` (``t >
  positions[s] + w``), in any page ``block_tables[s, :]`` lists, makes
  row ``w``'s column NaN (``0 * inf = 0 * NaN = NaN``): a page wholly
  past the position counts, and so does the masked tail of the last
  visible page;
* a non-finite K value at a masked position changes nothing (its score
  is replaced by a select before the max);
* non-finite values at visible positions propagate as the plain version
  propagates them (+inf in V with p > 0 gives inf, not NaN).

:func:`_plain_paged` gathers every listed row and computes exactly that;
the CUDA kernel reads V, not K, at positions no query row of its block
sees and accumulates ``0 * V`` for them, scanning a run of equal
trailing block-table entries once (serving lists the scratch page 0 in
every unused entry). ``tests/paged_nonfinite.py`` plants the cases.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; CPU tensors take the plain torch version beside
it (:func:`_plain_flash`, :func:`_plain_paged`), the same function.
Every launch adds one to its kernel's entry in ``launches_by_kernel``;
nothing else does. ``flash_attention`` is differentiable: its backward
is the vjp of :func:`reference_attention`, recomputed in plain torch as
the JAX package's ``custom_vjp`` recomputes it (no backward kernel);
the paged op serves decoding and has no backward.

Guards keep the JAX package's reason strings where the rule is about
the function: rank, dtype, k/v shape mismatch, causal cross-length,
divisibility of the dim by the heads, page-store rows by ``page_size``,
block-table and position shapes. Dropped, because they exist only for
the TPU: "symbolic dimension" (the port's engines run with concrete
shapes, so prefill's attention dispatches here where the JAX package's
exported prefill falls back), "head_dim exceeds the 512 VMEM plan",
"page_size not sublane-aligned (multiple of 8)" and the Mosaic lane
rule behind ``_paged_block_h``. Added, the CUDA kernels' own limit:
"head_dim %d exceeds the CUDA kernel's 128-wide tile" for both ops.
So where ``tests/test_attention_kernel.py`` shows the JAX package
falling back at ``page_size=4``, the port dispatches: any page size is
served.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..base import MXNetError, dtype_name
from . import _build
from . import tier as _tier

__all__ = ["flash_attention", "attend_or_none", "reference_attention",
           "paged_attention", "paged_attend_or_none",
           "eligible", "paged_eligible",
           "shape_key_shapes", "paged_shape_key_shapes",
           "OP_NAME", "PAGED_OP_NAME", "DEFAULT_CONFIG",
           "PAGED_DEFAULT_CONFIG", "launches_by_kernel", "reset_launches"]

OP_NAME = "flash_attn"
PAGED_OP_NAME = "flash_attn_paged"
# the compiled tiles, recorded by the tier (the kernels take no others):
# 128 q rows (two warpgroups; 64 for head dims over 64) x 64 kv rows per
# CTA; 8 query rows (1 at W = 1) x 4 warps per CTA, each warp streaming
# units of 16 positions through 2 stages
DEFAULT_CONFIG = {"block_q": 128, "block_k": 64}
PAGED_DEFAULT_CONFIG = {"block_rows": 8, "warps": 4, "unit": 16, "stages": 2}
MAX_HEAD_DIM = 128

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches_by_kernel = {OP_NAME: 0, PAGED_OP_NAME: 0}
_count_lock = threading.Lock()

_SIGNATURES = {
    "flash_attn": {
        "mxk_flash_attn": (ctypes.c_int, (
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p)),
        "mxk_error_string": (ctypes.c_char_p, (ctypes.c_int,)),
    },
    "flash_attn_paged": {
        "mxk_flash_attn_paged": (ctypes.c_int, (
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p)),
        "mxk_error_string": (ctypes.c_char_p, (ctypes.c_int,)),
    },
}


def reset_launches():
    with _count_lock:
        for k in launches_by_kernel:
            launches_by_kernel[k] = 0


def _count(name):
    with _count_lock:
        launches_by_kernel[name] += 1


def _head_dim_reason(d):
    if d > MAX_HEAD_DIM:
        return "head_dim %d exceeds the CUDA kernel's %d-wide tile" % (
            d, MAX_HEAD_DIM)
    return None


# ------------------------------------------------------------- reference
def reference_attention(q, k, v, causal=True):
    """Dense attention over (B, H, T, D) in plain torch: the numerics
    oracle. f32 score/softmax math whatever the input dtype, masked
    scores an exact -1e30 before the max; cross-length causal masks take
    the diagonal offset ``tk - tq``."""
    tq, tk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[3])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None]
        kpos = torch.arange(tk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos + (tk - tq), s,
                        torch.full((), _NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def _masked_softmax(s, mask):
    """The kernels' softmax in plain torch: scores ``s`` (already
    scaled, f32) with a boolean ``mask`` broadcast to them -> ``(p, l)``
    with p forced to 0 where masked and ``l = max(sum p, 1e-30)``; the
    caller divides ``p @ v`` by ``l``."""
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros((), device=s.device))
    return p, p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


# ------------------------------------------------- dense kernel (prefill)
def _plain_flash(q, k, v, causal):
    """The flash kernel's function in plain torch (q pre-scaled, f32)."""
    tq, tk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[3])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = kpos < tk
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None]
        mask = kpos <= qpos + (tk - tq)
    p, l = _masked_softmax(s, mask)
    return (torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l).to(q.dtype)


def _launch_flash(q, k, v, causal):
    """Launch csrc/flash_attn.cu on the current stream of q's device."""
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError("flash_attn kernel: dtype must be f32 or bf16, got "
                         "%s" % dtype_name(q.dtype))
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if (t.dim() != 4 or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise MXNetError("flash_attn kernel: %s must be a contiguous "
                             "(B, H, T, D) %s tensor on %s" % (
                                 nm, dtype_name(q.dtype), q.device))
    B, H, tq, d = q.shape
    tk = k.shape[2]
    if (tuple(k.shape) != (B, H, tk, d) or v.shape != k.shape
            or d > MAX_HEAD_DIM):
        raise MXNetError("flash_attn kernel: q %s, k %s, v %s (head_dim "
                         "<= %d)" % (tuple(q.shape), tuple(k.shape),
                                     tuple(v.shape), MAX_HEAD_DIM))
    lib = _build.load("flash_attn", _SIGNATURES["flash_attn"])
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mxk_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H,
            tq, tk, d, 1 if causal else 0, 1.0 / math.sqrt(d),
            _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise MXNetError("flash_attn kernel launch failed: CUDA error %d "
                         "(%s)" % (err, lib.mxk_error_string(err).decode()))
    _count(OP_NAME)
    return o


def eligible(q_shape, k_shape, v_shape, dtype, causal=True):
    """Strict guard for the dense op; None when dispatchable, else the
    fallback reason."""
    if len(q_shape) != 4 or len(k_shape) != 4 or len(v_shape) != 4:
        return "q/k/v must be (B, H, T, D) 4-D, got %d/%d/%d-D" % (
            len(q_shape), len(k_shape), len(v_shape))
    if dtype not in _DTYPE_CODE:
        return "dtype must be f32 or bf16, got %s" % dtype_name(dtype)
    if tuple(k_shape) != tuple(v_shape):
        return "k/v shapes differ: %s vs %s" % (tuple(k_shape),
                                               tuple(v_shape))
    if q_shape[0] != k_shape[0] or q_shape[1] != k_shape[1] \
            or q_shape[3] != k_shape[3]:
        return "q %s and kv %s disagree on batch/heads/head_dim" % (
            tuple(q_shape), tuple(k_shape))
    tq, tk = q_shape[2], k_shape[2]
    if tq < 1 or tk < 1:
        return "empty sequence"
    if causal and tq != tk:
        return "causal cross-length (tq=%d != tk=%d) not served by the " \
            "tier: fully-masked rows would take the kernel's zeros " \
            "convention, not the reference softmax" % (tq, tk)
    return _head_dim_reason(q_shape[3])


def shape_key_shapes(q_shape, k_shape):
    """Tuner key: (B*H, T, D) for the q and kv streams."""
    b, h, tq, d = q_shape
    return ((b * h, tq, d), (b * h, k_shape[2], d))


class _FlashAttn(torch.autograd.Function):
    """Forward: the kernel for CUDA tensors, its plain version for CPU
    tensors. Backward: the vjp of :func:`reference_attention`,
    recomputed from q, k, v (the JAX package's ``_fused_bwd``); it
    launches no kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        if q.device.type in ("cpu", "meta"):
            return _plain_flash(q, k, v, causal)
        if q.device.type != "cuda":
            raise MXNetError("flash_attn: no kernel for %s tensors"
                             % q.device.type)
        return _launch_flash(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = [t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors]
        # a named range, so that a profile can attribute the recompute
        with torch.profiler.record_function("flash_attn.backward"), \
                torch.enable_grad():
            o = reference_attention(q, k, v, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal=True):
    """Flash attention over (B, H, T, D): the kernel for CUDA tensors,
    its plain version for CPU tensors, differentiable through
    :class:`_FlashAttn`. Raises on guard failure (call-sites consult
    :func:`eligible`/:func:`attend_or_none`)."""
    reason = eligible(tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      q.dtype, causal=causal)
    if reason is not None:
        raise ValueError("flash_attn guard: %s" % reason)
    return _FlashAttn.apply(q, k, v, bool(causal))


def attend_or_none(q, k, v, *, causal=True):
    """Tier-dispatched attention: the kernel when the policy and the
    guard allow, None when the caller keeps its plain path (the
    per-site fallback reason is recorded either way)."""
    reason = eligible(tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      q.dtype, causal=causal)
    go, _cfg = _tier.should_dispatch(
        OP_NAME, shape_key_shapes(tuple(q.shape), tuple(k.shape))
        if reason is None else ((1, 1, 1), (1, 1, 1)),
        dtype_name(q.dtype), DEFAULT_CONFIG, guard_reason=reason)
    if not go:
        return None
    return flash_attention(q, k, v, causal=causal)


# --------------------------------------------------- paged kernel (serving)
def _context_rows(block_tables, page_size, rows):
    """(S, MP) block table -> (S, MP * page_size) flat store rows in
    logical position order, clipped to the store."""
    offs = torch.arange(page_size, device=block_tables.device)
    idx = block_tables.long()[:, :, None] * page_size + offs[None, None, :]
    return idx.reshape(block_tables.shape[0], -1).clamp(0, rows - 1)


def _plain_paged(q, k_pages, v_pages, block_tables, positions, heads,
                 page_size):
    """The paged kernel's function in plain torch: gather every context
    row through the block table, mask ``t <= positions[s] + w``."""
    S, W, C = q.shape
    dh = C // heads
    idx = _context_rows(block_tables, page_size, k_pages.shape[0])
    ctx = idx.shape[1]
    kh = k_pages[idx].float().reshape(S, ctx, heads, dh)
    vh = v_pages[idx].float().reshape(S, ctx, heads, dh)
    qh = q.float().reshape(S, W, heads, dh) * (1.0 / math.sqrt(dh))
    s = torch.einsum("swhd,sthd->shwt", qh, kh)
    qpos = (positions.long()[:, None]
            + torch.arange(W, device=q.device)[None, :])          # (S, W)
    tpos = torch.arange(ctx, device=q.device)
    mask = (tpos[None, None, :] <= qpos[:, :, None])[:, None]     # S,1,W,t
    p, l = _masked_softmax(s, mask)
    o = torch.einsum("shwt,sthd->swhd", p, vh) / l.permute(0, 2, 1, 3)
    return o.reshape(S, W, C).to(q.dtype)


def _launch_paged(q, k_pages, v_pages, block_tables, positions, heads,
                  page_size):
    """Launch csrc/flash_attn_paged.cu on the current stream of q's
    device."""
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError("flash_attn_paged kernel: dtype must be f32 or "
                         "bf16, got %s" % dtype_name(q.dtype))
    if q.dim() != 3 or not q.is_contiguous():
        raise MXNetError("flash_attn_paged kernel: q must be a contiguous "
                         "(S, W, C) tensor, got %s" % (tuple(q.shape),))
    S, W, C = q.shape
    for nm, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if (t.dim() != 2 or t.shape[1] != C or t.dtype != q.dtype
                or t.device != q.device or not t.is_contiguous()):
            raise MXNetError("flash_attn_paged kernel: %s must be a "
                             "contiguous (rows, %d) %s store on %s"
                             % (nm, C, dtype_name(q.dtype), q.device))
    for nm, t, shape in (("block_tables", block_tables,
                          (S, block_tables.shape[-1])),
                         ("positions", positions, (S,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != q.device or not t.is_contiguous()):
            raise MXNetError("flash_attn_paged kernel: %s must be a "
                             "contiguous int32 %s tensor on %s"
                             % (nm, shape, q.device))
    if C % heads or C // heads > MAX_HEAD_DIM or k_pages.shape != \
            v_pages.shape:
        raise MXNetError("flash_attn_paged kernel: dim %d over %d heads "
                         "(head_dim <= %d), k/v stores %s/%s"
                         % (C, heads, MAX_HEAD_DIM, tuple(k_pages.shape),
                            tuple(v_pages.shape)))
    lib = _build.load("flash_attn_paged", _SIGNATURES["flash_attn_paged"])
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mxk_flash_attn_paged(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), o.data_ptr(),
            S, W, C, heads, page_size, block_tables.shape[1],
            k_pages.shape[0], 1.0 / math.sqrt(C // heads),
            _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise MXNetError("flash_attn_paged kernel launch failed: CUDA error "
                         "%d (%s)" % (err,
                                      lib.mxk_error_string(err).decode()))
    _count(PAGED_OP_NAME)
    return o


def paged_eligible(q_shape, pages_shape, bt_shape, pos_shape, dtype,
                   heads, page_size):
    """Strict guard for the paged op; None when dispatchable, else the
    fallback reason."""
    if len(q_shape) != 3:
        return "q must be (slots, window, dim) 3-D, got %d-D" % \
            len(q_shape)
    if len(pages_shape) != 2:
        return "page store must be (rows, dim) 2-D, got %d-D" % \
            len(pages_shape)
    if dtype not in _DTYPE_CODE:
        return "dtype must be f32 or bf16, got %s" % dtype_name(dtype)
    S, W, C = q_shape
    if heads < 1 or C % heads != 0:
        return "dim %d not divisible by heads %d" % (C, heads)
    if pages_shape[1] != C:
        return "page store dim %d != q dim %d" % (pages_shape[1], C)
    if page_size < 1 or pages_shape[0] % page_size != 0:
        return "page store rows %d not a whole number of %d-row pages" % \
            (pages_shape[0], page_size)
    if len(bt_shape) != 2 or bt_shape[0] != S:
        return "block table must be (slots, max_pages), got %s" % \
            (tuple(bt_shape),)
    if len(pos_shape) != 1 or pos_shape[0] != S:
        return "positions must be (slots,), got %s" % (tuple(pos_shape),)
    if W < 1:
        return "empty query window"
    return _head_dim_reason(C // heads)


def paged_shape_key_shapes(q_shape, heads, page_size, bt_shape):
    """Tuner key: (slots, window, heads, head_dim) + (pages/slot, page)."""
    S, W, C = q_shape
    return ((S, W, heads, C // heads), (bt_shape[1], page_size))


def paged_attention(q, k_pages, v_pages, block_tables, positions, *,
                    heads, page_size):
    """Paged-KV flash attention: (S, W, C) queries over the flat
    (rows, C) page store through the (S, MP) block table. Query row
    ``w`` of slot ``s`` attends logical positions ``<= positions[s]+w``.
    The kernel for CUDA tensors, its plain version for CPU tensors.
    Raises on guard failure."""
    reason = paged_eligible(tuple(q.shape), tuple(k_pages.shape),
                            tuple(block_tables.shape),
                            tuple(positions.shape), q.dtype, heads,
                            page_size)
    if reason is not None:
        raise ValueError("flash_attn_paged guard: %s" % reason)
    if q.device.type == "cpu":
        return _plain_paged(q, k_pages, v_pages, block_tables, positions,
                            heads, page_size)
    if q.device.type != "cuda":
        raise MXNetError("flash_attn_paged: no kernel for %s tensors"
                         % q.device.type)
    return _launch_paged(q.contiguous(), k_pages, v_pages,
                         block_tables.to(torch.int32).contiguous(),
                         positions.to(torch.int32).contiguous(), heads,
                         page_size)


def paged_attend_or_none(q, k_pages, v_pages, block_tables, positions, *,
                         heads, page_size):
    """Tier-dispatched paged attention; None = keep the gather + softmax
    path (the reason is recorded per site)."""
    reason = paged_eligible(tuple(q.shape), tuple(k_pages.shape),
                            tuple(block_tables.shape),
                            tuple(positions.shape), q.dtype, heads,
                            page_size)
    go, _cfg = _tier.should_dispatch(
        PAGED_OP_NAME,
        paged_shape_key_shapes(tuple(q.shape), heads, page_size,
                               tuple(block_tables.shape))
        if reason is None else ((1, 1, 1, 1), (1, 8)),
        dtype_name(q.dtype), PAGED_DEFAULT_CONFIG, guard_reason=reason)
    if not go:
        return None
    return paged_attention(q, k_pages, v_pages, block_tables, positions,
                           heads=heads, page_size=page_size)
