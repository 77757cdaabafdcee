"""Blockwise (flash-pattern) attention in plain torch.

Counterpart of :func:`blockwise_attention` in
``mxnet_tpu/parallel/ring_attention.py``: an online softmax over KV
blocks, f32 running max, denominator and numerator whatever the input
dtype, each block's probabilities rounded to V's dtype before the PV
product, fully masked rows giving zeros. Torch autograd differentiates
it; it is the backward oracle of the legacy flash forward
(``ops/pallas_flash.py``). Ring attention over a sequence-parallel mesh
waits for the distributed slice.

Shapes follow (batch, heads, seq, head_dim).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["blockwise_attention"]

_NEG_INF = -1e30


def _block_update(qs, k_blk, v_blk, m, l, o, mask):
    """One online-softmax accumulation step (the JAX ``_block_update``)
    on the f32 scaled queries ``qs``: scores and accumulators in f32, p
    rounded to V's dtype for PV."""
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k_blk.float())
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=s.device))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    p = torch.where(mask, p, torch.zeros((), device=s.device))
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    o_new = o * corr + torch.einsum("bhqk,bhkd->bhqd",
                                    p.to(v_blk.dtype).float(),
                                    v_blk.float())
    return m_new, l_new, o_new


def blockwise_attention(q, k, v, block_size=512, causal=False):
    """Memory-efficient attention: a loop over KV blocks (flash
    pattern). Cross-length causal masks take the diagonal offset
    ``tk - tq``; rows that see no key are 0."""
    b, h, t, d = q.shape
    tk = k.shape[2]
    block_size = min(block_size, tk)
    n_blocks = (tk + block_size - 1) // block_size
    pad = n_blocks * block_size - tk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    dev = q.device
    # q is scaled in f32 before the dot, as the flash kernels scale it
    # (the JAX function scales the scores: the same up to an f32 ulp,
    # but in bf16 that ulp can move where p rounds to V's dtype)
    qs = q.float() * (1.0 / math.sqrt(d))
    q_pos = torch.arange(t, device=dev)[:, None]
    m = torch.full((b, h, t, 1), _NEG_INF, device=dev)
    l = torch.zeros((b, h, t, 1), device=dev)
    o = torch.zeros((b, h, t, d), device=dev)
    for i in range(n_blocks):
        lo = i * block_size
        kv_pos = lo + torch.arange(block_size, device=dev)[None, :]
        mask = kv_pos < tk
        if causal:
            mask = mask & (kv_pos <= q_pos + (tk - t))
        m, l, o = _block_update(qs, k[:, :, lo:lo + block_size],
                                v[:, :, lo:lo + block_size], m, l, o,
                                mask[None, None])
    return (o / l.clamp_min(1e-30)).to(q.dtype)
