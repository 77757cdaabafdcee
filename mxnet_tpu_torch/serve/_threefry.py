"""JAX's default PRNG, bit for bit, in torch: the sampling keys of decode.

The JAX package samples a token with ``jax.random.categorical(
fold_in(fold_in(PRNGKey(0), seed), position), logits / max(t, 1e-6))``
(``serve/decode_model.py`` ``_sample``). A torch generator would draw a
different stream, so the port carries the algorithm itself, as jax 0.9
defines it for its default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on:

* ``threefry2x32``: Threefry-2x32 with 20 rounds (five groups of four,
  rotations 13 15 26 6 / 17 29 16 24, key schedule with 0x1BD11BDA),
  shared with the random key chain (``mxnet_tpu_torch/random.py``).
* ``PRNGKey(0)`` is the pair (0, 0); ``fold_in(key, d)`` hashes the
  count pair (0, d) under ``key`` and the two outputs are the new key.
* 32 random bits for flat index i of an array: both hash outputs of the
  count pair (i >> 32, i & 0xFFFFFFFF), xor-ed.
* uniform in [tiny, 1): the top 23 bits as the mantissa of a float in
  [1, 2), minus 1, then ``max(tiny, f * (1 - tiny) + tiny)``.
* Gumbel ("low" mode, jax's default): ``-log(-log(u))``.
* ``categorical``: ``argmax(gumbel + logits)``, first index on ties.

Unsigned 32-bit words live in int64 tensors masked to 32 bits, so every
add, shift and rotate is exact on any device. The log is torch's, which
may round differently from XLA's in the last place; the tests hold the
bits and uniforms bitwise and the drawn tokens equal.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..random import _M32, threefry2x32  # noqa: F401

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "uniform",
           "gumbel", "categorical"]

_TINY = float(_np.finfo(_np.float32).tiny)


def prng_key(seed, device=None):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): the pair
    (seed >> 32, seed & 0xFFFFFFFF) as two int64 tensors."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return (s >> 32) & _M32, s & _M32


def fold_in(key, data):
    """``jax.random.fold_in``: ``data`` (int tensor, taken mod 2**32,
    any shape) folded into ``key`` -> a key of data's shape."""
    d = torch.as_tensor(data).to(torch.int64) & _M32
    k1, k2 = key
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def random_bits(key, n):
    """32 random bits for each of ``n`` flat indices under each key:
    keys of shape ``(B,)`` -> an int64 ``(B, n)`` tensor of uint32s."""
    k1, k2 = key
    i = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], i >> 32, i & _M32)
    return b1 ^ b2


def uniform(key, n):
    """``jax.random.uniform(key, (n,), minval=tiny, maxval=1.)`` in f32
    for each key: ``(B,)`` keys -> ``(B, n)``."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(_TINY, dtype=torch.float32, device=f.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=f.device) - lo
    return torch.maximum(lo, f * span + lo)


def gumbel(key, n):
    """``jax.random.gumbel(key, (n,))`` in f32 ("low" mode)."""
    return -torch.log(-torch.log(uniform(key, n)))


def categorical(key, logits):
    """``jax.random.categorical`` over the last axis of ``(B, V)`` f32
    logits with ``(B,)`` keys -> ``(B,)`` int64 draws."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
