"""Port parity for the legacy flash forward (B7), its backward oracle
``blockwise_attention`` and the ``_contrib_FlashAttention`` op.

The port's ``ops.pallas_flash.flash_attention`` runs its plain torch
version on CPU tensors (the online softmax over the caller's
``block_k`` blocks); it is held against the JAX package's Pallas kernel
in interpret mode on the same numpy inputs, forward and ``jax.grad``:
causal and not, cross-length with fully masked rows (exactly 0 on both
sides), blocks that do not divide T. f32 within atol/rtol 1e-5 (the same
recurrence, summed in another order); bf16 forward within one bf16 ulp
plus 1e-3.

The CUDA kernel's tensor-core products are emulated by the attention
tests' ``_tc_flash`` (3 terms f32; bf16: 2 for the scaled q against K,
1 for the bf16-rounded p against V) and held against the JAX kernel at
the card's tolerance (f32 atol 2e-5, rtol 1e-4; bf16 one bf16 ulp plus
1e-3), with the KV tile at which the running max moves (``KV_TILE``).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import config as jconfig
from mxnet_tpu.kernels import tier as jtier
from mxnet_tpu.ops import pallas_flash as jpf
from mxnet_tpu.parallel.ring_attention import blockwise_attention as jblockwise

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import attention as tattn
from mxnet_tpu_torch.kernels import tier as ttier
from mxnet_tpu_torch.ops import pallas_flash as tpf
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.parallel import blockwise_attention

from test_torch_port_attention import _card_close, _tc_flash


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(b, h, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, tq, d) / math.sqrt(d)).astype(np.float32)
    k = (rng.randn(b, h, tk, d) / math.sqrt(d)).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    return q, k, v


# (tq, tk, block_q, block_k, causal): square, uneven blocks, non-causal
# cross-length, causal cross-length with tq > tk (fully masked rows)
CASES = [(32, 32, 16, 16, True), (40, 40, 16, 16, True),
         (24, 40, 8, 16, False), (24, 40, 8, 16, True),
         (20, 12, 8, 8, True), (33, 33, 128, 128, False)]


@pytest.mark.parametrize("case", CASES)
def test_forward_and_grads_match_the_jax_kernel(case):
    tq, tk, bq, bk, causal = case
    q, k, v = _qkv(2, 2, tq, tk, 8, seed=tq + tk)
    cot = np.random.RandomState(1).randn(2, 2, tq, 8).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    jout = _f32(jpf.flash_attention(*jargs, bq, bk, causal))
    jgrads = jax.grad(lambda a, b, c: jnp.sum(
        jpf.flash_attention(a, b, c, bq, bk, causal) * jnp.asarray(cot)),
        argnums=(0, 1, 2))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tpf.flash_attention(*leaves, block_q=bq, block_k=bk,
                              causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-5)
    if causal and tq > tk:
        dead = tq - tk            # rows that see no key
        assert (out[:, :, :dead] == 0).all() and (jout[:, :, :dead] == 0).all()
    (out * torch.from_numpy(cot)).sum().backward()
    for leaf, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), _f32(jg), rtol=1e-5,
                                   atol=1e-5)
    assert tpf.launches == 0


# (tq, tk, causal, d): square causal and not, a ragged tail at d 16,
# causal cross-length with fully masked rows (tq > tk) and with tq < tk
TC_CASES = [(128, 128, True, 64), (128, 128, False, 64),
            (100, 100, True, 16), (100, 60, True, 64), (60, 100, True, 16)]


@pytest.mark.parametrize("case", TC_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_split_matches_the_jax_kernel(case, dtype):
    tq, tk, causal, d = case
    rng = np.random.RandomState(tq + tk + d)
    q = rng.randn(1, 2, tq, d).astype(np.float32)
    k, v = (rng.randn(1, 2, tk, d).astype(np.float32) for _ in range(2))
    jdt = getattr(jnp, dtype)
    want = _f32(jpf.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                    tpf.KV_TILE, tpf.KV_TILE, causal))
    got = _tc_flash(*(torch.from_numpy(a).to(getattr(torch, dtype))
                      for a in (q, k, v)), causal, round_p=True,
                    kv_tile=tpf.KV_TILE)
    assert _card_close(got, want, dtype) == 0
    if causal and tq > tk:
        assert (got[:, :, :tq - tk] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_forward_matches_the_jax_kernel(causal):
    q, k, v = _qkv(1, 2, 48, 48, 16, seed=5)
    jout = _f32(jpf.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                      for a in (q, k, v)), 16, 16, causal))
    out = tpf.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)), block_q=16,
                              block_k=16, causal=causal).float().numpy()
    ulp = np.maximum(np.abs(out), np.abs(jout)) * 2.0 ** -7
    assert (np.abs(out - jout) <= ulp + 1e-3).all()


@pytest.mark.parametrize("case", [(32, 32, 8, True), (24, 40, 16, False),
                                  (20, 12, 8, True)])
def test_blockwise_attention_matches_the_jax_one(case):
    tq, tk, bs, causal = case
    q, k, v = _qkv(2, 2, tq, tk, 8, seed=3)
    want = _f32(jblockwise(*(jnp.asarray(a) for a in (q, k, v)),
                           block_size=bs, causal=causal))
    got = blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              block_size=bs, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_op_dispatch_follows_the_tier():
    """At tier auto the op runs ``flash_attn``; at tier off, and where
    the tier's guard declines (causal cross-length), the legacy
    forward, with the reason recorded in both packages."""
    q, k, v = _qkv(1, 2, 16, 16, 8, seed=2)
    op = treg.get("_contrib_FlashAttention")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with mt.config.override(kernel_tier="auto"):
        ttier.reset_stats()
        auto = op.fn(*t, causal=True)
        st = ttier.stats()
    assert st["dispatch"] == {"flash_attn": 1} and not st["fallback"]
    np.testing.assert_allclose(auto.numpy(), tattn._plain_flash(
        *t, True).numpy(), rtol=1e-6, atol=1e-6)
    with mt.config.override(kernel_tier="off"):
        ttier.reset_stats()
        off = op.fn(*t, causal=True, block_q=8, block_k=8)
        assert ttier.stats()["dispatch"] == {}
    np.testing.assert_allclose(off.numpy(), auto.numpy(), rtol=1e-5,
                               atol=1e-5)
    q2, k2, v2 = _qkv(1, 2, 12, 20, 8, seed=4)
    with mt.config.override(kernel_tier="auto"):
        ttier.reset_stats()
        got = op.fn(*(torch.from_numpy(a) for a in (q2, k2, v2)),
                    causal=True)
        st = ttier.stats()
    with jconfig.override(kernel_tier="auto"):
        jtier.reset_stats()
        want = _f32(jpf._contrib_flash_attention(
            *(jnp.asarray(a) for a in (q2, k2, v2)), causal=True))
        jst = jtier.stats()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert list(st["fallback"]) == list(jst["fallback"])
    assert "causal cross-length" in next(iter(st["fallback"]))
