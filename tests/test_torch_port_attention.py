"""Port parity for the attention kernels' plain versions.

The port's ``flash_attention`` and ``paged_attention`` run their plain
torch versions on CPU tensors. They are held against the JAX package's
Pallas kernels (interpret mode, as ``tests/test_attention_kernel.py``
runs them) and its dense ``reference_attention`` on the same numpy
inputs: f32 within atol/rtol 1e-5 (the same function summed in another
order), bf16 within one bf16 ulp plus 1e-3 of the f32 result (each side
rounds its f32 result once, after another summation order). Cases cover
an uneven tail, position 0, page boundaries and W > 1.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import config as jconfig
from mxnet_tpu.kernels import attention as jattn
from mxnet_tpu.kernels import tier as jtier

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import attention as tattn
from mxnet_tpu_torch.kernels import tier as ttier


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
        assert (np.abs(got - want) <= ulp + 1e-3).all(), \
            float(np.abs(got - want).max())


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) / math.sqrt(shape[-1])).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 3, 64, 16), (2, 3, 56, 16),
                                   (1, 4, 8, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_kernel_and_reference(shape, dtype):
    q, k, v = _qkv(shape, seed=shape[2])
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    with jconfig.override(kernel_tier="auto"):
        jk_out = _np(jattn.flash_attention(jq, jk, jv, causal=True,
                                           config={"block_q": 16,
                                                   "block_k": 16}))
    jref = _np(jattn.reference_attention(jq, jk, jv, causal=True))
    got = tattn.flash_attention(*(torch.from_numpy(a).to(tdt)
                                  for a in (q, k, v)), causal=True)
    assert got.dtype == tdt and got.shape == shape
    _close(got, jk_out, dtype)
    _close(got, jref, dtype)
    tref = tattn.reference_attention(*(torch.from_numpy(a).to(tdt)
                                       for a in (q, k, v)))
    _close(tref, jref, dtype)


def test_flash_attention_non_causal_cross_length():
    rng = np.random.RandomState(3)
    q = rng.randn(1, 2, 12, 8).astype(np.float32)
    k = rng.randn(1, 2, 20, 8).astype(np.float32)
    v = rng.randn(1, 2, 20, 8).astype(np.float32)
    want = _np(jattn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=False))
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False)
    _close(got, want, "float32")


def _paged_setup(S=3, W=5, heads=4, dh=8, page=8, mp=4, positions=(0, 7, 26),
                 seed=0):
    """Random store, a block table of distinct pages (page 0 unused),
    queries; positions 0 and page boundaries by default."""
    rng = np.random.RandomState(seed)
    C = heads * dh
    num_pages = S * mp + 1
    kp = rng.randn(num_pages * page, C).astype(np.float32)
    vp = rng.randn(num_pages * page, C).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_pages)).reshape(S, mp).astype(
        np.int32)
    q = (rng.randn(S, W, C) / math.sqrt(dh)).astype(np.float32)
    return q, kp, vp, bt, np.asarray(positions, np.int32)


def _paged_dense_ref(q, kp, vp, bt, pos, heads, page):
    """Gather each slot's context and attend with the JAX package's dense
    reference mask: row w of slot s sees t <= pos[s] + w."""
    S, W, C = q.shape
    dh = C // heads
    ctx_idx = (bt[:, :, None] * page + np.arange(page)).reshape(S, -1)
    out = np.zeros_like(q)
    for s in range(S):
        kk = kp[ctx_idx[s]].reshape(-1, heads, dh)
        vv = vp[ctx_idx[s]].reshape(-1, heads, dh)
        qq = q[s].reshape(W, heads, dh)
        sc = np.einsum("whd,thd->hwt", qq, kk) / math.sqrt(dh)
        t = np.arange(kk.shape[0])
        mask = t[None, :] <= pos[s] + np.arange(W)[:, None]
        sc = np.where(mask[None], sc, -1e30)
        w = np.exp(sc - sc.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        out[s] = np.einsum("hwt,thd->whd", w, vv).reshape(W, C)
    return out


@pytest.mark.parametrize("case", [
    dict(),                                                  # W>1, bounds
    dict(S=4, W=1, positions=(0, 8, 15, 31)),                # decode
    dict(S=1, W=8, positions=(16,)),                         # one chunk
    dict(S=2, W=3, heads=2, dh=16, page=4, mp=6, positions=(3, 20)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_jax_kernel_and_reference(case, dtype):
    heads = case.get("heads", 4)
    page = case.get("page", 8)
    q, kp, vp, bt, pos = _paged_setup(**case)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    want = _paged_dense_ref(q, kp, vp, bt, pos, heads, page)
    got = tattn.paged_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(bt),
        torch.from_numpy(pos), heads=heads, page_size=page)
    assert got.dtype == tdt and got.shape == q.shape
    if dtype == "float32":
        _close(got, want, dtype)
    if page % 8 == 0:   # the JAX kernel's sublane rule
        jout = _np(jattn.paged_attention(
            jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(bt), jnp.asarray(pos), heads=heads,
            page_size=page))
        _close(got, jout, dtype)


def test_guard_reasons():
    f32 = torch.float32
    q4 = (2, 3, 16, 8)
    assert tattn.eligible(q4, q4, q4, f32) is None
    assert "4-D" in tattn.eligible((2, 16, 8), q4, q4, f32)
    assert "dtype" in tattn.eligible(q4, q4, q4, torch.int32)
    assert "k/v shapes differ" in tattn.eligible(q4, q4, (2, 3, 15, 8), f32)
    assert "causal cross-length" in tattn.eligible(
        q4, (2, 3, 20, 8), (2, 3, 20, 8), f32)
    assert tattn.eligible(q4, (2, 3, 20, 8), (2, 3, 20, 8), f32,
                          causal=False) is None
    big = (1, 1, 4, 256)
    assert "128-wide tile" in tattn.eligible(big, big, big, f32)
    # JAX's TPU-only rule, dropped here: head_dim 256 fits its VMEM plan
    assert jattn.eligible(big, big, big, jnp.float32) is None
    q, pages, bt, pos = (3, 5, 32), (264, 32), (3, 4), (3,)
    assert tattn.paged_eligible(q, pages, bt, pos, f32, 4, 8) is None
    # page_size 4: the JAX package falls back (sublane rule), the port
    # serves it
    assert "sublane" in jattn.paged_eligible(q, pages, bt, pos,
                                             jnp.float32, 4, 4)
    assert tattn.paged_eligible(q, pages, bt, pos, f32, 4, 4) is None
    assert "3-D" in tattn.paged_eligible((3, 5, 4, 8), pages, bt, pos, f32,
                                         4, 8)
    assert "divisible by heads" in tattn.paged_eligible(q, pages, bt, pos,
                                                        f32, 5, 8)
    assert "whole number" in tattn.paged_eligible(q, (260, 32), bt, pos,
                                                  f32, 4, 8)
    assert "block table" in tattn.paged_eligible(q, pages, (2, 4), pos, f32,
                                                 4, 8)
    assert "positions" in tattn.paged_eligible(q, pages, bt, (2,), f32, 4,
                                               8)
    assert "dtype" in tattn.paged_eligible(q, pages, bt, pos, torch.int32,
                                           4, 8)
    assert "128-wide tile" in tattn.paged_eligible(
        (1, 1, 512), (8, 512), (1, 1), (1,), f32, 2, 8)
    with pytest.raises(ValueError, match="flash_attn_paged guard"):
        tattn.paged_attention(torch.zeros(3, 5, 32), torch.zeros(260, 32),
                              torch.zeros(260, 32),
                              torch.zeros(3, 4, dtype=torch.int32),
                              torch.zeros(3, dtype=torch.int32), heads=4,
                              page_size=8)


def test_tier_dispatch_and_fallback_are_recorded():
    q, kp, vp, bt, pos = (torch.from_numpy(a) for a in _paged_setup())
    with mt.config.override(kernel_tier="auto"):
        ttier.reset_stats()
        out = tattn.paged_attend_or_none(q, kp, vp, bt, pos, heads=4,
                                         page_size=8)
        assert tattn.paged_attend_or_none(q, kp, vp, bt, pos, heads=5,
                                          page_size=8) is None
        st = ttier.stats()
    assert out is not None
    assert st["dispatch"] == {"flash_attn_paged": 1}
    assert any(k.startswith("flash_attn_paged:") and "divisible" in k
               for k in st["fallback"]), st["fallback"]
    with mt.config.override(kernel_tier="off"):
        assert tattn.attend_or_none(torch.zeros(1, 1, 4, 8),
                                    torch.zeros(1, 1, 4, 8),
                                    torch.zeros(1, 1, 4, 8)) is None
    # the plain versions launch nothing
    assert tattn.launches_by_kernel == {"flash_attn": 0,
                                        "flash_attn_paged": 0}


def test_tier_stats_keys_match_the_jax_package():
    assert set(ttier.stats()) == set(jtier.stats())


@pytest.mark.parametrize("shape", [(2, 3, 64, 16), (1, 2, 40, 8)])
def test_flash_attention_grads_match_jax_grad(shape):
    """The backward (the vjp of ``reference_attention``, recomputed)
    against ``jax.grad`` through the JAX kernel's ``custom_vjp``, on
    the same cotangent: f32 within atol/rtol 1e-5."""
    import jax
    q, k, v = _qkv(shape, seed=7)
    cot = np.random.RandomState(8).randn(*shape).astype(np.float32)
    with jconfig.override(kernel_tier="auto"):
        want = jax.grad(lambda a, b, c: jnp.sum(jattn.flash_attention(
            a, b, c, causal=True, config={"block_q": 16, "block_k": 16})
            * jnp.asarray(cot)), argnums=(0, 1, 2))(
                *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    (tattn.flash_attention(tq, tk, tv, causal=True)
     * torch.from_numpy(cot)).sum().backward()
    for got, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), _np(w), rtol=1e-5,
                                   atol=1e-5)
