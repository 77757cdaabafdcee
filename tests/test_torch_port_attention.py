"""Port parity for the attention kernels' plain versions.

The port's ``flash_attention`` and ``paged_attention`` run their plain
torch versions on CPU tensors. They are held against the JAX package's
Pallas kernels (interpret mode, as ``tests/test_attention_kernel.py``
runs them) and its dense ``reference_attention`` on the same numpy
inputs: f32 within atol/rtol 1e-5 (the same function summed in another
order), bf16 within one bf16 ulp plus 1e-3 of the f32 result (each side
rounds its f32 result once, after another summation order). Cases cover
an uneven tail, position 0, page boundaries and W > 1.

The CUDA tile (``csrc/flash_tile.cuh``) computes both products on TF32
tensor cores with an error-compensated split. :func:`_tc_flash` forms
them here exactly as the kernel does (3 terms for two f32 operands, 2
where one side is exact in TF32, 1 where both are) and is held against
the JAX kernel at the card's tolerance (f32 atol 2e-5, rtol 1e-4; bf16
one bf16 ulp plus 1e-3); one case shows that a single TF32 product
misses it, which is why the kernel splits.
"""
import itertools
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

from paged_nonfinite import CASES, plant


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


# --------------------------------------------- the tensor-core split
def _tf32(x):
    """x (f32) rounded to TF32's 10 mantissa bits, to nearest, ties away
    from zero, by the mantissa mask (the kernel's ``tf32r``)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _tc_matmul(a, b, a_full, b_full, terms=3):
    """a @ b in f32 as the kernel's wgmmas form it. An operand with a
    full f32 mantissa (``*_full``) is split into big = tf32(x) and small
    = tf32(x - big); a bf16 one is exact in TF32 and is not. The products
    kept are big.big, big.small and small.big where those parts exist;
    ``terms=1`` keeps big.big alone (one plain TF32 product)."""
    ab, bb = _tf32(a), _tf32(b)
    out = ab @ bb
    if terms == 1:
        return out
    if b_full:
        out = out + ab @ _tf32(b - bb)
    if a_full:
        out = out + _tf32(a - ab) @ bb
    return out


def _tc_flash(q, k, v, causal, round_p, terms=3, kv_tile=64):
    """The CUDA tile's function with its tensor-core products: q scaled
    in f32, an online softmax whose running max moves once per
    ``kv_tile`` keys, masked scores -1e30 before the max and p forced to
    0, ``round_p`` (B7) rounding p to the input dtype before P.V, output
    ``acc / max(l, 1e-30)`` in the input dtype."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    full = q.dtype == torch.float32          # bf16 K and V are exact
    qs = q.float() * (1.0 / math.sqrt(d))
    m = torch.full(q.shape[:3] + (1,), -1e30)
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(q.shape[:3] + (d,))
    qpos = torch.arange(tq)[:, None]
    for t0 in range(0, tk, kv_tile):
        kb = k[:, :, t0:t0 + kv_tile].float()
        vb = v[:, :, t0:t0 + kv_tile].float()
        s = _tc_matmul(qs, kb.transpose(-1, -2), True, full, terms)
        mask = torch.arange(t0, t0 + kb.shape[2])[None, :] < tk
        if causal:
            mask = mask & (torch.arange(t0, t0 + kb.shape[2])[None, :]
                           <= qpos + (tk - tq))
        s = torch.where(mask, s, torch.full((), -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros(()))
        l = l * corr + p.sum(-1, keepdim=True)
        pv = p.to(q.dtype).float() if round_p else p
        acc = acc * corr + _tc_matmul(pv, vb, full or not round_p, full,
                                      terms)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _card_close(got, want, dtype):
    """chip_smoke.py's kernel tolerance -> the elements outside it."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    diff = np.abs(got - want)
    if dtype == "float32":
        return int((diff > 2e-5 + 1e-4 * np.abs(want)).sum())
    ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
    return int((diff > ulp + 1e-3).sum())


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


# (q shape, tk, causal): square, a ragged tail over two KV tiles, d 16,
# non-causal cross-length
TC_CASES = [((1, 2, 128, 64), 128, True), ((1, 2, 100, 64), 100, True),
            ((1, 2, 100, 16), 100, True), ((1, 2, 40, 16), 100, False)]


@pytest.mark.parametrize("case", TC_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_split_matches_the_jax_kernel(case, dtype):
    """The kernel's split products (3 terms f32; 2 terms bf16: the scaled
    q's and p's small parts) against ``mxk_flash_attn`` in interpret
    mode, unscaled randn inputs as on the card."""
    qshape, tk, causal = case
    rng = np.random.RandomState(qshape[2] + tk)
    kshape = qshape[:2] + (tk, qshape[3])
    q, k, v = (rng.randn(*s_).astype(np.float32)
               for s_ in (qshape, kshape, kshape))
    jdt = getattr(jnp, dtype)
    with jconfig.override(kernel_tier="auto"):
        want = _np(jattn.flash_attention(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
            config={"block_q": 64, "block_k": 64}))
    got = _tc_flash(*(torch.from_numpy(a).to(getattr(torch, dtype))
                      for a in (q, k, v)), causal, round_p=False)
    assert _card_close(got, want, dtype) == 0


def test_one_tf32_product_misses_the_f32_tolerance():
    """Without the split (one TF32 product per matmul) the kernel would
    fail the card's f32 tolerance; the 3-term split on the same inputs
    meets it."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(1, 4, 256, 64).astype(np.float32)
               for _ in range(3))
    with jconfig.override(kernel_tier="auto"):
        want = _np(jattn.flash_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=True,
            config={"block_q": 64, "block_k": 64}))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    assert _card_close(_tc_flash(*t, True, False, terms=1), want,
                       "float32") > 0
    assert _card_close(_tc_flash(*t, True, False), want, "float32") == 0


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


# ---------------------------------------- the non-finite contract (C2)
# (S, W, heads, dh, page, mp, positions): decode rows with a masked tail
# in the last visible page and pages wholly past it; W = 3, whose row 0
# cannot see position pos + 1 and rows 1-2 can; pages of 32 (two 16-row
# units in the CUDA kernel); W = 10 (two row blocks of the kernel)
NONFINITE_GEOMS = {
    "decode": (3, 1, 2, 8, 8, 4, (2, 13, 21)),
    "w3": (2, 3, 2, 8, 8, 4, (4, 17)),
    "page32": (2, 1, 2, 8, 32, 4, (40, 70)),
    "w10": (1, 10, 2, 8, 8, 4, (5,)),
}


def _nonfinite_setup(case, geom):
    S, W, heads, dh, page, mp, positions = NONFINITE_GEOMS[geom]
    q, kp, vp, bt, pos = _paged_setup(S=S, W=W, heads=heads, dh=dh,
                                      page=page, mp=mp, positions=positions,
                                      seed=7)
    kp, vp, bt, nan, inf = plant(case, kp, vp, bt, pos, W, page)
    return (q, kp, vp, bt, pos), heads, page, nan, inf


def _same_nonfinite(got, want, dtype):
    """NaN, +inf and -inf masks equal exactly; finite entries within the
    file's tolerance for ``dtype``."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], dtype)


def _emulate_paged_kernel(q, kp, vp, bt, pos, heads, page, rows_per_cta=8,
                          warps=4, unit=16):
    """``csrc/flash_attn_paged.cu``'s algorithm in plain torch (f32): per
    (slot, head, block of 8 rows; the kernel's block of 1 row at W = 1
    computes the same), warp w takes units w, w + 4, ... of 16
    positions, skipping a unit no row sees when the entry before it lists
    the same page and that page is wholly unseen; a unit no row sees adds
    0 * V to every row, a seen one runs the online softmax (masked scores
    -1e30 by a select, p = 0 there, 0 * V added); the warps' states are
    merged scaled by exp(m_w - m), none skipped; out = acc / max(l,
    1e-30) with the CUDA ``fmaxf``'s NaN rule."""
    S, W, C = q.shape
    dh = C // heads
    R, mp = kp.shape[0], bt.shape[1]
    nsub = -(-page // unit)
    neg = torch.tensor(-1e30)
    out = torch.empty(S, W, C)
    for s, h, w0 in itertools.product(range(S), range(heads),
                                      range(0, W, rows_per_cta)):
        nrows = min(rows_per_cta, W - w0)
        last = int(pos[s]) + w0 + nrows - 1
        cols = slice(h * dh, (h + 1) * dh)
        qh = q[s, w0:w0 + nrows, cols].float() * (1.0 / math.sqrt(dh))
        qpos = int(pos[s]) + w0 + torch.arange(nrows)
        states = []
        for warp in range(warps):
            m = torch.full((nrows,), -1e30)
            l = torch.zeros(nrows)
            acc = torch.zeros(nrows, dh)
            z = torch.zeros(dh)
            for u in range(warp, mp * nsub, warps):
                pi, sub = divmod(u, nsub)
                t0 = pi * page + sub * unit
                if (t0 > last and pi > 0 and bt[s, pi] == bt[s, pi - 1]
                        and (pi - 1) * page > last):
                    continue
                n_t = min(unit, page - sub * unit)
                rid = (int(bt[s, pi]) * page + sub * unit
                       + torch.arange(n_t)).clamp(0, R - 1)
                v = vp[rid, cols].float()
                if t0 > last:
                    z = z + (0.0 * v).sum(0)
                    continue
                sc = qh @ kp[rid, cols].float().T
                vis = (t0 + torch.arange(n_t))[None, :] <= qpos[:, None]
                sc = torch.where(vis, sc, neg)
                m_new = torch.fmax(m, sc.max(1).values)
                corr = torch.exp(m - m_new)
                p = torch.where(vis, torch.exp(sc - m_new[:, None]),
                                torch.zeros(()))
                l = l * corr + p.sum(1)
                acc = acc * corr[:, None] + (p[:, :, None] * v).sum(1)
                m = m_new
            states.append((m, l, acc + z))
        mm = torch.stack([st[0] for st in states]).max(0).values
        ll = sum(st[1] * torch.exp(st[0] - mm) for st in states)
        aa = sum(st[2] * torch.exp(st[0] - mm)[:, None] for st in states)
        out[s, w0:w0 + nrows, cols] = aa / torch.fmax(ll, torch.tensor(
            1e-30))[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("geom", sorted(NONFINITE_GEOMS))
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_nonfinite_contract_matches_jax_kernel(dtype, case, geom):
    """The port's paged attention (its plain version on the CPU) gives
    the JAX kernel's NaN and inf exactly where the contract puts them,
    and its finite values within the file's tolerance."""
    (q, kp, vp, bt, pos), heads, page, nan, inf = _nonfinite_setup(case,
                                                                  geom)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout = _np(jattn.paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(bt), jnp.asarray(pos), heads=heads, page_size=page))
    np.testing.assert_array_equal(np.isnan(jout), nan)
    np.testing.assert_array_equal(np.isinf(jout), inf)
    got = tattn.paged_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(bt),
        torch.from_numpy(pos), heads=heads, page_size=page)
    assert got.dtype == tdt
    _same_nonfinite(got, jout, dtype)


@pytest.mark.parametrize("geom", sorted(NONFINITE_GEOMS))
@pytest.mark.parametrize("case", CASES)
def test_kernel_algorithm_keeps_the_nonfinite_contract(case, geom):
    """The CUDA kernel's units, page dedup and warp merge, emulated in
    plain torch, against the JAX kernel (f32)."""
    (q, kp, vp, bt, pos), heads, page, _nan, _inf = _nonfinite_setup(
        case, geom)
    jout = _np(jattn.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), heads=heads, page_size=page))
    got = _emulate_paged_kernel(*(torch.from_numpy(a) for a in (
        q, kp, vp, bt, pos)), heads, page)
    _same_nonfinite(got, jout, "float32")


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
