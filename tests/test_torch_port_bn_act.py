"""Port parity: the fused BatchNorm -> (+residual) -> ReLU epilogue.

The same numpy inputs go through ``mxnet_tpu.kernels.bn_act.fused_bn_act``
(tier auto; on the CPU its Pallas kernel runs in interpret mode, as in
tests/test_kernels.py) and ``mxnet_tpu_torch.kernels.bn_act.fused_bn_act``
(on the CPU the wrapper takes the kernel's plain torch version).

Tolerances: f32 rtol 1e-5 / atol 1e-6 (both compute x*sc + sh [+ r] in
f32; only the order of a few f32 roundings may differ). bf16 rtol 2^-7:
both round one f32 value once to bf16, so they differ by at most one
bf16 ulp where a tiny f32 difference crosses a rounding boundary.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu import config as jconfig
from mxnet_tpu.kernels import bn_act as jbn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import bn_act as tbn

SHAPES = [(2, 16, 7, 7),      # HW = 49, ResNet-50's last stage
          (3, 5, 4, 6),       # N*C = 15, a multiple of no block
          (1, 3, 13, 11)]     # odd HW = 143

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
        "bfloat16": dict(rtol=2 ** -7, atol=1e-6)}


def _inputs(shape, residual, seed):
    rng = np.random.RandomState(seed)
    C = shape[1]
    return dict(
        x=rng.randn(*shape).astype(np.float32),
        r=rng.randn(*shape).astype(np.float32) if residual else None,
        gamma=(rng.rand(C) + 0.5).astype(np.float32),     # gamma != 1
        beta=rng.randn(C).astype(np.float32),
        mm=(0.3 * rng.randn(C)).astype(np.float32),
        mv=(rng.rand(C) + 0.5).astype(np.float32))


def _run_jax(d, dt, **kw):
    x = jnp.asarray(d["x"], _JDT[dt])
    r = None if d["r"] is None else jnp.asarray(d["r"], _JDT[dt])
    with jconfig.override(kernel_tier="auto"):
        out = jbn.fused_bn_act(x, jnp.asarray(d["gamma"]),
                               jnp.asarray(d["beta"]), jnp.asarray(d["mm"]),
                               jnp.asarray(d["mv"]), r, **kw)
    return [np.asarray(jnp.asarray(o, jnp.float32)) for o in out]


def _run_torch(d, dt, **kw):
    x = torch.from_numpy(d["x"]).to(_TDT[dt])
    r = None if d["r"] is None else torch.from_numpy(d["r"]).to(_TDT[dt])
    out = tbn.fused_bn_act(x, torch.from_numpy(d["gamma"]),
                           torch.from_numpy(d["beta"]),
                           torch.from_numpy(d["mm"]),
                           torch.from_numpy(d["mv"]), r, **kw)
    return [o.float().numpy() for o in out]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_bn_act_eval_matches_jax(shape, residual, dt):
    d = _inputs(shape, residual, seed=sum(shape))
    kw = dict(eps=2e-5, momentum=0.9, fix_gamma=False, act="relu",
              training=False)
    before = tbn.launches
    got = _run_torch(d, dt, **kw)
    want = _run_jax(d, dt, **kw)
    np.testing.assert_allclose(got[0], want[0], **_TOL[dt])
    # eval mode: the stat outputs are the moving statistics themselves
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert tbn.launches == before     # CPU tensors never launch the kernel


def test_fused_bn_act_identity_and_fix_gamma_match_jax():
    d = _inputs((2, 6, 5, 5), True, seed=7)
    kw = dict(eps=1e-3, fix_gamma=True, act="identity", training=False)
    got = _run_torch(d, "float32", **kw)
    want = _run_jax(d, "float32", **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert (got[0] < 0).any()         # identity: negatives survive


def test_fused_bn_act_training_statistics_match_jax():
    d = _inputs((4, 8, 6, 6), False, seed=3)
    kw = dict(eps=2e-5, momentum=0.9, fix_gamma=False, training=True)
    got = _run_torch(d, "float32", **kw)
    want = _run_jax(d, "float32", **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


_ELIGIBLE_CASES = [
    ((2, 8, 4, 4), "float32", {}),
    ((2, 8), "float32", {}),
    ((2, 8, 4, 4), "int32", {}),
    ((2, 8, 4, 4), "float16", {}),
    ((2, 8, 4, 4), "float32", {"axis": 3}),
    ((2, 8, 4, 4), "float32", {"act": "tanh"}),
    ((2, 8, 4, 4), "float32", {"residual_shape": (2, 8, 4, 5)}),
    ((0, 8, 4, 4), "float32", {}),
]


@pytest.mark.parametrize("shape,dt,kw", _ELIGIBLE_CASES)
def test_eligible_reason_strings_match_jax(shape, dt, kw):
    want = jbn.eligible(shape, jnp.dtype(dt), **kw)
    got = tbn.eligible(shape, getattr(torch, dt), **kw)
    assert got == want


def test_guard_failure_raises_like_jax():
    x = torch.zeros(2, 8, 4, 4, dtype=torch.float16)
    v = torch.ones(8)
    with pytest.raises(ValueError, match="fused_bn_act guard: dtype"):
        tbn.fused_bn_act(x, v, v, v, v)


def test_wrapper_refuses_meta_tensors_and_gradients():
    """Meta tensors have no kernel; a gradient request runs the forward
    and its recomputed backward (statistic outputs carry none)."""
    x = torch.empty(2, 4, 3, 3, device="meta")
    v = torch.ones(4, device="meta")
    with pytest.raises(mt.MXNetError, match="no kernel for meta"):
        tbn.fused_bn_act(x, v, v, v, v, training=False)
    xg = torch.randn(2, 4, 3, 3, requires_grad=True)
    w = torch.ones(4)
    out = tbn.fused_bn_act(xg, w, w, w, w, training=False)
    assert out[0].requires_grad and not out[1].requires_grad
    out[0].sum().backward()
    assert xg.grad.shape == xg.shape
    with torch.inference_mode():
        y = tbn.fused_bn_act(xg, w, w, w, w, training=False)[0]
    assert y.shape == xg.shape


_GRAD_CASES = [((2, 16, 7, 7), False, True, False),
               ((2, 16, 7, 7), True, True, False),
               ((3, 5, 4, 6), True, False, False),
               ((1, 3, 13, 11), False, True, True),
               ((3, 5, 4, 6), True, True, True)]


@pytest.mark.parametrize("shape,residual,training,fix_gamma", _GRAD_CASES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_bn_act_gradients_match_jax(shape, residual, training,
                                          fix_gamma, dt):
    """Gradients of data, gamma, beta and the residual against jax.grad
    through the JAX package's custom_vjp (its Pallas forward in interpret
    mode), for a random head gradient; with fix_gamma, gamma's is 0. f32
    within rtol 1e-4 / atol 1e-5; bf16 within a relative L2 error of one
    bf16 ulp (gamma's and beta's elements sum N*H*W products that both
    sides round in bf16, in other orders)."""
    import jax
    d = _inputs(shape, residual, seed=sum(shape) + 1)
    head = np.random.RandomState(9).randn(*shape).astype(np.float32)
    kw = dict(eps=2e-5, momentum=0.9, fix_gamma=fix_gamma, act="relu",
              training=training)
    names = ["x", "gamma", "beta"] + (["r"] if residual else [])

    def jfn(*vals):
        a = dict(zip(names, vals))
        out = jbn.fused_bn_act(a["x"], a["gamma"], a["beta"],
                               jnp.asarray(d["mm"]), jnp.asarray(d["mv"]),
                               a.get("r"), **kw)[0]
        return jnp.sum(out.astype(jnp.float32) * head)

    jvals = [jnp.asarray(d[n], _JDT[dt] if n in ("x", "r") else jnp.float32)
             for n in names]
    with jconfig.override(kernel_tier="auto"):
        want = jax.grad(jfn, argnums=tuple(range(len(names))))(*jvals)
    tvals = [torch.from_numpy(d[n]).to(_TDT[dt] if n in ("x", "r")
                                       else torch.float32)
             .requires_grad_(True) for n in names]
    a = dict(zip(names, tvals))
    out = tbn.fused_bn_act(a["x"], a["gamma"], a["beta"],
                           torch.from_numpy(d["mm"]),
                           torch.from_numpy(d["mv"]), a.get("r"), **kw)[0]
    (out.float() * torch.from_numpy(head)).sum().backward()
    for n, t, w in zip(names, tvals, want):
        got, w = t.grad.float().numpy(), np.asarray(jnp.asarray(w,
                                                               jnp.float32))
        if dt == "float32":
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-5,
                                       err_msg=n)
        else:
            err = np.linalg.norm(got - w)
            assert err <= 2 ** -7 * np.linalg.norm(w), (n, err)


def test_plain_epilogue_is_one_rounding_of_f32_math():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 3, 4, 4).astype(np.float32))
    r = torch.from_numpy(rng.randn(2, 3, 4, 4).astype(np.float32))
    sc = torch.tensor([0.5, -1.0, 2.0])
    sh = torch.tensor([0.1, 0.2, -0.3])
    y = tbn._plain_epilogue(x.bfloat16(), sc, sh, r.bfloat16(), "relu")
    ref = torch.relu(x.bfloat16().float() * sc.view(1, 3, 1, 1)
                     + sh.view(1, 3, 1, 1) + r.bfloat16().float())
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ref.bfloat16())
