"""Port parity for the fused scale + bias + activation (B5).

The port's ``kernels.mlp.fused_scale_bias_act`` runs its plain torch
version on CPU tensors; it is held against the JAX package's Pallas
kernel (interpret mode, as ``tests/test_kernels.py`` runs it) on the
same numpy inputs, forward and ``jax.grad``, for ReLU, erf GeLU and
identity, f32 and bf16, with and without the scale. Tolerances: f32
within atol/rtol 1e-5 (erf and the sums come from two libraries); bf16
forward within one bf16 ulp of the larger value plus 1e-3 (both round
one f32 value once); bf16 gradients differentiate the reference in
bf16 on both sides, rounding at other places: within four bf16 ulps
plus 1e-2, and the scale gradient, a bf16 sum over the rows, within
the same bound per row summed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import config as jconfig
from mxnet_tpu.kernels import mlp as jmlp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import mlp as tmlp
from mxnet_tpu_torch.kernels import tier as ttier
from mxnet_tpu_torch.ops import registry as treg


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    F = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            (rng.rand(F) * 2 - 0.5).astype(np.float32),
            rng.randn(F).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _close(got, want, dtype, ulps=1, atol_bf16=1e-3, rows=1):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
        bad = np.abs(got - want) > rows * (ulps * ulp + atol_bf16)
        assert not bad.any(), float(np.abs(got - want).max())


@pytest.mark.parametrize("act", ["relu", "gelu", "identity"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_scale", [False, True])
def test_forward_and_grads_match_the_jax_kernel(act, dtype, with_scale):
    shape = (2, 3, 40)
    x, sc, b, cot = _inputs(shape, seed=len(act) + with_scale)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jdt)
    jsc = jnp.asarray(sc) if with_scale else None

    def jf(a, s, c):
        return jnp.sum(jmlp.fused_scale_bias_act(
            a, s, c, act=act).astype(jnp.float32) * jnp.asarray(cot))

    with jconfig.override(kernel_tier="auto"):
        jout = _f32(jmlp.fused_scale_bias_act(jx, jsc, jnp.asarray(b),
                                              act=act))
        argnums = (0, 1, 2) if with_scale else (0, 2)
        jgrads = jax.grad(jf, argnums=argnums)(jx, jsc, jnp.asarray(b))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tsc = torch.from_numpy(sc).requires_grad_(True) if with_scale else None
    tb = torch.from_numpy(b).requires_grad_(True)
    out = tmlp.fused_scale_bias_act(tx, tsc, tb, act=act)
    assert out.dtype == tdt and tuple(out.shape) == shape
    _close(out.float().detach().numpy(), jout, dtype)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    leaves = (tx, tsc, tb) if with_scale else (tx, tb)
    rows = shape[0] * shape[1]
    for leaf, jg in zip(leaves, jgrads):
        _close(leaf.grad.float().numpy(), _f32(jg), dtype, ulps=4,
               atol_bf16=1e-2, rows=1 if leaf is tx else rows)
    assert tmlp.launches == 0      # CPU tensors launch nothing


def test_registered_op_is_the_fused_function():
    x, sc, b, _ = _inputs((4, 24), seed=1)
    op = treg.get("_contrib_FusedScaleBiasGeLU")
    got = op.fn(torch.from_numpy(x), torch.from_numpy(sc),
                torch.from_numpy(b))
    with jconfig.override(kernel_tier="auto"):
        want = _f32(jmlp._contrib_fused_scale_bias_gelu(
            jnp.asarray(x), jnp.asarray(sc), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert hasattr(mt.sym.contrib, "FusedScaleBiasGeLU")


@pytest.mark.parametrize("case", [
    ((5,), "float32", "gelu", None, None),
    ((4, 8), "float16", "gelu", None, None),
    ((4, 8), "float32", "swish", None, None),
    ((4, 8), "float32", "relu", (7,), None),
    ((4, 8), "float32", "relu", None, (8, 1)),
    ((4, 0), "float32", "relu", None, None),
    ((4, 8), "float32", "relu", (8,), (8,)),
])
def test_guard_reasons_are_the_jax_packages(case):
    shape, dtype, act, sshape, bshape = case
    want = jmlp.eligible(shape, getattr(jnp, dtype), act=act,
                         scale_shape=sshape, bias_shape=bshape)
    got = tmlp.eligible(shape, getattr(torch, dtype), act=act,
                        scale_shape=sshape, bias_shape=bshape)
    assert got == want
    if got is not None:
        with pytest.raises(ValueError, match="fused_scale_bias_act guard"):
            tmlp.fused_scale_bias_act(
                torch.zeros(shape, dtype=getattr(torch, dtype)),
                None if sshape is None else torch.zeros(sshape),
                None if bshape is None else torch.zeros(bshape), act=act)


def test_shape_key_and_tier_dispatch():
    assert tmlp.shape_key_shapes((8, 1024, 3072)) == \
        jmlp.shape_key_shapes((8, 1024, 3072)) == ((8192, 3072),)
    with mt.config.override(kernel_tier="auto"):
        ttier.reset_stats()
        ok, cfg = ttier.should_dispatch(
            tmlp.OP_NAME, tmlp.shape_key_shapes((8, 16)), "float32",
            tmlp.DEFAULT_CONFIG)
    assert ok and cfg == tmlp.DEFAULT_CONFIG
    assert ttier.stats()["dispatch"] == {"scale_bias_act": 1}
