"""Port parity: the fused int8 dequant -> affine -> activation epilogue.

The same numpy inputs go through ``mxnet_tpu.kernels.int8_dequant.
dequant_epilogue(..., interpret=True)`` (the Pallas kernel in interpret
mode) and ``mxnet_tpu_torch.kernels.int8_dequant.dequant_epilogue`` (on
the CPU the wrapper takes the kernel's plain torch version), in both
forms: per row (conv, NCHW viewed (N*C, H*W)) and per column (FC, and
conv as the GEMM gives it).

Tolerance: one f32 ulp of the larger of |f32(acc) * sc| and |y|. Both
sides round the affine once (XLA contracts it into an FMA; the plain
version sums in f64, where the product is exact, and rounds to f32), so
they agree bit for bit except where the f64 sum rounds twice; the ulp
is taken of |y| too because a shift larger than the product makes the
result, and its ulp, larger than the product's. The bitwise share must
be at least 99 %.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.kernels import int8_dequant as jdq

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import int8_dequant as tdq

# (R, S) accumulator views: ResNet-50's last stage as NCHW rows (HW = 49,
# odd), a conv GEMM's (N*OH*OW, O) and an FC's (N, 1000) in column form,
# and a ragged shape that is a multiple of no block or vector width
SHAPES = [(2 * 16, 49), (98, 64), (3, 1000), (37, 29)]


def _inputs(R, S, per_row, seed, big=False):
    rng = np.random.RandomState(seed)
    hi = 2 ** 24 + 2 ** 20 if big else 2 ** 21
    acc = rng.randint(-hi, hi, (R, S)).astype(np.int32)
    if big:   # |acc| near 2^24, where the int32 -> f32 conversion rounds
        acc[::2] = (2 ** 24 - 3 + np.arange(S)).astype(np.int32)
        acc[1::4] = -acc[1::4]
    n = R if per_row else S
    sc = (rng.rand(n) * 2e-3 - 5e-4).astype(np.float32)
    sh = rng.randn(n).astype(np.float32)
    return acc, sc, sh


def _jax(acc, sc, sh, per_row, act):
    shape = (-1, 1) if per_row else (1, -1)
    out = jdq.dequant_epilogue(jnp.asarray(acc),
                               jnp.asarray(sc.reshape(shape)),
                               jnp.asarray(sh.reshape(shape)),
                               per_row=per_row, act=act, interpret=True)
    return np.asarray(out)


def _torch(acc, sc, sh, per_row, act):
    shape = (-1, 1) if per_row else (1, -1)
    return tdq.dequant_epilogue(
        torch.from_numpy(acc), torch.from_numpy(sc.reshape(shape)),
        torch.from_numpy(sh.reshape(shape)), per_row=per_row,
        act=act).numpy()


def _assert_within_ulp(got, want, acc, sc, per_row):
    coef = sc.reshape((-1, 1) if per_row else (1, -1))
    prod = np.abs(acc.astype(np.float32) * coef)
    tol = np.spacing(np.maximum(prod, np.abs(want)))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (diff <= tol).all(), float((diff / tol).max())
    share = float(np.mean(got == want))
    assert share >= 0.99, share
    return share


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("act", ["relu", "identity"])
def test_plain_version_matches_the_jax_kernel(shape, per_row, act):
    acc, sc, sh = _inputs(*shape, per_row, seed=sum(shape) + per_row)
    before = tdq.launches
    got = _torch(acc, sc, sh, per_row, act)
    want = _jax(acc, sc, sh, per_row, act)
    assert got.dtype == np.float32 and got.shape == shape
    _assert_within_ulp(got, want, acc, sc, per_row)
    if act == "relu":
        assert (got >= 0).all()
    else:
        assert (got < 0).any()
    assert tdq.launches == before   # CPU tensors never launch the kernel


@pytest.mark.parametrize("per_row", [True, False])
def test_accumulators_near_2_24_round_like_jax(per_row):
    acc, sc, sh = _inputs(40, 24, per_row, seed=11, big=True)
    assert np.abs(acc).max() >= 2 ** 24
    got = _torch(acc, sc, sh, per_row, "identity")
    want = _jax(acc, sc, sh, per_row, "identity")
    _assert_within_ulp(got, want, acc, sc, per_row)


def test_plain_version_rounds_once():
    """A case where two roundings (f32 multiply, then add) and one
    (the FMA) differ: the plain version is the single rounding."""
    rng = np.random.RandomState(3)
    acc = rng.randint(-2 ** 22, 2 ** 22, (64, 300)).astype(np.int32)
    sc = (rng.rand(300) * 1e-3).astype(np.float32)
    sh = rng.randn(300).astype(np.float32)
    got = _torch(acc, sc, sh, False, "identity")
    exact = (acc.astype(np.float64) * sc.astype(np.float64)
             + sh.astype(np.float64)).astype(np.float32)
    twice = acc.astype(np.float32) * sc + sh
    assert float(np.mean(got == exact)) >= 0.999
    assert float(np.mean(twice == exact)) < 0.99


def test_per_row_coefficients_are_not_tiled():
    """Per-row coefficients of C channels serve N*C rows (row r takes
    channel r % C); the JAX wrapper's (N*C, 1) column is the tiled
    equivalent."""
    N, C, HW = 3, 5, 49
    acc, sc, sh = _inputs(N * C, HW, True, seed=5)
    sc_c, sh_c = sc[:C], sh[:C]
    got = tdq.dequant_epilogue(torch.from_numpy(acc),
                               torch.from_numpy(sc_c).reshape(C, 1),
                               torch.from_numpy(sh_c).reshape(C, 1),
                               per_row=True, act="relu").numpy()
    want = _jax(acc, np.tile(sc_c, N), np.tile(sh_c, N), True, "relu")
    _assert_within_ulp(got, want, acc, np.tile(sc_c, N), True)


_ELIGIBLE_CASES = [((4, 8), "relu"), ((4, 8), "identity"), ((2, 3, 4), "relu"),
                   ((8,), "relu"), ((4, 8), "gelu"), ((0, 8), "relu"),
                   ((4, 0), "identity")]


@pytest.mark.parametrize("shape,act", _ELIGIBLE_CASES)
def test_guard_reasons_match_jax(shape, act):
    assert tdq.eligible(shape, act=act) == jdq.eligible(shape, act=act)
    assert tdq.shape_key_shapes(shape) == jdq.shape_key_shapes(shape)


def test_guard_failure_raises_like_jax_and_meta_has_no_kernel():
    acc = torch.zeros(2, 3, 4, dtype=torch.int32)
    v = torch.ones(1, 4)
    with pytest.raises(ValueError, match="dequant_epilogue guard: "
                                         "accumulator view must be 2-D"):
        tdq.dequant_epilogue(acc, v, v, per_row=False)
    with pytest.raises(ValueError, match="dequant_epilogue guard"):
        jdq.dequant_epilogue(jnp.zeros((2, 3, 4), jnp.int32),
                             jnp.ones((1, 4)), jnp.ones((1, 4)),
                             per_row=False, interpret=True)
    m = torch.empty(4, 8, dtype=torch.int32, device="meta")
    c = torch.empty(1, 8, device="meta")
    with pytest.raises(mt.MXNetError, match="no kernel for meta"):
        tdq.dequant_epilogue(m, c, c, per_row=False)
    assert tdq.OP_NAME == jdq.OP_NAME


_BAD_OPERANDS = [
    (dict(acc_dtype=torch.int64), "must be int32"),
    (dict(transpose=True), "contiguous 2-D"),
    (dict(per_row=True, n_coef=3), "must divide the 8 rows"),
    (dict(n_coef=5), "must number 8"),
    (dict(coef_dtype=torch.float64), "sc must be 8 contiguous f32"),
    (dict(act="gelu"), "unsupported activation"),
]


@pytest.mark.parametrize("kw,msg", _BAD_OPERANDS)
def test_wrapper_checks_what_the_kernel_takes(kw, msg):
    """The checks the CUDA wrapper makes before a launch (run here on
    CPU tensors; the card's tests launch)."""
    acc = torch.zeros(8, 8, dtype=kw.get("acc_dtype", torch.int32))
    if kw.get("transpose"):
        acc = acc.t()
    n = kw.get("n_coef", 8)
    sc = torch.ones(n, dtype=kw.get("coef_dtype", torch.float32))
    sh = torch.ones(n)
    with pytest.raises(mt.MXNetError, match=msg):
        tdq._check(acc, sc, sh, kw.get("per_row", False),
                   kw.get("act", "relu"))


def test_launch_counters_reset():
    tdq.reset_launches()
    assert tdq.launches == 0
    assert set(tdq.launches_by_kernel) == {
        "column/relu", "column/identity", "row/relu", "row/identity"}
    assert not any(tdq.launches_by_kernel.values())
