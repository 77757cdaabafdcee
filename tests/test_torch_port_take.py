"""Port parity for the row gather (``take_rows`` / ``gather_pages``).

The port's plain version (CPU tensors) must be bitwise the JAX
package's Pallas kernel (interpret mode) and its clipped ``jnp.take``
fallback, out-of-range ids included: ids clip to ``[0, vocab-1]`` where
torch indexing would raise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import config as jconfig
from mxnet_tpu.kernels import take as jtake

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import take as ttake
from mxnet_tpu_torch.kernels import tier as ttier


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx_shape", [(37,), (4, 24)])
def test_take_rows_is_bitwise_the_jax_kernel(dtype, idx_shape):
    rng = np.random.RandomState(len(idx_shape))
    table = rng.randn(50, 128).astype(np.float32)
    ids = rng.randint(-20, 70, idx_shape).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jconfig.override(kernel_tier="auto"):
        want = np.asarray(jnp.asarray(
            jtake.take_rows(jnp.asarray(table, jdt), jnp.asarray(ids)),
            jnp.float32))
    got = ttake.take_rows(torch.from_numpy(table).to(tdt),
                          torch.from_numpy(ids))
    assert got.dtype == tdt and got.shape == idx_shape + (128,)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gather_pages_clips_like_the_jax_fallback_at_any_width():
    rng = np.random.RandomState(1)
    table = rng.randn(40, 33).astype(np.float32)     # D % 128 != 0
    ids = rng.randint(-5, 60, (3, 16)).astype(np.int32)
    want = np.asarray(jtake.gather_pages(jnp.asarray(table),
                                         jnp.asarray(ids)))
    with mt.config.override(kernel_tier="auto"):
        ttier.reset_stats()
        got = ttake.gather_pages(torch.from_numpy(table),
                                 torch.from_numpy(ids))
        st = ttier.stats()
    np.testing.assert_array_equal(got.numpy(), want)
    # the port dispatches where the JAX package's lane rule falls back
    assert st["dispatch"] == {"take_rows": 1} and not st["fallback"]
    assert "lane-aligned" in jtake.eligible((40, 33), jnp.float32, (3, 16),
                                            jnp.int32)
    assert ttake.eligible((40, 33), torch.float32, (3, 16),
                          torch.int32) is None
    assert ttake.launches == 0   # the plain version launches nothing


def test_guard_reasons():
    f32 = torch.float32
    assert "2-D" in ttake.eligible((4, 5, 6), f32, (3,), torch.int32)
    assert "dtype" in ttake.eligible((4, 8), torch.int32, (3,), torch.int32)
    assert "empty vocab" in ttake.eligible((0, 8), f32, (3,), torch.int32)
    assert "1-D or 2-D" in ttake.eligible((4, 8), f32, (1, 2, 3),
                                          torch.int32)
    assert "castable" in ttake.eligible((4, 8), f32, (3,), torch.bool)
    assert "empty index" in ttake.eligible((4, 8), f32, (0,), torch.int32)
    with pytest.raises(ValueError, match="take_rows guard"):
        ttake.take_rows(torch.zeros(4, 5, 6), torch.zeros(3,
                                                          dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_grad_matches_jax_grad(dtype):
    """The backward (scatter-add at the clipped ids) against ``jax.grad``
    through the JAX kernel's ``custom_vjp``: out-of-range ids land on
    rows 0 and vocab-1 and repeated ids add up. The cotangent holds
    quarters in [-1, 1], so every partial sum is exact in bf16 too and
    the two must be equal whatever order they add in."""
    import jax
    rng = np.random.RandomState(3)
    table = rng.randn(40, 128).astype(np.float32)
    ids = rng.randint(-10, 50, (4, 24)).astype(np.int32)
    cot = (rng.randint(-4, 5, (4, 24, 128)) / 4.0).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jconfig.override(kernel_tier="auto"):
        want = jax.grad(lambda w: jnp.sum(
            jtake.take_rows(w, jnp.asarray(ids)).astype(jnp.float32)
            * jnp.asarray(cot)))(jnp.asarray(table, jdt))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    w = torch.from_numpy(table).to(tdt).requires_grad_(True)
    out = ttake.take_rows(w, torch.from_numpy(ids))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    got = w.grad.float().numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[0]).sum() > 0 and np.abs(got[-1]).sum() > 0
