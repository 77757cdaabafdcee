"""Random sampling operators (counterpart of ``mxnet_tpu/ops/random_ops.py``
and of ``_sample_exponential`` in its ``legacy_aliases.py``).

Every op takes its key from :func:`random.next_key`: the chain in an
eager call, the call's folded key inside a hybridized block or an
executor's graph. The draws are :mod:`random`'s samplers, which follow
``jax.random`` step for step, so after ``seed(s)`` an op returns the
JAX package's values (normal and exponential draws within a few f32
ulp; see ``random.py``).

The gamma family (``_random_gamma``, ``_random_poisson``, the negative
binomials, ``_sample_gamma`` and the ``_sample_*`` Poisson mixtures)
draws through JAX's rejection loops, which are not ported: those ops
raise (ROADMAP A3b.1b). A no-input op lands on ``ctx``, on the CPU when
it is None.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError, normalize_dtype
from .init_ops import _dev
from .registry import alias, register


def _ext(t, shape):
    """``t`` broadcast over the trailing sample dims ``shape``."""
    return t.reshape(tuple(t.shape) + (1,) * len(tuple(shape)))


@register("_random_uniform", is_random=True)
def random_uniform(*, low=0.0, high=1.0, shape=(1,), dtype="float32",
                   ctx=None):
    return _random.uniform(_random.next_key(), shape, dtype, low, high,
                           _dev(ctx))


@register("_random_normal", is_random=True)
def random_normal(*, loc=0.0, scale=1.0, shape=(1,), dtype="float32",
                  ctx=None):
    return loc + scale * _random.normal(_random.next_key(), shape, dtype,
                                        _dev(ctx))


alias("_random_normal", "_random_gaussian")


@register("_random_uniform_like", is_random=True)
def random_uniform_like(data, *, low=0.0, high=1.0, dtype=None):
    return _random.uniform(_random.next_key(), data.shape,
                           dtype or data.dtype, low, high, data.device)


@register("_random_normal_like", is_random=True)
def random_normal_like(data, *, loc=0.0, scale=1.0, dtype=None):
    return loc + scale * _random.normal(_random.next_key(), data.shape,
                                        dtype or data.dtype, data.device)


@register("_random_exponential", is_random=True)
def random_exponential(*, lam=1.0, shape=(1,), dtype="float32", ctx=None):
    return _random.exponential(_random.next_key(), shape, dtype,
                               _dev(ctx)) / lam


@register("_random_randint", is_random=True)
def random_randint(*, low=0, high=1, shape=(1,), dtype="int32", ctx=None):
    return _random.randint(_random.next_key(), shape, low, high, dtype,
                           _dev(ctx))


@register("_sample_uniform", is_random=True)
def sample_uniform(low, high, *, shape=(), dtype="float32"):
    u = _random.uniform(_random.next_key(), tuple(low.shape) + tuple(shape),
                        dtype, device=low.device)
    return _ext(low, shape) + u * _ext(high - low, shape)


@register("_sample_normal", is_random=True)
def sample_normal(mu, sigma, *, shape=(), dtype="float32"):
    z = _random.normal(_random.next_key(), tuple(mu.shape) + tuple(shape),
                       dtype, mu.device)
    return _ext(mu, shape) + z * _ext(sigma, shape)


@register("_sample_exponential", is_random=True)
def sample_exponential(lam, *, shape=None, dtype="float32"):
    out = tuple(lam.shape) + tuple(shape or ())
    e = _random.exponential(_random.next_key(), out, dtype, lam.device)
    return e / lam.reshape(tuple(lam.shape) + (1,) * (len(out) - lam.dim()))


@register("_sample_multinomial", is_random=True,
          num_outputs=lambda p: 2 if p.get("get_prob") else 1)
def sample_multinomial(data, *, shape=(), get_prob=False, dtype="int32"):
    """Draws from the categorical rows of ``(..., K)`` probabilities:
    the JAX op's Gumbel-max over ``log(max(p, 1e-30))``, one key a row
    (``split``)."""
    n = 1
    for s in tuple(shape) or ():
        n *= int(s)
    logits = torch.log(torch.clamp_min(data, 1e-30))
    flat = logits.reshape(-1, logits.shape[-1])
    draws = _random.categorical_rows(_random.next_key(), flat, max(n, 1))
    out_shape = tuple(data.shape[:-1]) + (tuple(shape) if shape else ())
    out = draws.reshape(out_shape).to(normalize_dtype(dtype))
    if get_prob:
        lp = torch.gather(torch.log_softmax(flat, -1), -1, draws)
        return out, lp.reshape(out_shape)
    return out


@register("_shuffle", is_random=True)
def shuffle(data):
    """Rows of ``data`` in ``jax.random.permutation``'s order."""
    return data[_random.permutation(_random.next_key(), data.shape[0],
                                    data.device)]


def _gamma_family(name):
    def fn(*args, **kwargs):
        raise MXNetError(
            "%s draws through JAX's gamma/Poisson rejection loops, which "
            "are not ported yet (ROADMAP A3b.1b)" % name)
    fn.__name__ = name
    fn.__doc__ = "Not ported: raises (ROADMAP A3b.1b)."
    return fn


for _name in ("_random_gamma", "_random_poisson", "_random_negative_binomial",
              "_random_generalized_negative_binomial"):
    register(_name, is_random=True)(_gamma_family(_name))

for _name in ("_sample_gamma", "_sample_poisson", "_sample_negative_binomial",
              "_sample_generalized_negative_binomial"):
    register(_name, is_random=True)(_gamma_family(_name))
