"""Random sampling operators (counterpart of ``mxnet_tpu/ops/random_ops.py``
and of ``_sample_exponential`` and the random-surface aliases in its
``legacy_aliases.py``).

Every op takes its key from :func:`random.next_key`: the chain in an
eager call, the call's folded key inside a hybridized block or an
executor's graph. The draws are :mod:`random`'s samplers, which follow
``jax.random`` step for step, so after ``seed(s)`` an op returns the
JAX package's values (normal and exponential draws within a few f32
ulp; see ``random.py``).

The gamma family (``_random_gamma``, ``_random_poisson``, the negative
binomials, ``_sample_gamma`` and the ``_sample_*`` Poisson mixtures,
with their aliases ``random_gamma`` ...) draws through JAX's rejection
loops, which are not ported: those ops raise (ROADMAP A3b.1b).
``_sample_unique_zipfian`` runs the JAX op's vectorised rejection loop
block by block on the device, all rows at once. A no-input op lands on
``ctx``, on the CPU when it is None.
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


@register("_sample_unique_zipfian", is_random=True, num_outputs=2,
          host=True)
def sample_unique_zipfian(*, range_max, shape=(1, 1), ctx=None):
    """``n`` distinct classes a row from the log-uniform (zipfian)
    proposal, and the draws each row took: the JAX op's loop over
    blocks of proposals, all rows at once on ``ctx``'s device. A block
    is deduplicated by a stable sort and checked against the sorted set
    so far (a draw after the one that fills the row never happened); a
    row that is full keeps its state, as under the JAX op's vmap. The
    loop reads back one flag a block. Int32."""
    shape = tuple(shape)
    if len(shape) == 1:
        shape = (1,) + shape
    batch, n = shape
    if n > range_max:
        raise ValueError("Number of samples (%d) cannot exceed the number "
                         "of possible classes (%d)" % (n, range_max))
    dev, i32, i64 = _dev(ctx), torch.int32, torch.int64
    log_rm = torch.log(torch.tensor(float(range_max), dtype=torch.float32,
                                    device=dev))
    blk = min(max(64, 2 * n), 8192)
    keys = _random.split(_random.next_key(), batch)
    if not isinstance(keys, torch.Tensor):
        keys = torch.from_numpy(keys.astype("int64"))
    keys = keys.to(dev, i64)
    k1, k2 = keys[:, :1], keys[:, 1:]
    two = torch.arange(2, dtype=i64, device=dev)
    draw = torch.arange(blk, dtype=i64, device=dev)
    samples = torch.zeros((batch, n + 1), dtype=i32, device=dev)
    sset = torch.full((batch, n), range_max, dtype=i32, device=dev)
    tries = torch.zeros((batch,), dtype=i32, device=dev)
    count = torch.zeros((batch,), dtype=i32, device=dev)
    while bool((count < n).any()):
        live = count < n
        # split(key): the row's next key and this block's subkey
        s1, s2 = _random.threefry2x32(k1, k2, 0, two)
        b1, b2 = _random.threefry2x32(s1[:, 1:], s2[:, 1:], 0, draw)
        # jax.random.uniform on [0, 1): the unit float of the bits
        x = _random._unit(b1 ^ b2, torch.float32)
        k1 = torch.where(live[:, None], s1[:, :1], k1)
        k2 = torch.where(live[:, None], s2[:, :1], k2)
        vals = (torch.round(_random.exp_f32(x * log_rm)).to(i32) - 1).clamp(
            0, range_max - 1)
        sv, order = torch.sort(vals, dim=1, stable=True)
        head = torch.ones_like(sv, dtype=torch.bool)
        head[:, 1:] = sv[:, 1:] != sv[:, :-1]
        first = torch.zeros_like(head).scatter_(1, order, head)
        at = torch.searchsorted(sset.contiguous(), vals).clamp(0, n - 1)
        is_new = first & (torch.gather(sset, 1, at) != vals)
        pos = count[:, None] + torch.cumsum(is_new.to(i32), 1)
        apply = is_new & (pos <= n) & live[:, None]
        samples.scatter_(1, torch.where(apply, pos - 1, n).to(i64), vals)
        sset = torch.sort(torch.cat(
            [sset, torch.where(apply, vals, range_max)], 1), 1).values[:, :n]
        last = pos[:, -1]
        took = torch.where(last >= n, torch.argmax((pos >= n).to(i32), 1)
                           .to(i32) + 1, blk)
        tries = torch.where(live, tries + took, tries)
        count = torch.where(live, torch.clamp_max(last, n), count)
    return samples[:, :n].contiguous(), tries


# the random-surface names of the JAX package's alias table
for _legacy, _new in {
    "uniform": "_random_uniform", "random_uniform": "_random_uniform",
    "normal": "_random_normal", "random_normal": "_random_normal",
    "random_gamma": "_random_gamma",
    "random_exponential": "_random_exponential",
    "random_poisson": "_random_poisson",
    "random_negative_binomial": "_random_negative_binomial",
    "random_generalized_negative_binomial":
        "_random_generalized_negative_binomial",
    "random_randint": "_random_randint",
    "sample_multinomial": "_sample_multinomial",
    "shuffle": "_shuffle",
}.items():
    alias(_new, _legacy)
