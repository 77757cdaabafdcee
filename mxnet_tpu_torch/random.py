"""The random key chain and its samplers (counterpart of
``mxnet_tpu/random.py``).

The JAX package reproduces MXNet's stateful RNG with a key chain: one
thread-local key, split on every eager draw, and inside a traced graph
a per-call base key that each random op folds with its site count
(``TraceRng``). The port keeps the same chain, so that after
``seed(s)`` every draw, mask and shuffle equals the JAX package's bit
for bit: keys are ``jax.random`` keys as jax 0.9 makes them with
``jax_threefry_partitionable`` on, hashed by the port's Threefry-2x32
(``serve/_threefry.py``); a ``torch.Generator`` would give another
stream.

A key is a numpy ``uint32`` pair on the host; the chain, ``split`` and
``fold_in`` of one key run there on Python ints, so drawing a key never
touches a device. A key may also be an int64 tensor pair on a device
(the grouped train step stages its keys so): then ``fold_in``,
``split`` and the samplers hash it there in tensor ops and never read
it back, so a captured CUDA graph draws fresh bits on every replay. The samplers (:func:`uniform`, :func:`normal`, ...)
hash the element counts under a key on the device the caller names.
Each follows its ``jax.random`` namesake step for step; where a step is
a transcendental (``normal``'s ``erf_inv``, ``exponential``'s
``log1p``) torch's function may round differently from XLA's in the
last places, so those draws agree within a few f32 ulp, not bitwise.
:func:`erfinv` is XLA's single-precision polynomial (Giles), not
``torch.erfinv``, which differs from it by up to 64 ulp; :func:`exp_f32`
is XLA's f32 ``exp`` on the CPU (Cephes, with fused multiply-adds),
which ``torch.exp`` misses by an ulp on ~10 % of inputs.
"""
from __future__ import annotations

import math
import threading

import numpy as _np
import torch

from .base import MXNetError, normalize_dtype

# the samplers of ``ndarray.random``, re-exported here as in the JAX
# package (resolved lazily: this module loads before the ndarray package)
_SAMPLERS = ("uniform", "normal", "randn", "poisson", "exponential",
             "gamma", "negative_binomial", "generalized_negative_binomial",
             "multinomial", "shuffle", "randint")

__all__ = ["seed", "next_key", "get_state", "set_state", "TraceRng",
           "current_trace_rng", "trace_scope", "prng_key", "split",
           "fold_in", *_SAMPLERS]

_M32 = 0xFFFFFFFF
_TINY = float(_np.finfo(_np.float32).tiny)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def __getattr__(name):
    if name in _SAMPLERS:
        from .ndarray import random as _ndrandom
        return getattr(_ndrandom, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


# ---------------------------------------------------------------------------
# Threefry-2x32 (20 rounds), JAX's default PRNG hash
# ---------------------------------------------------------------------------

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the count words (x1, x2) under the key (k1, k2):
    uint32 values held in Python ints or int64 tensors (masked to 32
    bits, so every add, shift and rotate is exact on any device),
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


# ---------------------------------------------------------------------------
# keys (host)
# ---------------------------------------------------------------------------

def _key(k1, k2):
    return _np.array([int(k1) & _M32, int(k2) & _M32], _np.uint32)


def _words(key):
    """A key (numpy uint32 pair, int64 tensor pair, or a sequence) as
    two words: Python ints, or for a tensor key its two 0-d int64
    tensors, left on their device (no host read)."""
    if isinstance(key, torch.Tensor):
        if tuple(key.shape) != (2,):
            raise MXNetError("a PRNG key is a pair of uint32 words, got "
                             "shape %s" % (tuple(key.shape),))
        key = key.to(torch.int64)
        return key[0], key[1]
    k = _np.asarray(key, dtype=_np.int64).reshape(-1)
    if k.shape != (2,):
        raise MXNetError("a PRNG key is a pair of uint32 words, got shape "
                         "%s" % (tuple(k.shape),))
    return int(k[0]) & _M32, int(k[1]) & _M32


def prng_key(seed_state):
    """``jax.random.PRNGKey(seed)`` with 32-bit seeds (the JAX package
    runs with x64 off): the pair (0, seed mod 2**32)."""
    s = int(seed_state)
    hi = (s >> 32) & _M32 if s >= 2 ** 31 else 0
    return _key(hi, s)


def _pack(k1, k2):
    """Two words as a key of the kind they came from: a numpy uint32
    pair, or a stacked int64 tensor pair."""
    if isinstance(k1, torch.Tensor):
        return torch.stack([k1, k2])
    return _key(k1, k2)


def split(key, num=2):
    """``jax.random.split``: ``num`` keys, a ``(num, 2)`` uint32 array
    (an int64 tensor for a tensor key)."""
    k1, k2 = _words(key)
    if isinstance(k1, torch.Tensor):
        i = torch.arange(int(num), dtype=torch.int64, device=k1.device)
        return torch.stack(threefry2x32(k1, k2, i >> 32, i & _M32), 1)
    out = _np.empty((int(num), 2), _np.uint32)
    for i in range(int(num)):
        out[i] = threefry2x32(k1, k2, i >> 32, i & _M32)
    return out


def fold_in(key, data):
    """``jax.random.fold_in`` of an int (taken mod 2**32)."""
    k1, k2 = _words(key)
    return _pack(*threefry2x32(k1, k2, 0, int(data) & _M32))


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

_state = threading.local()


def _chain():
    if getattr(_state, "key", None) is None:
        _state.key = prng_key(_np.random.randint(0, 2 ** 31 - 1))
    return _state.key


def seed(seed_state):
    """Seed this thread's key chain, and numpy's global generator."""
    _state.key = prng_key(seed_state)
    _np.random.seed(int(seed_state) % (2 ** 32))


def get_state():
    """``(key, numpy_state)``: the chain's key as a uint32 pair (None
    before any seed or draw) and ``np.random.get_state()``."""
    key = getattr(_state, "key", None)
    return (None if key is None else key.copy()), _np.random.get_state()


def set_state(snapshot):
    """Restore a :func:`get_state` snapshot."""
    key, np_state = snapshot
    _state.key = None if key is None else _key(*_words(key))
    if np_state is not None:
        _np.random.set_state(np_state)


class TraceRng:
    """The keys of one graph call: random op number ``i`` in it takes
    ``fold_in(base_key, i)``."""

    def __init__(self, base_key):
        self.base_key = base_key
        self.count = 0

    def next_key(self):
        k = fold_in(self.base_key, self.count)
        self.count += 1
        return k


def current_trace_rng():
    return getattr(_state, "trace_rng", None)


class _TraceScope:
    def __init__(self, rng):
        self.rng = rng

    def __enter__(self):
        self.prev = getattr(_state, "trace_rng", None)
        _state.trace_rng = self.rng
        return self.rng

    def __exit__(self, *a):
        _state.trace_rng = self.prev


def trace_scope(base_key):
    """Scope in which :func:`next_key` folds ``base_key`` with a count
    instead of advancing the chain."""
    return _TraceScope(TraceRng(base_key))


def next_key():
    """A fresh key: inside a trace scope the next fold of its base key,
    else the chain's split (the chain keeps the first half)."""
    tr = current_trace_rng()
    if tr is not None:
        return tr.next_key()
    k1, k2 = _words(_chain())
    _state.key = _key(*threefry2x32(k1, k2, 0, 0))
    return _key(*threefry2x32(k1, k2, 0, 1))


# ---------------------------------------------------------------------------
# samplers (device)
# ---------------------------------------------------------------------------

# nbits, mantissa bits, the bits of 1.0
_FLOATS = {torch.float32: (32, 23, 0x3F800000),
           torch.float16: (16, 10, 0x3C00),
           torch.bfloat16: (16, 7, 0x3F80)}


def _float_dtype(dtype):
    """The sampling dtype: float64 narrows to float32, as under the JAX
    package's x64-off default."""
    dt = normalize_dtype(dtype or "float32")
    if dt == torch.float64:
        dt = torch.float32
    if dt not in _FLOATS:
        raise MXNetError("random: a float dtype is needed, got %s" % dt)
    return dt


def _shape(shape):
    return tuple(int(s) for s in shape)


def bits(key, shape, device=None):
    """32 random bits per element of ``shape`` as int64 (``jax.random``'s
    partitionable ``_random_bits``): both outputs of the element's flat
    index hashed under ``key``, xor-ed."""
    shape = _shape(shape)
    k1, k2 = _words(key)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    if isinstance(k1, torch.Tensor):
        k1, k2 = k1.to(i.device), k2.to(i.device)
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & _M32)
    return (b1 ^ b2).reshape(shape)


def _unit(b, dtype):
    """Floats in [0, 1) from random bits: the top mantissa bits under the
    exponent of 1.0, minus 1 (8 bits drawn for bfloat16)."""
    nbits, nmant, one = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    b = b & ((1 << rng_bits) - 1)
    fb = (b >> (rng_bits - nmant)) | one
    iv = fb.to(torch.int32 if nbits == 32 else torch.int16)
    return iv.view(dtype) - 1.0


def _scale(f, minval, maxval):
    """``max(lo, f * (hi - lo) + lo)`` in f's dtype, the multiply-add
    fused as XLA's CPU backend fuses it for f32 and f16 (emulated in f64,
    where the product is exact); bfloat16 rounds after each step."""
    # torch.full, not torch.tensor: a fill on the device, where
    # torch.tensor would copy from the host (no copy inside a CUDA graph)
    lo = torch.full((), minval, dtype=f.dtype, device=f.device)
    hi = torch.full((), maxval, dtype=f.dtype, device=f.device)
    if f.dtype == torch.bfloat16:
        return torch.maximum(lo, f * (hi - lo) + lo)
    y = f.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, y.to(f.dtype))


def uniform(key, shape, dtype="float32", minval=0.0, maxval=1.0,
            device=None):
    """``jax.random.uniform``."""
    dt = _float_dtype(dtype)
    return _scale(_unit(bits(key, shape, device), dt), minval, maxval)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x):
    """XLA's f32 ``erf_inv`` (M. Giles' single-precision polynomials in
    ``w = -log1p(-x * x)``), computed in f32 for any float dtype."""
    dt = x.dtype
    x = x.float()
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.full((), _ERFINV_LT5[i],
                                          device=x.device),
                           torch.full((), _ERFINV_GE5[i], device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    r = torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                    p * x)
    return r.to(dt)


def _fma_f32(a, b, c):
    """``fma(a, b, c)`` of f32 values rounded once to f32, on any
    device: the product is exact in f64, the sum's rounding error comes
    from a two-sum, and the f64 sum is rounded to odd before the single
    rounding to f32 (53 bits hold 24 + 2, so the double rounding is
    exact). ``b`` and ``c`` may be Python floats holding f32 values."""
    f64 = torch.float64
    p = a.to(f64) * (b.to(f64) if isinstance(b, torch.Tensor) else b)
    if isinstance(c, torch.Tensor):
        c = c.to(f64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    si = s.view(torch.int64)
    # the odd one of s and its neighbour toward the exact sum
    step = torch.where((err > 0) == (s > 0), 1, -1)
    si = torch.where(((si & 1) == 0) & (err != 0), si + step, si)
    return si.view(f64).to(torch.float32)


def _f32(v):
    return float(_np.float32(v))


_EXP_POLY = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                    8.3334519073e-3, 4.1665795894e-2,
                                    1.6666665459e-1, 5.0000001201e-1))


def exp_f32(x):
    """XLA's f32 ``exp`` on the CPU, bit for bit: Cephes' range
    reduction ``x - n ln 2`` (ln 2 in two parts) and degree-5 polynomial,
    each multiply-add fused as LLVM contracts them, then ``2^n`` built
    in the exponent bits. ``torch.exp`` differs from it by an ulp on
    ~10 % of inputs. Inputs clamp to [-87.8, 88.8]."""
    x = x.float().clamp(_f32(-87.8), _f32(88.8))
    n = torch.floor(_fma_f32(x, _f32(1.44269504088896341), 0.5))
    n = n.clamp(-127.0, 127.0)
    r = _fma_f32(n, -_f32(0.693359375), x)
    r = _fma_f32(n, _f32(2.12194440e-4), r)
    z = _fma_f32(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        z = _fma_f32(z, r, c)
    z = 1.0 + _fma_f32(z, r * r, r)
    return z * ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def normal(key, shape, dtype="float32", device=None):
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)``, u uniform in
    (-1, 1)."""
    dt = _float_dtype(dtype)
    lo = float(_np.nextafter(_np.array(-1.0, _np.float32), _np.float32(0)))
    if dt != torch.float32:
        lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dt),
                                   torch.tensor(0.0, dtype=dt)))
    u = uniform(key, shape, dt, lo, 1.0, device)
    return torch.full((), math.sqrt(2), dtype=dt, device=u.device) \
        * erfinv(u)


def exponential(key, shape, dtype="float32", device=None):
    """``jax.random.exponential``: ``-log1p(-u)``."""
    return -torch.log1p(-uniform(key, shape, dtype, device=device))


def bernoulli(key, p, shape, device=None):
    """``jax.random.bernoulli`` with a float ``p``: ``uniform < p``."""
    u = uniform(key, shape, torch.float32, device=device)
    return u < torch.full((), float(p), dtype=torch.float32,
                          device=u.device)


def randint(key, shape, low, high, dtype="int32", device=None):
    """``jax.random.randint``: two 32-bit words a value, reduced modulo
    the span in uint32 arithmetic. Sampled in int32 (int64 narrows, as
    with x64 off); a narrower type clips its bounds to its range, samples
    in int32 and casts."""
    dt = normalize_dtype(dtype or "int32")
    if dt.is_floating_point or dt == torch.bool:
        raise MXNetError("randint only accepts integer dtypes, got %s" % dt)
    if dt == torch.int64:
        dt = torch.int32
    low, high = int(low), int(high)
    if dt != torch.int32:
        info = torch.iinfo(dt)
        low = min(max(low, info.min), info.max)
        high = min(max(high, info.min), info.max + 1)
    if not (-2 ** 31 <= low < 2 ** 31 and -2 ** 31 <= high < 2 ** 31):
        raise MXNetError("randint: bounds (%d, %d) outside int32"
                         % (low, high))
    ka, kb = split(key)
    hb, lb = bits(ka, shape, device), bits(kb, shape, device)
    span = 1 if high <= low else (high - low) & _M32
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((((hb % span) * mult) & _M32) + (lb % span)) & _M32
    off = off % span
    v = ((low + off + 2 ** 31) & _M32) - 2 ** 31
    return v.to(torch.int32).to(dt)


def permutation(key, n, device=None):
    """``jax.random.permutation(key, n)``: rounds of a stable sort by
    fresh 32-bit keys (one round below 1626 elements)."""
    n = int(n)
    rounds = int(_np.ceil(3 * _np.log(max(1, n))
                          / _np.log(_np.iinfo(_np.uint32).max)))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, (n,), device), stable=True).indices
        idx = idx[order]
    return idx


def categorical_rows(key, logits, n):
    """``jax.random.categorical(k_r, logits[r], shape=(n,))`` for each
    row r of ``(R, K)`` f32 logits, ``k_r`` the r-th key of
    ``split(key, R)`` -> ``(R, n)`` int64 draws."""
    R, K = logits.shape
    keys = split(key, R)
    keys = (keys.to(logits.device) if isinstance(keys, torch.Tensor) else
            torch.as_tensor(keys.astype(_np.int64), device=logits.device))
    i = torch.arange(n * K, dtype=torch.int64, device=logits.device)
    b1, b2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], (i >> 32)[None],
                          (i & _M32)[None])
    u = _scale(_unit(b1 ^ b2, torch.float32), _TINY, 1.0)
    g = -torch.log(-torch.log(u)).reshape(R, n, K)
    return torch.argmax(g + logits[:, None, :], dim=-1)
