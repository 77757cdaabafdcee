"""``nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``): the
eager samplers over the ``_random_*``/``_sample_*`` ops, drawing from
the key chain (``mxnet_tpu_torch.random``). An array ``low``/``loc``/
``alpha`` selects the per-element ``_sample_*`` op."""
from __future__ import annotations

from . import ndarray as _nd


def _shape(shape):
    if shape is None:
        return (1,)
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    if isinstance(low, _nd.NDArray):
        return _nd.invoke("_sample_uniform", [low, high],
                          {"shape": shape or ()})
    return _nd.invoke("_random_uniform", [], {
        "low": low, "high": high, "shape": _shape(shape), "dtype": dtype,
        "ctx": ctx}, out=out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    if isinstance(loc, _nd.NDArray):
        return _nd.invoke("_sample_normal", [loc, scale],
                          {"shape": shape or ()})
    return _nd.invoke("_random_normal", [], {
        "loc": loc, "scale": scale, "shape": _shape(shape), "dtype": dtype,
        "ctx": ctx}, out=out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, **kw):
    if isinstance(alpha, _nd.NDArray):
        return _nd.invoke("_sample_gamma", [alpha, beta],
                          {"shape": shape or ()})
    return _nd.invoke("_random_gamma", [], {
        "alpha": alpha, "beta": beta, "shape": _shape(shape),
        "dtype": dtype, "ctx": ctx}, out=out)


def exponential(lam=1.0, shape=None, dtype="float32", ctx=None, out=None,
                **kw):
    return _nd.invoke("_random_exponential", [], {
        "lam": lam, "shape": _shape(shape), "dtype": dtype, "ctx": ctx},
        out=out)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None, **kw):
    return _nd.invoke("_random_poisson", [], {
        "lam": lam, "shape": _shape(shape), "dtype": dtype, "ctx": ctx},
        out=out)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None, **kw):
    return _nd.invoke("_random_negative_binomial", [], {
        "k": k, "p": p, "shape": _shape(shape), "dtype": dtype,
        "ctx": ctx}, out=out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None, **kw):
    return _nd.invoke("_random_generalized_negative_binomial", [], {
        "mu": mu, "alpha": alpha, "shape": _shape(shape), "dtype": dtype,
        "ctx": ctx}, out=out)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None, **kw):
    return _nd.invoke("_random_randint", [], {
        "low": low, "high": high, "shape": _shape(shape), "dtype": dtype,
        "ctx": ctx}, out=out)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    return _nd.invoke("_sample_multinomial", [data], {
        "shape": shape or (), "get_prob": get_prob, "dtype": dtype})


def shuffle(data, **kw):
    return _nd.invoke("_shuffle", [data], {})


def randn(*shape, **kwargs):
    """Standard-normal draws, the shape given positionally."""
    loc = kwargs.pop("loc", 0.0)
    scale = kwargs.pop("scale", 1.0)
    return normal(loc, scale, shape or (1,), **kwargs)
