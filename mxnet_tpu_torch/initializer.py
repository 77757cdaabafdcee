"""Weight initializers (counterpart of a subset of ``mxnet_tpu/initializer.py``):
the name-suffix rules of ``Initializer`` and ``Uniform``, ``Normal``,
``Zero``, ``One``, ``Constant`` and ``Xavier``.

Each initializer draws from its own ``torch.Generator`` seeded by its
``seed`` argument (the JAX package draws from numpy's global state), on
the CPU in f32, and copies the values into the tensor it is given, in
place. Two initializers with the same seed fill the same parameters in
the same order with the same values.
"""
from __future__ import annotations

import json

import torch

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Xavier",
           "InitDesc", "register", "create"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(initializer, **kwargs):
    if initializer is None:
        return Uniform()
    if isinstance(initializer, Initializer):
        return initializer
    if isinstance(initializer, str):
        try:
            obj = json.loads(initializer)
            if isinstance(obj, list):
                return _INIT_REGISTRY[obj[0].lower()](**obj[1])
        except (ValueError, KeyError):
            pass
        return _INIT_REGISTRY[initializer.lower()](**kwargs)
    raise TypeError("invalid initializer %r" % (initializer,))


class InitDesc(str):
    """Name + attrs descriptor handed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Fills a tensor by the suffix of its name: ``weight`` by the
    subclass's rule, ``bias``/``beta``/moving means with zeros,
    ``gamma``/moving variances with ones. A ``__init__`` attr names
    another initializer for that parameter."""

    def __init__(self, seed=0, **kwargs):
        self._kwargs = kwargs
        self.seed = seed
        self._gen = torch.Generator().manual_seed(int(seed))

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        if desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            self._init_zero(desc, arr)
        elif name.endswith("gamma"):
            self._init_one(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        elif name.endswith("min") or name.endswith("max"):
            self._init_zero(desc, arr)
        else:
            raise ValueError(
                "Unknown initialization pattern for %s. Default init needs "
                "a name ending in weight/bias/gamma/beta" % desc)

    @staticmethod
    def _set(arr, values):
        with torch.no_grad():
            arr.copy_(values.to(device=arr.device, dtype=arr.dtype))

    def _init_zero(self, _, arr):
        self._set(arr, torch.zeros(arr.shape))

    def _init_one(self, _, arr):
        self._set(arr, torch.ones(arr.shape))

    def _uniform(self, arr, scale):
        u = torch.rand(tuple(arr.shape), generator=self._gen)
        self._set(arr, (u * 2.0 - 1.0) * scale)

    def _normal(self, arr, sigma):
        self._set(arr, torch.randn(tuple(arr.shape), generator=self._gen)
                  * sigma)

    def _init_weight(self, name, arr):
        raise NotImplementedError


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07, seed=0):
        super().__init__(seed=seed, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._uniform(arr, self.scale)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01, seed=0):
        super().__init__(seed=seed, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._normal(arr, self.sigma)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._init_zero(_, arr)


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._init_one(_, arr)


@register
class Constant(Initializer):
    """Every weight element set to ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._set(arr, torch.full(tuple(arr.shape), float(self.value)))


@register
class Xavier(Initializer):
    """Uniform or Gaussian with variance ``magnitude / factor``, the
    factor the fan-in, fan-out or their mean."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 seed=0):
        super().__init__(seed=seed, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise ValueError("Xavier requires ndim >= 2: %r %s"
                             % (name, shape))
        hw_scale = 1.0
        for d in shape[2:]:
            hw_scale *= d
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0,
                  "in": fan_in, "out": fan_out}[self.factor_type]
        scale = (self.magnitude / factor) ** 0.5
        if self.rnd_type == "uniform":
            self._uniform(arr, scale)
        else:
            self._normal(arr, scale)


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One
