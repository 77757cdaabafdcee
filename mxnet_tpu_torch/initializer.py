"""Weight initializers (counterpart of a subset of ``mxnet_tpu/initializer.py``):
the name-suffix rules of ``Initializer`` and ``Uniform``, ``Normal``,
``Zero``, ``One``, ``Constant``, ``Xavier``, ``MSRAPrelu``,
``Orthogonal``, ``Bilinear``, ``LSTMBias``, ``FusedRNN`` and ``Mixed``.

Each initializer draws from its own generator seeded by its ``seed``
argument (the JAX package draws from numpy's global state), on the CPU,
and copies the values into the tensor it is given, in place. Two
initializers with the same seed fill the same parameters in the same
order with the same values. ``Orthogonal`` draws from a
``numpy.random.RandomState(seed)`` and factors in f64 with numpy, as
the JAX package does from numpy's global state: after
``numpy.random.seed(seed)`` there, both fill the same f32 values.
``MSRAPrelu`` draws its Gaussian from a ``RandomState(seed)`` too, and
``Bilinear`` (the upsampling kernel) draws nothing. The
others draw from a ``torch.Generator``, on the CPU in f32.
"""
from __future__ import annotations

import json
import re

import numpy as _np
import torch

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias", "FusedRNN", "Mixed",
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
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("beta"):
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
            self._init_default(desc, arr)

    @staticmethod
    def _set(arr, values):
        with torch.no_grad():
            arr.copy_(values.to(device=arr.device, dtype=arr.dtype))

    def _init_zero(self, _, arr):
        self._set(arr, torch.zeros(arr.shape))

    def _init_one(self, _, arr):
        self._set(arr, torch.ones(arr.shape))

    def _init_bias(self, desc, arr):
        self._init_zero(desc, arr)

    def _init_default(self, desc, arr):
        raise ValueError(
            "Unknown initialization pattern for %s. Default init needs "
            "a name ending in weight/bias/gamma/beta" % desc)

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


@register
class MSRAPrelu(Xavier):
    """Xavier's Gaussian at ``magnitude = 2 / (1 + slope^2)``, drawn in
    f64 from a ``numpy.random.RandomState(seed)``."""

    def __init__(self, factor_type="avg", slope=0.25, seed=0):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         seed=seed)
        self._kwargs = {"factor_type": factor_type, "slope": slope}
        self._rs = _np.random.RandomState(int(seed))

    def _normal(self, arr, sigma):
        self._set(arr, torch.from_numpy(
            self._rs.normal(0, sigma, tuple(arr.shape)).astype(_np.float32)))


@register
class Orthogonal(Initializer):
    """The orthogonal factor of a uniform (``rand_type="uniform"``) or
    normal matrix of shape (out, prod(in)), times ``scale``."""

    def __init__(self, scale=1.414, rand_type="uniform", seed=0):
        super().__init__(seed=seed, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type
        self._rs = _np.random.RandomState(int(seed))

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = 1
        for d in arr.shape[1:]:
            nin *= d
        if self.rand_type == "uniform":
            tmp = self._rs.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = self._rs.normal(0.0, 1.0, (nout, nin))
        u, _s, v = _np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        self._set(arr, torch.from_numpy(
            (self.scale * q).reshape(tuple(arr.shape)).astype(_np.float32)))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes of every
    (out, in) slice."""

    def _init_weight(self, _, arr):
        shape = tuple(arr.shape)
        weight = _np.zeros(shape, dtype="float32")
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(_np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        self._set(arr, torch.from_numpy(weight))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (gates i, f, g, o) set to
    ``forget_bias``: whatever the name, weight or bias."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _, arr):
        b = torch.zeros(tuple(arr.shape))
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)

    _init_bias = _init_weight
    _init_default = _init_weight


@register
class FusedRNN(Initializer):
    """A ``FusedRNNCell``'s packed parameter vector: unpacked into its
    per-gate i2h/h2h weights and biases, each initialized by ``init``
    (the run's global initializer when None), the LSTM forget-gate
    biases (i2h and h2h both) set to ``forget_bias``, and packed
    again."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            init = create(init)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .rnn import rnn_cell
        cell = rnn_cell.FusedRNNCell(
            self._num_hidden, self._num_layers, self._mode,
            self._bidirectional, forget_bias=self._forget_bias, prefix="")
        args = cell.unpack_weights({"parameters": arr.detach().cpu()})
        inner = self._init or desc.global_init or Uniform()
        for name, piece in args.items():
            if self._mode == "lstm" and name.endswith("_f_bias"):
                piece.fill_(self._forget_bias)
            else:
                inner(InitDesc(name, global_init=desc.global_init), piece)
        self._set(arr, cell.pack_weights(args)["parameters"])


class Mixed(Initializer):
    """The first initializer whose pattern matches the name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise ValueError("Parameter %s did not match Mixed patterns" % name)


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One
