"""Module-level eager op functions generated from the registry
(counterpart of ``mxnet_tpu/ndarray/register.py``): one function per
registered op that splits NDArray inputs from keyword hyper-parameters
and goes through :func:`ndarray.invoke`."""
from __future__ import annotations

import sys

from ..ops import registry as _registry
from . import ndarray as _nd


def _make_op_func(op):
    def fn(*args, out=None, name=None, **kwargs):
        args, kwargs = op.bind_positional(args, kwargs)
        inputs = [a if isinstance(a, _nd.NDArray) or a is None
                  else _nd.array(a) for a in args]
        # optional inputs left out (bias under no_bias) are dropped
        inputs = [x for x in inputs if x is not None]
        return _nd.invoke(op.name, inputs, kwargs, out=out)
    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def populate(module_name):
    mod = sys.modules[module_name]
    for name in _registry.list_ops():
        if not hasattr(mod, name):
            setattr(mod, name, _make_op_func(_registry.get(name)))


def populate_contrib(module_name):
    """``_contrib_X`` ops as ``X`` in the contrib namespace."""
    mod = sys.modules[module_name]
    for name in _registry.list_ops():
        if name.startswith("_contrib_"):
            setattr(mod, name[len("_contrib_"):],
                    _make_op_func(_registry.get(name)))
