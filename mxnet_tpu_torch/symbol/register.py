"""Module-level symbolic op constructors generated from the registry
(counterpart of ``mxnet_tpu/symbol/register.py``)."""
from __future__ import annotations

import sys

from ..ops import registry as _registry
from . import symbol as _symbol


def _make_op_func(op):
    def fn(*args, name=None, **kwargs):
        node_name = _symbol._auto_name(
            op.name.lower().lstrip("_") + "_", name)
        if op.has_var_inputs:
            # ops over *data (Concat, stack): every Symbol given is an input
            inputs = [a for a in args if isinstance(a, _symbol.Symbol)]
            for k in [k for k, v in kwargs.items()
                      if isinstance(v, _symbol.Symbol)]:
                inputs.append(kwargs.pop(k))
            return _symbol.invoke_sym(op.name, inputs, kwargs,
                                      name=node_name)
        args, kwargs = op.bind_positional(args, kwargs)
        # named input slots: positionals, then keywords, then variables
        # created the reference way (Convolution(data) -> conv0_weight;
        # SoftmaxOutput(net, name="softmax") -> softmax_label)
        slots = {}
        for slot_name, a in zip(op.input_names, args):
            if a is not None:
                if not isinstance(a, _symbol.Symbol):
                    raise TypeError("%s: input %r must be Symbol, got %r"
                                    % (op.name, slot_name, type(a)))
                slots[slot_name] = a
        for slot_name in op.input_names:
            if isinstance(kwargs.get(slot_name), _symbol.Symbol):
                slots[slot_name] = kwargs.pop(slot_name)
        inputs = []
        for slot_name, optional in zip(op.input_names, op.input_optional):
            if slot_name in slots:
                inputs.append(slots[slot_name])
            elif _should_autocreate(slot_name, optional, kwargs):
                inputs.append(_symbol.Variable(
                    "%s_%s" % (node_name, slot_name)))
        return _symbol.invoke_sym(op.name, inputs, kwargs, name=node_name)

    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def _should_autocreate(slot_name, optional, params):
    if not optional:
        return True   # required tensor input with no symbol -> variable
    if slot_name == "bias":
        return not params.get("no_bias", False)
    if slot_name == "state_cell":
        return params.get("mode") == "lstm"
    return slot_name == "label"   # loss heads create their label variable


def populate(module_name):
    mod = sys.modules[module_name]
    for name in _registry.list_ops():
        setattr(mod, name, _make_op_func(_registry.get(name)))


def populate_contrib(module_name):
    """``_contrib_X`` ops as ``X`` in the contrib namespace."""
    mod = sys.modules[module_name]
    for name in _registry.list_ops():
        if name.startswith("_contrib_"):
            setattr(mod, name[len("_contrib_"):],
                    _make_op_func(_registry.get(name)))
