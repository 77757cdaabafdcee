"""Central operator registry (counterpart of ``mxnet_tpu/ops/registry.py``).

One registry feeds the symbolic layer and the graph evaluator. Each op is
a plain function over torch tensors: positional tensor inputs, then
keyword hyper-parameters, returning one tensor or a tuple. The keyword
names are the JAX package's, so symbol JSON written by either package
loads in the other.
"""
from __future__ import annotations

import inspect

__all__ = ["Operator", "register", "set_op_meta", "alias", "get",
           "list_ops"]

_REGISTRY: dict[str, "Operator"] = {}


class Operator:
    """A registered op: a torch function plus symbolic-layer metadata."""

    __slots__ = ("name", "fn", "num_outputs", "param_names", "doc",
                 "is_random", "host",
                 "shape_hook", "aux_inputs", "aux_outputs",
                 "num_visible_outputs", "input_names", "input_optional",
                 "has_var_inputs")

    def __init__(self, name, fn, num_outputs=1, is_random=False,
                 host=False):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs  # int, or callable(params)->int
        self.is_random = is_random    # draws keys from ``random.next_key``
        # reads values back to the host mid-graph (a greedy pass, user
        # Python): a step holding it cannot be captured as a CUDA graph;
        # bool, or callable(params)->bool where only some calls read back
        self.host = host
        self.doc = fn.__doc__ or ""
        self.shape_hook = None        # fn(in_shapes, params) -> completed
        self.aux_inputs = ()          # input slots that are auxiliary states
        self.aux_outputs = ()         # output slots holding updated aux
        self.num_visible_outputs = None  # outputs exposed to the graph
        sig = inspect.signature(fn)
        self.param_names = [p.name for p in sig.parameters.values()
                            if p.kind == inspect.Parameter.KEYWORD_ONLY]
        self.input_names = []
        self.input_optional = []
        self.has_var_inputs = False
        for p in sig.parameters.values():
            if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                          inspect.Parameter.POSITIONAL_ONLY):
                self.input_names.append(p.name)
                self.input_optional.append(
                    p.default is not inspect.Parameter.empty)
            elif p.kind == inspect.Parameter.VAR_POSITIONAL:
                self.has_var_inputs = True

    def bind_positional(self, args, kwargs):
        """Positional arguments past the tensor-input slots bind to
        ``param_names`` in declaration order."""
        if self.has_var_inputs or len(args) <= len(self.input_names):
            return args, kwargs
        extra = args[len(self.input_names):]
        if len(extra) > len(self.param_names):
            raise TypeError("%s: too many positional arguments" % self.name)
        for pname, val in zip(self.param_names, extra):
            if pname in kwargs:
                raise TypeError("%s: parameter %r given positionally and "
                                "by keyword" % (self.name, pname))
            kwargs[pname] = val
        return args[:len(self.input_names)], kwargs

    def resolve_num_outputs(self, params):
        if callable(self.num_outputs):
            return self.num_outputs(params)
        return self.num_outputs

    def reads_back(self, params):
        """Whether a call with ``params`` reads values back to the host."""
        if callable(self.host):
            return bool(self.host(params))
        return bool(self.host)

    def resolve_num_visible_outputs(self, params):
        """Outputs exposed to the graph; the hidden suffix carries the
        updated aux state."""
        if self.num_visible_outputs is None:
            return self.resolve_num_outputs(params)
        if callable(self.num_visible_outputs):
            return self.num_visible_outputs(params)
        return self.num_visible_outputs

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __repr__(self):
        return "Operator(%s)" % self.name


def register(name=None, num_outputs=1, is_random=False, host=False):
    """Decorator: register a torch function as an operator; ``host``
    marks an op that reads values back to the host while it runs (a
    bool, or a predicate of the call's params)."""
    def deco(fn):
        opname = name or fn.__name__
        if opname in _REGISTRY:
            raise ValueError("duplicate op registration: %s" % opname)
        _REGISTRY[opname] = Operator(opname, fn, num_outputs=num_outputs,
                                     is_random=is_random, host=host)
        return fn
    return deco


def set_op_meta(name, shape_hook=None, aux_inputs=None, aux_outputs=None,
                num_visible_outputs=None):
    """Attach symbolic-layer metadata: the parameter-shape hook and the
    auxiliary-state slots."""
    op = _REGISTRY[name]
    if shape_hook is not None:
        op.shape_hook = shape_hook
    if aux_inputs is not None:
        op.aux_inputs = tuple(aux_inputs)
    if aux_outputs is not None:
        op.aux_outputs = tuple(aux_outputs)
    if num_visible_outputs is not None:
        op.num_visible_outputs = num_visible_outputs
    return op


def alias(existing, *names):
    op = _REGISTRY[existing]
    for n in names:
        _REGISTRY[n] = op
    return op


def get(name) -> Operator:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError("operator %r is not registered (have %d ops)"
                       % (name, len(_REGISTRY))) from None


def list_ops():
    return sorted(_REGISTRY.keys())
