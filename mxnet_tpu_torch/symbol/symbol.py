"""Symbolic graph construction (counterpart of ``mxnet_tpu/symbol/symbol.py``).

A Symbol is a list of output entries over a DAG of Nodes; each node
applies a registered op (:mod:`mxnet_tpu_torch.ops.registry`) or is a
variable. Shape inference runs the op functions on ``device="meta"``
tensors, where the JAX package runs ``jax.eval_shape``, with the same
per-op hooks filling in parameter shapes from data shapes.

``tojson``/``load_json`` keep the JAX package's on-disk layout (the
reference MXNet layout: repr-string attribute values, ``node_row_ptr``,
``heads``), so a symbol written by either package loads in the other.
"""
from __future__ import annotations

import ast
import json
import warnings

import torch

from ..base import MXNetError
from ..config import override
from ..name import current as _name_current
from ..ops import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load_json", "load"]


def _auto_name(prefix, name=None):
    return _name_current().get(name, prefix)


class Node:
    """One graph node: an op application or a variable (op=None)."""

    __slots__ = ("op", "name", "inputs", "params", "attrs")

    def __init__(self, op, name, inputs, params, attrs=None):
        self.op = op                # Operator or None (variable)
        self.name = name
        self.inputs = inputs        # list[(Node, int)]
        self.params = params or {}  # op hyper-parameters
        self.attrs = attrs or {}    # user attrs (__shape__, __lr_mult__, ...)

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        """Graph-visible output count (hidden aux-update outputs excluded)."""
        if self.op is None:
            return 1
        return self.op.resolve_num_visible_outputs(self.params)


class Symbol:
    """An output list over a DAG of Nodes."""

    __slots__ = ("_entries",)

    def __init__(self, entries):
        self._entries = list(entries)  # list[(Node, int)]

    def _topo(self):
        """All nodes in topological order (inputs before consumers)."""
        seen = set()
        order = []
        stack = [(n, False) for n, _ in reversed(self._entries)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for (inp, _) in reversed(node.inputs):
                if id(inp) not in seen:
                    stack.append((inp, False))
        return order

    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return "group"

    def list_arguments(self):
        """Variable names in topo order, excluding auxiliary states."""
        aux = set(self.list_auxiliary_states())
        return [n.name for n in self._topo()
                if n.is_variable and n.name not in aux]

    def list_auxiliary_states(self):
        """Variables wired into ops' aux input slots (BatchNorm's moving
        statistics)."""
        aux = []
        seen = set()
        for n in self._topo():
            if n.is_variable:
                continue
            for i in n.op.aux_inputs:
                if i < len(n.inputs):
                    v = n.inputs[i][0]
                    if v.is_variable and v.name not in seen:
                        seen.add(v.name)
                        aux.append(v.name)
        return aux

    def list_outputs(self):
        out = []
        for node, idx in self._entries:
            if node.num_outputs() > 1:
                out.append("%s_output%d" % (node.name, idx))
            else:
                out.append("%s_output" % node.name)
        return out

    def attr_dict(self):
        """{node name: user attrs} for every node that has any."""
        return {n.name: dict(n.attrs) for n in self._topo() if n.attrs}

    # ------------------------------------------------------------ operators
    def __add__(self, other):
        return _sym_binary("broadcast_add", "_plus_scalar", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _sym_binary("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _sym_binary_r("broadcast_sub", "_rminus_scalar", self, other)

    def __mul__(self, other):
        return _sym_binary("broadcast_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return _sym_binary("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _sym_binary_r("broadcast_div", "_rdiv_scalar", self, other)

    def __neg__(self):
        return invoke_sym("negative", [self], {})

    # ------------------------------------------------------------ outputs
    def __getitem__(self, index):
        if isinstance(index, str):
            index = self.list_outputs().index(index)
        if isinstance(index, slice):
            return Symbol(self._entries[index])
        return Symbol([self._entries[index]])

    def __iter__(self):
        for i in range(len(self._entries)):
            yield self[i]

    def __len__(self):
        return len(self._entries)

    # ----------------------------------------------------------------- bind
    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        """An :class:`~mxnet_tpu_torch.executor.Executor` over the given
        tensors (dicts by name, or lists in ``list_arguments`` order)."""
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **shapes):
        """Infer every shape from the given ones, allocate zeros (and
        gradient buffers where ``grad_req`` is not 'null'), bind."""
        from ..executor import simple_bind
        return simple_bind(self, ctx, grad_req=grad_req,
                           type_dict=type_dict, **shapes)

    def __repr__(self):
        return "<Symbol %s>" % self.name

    # --------------------------------------------------------------- infer
    def infer_shape(self, *args, **kwargs):
        """Returns (arg_shapes, out_shapes, aux_shapes); raises when an
        argument or output shape stays unknown."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As infer_shape, with None where inference failed."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known = dict(kwargs)
        for name, shp in zip(self.list_arguments(), args):
            if shp is not None:
                known[name] = shp
        shapes = _infer_shapes(self, known)
        args_order = self.list_arguments()
        arg_shapes = [shapes.get(("var", nm)) for nm in args_order]
        aux_shapes = [shapes.get(("var", nm))
                      for nm in self.list_auxiliary_states()]
        out_shapes = [shapes.get(("var", node.name) if node.is_variable
                                 else (id(node), idx))
                      for node, idx in self._entries]
        if not partial and any(s is None for s in arg_shapes + out_shapes):
            missing = [nm for nm, s in zip(args_order, arg_shapes)
                       if s is None]
            raise MXNetError("infer_shape incomplete; unknown for args %s"
                             % missing)
        return arg_shapes, out_shapes, aux_shapes

    # --------------------------------------------------------------- serde
    def tojson(self):
        nodes = self._topo()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        row_ptr = [0]
        for n in nodes:
            attrs = {k: _attr_str(k, v) for k, v in n.params.items()}
            attrs.update({k: _attr_str(k, v) for k, v in n.attrs.items()})
            jn = {"op": "null" if n.is_variable else n.op.name,
                  "name": n.name,
                  "inputs": [[nid[id(src)], oi, 0]
                             for (src, oi) in n.inputs]}
            if attrs:
                jn["attrs"] = attrs
            jnodes.append(jn)
            nout = 1 if n.is_variable else n.op.resolve_num_outputs(n.params)
            row_ptr.append(row_ptr[-1] + nout)
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_variable]
        heads = [[nid[id(n)], oi, 0] for (n, oi) in self._entries]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": row_ptr, "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10400]}},
                          indent=2)

    def save(self, fname):
        """Write :meth:`tojson` to ``fname``."""
        with open(fname, "w") as f:
            f.write(self.tojson())


def invoke_sym(op_name, inputs, params, name=None):
    """Create a graph node applying op to input symbols."""
    op = _registry.get(op_name)
    params = {k: v for k, v in params.items() if v is not None}
    entries = []
    for s in inputs:
        if not isinstance(s, Symbol):
            raise TypeError("symbol op %s expects Symbol inputs, got %r"
                            % (op_name, type(s)))
        entries.extend(s._entries)
    if name is None:
        name = _auto_name(op_name.lower().lstrip("_") + "_")
    node = Node(op, name, entries, params)
    n_out = op.resolve_num_visible_outputs(params)
    return Symbol([(node, i) for i in range(n_out)])


def _sym_binary(op_name, scalar_op, lhs, rhs):
    if isinstance(rhs, Symbol):
        return invoke_sym(op_name, [lhs, rhs], {})
    return invoke_sym(scalar_op, [lhs], {"scalar": float(rhs)})


def _sym_binary_r(op_name, rscalar_op, lhs, rhs):
    """rhs OP lhs, rhs a scalar or a Symbol (the reflected operators)."""
    if isinstance(rhs, Symbol):
        return invoke_sym(op_name, [rhs, lhs], {})
    return invoke_sym(rscalar_op, [lhs], {"scalar": float(rhs)})


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """A graph input. ``shape`` (stored as ``__shape__``) seeds shape
    inference; the other keywords become the JAX package's dunder
    attrs (``__dtype__`` by its numpy name, ``__init__`` as the
    initializer's ``dumps()``)."""
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = str(getattr(dtype, "name", None)
                                 or str(dtype).replace("torch.", ""))
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if init is not None:
        attrs["__init__"] = init.dumps() if hasattr(init, "dumps") \
            else str(init)
    if stype is not None:
        attrs["__storage_type__"] = stype
    attrs.update(kwargs)
    return Symbol([(Node(None, name, [], {}, attrs), 0)])


var = Variable


def Group(symbols):
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


# ---------------------------------------------------------------------------
# shape inference over the DAG
# ---------------------------------------------------------------------------

def _infer_shapes(sym, known_var_shapes):
    """Forward shape propagation with parameter-shape hooks.

    Returns dict: ("var", name) -> shape for variables,
    (id(node), out_idx) -> shape for op outputs. Each op runs on meta
    tensors, which carry shapes and no data, so no kernel is reached.
    """
    shapes = {("var", name): tuple(s)
              for name, s in known_var_shapes.items()}
    for n in sym._topo():
        if n.is_variable:
            if ("var", n.name) not in shapes and "__shape__" in n.attrs:
                shapes[("var", n.name)] = tuple(n.attrs["__shape__"])
            continue
        keys = [("var", src.name) if src.is_variable else (id(src), oi)
                for (src, oi) in n.inputs]
        in_shapes = [shapes.get(k) for k in keys]
        hook = n.op.shape_hook
        if hook is not None and any(s is None for s in in_shapes):
            try:
                completed = hook(in_shapes, n.params)
            except Exception as e:
                warnings.warn("shape hook for op %r (node %r) failed: %s: %s"
                              % (n.op.name, n.name, type(e).__name__, e))
                completed = in_shapes
            for k, s in zip(keys, completed):
                if s is not None and shapes.get(k) is None:
                    shapes[k] = tuple(s)
            in_shapes = [None if s is None else tuple(s) for s in completed]
        if any(s is None for s in in_shapes):
            continue
        try:
            # tier off: an op that dispatches to a kernel records no
            # dispatch for a shape probe
            with override(kernel_tier="off"):
                out = n.op.fn(*[torch.empty(s, device="meta")
                                for s in in_shapes], **n.params)
        except Exception:
            continue
        outs = out if isinstance(out, tuple) else (out,)
        for i, o in enumerate(outs):
            shapes[(id(n), i)] = tuple(o.shape)
    return shapes


# ---------------------------------------------------------------------------
# JSON
# ---------------------------------------------------------------------------

# MXNet's on-disk dtype enum (reference python/mxnet/base.py)
_MX_DTYPE_CODE = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
                  "int32": 4, "int8": 5, "int64": 6}
_MX_CODE_DTYPE = {v: k for k, v in _MX_DTYPE_CODE.items()}

# attr keys the reference hides as __key__
_HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
                "mirror_stage")
# reference-era backend knobs with no effect on the math
_IGNORABLE_PARAMS = frozenset(["workspace", "cudnn_tune", "cudnn_off",
                               "key_var_num_args", "num_args"])


def _attr_str(key, v):
    """One attr value as the reference JSON stores it (repr-string;
    __dtype__ as the dtype enum code)."""
    if key == "__dtype__":
        name = str(v)
        return str(_MX_DTYPE_CODE.get(name, name))
    return v if isinstance(v, str) else str(v)


def _untuple(v):
    return tuple(v) if isinstance(v, list) else v


def _attr_parse(raw):
    """Parse one attr value: json-encoded values and the reference's
    repr-strings ("(3, 3)", "True", "2e-05", "relu"). Parsing matters:
    the string "False" is truthy."""
    if not isinstance(raw, str):
        return _untuple(raw)
    try:
        return _untuple(json.loads(raw))
    except ValueError:
        pass
    try:
        return _untuple(ast.literal_eval(raw))
    except (ValueError, SyntaxError):
        return raw


def _user_attr_parse(key, raw):
    """User (dunder) attrs stay strings except the structural
    __shape__ and __dtype__."""
    if key == "__shape__":
        v = _attr_parse(raw)
        return tuple(v) if isinstance(v, (tuple, list)) else v
    if key == "__dtype__":
        v = _attr_parse(raw)
        if isinstance(v, int):
            return _MX_CODE_DTYPE.get(v, "float32")
        return raw
    return raw if isinstance(raw, str) else _untuple(raw)


def _filter_params(opname, op, params):
    """Drop reference-era backend knobs; any other unknown param raises,
    because silently dropping a semantic param would load another
    model."""
    known = set(op.param_names)
    out = {}
    for k, v in params.items():
        if k in known:
            out[k] = v
        elif k not in _IGNORABLE_PARAMS:
            raise MXNetError("load_json: op %r has no parameter %r "
                             "(value %r)" % (opname, k, v))
    return out


def load_json(json_str):
    """Parse a symbol JSON written by either package (or by reference
    MXNet, for the ops the port has)."""
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        raw = jn.get("attrs", jn.get("attr", jn.get("param", {}))) or {}
        user = {k: _user_attr_parse(k, v) for k, v in raw.items()
                if k.startswith("__") and k.endswith("__")}
        for hk in _HIDDEN_KEYS:
            if hk in raw:
                user["__%s__" % hk] = _user_attr_parse("__%s__" % hk,
                                                       raw[hk])
        inputs = [(nodes[jin[0]], jin[1] if len(jin) > 1 else 0)
                  for jin in jn["inputs"]]
        if jn["op"] == "null":
            node = Node(None, jn["name"], [], {}, user)
        else:
            params = {}
            for k, v in raw.items():
                if (k.startswith("__") and k.endswith("__")) or any(
                        k == hk or k.endswith("_" + hk)
                        for hk in _HIDDEN_KEYS):
                    continue
                params[k] = _attr_parse(v)
            op = _registry.get(jn["op"])
            node = Node(op, jn["name"], inputs,
                        _filter_params(jn["op"], op, params), user)
        nodes.append(node)
    entries = [(nodes[jh[0]], jh[1] if len(jh) > 1 else 0)
               for jh in data["heads"]]
    return Symbol(entries)


def load(fname):
    """A Symbol from a JSON file written by :meth:`Symbol.save` (or by
    the JAX package)."""
    with open(fname) as f:
        return load_json(f.read())
