"""Symbol-DAG pattern fusion for the kernel tier.

Counterpart of ``mxnet_tpu/kernels/graph_fuse.py``, with its four
patterns:

* ``BatchNorm -> Activation(relu)`` and ``BatchNorm ->
  broadcast_add(residual) -> Activation(relu)`` (``bn_act``);
* ``FullyConnected(+bias) -> Activation(relu) | LeakyReLU(gelu)``
  (``fc_act``: the product without its bias, then ``scale_bias_act``);
* ``broadcast_mul(x, scale) -> broadcast_add(+bias) -> LeakyReLU(gelu)``
  (``scale_bias_act``);
* ``batch_dot(softmax([scale *] batch_dot(q, k, transpose_b)), v)``, the
  naive attention spelling (``flash_attn``), taken only when the scale
  is 1/sqrt(d),

guarded by single-use edges, so that nothing else observes an interior
value. :func:`plan` runs once per graph, on structure alone; interior
nodes become *deferred* and the executor evaluates them only if
:func:`try_eval` declines the fusion for the shapes it meets.
"""
from __future__ import annotations

import math
from typing import NamedTuple

from ..base import dtype_name
from . import tier

__all__ = ["plan", "try_eval"]

_ADD_OPS = ("broadcast_add", "elemwise_add")
_MUL_OPS = ("broadcast_mul", "elemwise_mul")


class _Plan(NamedTuple):
    kind: str          # 'bn_act' | 'fc_act' | 'scale_bias_act' | 'flash_attn'
    act: str           # 'relu' | 'gelu' ('' for flash_attn)
    base: object       # BatchNorm / FC / broadcast_mul / inner batch_dot
    mid: object        # interior add / _mul_scalar node or None
    res_entry: object  # (node, out_idx) residual or V entry, or None
    deferred: tuple    # node ids the executor must skip


def _flag(val):
    """Truthiness of a symbol param that may arrive as bool or string."""
    if isinstance(val, str):
        return val.lower() in ("1", "true")
    return bool(val)


def _sole_use(uses, node, src):
    """src's out0 is consumed exactly once (by node) and no other output
    slot of src is observed anywhere."""
    for (sid, oi), n in uses.items():
        if sid == id(src) and (oi != 0 or n != 1):
            return False
    return uses.get((id(src), 0)) == 1


def _act_kind(node):
    """'relu'/'gelu' for activation nodes the tier can absorb."""
    name = node.op.name
    if name == "Activation" and node.params.get("act_type",
                                                "relu") == "relu":
        return "relu"
    if name == "LeakyReLU" and node.params.get("act_type",
                                               "leaky") == "gelu":
        return "gelu"
    return None


def _match_flash_attn(uses, node):
    """Anchor on the output batch_dot of the naive attention spelling
    with every interior value single-use -> _Plan or None. The scale
    check needs shapes and waits for :func:`try_eval`."""
    if node.op.name != "batch_dot" or len(node.inputs) != 2:
        return None
    if _flag(node.params.get("transpose_a")) \
            or _flag(node.params.get("transpose_b")):
        return None
    sm, sm_oi = node.inputs[0]
    if sm.is_variable or sm_oi != 0 or sm.op.name != "softmax" \
            or not _sole_use(uses, node, sm):
        return None
    if int(sm.params.get("axis", -1)) != -1:
        return None
    inner, in_oi = sm.inputs[0]
    if inner.is_variable or in_oi != 0 or not _sole_use(uses, sm, inner):
        return None
    mid = None
    if inner.op.name == "_mul_scalar":
        mid = inner
        nxt, nxt_oi = inner.inputs[0]
        if nxt.is_variable or nxt_oi != 0 \
                or not _sole_use(uses, mid, nxt):
            return None
        inner = nxt
    if inner.op.name != "batch_dot" or len(inner.inputs) != 2:
        return None
    if _flag(inner.params.get("transpose_a")) \
            or not _flag(inner.params.get("transpose_b")):
        return None
    deferred = ((id(inner),) + (() if mid is None else (id(mid),))
                + (id(sm),))
    return _Plan("flash_attn", "", inner, mid, node.inputs[1], deferred)


def _fusable_bn(uses, consumer, node, oi):
    return (not node.is_variable and oi == 0
            and node.op.name == "BatchNorm"
            and not node.params.get("output_mean_var")
            and _sole_use(uses, consumer, node))


def plan(nodes, entries):
    """Structural pass -> ({id(act_node): _Plan}, deferred_ids); empty
    when the tier is off."""
    if not tier.enabled():
        return {}, frozenset()
    uses = {}
    for node in nodes:
        for (src, oi) in node.inputs:
            if not src.is_variable:
                uses[(id(src), oi)] = uses.get((id(src), oi), 0) + 1
    for (src, oi) in entries:
        if not src.is_variable:
            uses[(id(src), oi)] = uses.get((id(src), oi), 0) + 1

    plans = {}
    deferred = set()
    for node in nodes:
        if node.is_variable:
            continue
        p = _match_flash_attn(uses, node)
        act = _act_kind(node)
        if p is None and act is not None and node.inputs:
            p = _match_act(uses, node, act)
        if p is not None:
            plans[id(node)] = p
            deferred.update(p.deferred)
    return plans, frozenset(deferred)


def _match_act(uses, node, act):
    """The epilogue patterns ending in activation ``node``."""
    src, src_oi = node.inputs[0]
    if src.is_variable or src_oi != 0 or not _sole_use(uses, node, src):
        return None
    if act == "relu" and _fusable_bn(uses, node, src, src_oi):
        return _Plan("bn_act", act, src, None, None, (id(src),))
    if src.op.name == "FullyConnected" and len(src.inputs) == 3 \
            and not _flag(src.params.get("no_bias")):
        return _Plan("fc_act", act, src, None, None, (id(src),))
    if src.op.name not in _ADD_OPS or len(src.inputs) != 2:
        return None
    for side in (0, 1):
        other, oi = src.inputs[side]
        if act == "relu" and _fusable_bn(uses, src, other, oi):
            return _Plan("bn_act", act, other, src, src.inputs[1 - side],
                         (id(other), id(src)))
        if act == "gelu" and not other.is_variable and oi == 0 \
                and other.op.name in _MUL_OPS \
                and _sole_use(uses, src, other):
            return _Plan("scale_bias_act", act, other, src,
                         src.inputs[1 - side], (id(other), id(src)))
    return None


def _eval_bn_act(p, read, training):
    from . import bn_act
    data, gamma, beta, mm, mv = [read(s, oi) for (s, oi) in p.base.inputs]
    bp = p.base.params
    residual = None if p.res_entry is None else read(*p.res_entry)
    reason = bn_act.eligible(
        tuple(data.shape), data.dtype, axis=int(bp.get("axis", 1)),
        act=p.act, residual_shape=None if residual is None
        else tuple(residual.shape))
    # the tier's key is the 4-D site's (rows, cols) view: a declined
    # site (a BatchNorm over 2-D features) has none and falls back
    go, cfg = tier.should_dispatch(
        bn_act.OP_NAME, bn_act.shape_key_shapes(tuple(data.shape))
        if reason is None else (), dtype_name(data.dtype),
        bn_act.DEFAULT_CONFIG, guard_reason=reason)
    if not go:
        return None
    return bn_act.fused_bn_act(
        data, gamma, beta, mm, mv, residual,
        eps=float(bp.get("eps", 1e-3)),
        momentum=float(bp.get("momentum", 0.9)),
        fix_gamma=bool(bp.get("fix_gamma", True)),
        use_global_stats=bool(bp.get("use_global_stats", False)),
        act=p.act, training=bool(training), config=cfg)


def _vector_of(t, length):
    """t as a (length,) vector if its shape allows, else None."""
    if t.numel() != length or sum(1 for d in t.shape if d != 1) > 1:
        return None
    return t.reshape(length)


def _eval_fc_act(p, read):
    from ..ops import nn as _nn
    from . import mlp
    data, weight, bias = [read(s, oi) for (s, oi) in p.base.inputs]
    fp = p.base.params
    num_hidden = int(fp.get("num_hidden", 0)) or weight.shape[0]
    flatten = _flag(fp.get("flatten", True))
    out_shape = ((data.shape[0], num_hidden) if flatten or data.dim() <= 2
                 else tuple(data.shape[:-1]) + (num_hidden,))
    reason = mlp.eligible(out_shape, data.dtype, act=p.act,
                          bias_shape=tuple(bias.shape))
    go, cfg = tier.should_dispatch(
        mlp.OP_NAME, mlp.shape_key_shapes(out_shape), dtype_name(data.dtype),
        mlp.DEFAULT_CONFIG, guard_reason=reason)
    if not go:
        return None
    y = _nn.fully_connected(data, weight, None, num_hidden=num_hidden,
                            no_bias=True, flatten=flatten)
    return mlp.fused_scale_bias_act(y, None, bias, act=p.act, config=cfg)


def _eval_scale_bias_act(p, read):
    from . import mlp
    a = read(*p.base.inputs[0])
    b = read(*p.base.inputs[1])
    bias_arr = read(*p.res_entry)
    # the data is the >= 2-D operand whose partner views as a
    # (features,) vector
    for data, sc in ((a, b), (b, a)):
        if data.dim() < 2:
            continue
        F_ = data.shape[-1]
        scale = _vector_of(sc, F_)
        bias = _vector_of(bias_arr, F_)
        if scale is None or bias is None:
            continue
        reason = mlp.eligible(tuple(data.shape), data.dtype, act=p.act,
                              scale_shape=tuple(scale.shape),
                              bias_shape=tuple(bias.shape))
        go, cfg = tier.should_dispatch(
            mlp.OP_NAME, mlp.shape_key_shapes(tuple(data.shape)),
            dtype_name(data.dtype), mlp.DEFAULT_CONFIG, guard_reason=reason)
        if not go:
            return None
        return mlp.fused_scale_bias_act(data, scale, bias, act=p.act,
                                        config=cfg)
    tier.record_fallback(mlp.OP_NAME,
                         "scale/bias operands are not feature vectors")
    return None


def _eval_flash_attn(p, read):
    from . import attention as _attn
    q = read(*p.base.inputs[0])
    k = read(*p.base.inputs[1])
    v = read(*p.res_entry)
    scale = 1.0 if p.mid is None \
        else float(p.mid.params.get("scalar", 1.0))
    want = 1.0 / math.sqrt(q.shape[-1])
    if abs(scale - want) > 1e-6 * want:
        tier.record_fallback(_attn.OP_NAME,
                             "softmax scale %g is not 1/sqrt(d)=%g"
                             % (scale, want))
        return None
    if q.dim() == 3:
        # (B*H, T, D) spelling: run as single-head (B*H, 1, T, D)
        out = _attn.attend_or_none(q[:, None], k[:, None], v[:, None],
                                   causal=False)
        return None if out is None else out[:, 0]
    if q.dim() == 4:
        return _attn.attend_or_none(q, k, v, causal=False)
    tier.record_fallback(_attn.OP_NAME,
                         "batch_dot operands are %d-D, need 3/4-D" % q.dim())
    return None


def try_eval(p, node, read, values, route_aux, training):
    """Attempt one planned fusion. True: the anchor node's value is
    stored (and BatchNorm's aux updates routed); False: the executor
    evaluates the pattern unfused, forcing the deferred nodes."""
    if p.kind == "bn_act":
        fused = _eval_bn_act(p, read, training)
        if fused is None:
            return False
        values[id(node)] = fused[0]
        route_aux(p.base, fused)
        return True
    if p.kind == "flash_attn":
        out = _eval_flash_attn(p, read)
    elif p.kind == "fc_act":
        out = _eval_fc_act(p, read)
    else:
        out = _eval_scale_bias_act(p, read)
    if out is None:
        return False
    values[id(node)] = out
    return True
