"""Graph rewrite: eligible f32 FC/Conv sites -> int8 serving ops.

Counterpart of ``mxnet_tpu/quant/rewrite.py``, whose float32 numpy
arithmetic it repeats operation for operation, so that the port's int8
weights and epilogue coefficients equal the JAX package's to the bit
for the same calibration numbers. Every quantized site becomes ONE node
(:mod:`~mxnet_tpu_torch.ops.quant_serve`): static-scale int8 quantize,
int8 product with int32 accumulation, and a fused dequant epilogue that
already carries the inference BatchNorm affine and a trailing ReLU.
Weights are quantized here, on the host, into new int8 parameter arrays
(symmetric per-output-channel), so the f32 weights leave the checkpoint:
that is the 4x payload cut.

Fold math (all float32 numpy, deterministic):

    Wq[k]        = clip(round(W[k] * w_scale[k]), +-127)   int8
    deq[k]       = 1 / (act_scale * w_scale[k])
    BN inference:  a[k] = gamma[k]/sqrt(var[k]+eps),
                   c[k] = beta[k] - mean[k]*a[k]   (gamma=1 if fix_gamma)
    out_scale[k] = deq[k] * a[k]
    out_bias[k]  = a[k] * bias[k] + c[k]

so ``act(acc*out_scale + out_bias)`` equals BN(ReLU-free site + bias)
up to int8 rounding. Sites that fail any guard keep their f32 node and
are listed in the report with the reason.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..ops import registry as _registry
from ..symbol.symbol import Node, Symbol

__all__ = ["quantize_serving_graph"]

_EPS = 1e-8


def _np32(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    elif hasattr(v, "asnumpy"):
        v = v.asnumpy()
    return _np.asarray(v, _np.float32)


def _consumers(sym):
    out = {}
    for node in sym._topo():
        if node.is_variable:
            continue
        for (src, _oi) in node.inputs:
            out.setdefault(id(src), []).append(node)
    return out


def _sole_consumer(node, consumers):
    cs = consumers.get(id(node), [])
    return cs[0] if len(cs) == 1 else None


def _bn_inputs(bn, arg_params, aux_params):
    """(gamma, beta, mean, var) names when every BN input is a direct
    checkpoint Variable; None otherwise."""
    names = []
    for i, store in ((1, arg_params), (2, arg_params), (3, aux_params),
                     (4, aux_params)):
        if i >= len(bn.inputs):
            return None
        src, _ = bn.inputs[i]
        if not src.is_variable or src.name not in store:
            return None
        names.append(src.name)
    return names


def _fold_chain(site, consumers, output_ids, arg_params, aux_params):
    """Absorbable (bn_node, relu_node) following ``site`` — either may be
    None. Interior absorbed nodes must have exactly one consumer and must
    not themselves be graph outputs."""
    bn = relu = None
    c = _sole_consumer(site.node, consumers)
    if (c is not None and not c.is_variable and c.op.name == "BatchNorm"
            and id(site.node) not in output_ids
            and c.inputs[0][0] is site.node
            and int(c.params.get("axis", 1)) == 1
            and not c.params.get("output_mean_var", False)
            and _bn_inputs(c, arg_params, aux_params) is not None):
        bn = c
    tail = bn if bn is not None else site.node
    c = _sole_consumer(tail, consumers)
    if (c is not None and not c.is_variable and c.op.name == "Activation"
            and c.params.get("act_type", "relu") == "relu"
            and id(tail) not in output_ids and c.inputs[0][0] is tail):
        if bn is not None or tail is site.node:
            relu = c
    return bn, relu


def _var(name, shape, dtype):
    return Node(None, name, [], {},
                {"__shape__": tuple(shape), "__dtype__": str(dtype)})


def quantize_serving_graph(sym, arg_params, aux_params, calib):
    """Rewrite ``sym`` using a :class:`~.calibrate.CalibrationResult`.

    Returns ``(qsym, qarg_params, qaux_params, report)``. Parameters of
    quantized sites are REPLACED (f32 weight/bias/BN params dropped, int8
    weight + f32 epilogue scale/bias added); untouched parameters pass
    through so mixed graphs keep working.
    """
    consumers = _consumers(sym)
    output_ids = {id(n) for n, _ in sym._entries}
    by_name = {s.name: s for s in calib.sites}
    skipped = dict(calib.skipped)
    new_params = {}
    mapping = {}
    absorbed = {}         # id(absorbed bn/relu node) -> fused Node
    quantized = []
    f32_weight_bytes = 0
    int8_weight_bytes = 0

    def mapped_entry(entry):
        node, idx = entry
        m = mapping[id(node)]
        return (m, 0) if id(node) in absorbed else (m, idx)

    for node in sym._topo():
        if node.is_variable:
            mapping[id(node)] = node
            continue
        if id(node) in absorbed:
            mapping[id(node)] = absorbed[id(node)]
            continue
        site = by_name.get(node.name) if node.name in by_name else None
        if site is not None and site.node is node:
            bn, relu = _fold_chain(site, consumers, output_ids,
                                   arg_params, aux_params)
            act = "relu" if relu is not None else "identity"
            w = _np32(arg_params[site.weight_name])
            w_scale = calib.weight_scale[site.name]        # (K,) f32
            act_scale = _np.float32(calib.act_scale[site.name])
            bshape = (-1,) + (1,) * (w.ndim - 1)
            wq = _np.clip(_np.round(w * w_scale.reshape(bshape)),
                          -127, 127).astype(_np.int8)
            deq = (_np.float32(1.0)
                   / (act_scale * w_scale)).astype(_np.float32)
            bias = (_np32(arg_params[site.bias_name])
                    if site.bias_name else _np.zeros(w.shape[0],
                                                     _np.float32))
            if bn is not None:
                gname, bname, mname, vname = _bn_inputs(
                    bn, arg_params, aux_params)
                eps = _np.float32(bn.params.get("eps", 1e-3))
                gamma = (_np.ones(w.shape[0], _np.float32)
                         if bn.params.get("fix_gamma", True)
                         else _np32(arg_params[gname]))
                beta = _np32(arg_params[bname])
                mean = _np32(aux_params[mname])
                var = _np32(aux_params[vname])
                a = (gamma / _np.sqrt(var + eps)).astype(_np.float32)
                c = (beta - mean * a).astype(_np.float32)
            else:
                a = _np.ones(w.shape[0], _np.float32)
                c = _np.zeros(w.shape[0], _np.float32)
            out_scale = (deq * a).astype(_np.float32)
            out_bias = (a * bias + c).astype(_np.float32)

            wq_v = _var(site.name + "_weight_q", wq.shape, "int8")
            sc_v = _var(site.name + "_oscale", out_scale.shape, "float32")
            ob_v = _var(site.name + "_obias", out_bias.shape, "float32")
            new_params[site.name + "_weight_q"] = wq
            new_params[site.name + "_oscale"] = out_scale
            new_params[site.name + "_obias"] = out_bias
            f32_weight_bytes += w.nbytes + bias.nbytes
            int8_weight_bytes += (wq.nbytes + out_scale.nbytes
                                  + out_bias.nbytes)
            data_e = mapped_entry(node.inputs[0])
            if site.kind == "conv":
                qop = _registry.get("_contrib_quantized_conv_int8")
                params = {"kernel": tuple(node.params["kernel"]),
                          "num_filter": node.params["num_filter"],
                          "stride": node.params.get("stride"),
                          "dilate": node.params.get("dilate"),
                          "pad": node.params.get("pad"),
                          "act_scale": float(act_scale), "act": act}
            else:
                qop = _registry.get("_contrib_quantized_fc_int8")
                params = {"num_hidden": node.params.get(
                              "num_hidden", w.shape[0]),
                          "flatten": node.params.get("flatten", True),
                          "act_scale": float(act_scale), "act": act}
            qnode = Node(qop, site.name + "_int8",
                         [data_e, (wq_v, 0), (sc_v, 0), (ob_v, 0)],
                         params)
            mapping[id(node)] = qnode
            for absorbed_node in (bn, relu):
                if absorbed_node is not None:
                    absorbed[id(absorbed_node)] = qnode
            quantized.append(site.name)
        else:
            new_inputs = [mapped_entry(e) for e in node.inputs]
            mapping[id(node)] = Node(node.op, node.name, new_inputs,
                                     dict(node.params), dict(node.attrs))

    qsym = Symbol([mapped_entry((n, i)) for n, i in sym._entries])
    keep_args = set(qsym.list_arguments())
    keep_aux = set(qsym.list_auxiliary_states())
    qargs = {k: v for k, v in arg_params.items() if k in keep_args}
    qargs.update({k: v for k, v in new_params.items() if k in keep_args})
    qaux = {k: v for k, v in aux_params.items() if k in keep_aux}
    report = {
        "scheme": "int8-symmetric/per-channel-weight/per-tensor-act",
        "sites": list(quantized),
        "skipped": dict(skipped),
        "calibration": calib.to_dict(),
        "weight_bytes": {"f32": int(f32_weight_bytes),
                         "int8": int(int8_weight_bytes)},
    }
    return qsym, qargs, qaux, report
