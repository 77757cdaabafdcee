"""Calibration pass: activation + weight ranges for int8 quantization.

Counterpart of ``mxnet_tpu/quant/calibrate.py``. The per-site activation
amax vector lives on the device as a small f32 carry, folded with
``torch.maximum`` after every batch (order-independent, so the result is
bitwise the same across runs), and is copied to the host once, after the
last batch. Per-output-channel weight ranges never touch the device:
they are exact maxima over the checkpoint arrays, computed in numpy.
"""
from __future__ import annotations

import hashlib

import numpy as _np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["SiteInfo", "CalibrationResult", "find_sites", "calibrate"]

_EPS = 1e-8
_QUANTIZABLE = ("FullyConnected", "Convolution")


class SiteInfo:
    """One eligible FullyConnected/Convolution site."""

    __slots__ = ("name", "kind", "node", "weight_name", "bias_name")

    def __init__(self, name, kind, node, weight_name, bias_name):
        self.name = name
        self.kind = kind            # "fc" | "conv"
        self.node = node
        self.weight_name = weight_name
        self.bias_name = bias_name  # None when no_bias


def _entry_var(entry):
    node, _ = entry
    return node.name if node.is_variable else None


def _host(v):
    """A checkpoint parameter (numpy array, tensor, or anything with
    ``asnumpy``) as host numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    return _np.asarray(v)


def find_sites(sym, arg_params, excluded=()):
    """(eligible sites in topo order, {name: reason} for the skipped).

    Strict guards: a site quantizes only when the int8 op pair can
    reproduce it exactly: direct f32 weight Variable present in the
    checkpoint, groups=1 / default-layout NCHW for conv, direct bias
    Variable when biased. Everything else stays f32, with the reason
    recorded for the report (the JAX package's reasons, word for word).
    """
    excluded = set(excluded)
    sites, skipped = [], {}
    for node in sym._topo():
        if node.is_variable or node.op.name not in _QUANTIZABLE:
            continue
        name = node.name
        if name in excluded:
            skipped[name] = "excluded by caller"
            continue
        wname = _entry_var(node.inputs[1]) if len(node.inputs) > 1 else None
        if wname is None or wname not in arg_params:
            skipped[name] = "weight is not a direct checkpoint Variable"
            continue
        w = _host(arg_params[wname])
        if w.dtype != _np.float32:
            skipped[name] = "weight dtype %s is not float32" % w.dtype
            continue
        no_bias = bool(node.params.get("no_bias", False))
        bname = None
        if not no_bias and len(node.inputs) > 2:
            bname = _entry_var(node.inputs[2])
            if bname is None or bname not in arg_params:
                skipped[name] = "bias is not a direct checkpoint Variable"
                continue
        if node.op.name == "Convolution":
            if int(node.params.get("num_group", 1) or 1) != 1:
                skipped[name] = "grouped convolution (num_group != 1)"
                continue
            if node.params.get("layout") not in (None, "NCHW"):
                skipped[name] = ("layout %r is not NCHW"
                                 % node.params.get("layout"))
                continue
            if len(tuple(node.params.get("kernel", ()))) != 2 or w.ndim != 4:
                skipped[name] = "only 2-D NCHW convolutions quantize"
                continue
            kind = "conv"
        else:
            if w.ndim != 2:
                skipped[name] = "FC weight is not 2-D"
                continue
            kind = "fc"
        sites.append(SiteInfo(name, kind, node, wname, bname))
    return sites, skipped


class CalibrationResult:
    """Ranges + scales for the eligible sites.

    * ``act_amax[name]``: per-tensor |max| of the site's f32 input.
    * ``act_scale[name]``: 127 / amax (the static quantize multiplier).
    * ``weight_amax[name]`` / ``weight_scale[name]``: per-output-channel
      f32 vectors.
    """

    def __init__(self, sites, skipped, act_amax, weight_amax, batches,
                 examples):
        self.sites = sites
        self.skipped = dict(skipped)
        self.act_amax = dict(act_amax)
        self.weight_amax = dict(weight_amax)
        self.batches = batches
        self.examples = examples
        self.act_scale = {
            n: float(_np.float32(127.0)
                     / _np.maximum(_np.float32(a), _np.float32(_EPS)))
            for n, a in self.act_amax.items()}
        self.weight_scale = {
            n: (_np.float32(127.0)
                / _np.maximum(a.astype(_np.float32), _np.float32(_EPS)))
            for n, a in self.weight_amax.items()}

    def fingerprint(self):
        """sha256 over every scale, bit-exact: the calibration
        determinism witness (same data + seed -> same fingerprint)."""
        h = hashlib.sha256()
        for name in sorted(self.act_scale):
            h.update(name.encode())
            h.update(_np.float32(self.act_scale[name]).tobytes())
        for name in sorted(self.weight_scale):
            h.update(name.encode())
            h.update(self.weight_scale[name].tobytes())
        return h.hexdigest()

    def to_dict(self):
        return {
            "batches": self.batches,
            "examples": self.examples,
            "fingerprint": self.fingerprint(),
            "act_amax": {n: float(a) for n, a in
                         sorted(self.act_amax.items())},
            "skipped": dict(self.skipped),
        }


def calibrate(sym, arg_params, aux_params, batches, data_names=("data",),
              excluded=(), num_calib_examples=None, device=None):
    """Collect calibration ranges over ``batches`` (iterable of dict
    name -> array, or bare arrays for a single-input model) on ``device``
    (default cuda:0). One device-to-host copy in all."""
    from ..executor import _as_tensor, _graph_eval_fn
    from ..symbol.symbol import Symbol

    dev = resolve_device(device)
    sites, skipped = find_sites(sym, arg_params, excluded=excluded)
    if not sites:
        raise MXNetError(
            "quant.calibrate: no eligible FullyConnected/Convolution "
            "sites (skipped: %s)" % (skipped or "none found"))
    # probe symbol over each site's DATA input (contrib calibrator idiom)
    probe = Symbol([s.node.inputs[0] for s in sites])
    eval_fn = _graph_eval_fn(probe)
    arg_vals = {k: _as_tensor(v, dev) for k, v in arg_params.items()}
    aux_vals = {k: _as_tensor(v, dev) for k, v in aux_params.items()}
    carry = torch.zeros(len(sites), dtype=torch.float32, device=dev)
    n_batches = examples = 0
    with torch.inference_mode():
        for batch in batches:
            if not isinstance(batch, dict):
                # single-input convenience: a bare array per batch
                if len(data_names) != 1:
                    raise MXNetError(
                        "quant.calibrate: batches must be dicts name -> "
                        "array when the model has %d data inputs %r"
                        % (len(data_names), tuple(data_names)))
                batch = {data_names[0]: batch}
            data_vals = {n: _as_tensor(batch[n], dev) for n in data_names}
            vals = dict(arg_vals)
            vals.update(data_vals)
            outs, _ = eval_fn(vals, aux_vals, False)
            amax = torch.stack([o.abs().amax().float() for o in outs])
            carry = torch.maximum(carry, amax)
            n_batches += 1
            examples += int(data_vals[data_names[0]].shape[0])
            if (num_calib_examples is not None
                    and examples >= num_calib_examples):
                break
    if n_batches == 0:
        raise MXNetError("quant.calibrate: empty calibration set")
    # THE one device-to-host copy of the whole pass
    host = carry.cpu().numpy().astype(_np.float32)
    act_amax = {s.name: float(host[i]) for i, s in enumerate(sites)}
    zero = [n for n, a in act_amax.items() if a <= 0.0]
    for n in zero:
        skipped[n] = "zero activation range over the calibration set"
        del act_amax[n]
    sites = [s for s in sites if s.name in act_amax]
    # per-output-channel weight ranges: exact, host-side, no device work
    weight_amax = {}
    for s in sites:
        w = _np.asarray(_host(arg_params[s.weight_name]), _np.float32)
        red = tuple(range(1, w.ndim))
        weight_amax[s.name] = _np.abs(w).max(axis=red).astype(_np.float32)
    return CalibrationResult(sites, skipped, act_amax, weight_amax,
                             n_batches, examples)
