"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm`` and
``download``, which raises (no network), as ``refuse_pretrained``
does for the model zoo's ``pretrained=True``; and
``params_from_reference``, which carries another package's weights into
a block by their names relative to the root block's prefix."""
from __future__ import annotations

import math
import warnings

import numpy as _np

from ..base import MXNetError
from ..ndarray import ndarray as _nd

__all__ = ["split_data", "split_and_load", "clip_global_norm", "download",
           "params_from_reference"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split an NDArray along ``batch_axis`` into ``num_slice`` slices."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d" % (str(data.shape), num_slice, batch_axis))
    step = size // num_slice
    if not even_split and size < num_slice:
        step = 1
        num_slice = size
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One slice of ``data`` on each context of ``ctx_list``."""
    if not isinstance(data, _nd.NDArray):
        data = _nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` (rebinding each) so that the 2-norm of them all
    is at most ``max_norm``; returns that norm (a float, or an NDArray
    when ``check_isfinite`` is False, so nothing waits for the card)."""
    if not arrays:
        raise ValueError("clip_global_norm: no arrays")
    ctx = arrays[0].context
    total = None
    for arr in arrays:
        sq = arr.reshape((-1,)).square().sum().as_in_context(ctx)
        total = sq if total is None else total + sq
    total_norm = total.sqrt()
    scale = (max_norm / (total_norm + 1e-8)).clip(0.0, 1.0)
    for arr in arrays:
        arr *= scale.as_in_context(arr.context)
    if check_isfinite:
        norm_val = float(total_norm.asscalar())
        if not math.isfinite(norm_val):
            warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                      "results will be undefined."),
                          stacklevel=2)
        return norm_val
    return total_norm


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise MXNetError("download(%s): the port fetches nothing over the "
                     "network" % (url,))


def refuse_pretrained(name):
    """What the zoo's constructors do with ``pretrained=True``: the
    published weights are files the repo does not hold."""
    raise MXNetError("pretrained %s: the weights are files the repo does "
                     "not hold; load a .params file with load_parameters "
                     "instead" % name)


def params_from_reference(block, arrays, ctx=None):
    """Set every parameter of ``block`` from ``arrays``: numpy (or
    anything ``np.asarray`` takes) keyed by the parameter's name with the
    root block's prefix removed, e.g. a JAX package block's
    ``{n[len(b.prefix):]: p.data().asnumpy() for n, p in
    b.collect_params().items()}``. A name manager counts block names per
    process, so two models built in one process get different prefixes;
    relative names are the same. A parameter not yet allocated lands on
    its deferred context, else on ``ctx``. Raises when a name is missing
    on either side."""
    params = block.collect_params()
    prefix = block.prefix
    rel = {}
    for name, p in params.items():
        if not name.startswith(prefix):
            raise MXNetError("parameter %s is outside %s's prefix %r"
                             % (name, block.name, prefix))
        rel[name[len(prefix):]] = p
    missing = sorted(set(rel) - set(arrays))
    extra = sorted(set(arrays) - set(rel))
    if missing or extra:
        raise MXNetError("params_from_reference: missing %s, unknown %s"
                         % (missing, extra))
    for key, p in rel.items():
        value = _np.asarray(arrays[key])
        if p._data is None and p._deferred_init is None and ctx is not None:
            value = _nd.array(value, ctx=ctx)
        p.set_data(value)
