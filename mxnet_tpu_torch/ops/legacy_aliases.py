"""Legacy operator names and the small op tail (counterpart of
``mxnet_tpu/ops/legacy_aliases.py``): ``_rnn_param_concat``, the scalar
logicals and ``_hypot_scalar``, ``hard_sigmoid``, ``_histogram``,
``_ravel_multi_index``/``_unravel_index`` (clamped, as ``jnp``'s),
``_square_sum``, ``cast_storage`` (inside a graph every tensor is dense,
so the op is the identity; ``nd.cast_storage`` converts NDArrays through
:func:`ndarray.sparse.cast_storage`), ``_sparse_retain``, the
``_scatter_*`` ops and ``_identity_with_attr_like_rhs``. The capitalised
elemwise names live in :mod:`.elemwise`, the random-surface names in
:mod:`.random_ops`, ``_sparse_adagrad_update`` in :mod:`.optimizer_ops`.

The deprecated layer names ``BatchNorm_v1``, ``CuDNNBatchNorm``,
``Convolution_v1``, ``Pooling_v1`` and ``Softmax`` (``SoftmaxOutput``)
and the contrib spellings of ``CTCLoss`` are aliases: the same
operator under another name, so a graph's fusion pass sees the op
itself (``BatchNorm_v1 -> relu`` fuses as ``BatchNorm -> relu`` does).
``crop`` and the contrib spelling of ``box_nms`` wait for their ops
(ROADMAP A9)."""
from __future__ import annotations

import torch

from .matrix import bin_counts, hist_edges
from .registry import alias, register

for _legacy, _new in {
    "BatchNorm_v1": "BatchNorm", "CuDNNBatchNorm": "BatchNorm",
    "Convolution_v1": "Convolution", "Pooling_v1": "Pooling",
    "Softmax": "SoftmaxOutput",
    "_contrib_CTCLoss": "CTCLoss", "_contrib_ctc_loss": "CTCLoss",
}.items():
    alias(_new, _legacy)


@register("_rnn_param_concat")
def rnn_param_concat(*data, dim=0):
    """Concat of the RNN parameter pieces along ``dim``."""
    return torch.cat(data, dim=dim)


def _scalar_logical(name, f):
    def op(data, *, scalar):
        return f(data != 0, torch.tensor(scalar != 0)).to(data.dtype)
    op.__name__ = name
    register(name)(op)


_scalar_logical("_logical_and_scalar", torch.logical_and)
_scalar_logical("_logical_or_scalar", torch.logical_or)
_scalar_logical("_logical_xor_scalar", torch.logical_xor)


@register("_hypot_scalar")
def hypot_scalar(data, *, scalar):
    return torch.hypot(data, torch.full_like(data, scalar))


@register("hard_sigmoid")
def hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    """``clip(alpha * x + beta, 0, 1)``."""
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("_histogram", num_outputs=2)
def histogram(data, bins=None, *, bin_cnt=None, range=None):
    """``(counts, edges)`` over the flattened data: ``bin_cnt`` bins over
    ``range``, or the edges given as ``bins``. The counts take the
    data's dtype, as ``jnp.histogram``'s."""
    if bin_cnt is not None:
        if range is None or len(tuple(range)) != 2:
            from ..base import MXNetError
            raise MXNetError("_histogram: bin_cnt requires "
                             "range=(min, max)")
        edges = hist_edges(data, bin_cnt, range)
    else:
        edges = bins
    return bin_counts(data, edges).to(data.dtype), edges


@register("_ravel_multi_index")
def ravel_multi_index(data, *, shape):
    """(ndim, N) coordinates, each clamped to its axis, -> flat
    indices."""
    out = torch.zeros(data.shape[1:], dtype=torch.int32, device=data.device)
    for i, s in enumerate(shape):
        out = out * int(s) + data[i].to(torch.int32).clamp(0, int(s) - 1)
    return out.to(data.dtype)


@register("_unravel_index")
def unravel_index(data, *, shape):
    """Flat indices (N,) -> (ndim, N) coordinates; an index past either
    end reads as the first or the last element, as
    ``jnp.unravel_index``."""
    rest = data.to(torch.int32)
    coords = []
    for s in reversed(shape):
        coords.append(torch.remainder(rest, s))
        rest = torch.div(rest, s, rounding_mode="floor")
    coords = coords[::-1]
    out = [torch.where(rest > 0, torch.full_like(c, int(s) - 1),
                       torch.where(rest < -1, torch.zeros_like(c), c))
           for s, c in zip(shape, coords)]
    return torch.stack(out).to(data.dtype)


@register("_identity_with_attr_like_rhs")
def identity_with_attr_like_rhs(lhs, rhs):
    """``lhs``'s values (``rhs`` lends only its storage type)."""
    return lhs * 1.0


@register("_square_sum")
def square_sum(data, *, axis=None, keepdims=False, exclude=False):
    """``sum(x^2)`` (``exclude`` is accepted and ignored, as the JAX
    op does)."""
    if axis is None:
        ax = tuple(range(data.dim()))
    else:
        ax = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    return torch.sum(torch.square(data), dim=ax, keepdim=keepdims)


@register("cast_storage")
def cast_storage_op(data, *, stype):
    return data * 1.0


@register("_sparse_retain")
def sparse_retain(data, indices):
    """``data`` with every row that ``indices`` does not name zeroed (a
    negative index counts from the end, one outside is dropped)."""
    n = data.shape[0]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    keep = torch.zeros(n + 1, dtype=torch.bool, device=data.device)
    keep[idx] = True
    keep = keep[:n].reshape((-1,) + (1,) * (data.dim() - 1))
    return torch.where(keep, data, torch.zeros_like(data))


@register("_scatter_plus_scalar")
def scatter_plus_scalar(data, *, scalar):
    return data + scalar


@register("_scatter_minus_scalar")
def scatter_minus_scalar(data, *, scalar):
    return data - scalar


@register("_scatter_elemwise_div")
def scatter_elemwise_div(lhs, rhs):
    return lhs / rhs


@register("_scatter_set_nd")
def scatter_set_nd(lhs, rhs, indices, *, shape=None):
    """``lhs`` with ``rhs`` written at gather_nd-style ``indices``, out
    of place."""
    out = lhs.clone()
    out[tuple(indices.long())] = rhs
    return out
