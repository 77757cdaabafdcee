"""Shape, indexing and ordering operators (counterpart of
``mxnet_tpu/ops/matrix.py``): Flatten, MXNet's Reshape with its special
codes, transpose, expand_dims, squeeze, slice, slice_axis, slice_like,
split, batch_dot, Concat, stack, pad, tile, repeat, flip, swapaxes,
depth_to_space/space_to_depth, dot, khatri_rao, take, pick, batch_take,
gather_nd/scatter_nd, one_hot, sort/argsort/topk, diag, shape_array,
size_array, histogram, ravel_multi_index/unravel_index,
boolean_mask_dense, reshape_like, the out-of-place slice assignments and
the sequence ops (SequenceMask, SequenceLast, SequenceReverse, with
optional per-sample lengths). Each is a plain function on tensors that
torch autograd differentiates.

Indices follow the JAX op, never torch's checks (a CUDA index past the
end asserts the device): ``take`` clips (``mode="wrap"`` wraps),
``gather_nd`` counts a negative index from the end and clamps the rest,
``scatter_nd`` drops what falls outside, ``batch_take`` fills NaN (the
integer minimum) there, and ``one_hot`` gives an all-``off_value`` row
for an index outside ``[0, depth)``. ``sort``, ``argsort`` and ``topk``
are stable: equal values keep the lower index first, as ``jnp.argsort``
and ``lax.top_k``; a NaN sorts as the largest value.
``depth_to_space``/``space_to_depth`` are MXNet's DCR order
(``(n, b, b, c / b^2, h, w)``), which ``torch.pixel_shuffle`` (CRD)
equals only at ``c / b^2 = 1``. Index outputs are int32, the JAX
package's index dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, normalize_dtype
from .registry import alias, register

_INDEX = torch.int32   # the JAX package's index dtype (x64 off)


@register("Flatten")
def flatten(data):
    return data.reshape(data.shape[0], -1)


alias("Flatten", "flatten")


def _reshape_target(src, shape, reverse):
    """MXNet's target shape: 0 copies a dim, -1 infers one, -2 copies
    the rest, -3 merges two, -4 splits one into the two that follow."""
    src = list(src)
    shape = list(shape)
    if reverse:
        src, shape = src[::-1], shape[::-1]
    out = []
    i = j = 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(s)
            if i < len(src):
                i += 1
        j += 1
    return out[::-1] if reverse else out


@register("Reshape")
def reshape(data, *, shape=None, reverse=False):
    """MXNet reshape with special codes 0 (copy dim), -1 (infer),
    -2 (copy rest), -3 (merge two), -4 (split, consumes two following)."""
    if shape is None:
        raise ValueError("reshape requires shape")
    return data.reshape(_reshape_target(data.shape, shape, reverse))


alias("Reshape", "reshape")


@register("transpose")
def transpose(data, *, axes=None):
    if axes is None or len(axes) == 0:
        return data.permute(*reversed(range(data.dim())))
    return data.permute(*axes)


@register("expand_dims")
def expand_dims(data, *, axis):
    return data.unsqueeze(axis)


@register("squeeze")
def squeeze(data, *, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(tuple(axis) if isinstance(axis, (list, tuple))
                        else axis)


@register("slice_axis")
def slice_axis(data, *, axis, begin=0, end=None):
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("split", num_outputs=lambda p: int(p.get("num_outputs", 1)))
def split(data, *, num_outputs, axis=1, squeeze_axis=False):
    n = data.shape[axis]
    if n % num_outputs:
        raise ValueError("split: axis of %d not divisible into %d parts"
                         % (n, num_outputs))
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


alias("split", "SliceChannel")


@register("batch_dot")
def batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("Concat")
def concat(*data, dim=1):
    return torch.cat(data, dim=dim)


alias("Concat", "concat")


@register("stack")
def stack(*data, axis=0):
    return torch.stack(data, dim=axis)


@register("pad")
def pad(data, *, mode="constant", pad_width=None, constant_value=0.0):
    """MXNet's flat ``pad_width`` (before, after per axis). ``edge`` and
    ``reflect`` (numpy's modes) pad at most the last three axes, as
    MXNet's op pads the spatial ones."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(data.dim())]
    padded = [i for i, p in enumerate(pw) if p != (0, 0)]
    flat = []
    for lo, hi in reversed(pw[padded[0]:] if padded else []):
        flat += [lo, hi]
    if not flat:
        return data * 1
    if mode == "constant":
        return F.pad(data, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise MXNetError("pad: unsupported mode %r" % (mode,))
    k = data.dim() - padded[0]
    if k > 3 or padded[0] == 0:
        raise MXNetError("pad: %s mode pads at most the last three axes "
                         "of a batched tensor, got pad_width %s"
                         % (mode, tuple(pad_width)))
    return F.pad(data, flat, mode="replicate" if mode == "edge"
                 else "reflect")


alias("pad", "Pad")


@register("swapaxes")
def swapaxes(data, *, dim1=0, dim2=0):
    return data.transpose(dim1, dim2)


alias("swapaxes", "SwapAxis")


@register("dot")
def dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    """MXNet dot: the last axis of lhs against the first of rhs."""
    a = lhs.permute(*reversed(range(lhs.dim()))) if transpose_a else lhs
    b = rhs.permute(*reversed(range(rhs.dim()))) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("pick")
def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis``, indices clipped to the
    axis (the JAX op clips whatever ``mode`` says)."""
    axis = axis % data.dim()
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


@register("reshape_like")
def reshape_like(lhs, rhs, *, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    """lhs in rhs's shape; with begin/end ranges only lhs dims
    [lhs_begin, lhs_end) take rhs dims [rhs_begin, rhs_end). rhs gives
    its shape, not its values, so no gradient reaches it."""
    def rng(b, e, ndim, what):
        b = 0 if b is None else (b + ndim if b < 0 else b)
        e = ndim if e is None else (e + ndim if e < 0 else e)
        if not 0 <= b <= e <= ndim:
            raise ValueError("reshape_like: invalid %s range [%s, %s) for "
                             "%d dims" % (what, b, e, ndim))
        return b, e

    lb, le = rng(lhs_begin, lhs_end, lhs.dim(), "lhs")
    rb, re = rng(rhs_begin, rhs_end, rhs.dim(), "rhs")
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re])
                       + tuple(lhs.shape[le:]))


# ---------------------------------------------------------------------------
# sequence ops: (T, B, ...) along ``axis`` with per-sample lengths
# ---------------------------------------------------------------------------

@register("sequence_mask")
def sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                  value=0.0, axis=0):
    """Steps at or past each sample's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data * 1.0
    maxlen = data.shape[axis]
    steps = torch.arange(maxlen, device=data.device)
    mask = steps[:, None] < sequence_length.long()[None, :]   # (T, B)
    shape = [1] * data.dim()
    shape[axis] = maxlen
    batch_axis = 1 if axis == 0 else 0
    shape[batch_axis] = data.shape[batch_axis]
    mask = (mask if axis == 0 else mask.t()).reshape(shape)
    fill = torch.full((), value, dtype=data.dtype, device=data.device)
    return torch.where(mask, data, fill)


alias("sequence_mask", "SequenceMask")


def _step_index(idx, t):
    """Indices as the JAX op's gather takes them: negative ones count
    from the end, the rest clamp to the axis."""
    return torch.where(idx < 0, idx + t, idx).clamp(0, t - 1)


@register("sequence_last")
def sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                  axis=0):
    """Each sample's last valid step (the last step without lengths)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    d = data.movedim(axis, 0)                             # (T, B, ...)
    idx = _step_index(sequence_length.long() - 1, d.shape[0])
    return d[idx, torch.arange(d.shape[1], device=d.device)]


alias("sequence_last", "SequenceLast")


@register("sequence_reverse")
def sequence_reverse(data, sequence_length=None, *,
                     use_sequence_length=False, axis=0):
    """Each sample's valid prefix reversed in place; the padding after
    it stays where it is."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    d = data.movedim(axis, 0)                             # (T, B, ...)
    t = d.shape[0]
    steps = torch.arange(t, device=d.device)[:, None]     # (T, 1)
    lens = sequence_length.long()[None, :]             # (1, B)
    idx = _step_index(torch.where(steps < lens, lens - 1 - steps, steps), t)
    out = d[idx, torch.arange(d.shape[1], device=d.device)[None, :]]
    return out.movedim(0, axis)


alias("sequence_reverse", "SequenceReverse")


# ---------------------------------------------------------------------------
# slicing
# ---------------------------------------------------------------------------

def _slices(shape, begin, end, step):
    """``(key, flips)`` for MXNet's begin/end/step over the leading
    axes: ``data[key].flip(flips)`` is numpy's ``data[b:e:s, ...]``
    (torch slices take no negative step)."""
    step = list(step or []) + [None] * (len(begin) - len(step or []))
    key, flips = [], []
    for ax, (b, e, st) in enumerate(zip(begin, end, step)):
        idx = range(shape[ax])[slice(b, e, st)]
        if idx.step > 0 or len(idx) == 0:
            key.append(slice(idx.start, idx.stop, idx.step) if len(idx)
                       else slice(0, 0))
        else:
            key.append(slice(idx[-1], idx[0] + 1, -idx.step))
            flips.append(ax)
    return tuple(key), tuple(flips)


@register("slice")
def slice_op(data, *, begin, end, step=None):
    key, flips = _slices(data.shape, begin, end, step)
    out = data[key]
    return out.flip(flips) if flips else out


@register("slice_like")
def slice_like(data, shape_like, *, axes=None):
    axes = range(data.dim()) if axes is None or len(axes) == 0 else axes
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("_slice_assign")
def slice_assign(lhs, rhs, *, begin, end, step=None):
    """``lhs`` with ``rhs`` written into ``lhs[begin:end:step]``, out of
    place."""
    key, flips = _slices(lhs.shape, begin, end, step)
    out = lhs.clone()
    out[key] = rhs.flip(flips) if flips else rhs
    return out


@register("_slice_assign_scalar")
def slice_assign_scalar(data, *, scalar=0.0, begin=(), end=(), step=None):
    """``data`` with ``data[begin:end:step]`` set to ``scalar``, out of
    place."""
    key, _ = _slices(data.shape, begin, end, step)
    out = data.clone()
    out[key] = torch.tensor(scalar, dtype=data.dtype).item()
    return out


alias("_slice_assign", "_crop_assign")
alias("_slice_assign_scalar", "_crop_assign_scalar")


@register("tile")
def tile(data, *, reps):
    return torch.tile(data, tuple(reps))


@register("repeat")
def repeat(data, *, repeats, axis=None):
    return torch.repeat_interleave(data, int(repeats), dim=axis)


@register("flip")
def flip(data, *, axis):
    return torch.flip(data, tuple(axis) if isinstance(axis, (list, tuple))
                      else (axis,))


alias("flip", "reverse")


@register("depth_to_space")
def depth_to_space(data, *, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, *, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("khatri_rao")
def khatri_rao(*args):
    """The column-wise Kronecker product of the matrices."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            out.shape[0] * m.shape[0], *out.shape[1:])
    return out


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

def _wrap_clamp(idx, n):
    """numpy indexing as ``jnp`` gathers: a negative index counts from
    the end, then every index is clamped to ``[0, n)``."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


@register("take")
def take(a, indices, *, axis=0, mode="clip"):
    """``a`` at ``indices`` along ``axis``: clipped, or wrapped with
    ``mode="wrap"``."""
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = indices.long()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(indices.shape)
                       + tuple(a.shape[axis + 1:]))


@register("batch_take")
def batch_take(a, indices):
    """``out[i] = a[i, indices[i]]``; a negative index counts from the
    end, one still outside the row reads NaN (the integer minimum)."""
    n = a.shape[1]
    idx = indices.long().reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    got = torch.gather(a, 1, idx.clamp(0, n - 1)[:, None])[:, 0]
    fill = float("nan") if a.is_floating_point() \
        else torch.iinfo(a.dtype).min
    return torch.where(ok, got, torch.full_like(got, fill))


@register("gather_nd")
def gather_nd(data, indices):
    """``data[indices[0], indices[1], ...]``; see the module note for
    indices outside the data."""
    idx = indices.long()
    key = tuple(_wrap_clamp(idx[i], data.shape[i])
                for i in range(idx.shape[0]))
    return data[key]


@register("scatter_nd")
def scatter_nd(data, indices, *, shape):
    """Zeros of ``shape`` with ``data`` written at ``indices``; a
    negative index counts from the end, a write outside is dropped."""
    shape = tuple(shape)
    idx = indices.long()
    k = idx.shape[0]
    norm = [torch.where(idx[i] < 0, idx[i] + shape[i], idx[i])
            for i in range(k)]
    ok = torch.ones_like(norm[0], dtype=torch.bool)
    for i in range(k):
        ok &= (norm[i] >= 0) & (norm[i] < shape[i])
    # a dropped write goes to a scratch row past the end
    flat = torch.zeros_like(norm[0])
    for i in range(k):
        flat = flat * shape[i] + norm[i].clamp(0, shape[i] - 1)
    n_lead = 1
    for d in shape[:k]:
        n_lead *= d
    flat = torch.where(ok, flat, torch.full_like(flat, n_lead))
    out = torch.zeros((n_lead + 1,) + shape[k:], dtype=data.dtype,
                      device=data.device)
    out = out.index_put((flat.reshape(-1),),
                        data.reshape((-1,) + shape[k:]))
    return out[:n_lead].reshape(shape)


@register("one_hot")
def one_hot(indices, *, depth, on_value=1.0, off_value=0.0,
            dtype="float32"):
    idx = indices.to(_INDEX)
    oh = (idx[..., None] == torch.arange(depth, dtype=_INDEX,
                                         device=idx.device)).float()
    out = oh * on_value + (1.0 - oh) * off_value
    return out.to(normalize_dtype(dtype))


@register("boolean_mask_dense", host=True)
def boolean_mask_dense(data, mask):
    """The rows (or elements) of ``data`` where ``mask`` is nonzero: a
    shape that only the data decides, so it reads the mask back."""
    return data[mask.to(torch.bool)]


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------

@register("sort")
def sort(data, *, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort")
def argsort(data, *, axis=-1, is_ascend=True, dtype="float32"):
    idx = torch.sort(data if is_ascend else -data, dim=axis,
                     stable=True).indices
    return idx.to(normalize_dtype(dtype))


@register("topk", num_outputs=lambda p: 2 if p.get("ret_typ") == "both"
          else 1)
def topk(data, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """``lax.top_k``'s order: largest first (smallest with
    ``is_ascend``), equal values by lower index."""
    d = data.movedim(axis, -1)
    vals, raw_idx = torch.sort(-d if is_ascend else d, dim=-1,
                               descending=True, stable=True)
    vals, raw_idx = vals[..., :k], raw_idx[..., :k]
    if is_ascend:
        vals = -vals
    if ret_typ == "mask":
        # 1 at every top-k position in the data's layout, built from the
        # integer indices before any float cast
        mask = torch.zeros_like(d).scatter_(-1, raw_idx, 1)
        return mask.movedim(-1, axis)
    vals = vals.movedim(-1, axis)
    idx = raw_idx.movedim(-1, axis).to(normalize_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    return idx


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

@register("diag")
def diag(data, *, k=0):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1).clone()


@register("shape_array")
def shape_array(data):
    return torch.tensor(tuple(data.shape), dtype=_INDEX, device=data.device)


@register("size_array")
def size_array(data):
    return torch.tensor([data.numel()], dtype=_INDEX, device=data.device)


def linspace(start, stop, num, endpoint=True, dtype=torch.float32,
             device=None):
    """``jnp.linspace``'s formula, ``start * (1 - s) + stop * s`` at
    ``s = i / div``, then ``stop`` itself at the end. XLA folds the
    constants of that formula in another order, so the inner points
    agree with the JAX op's within an ulp or two, not bitwise."""
    start = torch.tensor(start, dtype=dtype, device=device)
    stop = torch.tensor(stop, dtype=dtype, device=device)
    if num <= 1:
        return start.reshape(1)[:num]
    div = num - 1 if endpoint else num
    step = torch.arange(div, dtype=dtype, device=device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)]) if endpoint else out


def bin_counts(data, edges):
    """``jnp.histogram``'s counts (f32) over sorted ``edges``: every bin
    half-open but the last, which holds its upper edge."""
    x = data.reshape(-1).to(edges.dtype)
    nb = edges.shape[0] - 1
    b = torch.searchsorted(edges, x, right=True)
    b = torch.where(x == edges[-1], torch.full_like(b, nb), b)
    counts = torch.zeros(nb + 2, dtype=torch.float32, device=x.device)
    counts.index_add_(0, b, torch.ones_like(x, dtype=torch.float32))
    return counts[1:-1]


def hist_edges(data, bins, rng):
    """``jnp.histogram_bin_edges``: ``bins + 1`` edges over ``rng`` or
    else the data's min and max (read back), widened by 0.5 each way
    when they are equal."""
    if rng is None:
        rng = (data.min().item(), data.max().item())
    dt = data.dtype if data.is_floating_point() else torch.float32
    lo, hi = torch.tensor(tuple(rng), dtype=dt)
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return linspace(lo.item(), hi.item(), int(bins) + 1, dtype=dt,
                    device=data.device)


def _range_read_back(params):
    """A histogram without ``range`` reads the data's min and max back."""
    return params.get("range") is None


@register("histogram", num_outputs=2, host=_range_read_back)
def histogram(data, *, bin_cnt=10, range=None):
    edges = hist_edges(data, bin_cnt, range)
    counts = bin_counts(data, edges)
    return counts.to(_INDEX), edges.to(data.dtype)


@register("ravel_multi_index")
def ravel_multi_index(data, *, shape):
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    strides = torch.tensor(strides[::-1], dtype=data.dtype,
                           device=data.device)
    return torch.sum(data * strides[:, None], dim=0).to(data.dtype)


@register("unravel_index")
def unravel_index(data, *, shape):
    idx = data.to(_INDEX)
    out = []
    for s in reversed(shape):
        out.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return torch.stack(out[::-1], dim=0).to(data.dtype)
