"""Shape operators (counterpart of a subset of ``mxnet_tpu/ops/matrix.py``):
Flatten, MXNet's Reshape with its special codes, transpose, expand_dims,
squeeze, slice_axis, split, batch_dot, Concat, stack, pad, swapaxes,
dot, pick (clip mode), reshape_like and the sequence ops
(SequenceMask, SequenceLast, SequenceReverse, with optional per-sample
lengths). Each is a plain function on
tensors that torch autograd differentiates."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import alias, register


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
