"""Neural-network operators of the serving and training slices.

Counterpart of ``mxnet_tpu/ops/nn.py``: FullyConnected, Convolution
and Deconvolution (1-, 2- and 3-D, NC... data and O/I-major weights,
through ``F.conv{n}d`` / ``F.conv_transpose{n}d``), Pooling (1-3 D),
BatchNorm, LayerNorm, InstanceNorm, Activation, LeakyReLU, softmax,
log_softmax, Embedding, Dropout (its mask from the random key chain)
and SoftmaxOutput,
each with the JAX op's keyword names and contract rather than torch's
defaults:

* BatchNorm returns the 5-tuple ``(out, batch_mean, batch_var,
  new_moving_mean, new_moving_var)``; the default eps is 1e-3, gamma is
  ignored under ``fix_gamma`` (the default), and the moving statistics
  update as ``moving * momentum + batch * (1 - momentum)``. Statistics
  and aux stay f32 for bf16/f16 data (the JAX op's ``_bn_dtypes``), and
  training on such data differentiates through the JAX op's own vjp
  (:class:`_BnLowpTrain`), not through autograd of the forward; under
  ``fix_gamma`` gamma's gradient is zeros.
* Pooling pads explicitly (with -inf for max, 0 for sums) and pools
  without ``ceil_mode``: ``pooling_convention="full"`` adds the
  high-side padding the JAX op adds, and ``count_include_pad`` divides
  by the whole window, that extra padding included.
* LayerNorm uses the biased variance and eps 1e-5; LeakyReLU's
  ``gelu`` is the exact (erf) GeLU.
* Embedding and _contrib_SparseEmbedding clip out-of-range ids to
  ``[0, input_dim - 1]``; at a kernel tier other than ``off`` they
  gather through ``kernels.take.take_rows``.
* SoftmaxOutput is a loss head: its backward is ``softmax - onehot``
  scaled by ``grad_scale`` and the normalization, and it ignores the
  incoming cotangent (``_SoftmaxOutputGrad``).

Every op is a function of tensors that torch autograd differentiates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from .registry import alias, register, set_op_meta


def _tuplize(v, n):
    if v is None:
        return (0,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------

@register("FullyConnected")
def fully_connected(data, weight, bias=None, *, num_hidden=0, no_bias=False,
                    flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten else data
    # weight layout: (num_hidden, in_units), which is F.linear's
    return F.linear(x, weight, None if no_bias else bias)


alias("FullyConnected", "fully_connected")


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _spatial(data, kernel, op):
    n = len(kernel)
    if n not in _CONV or data.dim() != n + 2:
        raise MXNetError("%s: kernel %s needs %d-D NC%s data, got %d-D"
                         % (op, tuple(kernel), n + 2, "DHW"[3 - n:],
                            data.dim()))
    return n


@register("Convolution")
def convolution(data, weight, bias=None, *, kernel, num_filter,
                stride=None, dilate=None, pad=None, num_group=1,
                no_bias=False, layout=None):
    """1-, 2- or 3-D convolution of NC(D)(H)W data with O I/g k... weights
    (``layout`` is taken and ignored, as in the JAX op)."""
    n = _spatial(data, kernel, "Convolution")
    stride = tuple(s if s else 1 for s in _tuplize(stride, n))
    dilate = tuple(d if d else 1 for d in _tuplize(dilate, n))
    return _CONV[n](data, weight, None if no_bias else bias, stride,
                    _tuplize(pad, n), dilate, int(num_group))


@register("Deconvolution")
def deconvolution(data, weight, bias=None, *, kernel, num_filter,
                  stride=None, dilate=None, pad=None, adj=None,
                  target_shape=None, num_group=1, no_bias=True, layout=None):
    """Transposed convolution, weights ``(in, num_filter / num_group,
    k...)``; output ``(in - 1) * stride - 2 * pad + dilate * (k - 1) + 1
    + adj``. A ``target_shape`` with a nonzero entry replaces pad and adj
    as the JAX op derives them (``total = stride * (in - 1) + dilated k
    - target``, ``adj = total % 2``, ``pad = (total + 1) // 2``)."""
    n = _spatial(data, kernel, "Deconvolution")
    stride = tuple(s if s else 1 for s in _tuplize(stride, n))
    dilate = tuple(d if d else 1 for d in _tuplize(dilate, n))
    pad_ = _tuplize(pad, n)
    adj_ = _tuplize(adj, n)
    spatial = tuple(data.shape[2:])
    if target_shape and any(int(t) > 0 for t in target_shape):
        target = tuple(int(t) for t in target_shape)
        dk = tuple(dilate[i] * (kernel[i] - 1) + 1 for i in range(n))
        total = tuple(stride[i] * (spatial[i] - 1) + dk[i] - target[i]
                      for i in range(n))
        if any(t < 0 for t in total):
            raise ValueError("too big target shape %s (natural zero-pad "
                             "output is %s)" % (target, tuple(
                                 stride[i] * (spatial[i] - 1) + dk[i]
                                 for i in range(n))))
        adj_ = tuple(t % 2 for t in total)
        pad_ = tuple((t + 1) // 2 for t in total)
    b = None if no_bias else bias
    if all(a < max(s, d) for a, s, d in zip(adj_, stride, dilate)):
        return _CONV_T[n](data, weight, b, stride, pad_, adj_,
                          int(num_group), dilate)
    # an adj torch's output_padding does not take: the full transposed
    # convolution, cropped by pad, zero-extended by adj on the high side
    full = _CONV_T[n](data, weight, b, stride, 0, 0, int(num_group),
                      dilate)
    idx = [slice(None), slice(None)]
    extra = []
    for i in range(n):
        size = full.shape[2 + i] - 2 * pad_[i] + adj_[i]
        stop = min(pad_[i] + size, full.shape[2 + i])
        idx.append(slice(pad_[i], stop))
        extra.append(size - (stop - pad_[i]))
    out = full[tuple(idx)]
    if any(extra):
        padding = []
        for e in reversed(extra):
            padding += [0, e]
        fill = F.pad(out, padding)
        if b is not None:
            # the extension holds no product, only the bias
            mask = F.pad(torch.zeros_like(out[:1, :1]), padding, value=1.0)
            fill = fill + mask * b.reshape((1, -1) + (1,) * n)
        out = fill
    return out


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(x, kernel, stride):
    """Window sums without padding (``divisor_override=1``; 1-D runs as
    2-D over a unit height)."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + tuple(kernel),
                            (1,) + tuple(stride),
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register("Pooling")
def pooling(data, *, kernel=(), pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, cudnn_off=False, p_value=2):
    n = data.dim() - 2
    if n not in _MAX_POOL:
        raise MXNetError("Pooling: 1-, 2- or 3-D pooling of NC... data, got "
                         "%d-D data" % data.dim())
    if global_pool:
        kernel = tuple(data.shape[2:])
        stride = (1,) * n
        pad_ = (0,) * n
    else:
        kernel = tuple(kernel)
        stride = tuple(s if s else 1 for s in _tuplize(stride, n))
        pad_ = _tuplize(pad, n)
    extra = [0] * n
    if pooling_convention == "full":
        # ceil-mode output: extra padding on the high side when needed
        for i in range(n):
            rem = (data.shape[2 + i] + 2 * pad_[i] - kernel[i]) % stride[i]
            extra[i] = 0 if rem == 0 else stride[i] - rem
    padding = []                  # F.pad order: last dim first, (lo, hi)
    for i in reversed(range(n)):
        padding += [pad_[i], pad_[i] + extra[i]]
    if pool_type == "max":
        x = F.pad(data, padding, value=float("-inf")) if any(padding) \
            else data
        return _MAX_POOL[n](x, kernel, stride)
    if pool_type not in ("avg", "sum"):
        raise MXNetError("Pooling: unsupported pool_type %r" % (pool_type,))
    x = F.pad(data, padding) if any(padding) else data
    s = _window_sum(x, kernel, stride)
    if pool_type == "sum":
        return s
    if count_include_pad:
        denom = 1.0
        for k in kernel:
            denom *= k
        return s / denom
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    cnt = _window_sum(F.pad(ones, padding), kernel, stride)
    return s / cnt


alias("Pooling", "pooling")


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

def _bn_widened_sums(x, red):
    """Per-channel sum and sum of squares of a low-precision tensor in
    f32, and the count reduced over: the JAX op's f32 reductions of bf16
    products (each product is exact in f32)."""
    x32 = x.float()
    n = 1
    for i in red:
        n *= x.shape[i]
    return x32.sum(red), (x32 * x32).sum(red), n


def _bn_lowp_stats(x, red):
    """f32 batch mean and (biased) variance of low-precision data over
    ``red``, from the widened sums."""
    s1, s2, n = _bn_widened_sums(x, red)
    mean = s1 / n
    return mean, (s2 / n - mean * mean).clamp_min(0.0)


def _bn_coef_apply(x, axis, *cols32):
    """Per-channel f32 coefficient vectors, concatenated and downcast to
    x's dtype once, each reshaped to broadcast against x."""
    C = x.shape[axis]
    coef = torch.cat(cols32).to(x.dtype)
    shape = [1] * x.dim()
    shape[axis] = C
    return [coef[i * C:(i + 1) * C].reshape(shape)
            for i in range(len(cols32))]


def _bn_lowp_fwd_impl(x, g32, b32, eps, axis):
    red = tuple(i for i in range(x.dim()) if i != axis)
    mean, var = _bn_lowp_stats(x, red)
    inv = torch.rsqrt(var + eps)
    scale = inv * g32
    shift = b32 - mean * scale
    sc, sh = _bn_coef_apply(x, axis, scale, shift)
    return x * sc + sh, mean, var, inv


class _BnLowpTrain(torch.autograd.Function):
    """Training BatchNorm of bf16/f16 data with the JAX op's own vjp
    (``_bn_lowp_train``): dgamma = inv * (sum(dy*x) - mean * sum(dy)) and
    dbeta = sum(dy), f32 sums of low-precision products, and dx = dy*a +
    x*b + c in the data dtype, off per-channel f32 coefficients downcast
    once. The statistic outputs carry no gradient."""

    @staticmethod
    def forward(ctx, x, g32, b32, eps, axis):
        out, mean, var, inv = _bn_lowp_fwd_impl(x, g32, b32, eps, axis)
        ctx.save_for_backward(x, g32, mean, inv)
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, g32, mean, inv = ctx.saved_tensors
        axis = ctx.axis
        red = tuple(i for i in range(x.dim()) if i != axis)
        with torch.profiler.record_function("batch_norm.lowp_backward"):
            dy32 = dy.float()
            s_dy = dy32.sum(red)
            s_dyx = (dy32 * x.float()).sum(red)
            n = 1
            for i in red:
                n *= x.shape[i]
            dgamma = inv * (s_dyx - mean * s_dy)
            dbeta = s_dy
            A = g32 * inv
            B = -A * inv * dgamma / n
            Cc = -A * s_dy / n - B * mean
            a, b, c = _bn_coef_apply(x, axis, A, B, Cc)
            dx = dy * a + x * b + c
        return dx, dgamma, dbeta, None, None


class _UnitGamma(torch.autograd.Function):
    """f32 ones in gamma's shape, with a zero gradient for gamma: under
    ``fix_gamma`` gamma's gradient is zeros, as ``jax.grad`` gives."""

    @staticmethod
    def forward(ctx, gamma):
        ctx.like = (gamma.shape, gamma.dtype, gamma.device)
        return torch.ones(gamma.shape, dtype=torch.float32,
                          device=gamma.device)

    @staticmethod
    def backward(ctx, _g):
        shape, dtype, device = ctx.like
        return torch.zeros(shape, dtype=dtype, device=device)


def unit_gamma(gamma):
    """The gamma BatchNorm uses under ``fix_gamma``."""
    if gamma.requires_grad and torch.is_grad_enabled():
        return _UnitGamma.apply(gamma)
    return torch.ones_like(gamma, dtype=torch.float32)


@register("BatchNorm", num_outputs=5)
def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               _training=True):
    """Returns (out, batch_mean, batch_var, new_moving_mean,
    new_moving_var). Statistics and coefficients are f32 whatever the
    data dtype; bf16/f16 data is normalized in its own dtype off one
    per-channel downcast of the coefficients, and in training takes
    :class:`_BnLowpTrain`, the JAX op's custom vjp."""
    axis = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != axis)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    g32 = unit_gamma(gamma) if fix_gamma else gamma.float()
    b32 = beta.float()
    lowp = data.dtype in (torch.bfloat16, torch.float16)
    train = _training and not use_global_stats
    if train and lowp:
        out, mean, var = _BnLowpTrain.apply(data, g32, b32, float(eps),
                                            axis)
    elif train:
        mean = data.mean(red)
        var = data.var(red, correction=0)
    else:
        mean, var = moving_mean, moving_var
    if train:
        new_mean = moving_mean * momentum + mean * (1.0 - momentum)
        new_var = moving_var * momentum + var * (1.0 - momentum)
    else:
        new_mean, new_var = moving_mean, moving_var
    if not (train and lowp):
        inv = torch.rsqrt(var + eps)
        if lowp:
            sc, sh = _bn_coef_apply(data, axis, inv * g32,
                                    b32 - mean * (inv * g32))
            out = data * sc + sh
        else:
            out = ((data - mean.reshape(shape)) * (inv * g32).reshape(shape)
                   + b32.reshape(shape))
    return (out.to(data.dtype), mean.detach(), var.detach(),
            new_mean.detach(), new_var.detach())


# ---------------------------------------------------------------------------
# Activation and the softmax head
# ---------------------------------------------------------------------------

_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


@register("Activation")
def activation(data, *, act_type="relu"):
    try:
        return _ACTS[act_type](data)
    except KeyError:
        raise MXNetError("Activation: unsupported act_type %r"
                         % (act_type,)) from None


@register("LeakyReLU")
def leaky_relu(data, gamma=None, *, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """``leaky``, ``elu``, ``selu``, ``prelu`` (a per-channel ``gamma``
    on axis 1), the exact (erf) ``gelu`` and ``rrelu``, whose negative
    slopes are uniform in [lower_bound, upper_bound) from the random key
    chain, in training and out of it, as in the JAX op."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        a, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data >= 0, data, a * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "prelu":
        g = gamma
        if g.dim() == 1 and data.dim() > 1:
            shape = [1] * data.dim()
            shape[1] = g.shape[0]
            g = g.reshape(shape)
        return torch.where(data >= 0, data, g * data)
    if act_type == "rrelu":
        slope_r = _random.uniform(_random.next_key(), data.shape, data.dtype,
                                  lower_bound, upper_bound, data.device)
        return torch.where(data >= 0, data, slope_r * data)
    raise MXNetError("LeakyReLU: unsupported act_type %r" % (act_type,))


@register("softmax")
def softmax(data, *, axis=-1, temperature=None, length=None):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(data, *, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


class _SoftmaxOutputGrad(torch.autograd.Function):
    """The loss head's gradient, ``(softmax(data) - onehot(label)) *
    scale``, whatever cotangent arrives (the JAX op's
    ``_softmax_output_bwd``). A label outside ``[0, classes)`` (the
    ignore label -1 among them) has an all-zero one-hot row."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, normalization, smooth_alpha):
        out = torch.softmax(data, dim=1 if multi_output else -1)
        ctx.save_for_backward(out, label)
        ctx.hyper = (grad_scale, ignore_label, multi_output, use_ignore,
                     normalization, smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        (grad_scale, ignore_label, multi_output, use_ignore, normalization,
         smooth_alpha) = ctx.hyper
        axis = 1 if multi_output else out.dim() - 1
        ncls = out.shape[axis]
        lab = label.to(torch.int32)
        if smooth_alpha:
            classes = torch.arange(ncls, device=out.device)
            oh = (lab.long().unsqueeze(-1) == classes).to(out.dtype)
            oh = oh * (1.0 - smooth_alpha) + smooth_alpha / ncls
            if multi_output:
                oh = oh.movedim(-1, 1)
            grad = out - oh
        else:
            # out - onehot without building the one-hot tensor
            grad = out.movedim(axis, -1).clone(
                memory_format=torch.contiguous_format)
            # 1 off at each in-range label, nothing elsewhere (x - 0 is
            # x), by gather and scatter: no host read of the labels, so
            # the step stays capturable as a CUDA graph
            rows = grad.reshape(-1, ncls)
            ids = lab.reshape(-1, 1).long()
            hit = ((ids >= 0) & (ids < ncls)).to(rows.dtype)
            safe = ids.clamp(0, ncls - 1)
            rows.scatter_(1, safe, rows.gather(1, safe) - hit)
            grad = grad.movedim(-1, axis)
        valid = lab != int(ignore_label)
        if use_ignore:
            grad = grad * valid.unsqueeze(axis).to(grad.dtype)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid" and use_ignore:
            scale = scale / valid.to(grad.dtype).sum().clamp_min(1.0)
        return grad * scale, None, None, None, None, None, None, None


@register("SoftmaxOutput")
def softmax_output(data, label=None, *, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """The softmax; with a label, a loss head whose gradient is
    :class:`_SoftmaxOutputGrad`'s."""
    if label is None:
        return torch.softmax(data, dim=1 if multi_output else -1)
    return _SoftmaxOutputGrad.apply(
        data, label, float(grad_scale), float(ignore_label),
        bool(multi_output), bool(use_ignore), str(normalization),
        float(smooth_alpha))


# ---------------------------------------------------------------------------
# LayerNorm and Embedding
# ---------------------------------------------------------------------------

@register("LayerNorm")
def layer_norm(data, gamma, beta, *, axis=-1, eps=1e-5,
               output_mean_var=False):
    axis = axis % data.dim()
    if axis == data.dim() - 1:
        return F.layer_norm(data, (data.shape[-1],), gamma, beta, eps)
    mean = data.mean(axis, keepdim=True)
    var = data.var(axis, correction=0, keepdim=True)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return ((data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape)
            + beta.reshape(shape))


@register("InstanceNorm")
def instance_norm(data, gamma, beta, *, eps=1e-3):
    red = tuple(range(2, data.dim()))
    mean = data.mean(red, keepdim=True)
    var = data.var(red, correction=0, keepdim=True)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return ((data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape)
            + beta.reshape(shape))


@register("Dropout", is_random=True)
def dropout(data, *, p=0.5, mode="training", axes=(), cudnn_off=False,
            _training=True):
    """The JAX op's inverted dropout: ``where(mask, data / (1 - p), 0)``
    with ``mask = bernoulli(key, 1 - p)`` over ``data``'s shape (1 on
    ``axes``), the key from the random chain. The identity at ``p <= 0``
    or outside training (``mode='always'`` aside)."""
    if (not _training and mode != "always") or p <= 0.0:
        return data * 1.0
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    keep = 1.0 - p
    mask = _random.bernoulli(_random.next_key(), keep, shape, data.device)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds differently from the JAX op's division;
    # filled on the device (torch.tensor would copy from the host, which
    # a CUDA graph cannot capture)
    kt = torch.full((), keep, dtype=data.dtype, device=data.device)
    return torch.where(mask, data / kt, torch.zeros_like(data))


def _maybe_take_rows(data, weight):
    """The tier's row gather (``kernels.take``) when the policy and the
    guard allow, else None."""
    from ..base import dtype_name
    from ..kernels import take as _take
    from ..kernels import tier as _tier
    if not _tier.enabled():
        return None
    reason = _take.eligible(tuple(weight.shape), weight.dtype,
                            tuple(data.shape), data.dtype)
    go, cfg = _tier.should_dispatch(
        _take.OP_NAME, _take.shape_key_shapes(tuple(weight.shape),
                                              tuple(data.shape)),
        dtype_name(weight.dtype), _take.DEFAULT_CONFIG, guard_reason=reason)
    if not go:
        return None
    return _take.take_rows(weight, data, config=cfg)


@register("Embedding")
def embedding(data, weight, *, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    out = _maybe_take_rows(data, weight)
    if out is not None:
        return out
    # clip mode, as the JAX op and the kernel take out-of-range ids
    from ..kernels import take as _take
    return _take._plain_take(weight, data)


@register("_contrib_SparseEmbedding")
def sparse_embedding(data, weight, *, input_dim=0, output_dim=0,
                     dtype="float32", deterministic=False):
    """Embedding whose weight gradient is row-sparse: the forward is the
    same gather (B2 at a kernel tier other than off); the sparse
    contract lives in the storage layer (a Parameter's
    ``grad_stype="row_sparse"``), which the optimizers' lazy row updates
    consume."""
    return embedding(data, weight)


# ---------------------------------------------------------------------------
# Parameter-shape hooks and aux slots
# ---------------------------------------------------------------------------

def _fc_shapes(ins, p):
    data, weight, bias = (ins + [None] * 3)[:3]
    nh = int(p.get("num_hidden", 0))
    out = list(ins)
    if data is not None:
        in_units = 1
        if p.get("flatten", True):
            for d in data[1:]:
                in_units *= d
        else:
            in_units = data[-1]
        if len(ins) > 1 and ins[1] is None:
            out[1] = (nh, in_units)
    if len(ins) > 2 and ins[2] is None:
        out[2] = (nh,)
    return out


def _conv_shapes(ins, p):
    data = ins[0]
    nf = int(p["num_filter"])
    k = tuple(p["kernel"])
    ng = int(p.get("num_group", 1))
    out = list(ins)
    if data is not None and len(ins) > 1 and ins[1] is None:
        out[1] = (nf, data[1] // ng) + k
    if len(ins) > 2 and ins[2] is None:
        out[2] = (nf,)
    return out


def _bn_shapes(ins, p):
    data = ins[0]
    out = list(ins)
    if data is not None:
        c = (data[int(p.get("axis", 1)) % len(data)],)
        for i in range(1, min(5, len(ins))):
            if out[i] is None:
                out[i] = c
    return out


def _softmax_out_shapes(ins, p):
    out = list(ins)
    data = ins[0]
    if data is not None and len(ins) > 1 and ins[1] is None:
        if p.get("multi_output"):
            out[1] = (data[0],) + tuple(data[2:])
        else:
            out[1] = tuple(data[:-1])
    return out


set_op_meta("FullyConnected", shape_hook=_fc_shapes)
def _deconv_shapes(ins, p):
    data = ins[0]
    nf = int(p["num_filter"])
    ng = int(p.get("num_group", 1))
    out = list(ins)
    if data is not None and len(ins) > 1 and ins[1] is None:
        out[1] = (data[1], nf // ng) + tuple(p["kernel"])
    if len(ins) > 2 and ins[2] is None:
        out[2] = (nf,)
    return out


set_op_meta("Convolution", shape_hook=_conv_shapes)
set_op_meta("Deconvolution", shape_hook=_deconv_shapes)
set_op_meta("BatchNorm", shape_hook=_bn_shapes, aux_inputs=(3, 4),
            aux_outputs=(3, 4),
            num_visible_outputs=lambda p: 3 if p.get("output_mean_var")
            else 1)
def _ln_shapes(ins, p):
    data = ins[0]
    out = list(ins)
    if data is not None:
        c = (data[int(p.get("axis", -1)) % len(data)],)
        for i in range(1, min(3, len(ins))):
            if out[i] is None:
                out[i] = c
    return out


def _embedding_shapes(ins, p):
    out = list(ins)
    if len(ins) > 1 and ins[1] is None:
        out[1] = (int(p["input_dim"]), int(p["output_dim"]))
    return out


set_op_meta("SoftmaxOutput", shape_hook=_softmax_out_shapes)
set_op_meta("LayerNorm", shape_hook=_ln_shapes)
set_op_meta("Embedding", shape_hook=_embedding_shapes)
set_op_meta("_contrib_SparseEmbedding", shape_hook=_embedding_shapes)
