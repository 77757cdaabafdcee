"""Neural-network operators of the serving and training slices.

Counterpart of ``mxnet_tpu/ops/nn.py``: FullyConnected, Convolution
and Deconvolution (1-, 2- and 3-D, NC... data and O/I-major weights,
through ``F.conv{n}d`` / ``F.conv_transpose{n}d``), Pooling (1-3 D),
BatchNorm, LayerNorm, InstanceNorm, LRN, Activation, LeakyReLU,
softmax, log_softmax, Embedding, Dropout (its mask from the random key
chain), SoftmaxOutput, MakeLoss and the fused RNN,
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
* MakeLoss (alias ``make_loss``) is the identity forward whose backward
  seeds ``grad_scale``, over the batch (``batch``) or over the count of
  elements above ``valid_thresh`` (``valid``), whatever cotangent
  arrives (``_MakeLossGrad``).
* RNN (lstm, gru, rnn_tanh, rnn_relu; time major) takes one flat
  parameter vector in the JAX op's order (:func:`_rnn_param_shapes`),
  projects the input of all T steps in one product and then loops over
  the steps in Python, one recurrent product and the gate math each.
  Between layers it applies dropout whenever ``p > 0``, in training or
  not, and it ignores ``projection_size`` and the ``lstm_state_clip_*``
  arguments: both as the JAX op does.

Every op is a function of tensors that torch autograd differentiates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from ..context import resolve_device
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


@register("LRN")
def lrn(data, *, nsize, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across channels of NCHW data, the
    JAX op's formula: ``data / (knorm + alpha * window / nsize) ** beta``,
    ``window`` the sum of ``data ** 2`` over ``nsize`` neighbouring
    channels of the zero-padded channel axis (``nsize // 2`` each side),
    summed slice by slice in channel order. Autograd differentiates it."""
    if data.dim() != 4:
        raise MXNetError("LRN: NCHW data expected, got %d-D" % data.dim())
    half = int(nsize) // 2
    c = data.shape[1]
    padded = F.pad(data * data, (0, 0, 0, 0, half, half))
    window = padded[:, 0:c]
    for i in range(1, int(nsize)):
        window = window + padded[:, i:i + c]
    return data / torch.pow(knorm + alpha * window / nsize, beta)


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


class _MakeLossGrad(torch.autograd.Function):
    """The JAX op's ``_make_loss_bwd``: the input is the loss, so its
    gradient is the constant ``grad_scale``, divided by the batch or by
    the count of elements above ``valid_thresh`` (at least 1), computed
    on the device (no host read, so a step stays capturable)."""

    @staticmethod
    def forward(ctx, data, grad_scale, normalization, valid_thresh):
        ctx.hyper = (grad_scale, normalization, valid_thresh)
        ctx.save_for_backward(data)
        return data * 1.0

    @staticmethod
    def backward(ctx, _g):
        (data,) = ctx.saved_tensors
        grad_scale, normalization, valid_thresh = ctx.hyper
        # a fill, not a copy from the host: a captured step holds it
        scale = torch.full((), grad_scale, dtype=data.dtype,
                           device=data.device)
        if normalization == "batch":
            scale = scale / data.shape[0]
        elif normalization == "valid":
            valid = (data > valid_thresh).to(data.dtype).sum().clamp_min(1.0)
            scale = scale / valid
        return scale.expand(data.shape).clone(), None, None, None


@register("MakeLoss")
def make_loss(data, *, grad_scale=1.0, normalization="null",
              valid_thresh=0.0):
    """Any value as a loss head: the identity forward; the backward
    injects ``grad_scale`` (0 makes a monitoring output that adds no
    gradient, SSD's ``cls_label``)."""
    return _MakeLossGrad.apply(data, float(grad_scale), str(normalization),
                               float(valid_thresh))


alias("MakeLoss", "make_loss")


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


# ---------------------------------------------------------------------------
# RNN (fused)
# ---------------------------------------------------------------------------

_GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}


def _lstm_cell(xproj, h, c, wh_t):
    """One LSTM step; ``xproj`` already holds ``x·wxᵀ + bx + bh``. Gates
    (i, f, g, o)."""
    gates = torch.addmm(xproj, h, wh_t)
    s = torch.sigmoid(gates)
    hs = h.shape[-1]
    i, f, o = s[:, :hs], s[:, hs:2 * hs], s[:, 3 * hs:]
    g = torch.tanh(gates[:, 2 * hs:3 * hs])
    c2 = f * c + i * g
    return o * torch.tanh(c2), c2


def _gru_cell(xproj, h, wh_t, bh):
    """One GRU step; ``xproj`` holds ``x·wxᵀ + bx``. Gates (r, z, n)."""
    xr, xz, xn = torch.chunk(xproj, 3, dim=-1)
    hr, hz, hn = torch.chunk(torch.addmm(bh, h, wh_t), 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


def _rnn_cell(xproj, h, wh_t, act):
    """One Elman step; ``xproj`` holds ``x·wxᵀ + bx + bh``."""
    return act(torch.addmm(xproj, h, wh_t))


def _rnn_param_order(num_layers, bidirectional):
    """The flat vector's pieces in order, as (kind, layer, direction):
    (wx, wh) for every layer and direction, then (bx, bh) for every
    layer and direction. Every reader of the layout walks this."""
    dirs = 2 if bidirectional else 1
    pairs = [(layer, d) for layer in range(num_layers) for d in range(dirs)]
    return ([(k, layer, d) for layer, d in pairs for k in ("wx", "wh")]
            + [(k, layer, d) for layer, d in pairs for k in ("bx", "bh")])


def _rnn_param_shapes(mode, input_size, state_size, num_layers,
                      bidirectional):
    """The flat vector's pieces in order, as (kind, shape)."""
    gh = _GATES[mode] * state_size
    dirs = 2 if bidirectional else 1
    shapes = []
    for kind, layer, _ in _rnn_param_order(num_layers, bidirectional):
        if kind == "wx":
            shape = (gh, input_size if layer == 0 else state_size * dirs)
        elif kind == "wh":
            shape = (gh, state_size)
        else:
            shape = (gh,)
        shapes.append((kind, shape))
    return shapes


_RNN_PIECE_NAMES = {"wx": "i2h_weight", "wh": "h2h_weight",
                    "bx": "i2h_bias", "bh": "h2h_bias"}


def _rnn_param_names(num_layers, bidirectional):
    """The Gluon layer's names of the flat vector's pieces, in order:
    ``l0_i2h_weight``, ``l0_h2h_weight``, ... (``r`` for the backward
    direction)."""
    return ["%s%d_%s" % ("lr"[d], layer, _RNN_PIECE_NAMES[kind])
            for kind, layer, d in _rnn_param_order(num_layers,
                                                   bidirectional)]


def _rnn_dropout_layers(p, num_layers):
    """The layers whose output takes dropout, each drawing one key: all
    but the last whenever ``p > 0``, training or not, as the JAX op."""
    return range(num_layers - 1) if p > 0.0 else range(0)


def rnn_param_size(mode, input_size, state_size, num_layers,
                   bidirectional):
    n = 0
    for _, s in _rnn_param_shapes(mode, input_size, state_size, num_layers,
                                  bidirectional):
        k = 1
        for d in s:
            k *= d
        n += k
    return n


def _unpack_rnn_params(params, mode, input_size, state_size, num_layers,
                       bidirectional):
    out, off = [], 0
    for _, s in _rnn_param_shapes(mode, input_size, state_size, num_layers,
                                  bidirectional):
        n = 1
        for d in s:
            n *= d
        out.append(params[off:off + n].reshape(s))
        off += n
    return out


def rnn_params_from_reference(flat, mode, input_size, state_size,
                              num_layers, bidirectional, device=None):
    """The JAX package's flat RNN parameter vector (numpy, or anything
    with ``asnumpy``) as an f32 tensor on ``device`` (default cuda:0),
    after checking its length against :func:`rnn_param_size`: both
    packages lay the vector out the same way, so the values cross
    unchanged."""
    import numpy as _np
    dev = resolve_device(device)
    if hasattr(flat, "asnumpy"):
        flat = flat.asnumpy()
    a = _np.ascontiguousarray(_np.asarray(flat, dtype=_np.float32)
                              .reshape(-1))
    want = rnn_param_size(mode, input_size, state_size, num_layers,
                          bidirectional)
    if a.size != want:
        raise MXNetError("RNN parameters: %d values, but mode %s with input "
                         "%d, state %d, %d layer(s)%s needs %d"
                         % (a.size, mode, input_size, state_size,
                            num_layers, ", bidirectional" if bidirectional
                            else "", want))
    return torch.from_numpy(a.copy()).to(dev)


def _rnn_outputs(p):
    if not p.get("state_outputs"):
        return 1
    return 3 if p.get("mode", "lstm") == "lstm" else 2


@register("RNN", num_outputs=_rnn_outputs)
def rnn(data, parameters, state, state_cell=None, *, state_size, num_layers,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
        projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False):
    """Fused multi-layer RNN over time-major data (T, N, I).

    Per layer and direction: one (T·N, I)×(I, G·H) product for the
    input of every step, then a Python loop over the steps, each one
    (N, H)×(H, G·H) product and the gate math; the backward direction
    walks the steps from the last. States are (layers·dirs, N, H).
    Returns the output (T, N, dirs·H), and with ``state_outputs`` the
    final h (and c for lstm)."""
    T, N, I = data.shape
    H = int(state_size)
    dirs = 2 if bidirectional else 1
    if data.device.type == "meta":
        # shape inference: the shapes without the loop, and the keys the
        # dropout between layers draws, as a real call draws them
        for _ in _rnn_dropout_layers(p, num_layers):
            _random.next_key()
        x = data.new_empty((T, N, dirs * H))
        st = data.new_empty((num_layers * dirs, N, H))
        if not state_outputs:
            return x
        return (x, st, st) if mode == "lstm" else (x, st)
    flat = _unpack_rnn_params(parameters, mode, I, H, num_layers,
                              bidirectional)
    pairs = num_layers * dirs
    wxs, whs = flat[0:2 * pairs:2], flat[1:2 * pairs:2]
    bxs, bhs = flat[2 * pairs::2], flat[2 * pairs + 1::2]
    act = torch.relu if mode == "rnn_relu" else torch.tanh
    dropped = _rnn_dropout_layers(p, num_layers)
    x = data
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        outs_dir = []
        for d in range(dirs):
            li = layer * dirs + d
            wh_t = whs[li].t()
            # the input projection of every step, one product; the
            # recurrent bias joins it where the cell adds it unscaled
            bias = bxs[li] if mode == "gru" else bxs[li] + bhs[li]
            xp = F.linear(x.reshape(T * N, -1), wxs[li], bias)
            xp = xp.reshape(T, N, -1)
            h = state[li]
            c = state_cell[li] if mode == "lstm" else None
            ys = [None] * T
            for t in (range(T) if d == 0 else range(T - 1, -1, -1)):
                if mode == "lstm":
                    h, c = _lstm_cell(xp[t], h, c, wh_t)
                elif mode == "gru":
                    h = _gru_cell(xp[t], h, wh_t, bhs[li])
                else:
                    h = _rnn_cell(xp[t], h, wh_t, act)
                ys[t] = h
            h_finals.append(h)
            if mode == "lstm":
                c_finals.append(c)
            outs_dir.append(torch.stack(ys, 0))
        x = torch.cat(outs_dir, -1) if dirs == 2 else outs_dir[0]
        if layer in dropped:
            keep = 1.0 - p
            mask = _random.bernoulli(_random.next_key(), keep, x.shape,
                                     x.device)
            kt = torch.full((), keep, dtype=x.dtype, device=x.device)
            x = torch.where(mask, x / kt, torch.zeros_like(x))
    if not state_outputs:
        return x
    if mode == "lstm":
        return x, torch.stack(h_finals, 0), torch.stack(c_finals, 0)
    return x, torch.stack(h_finals, 0)


@register("_rnn_begin_state")
def _rnn_begin_state(ref, *, state_shape, batch_axis=0):
    """Zero initial RNN state whose entries of 0 in ``state_shape`` take
    ``ref``'s batch dim, so shape inference flows forward when cells
    unroll with default states."""
    shp = tuple(ref.shape[batch_axis] if int(s) == 0 else int(s)
                for s in state_shape)
    return torch.zeros(shp, dtype=ref.dtype, device=ref.device)


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


def _rnn_shapes(ins, p):
    data = ins[0]
    out = list(ins)
    if data is not None:
        H = int(p["state_size"])
        L = int(p["num_layers"])
        bi = bool(p.get("bidirectional", False))
        if len(ins) > 1 and out[1] is None:
            out[1] = (rnn_param_size(p.get("mode", "lstm"), data[2], H, L,
                                     bi),)
        for i in (2, 3):
            if len(ins) > i and out[i] is None:
                out[i] = (L * (2 if bi else 1), data[1], H)
    return out


set_op_meta("SoftmaxOutput", shape_hook=_softmax_out_shapes)
set_op_meta("RNN", shape_hook=_rnn_shapes)
set_op_meta("LayerNorm", shape_hook=_ln_shapes)
set_op_meta("Embedding", shape_hook=_embedding_shapes)
set_op_meta("_contrib_SparseEmbedding", shape_hook=_embedding_shapes)
