"""Image operators (counterpart of ``mxnet_tpu/ops/image_ops.py``): the
14 ``_image_*`` ops of the Gluon vision transforms.

Images are HWC (NHWC batched), uint8 or float, as in MXNet;
``_image_to_tensor`` gives CHW float32 in [0, 1]. The random ops take
one key each from the random chain (``random.next_key``) and draw what
the JAX op draws (a Bernoulli flip, a uniform factor, three normal
lighting weights), so a seeded pipeline flips the same images and
scales by the same factors as the JAX package's. Their arithmetic
follows the JAX op's order of operations. ``_image_resize`` is
``jax.image.resize``'s separable resampling (half-pixel centres;
triangle, Keys cubic or Lanczos-3 weights, widened when downsampling;
nearest by ``floor``), one weight matrix an axis.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .. import random as _random
from .registry import register


@register("_image_to_tensor")
def to_tensor(data):
    x = data.to(torch.float32) / 255.0
    if x.dim() == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


def _vec(v, like):
    return torch.as_tensor(_np.asarray(v, _np.float32), device=like.device)


@register("_image_normalize")
def normalize(data, *, mean=0.0, std=1.0):
    shape = (-1, 1, 1) if data.dim() == 3 else (1, -1, 1, 1)
    mean = _vec(mean, data).reshape(shape)
    std = _vec(std, data).reshape(shape)
    return (data - mean) / std


def _flip(data, axis3):
    """Flip the HWC axis ``axis3`` (one further out when batched)."""
    return torch.flip(data, (axis3 if data.dim() == 3 else axis3 + 1,))


@register("_image_flip_left_right")
def flip_left_right(data):
    return _flip(data, 1)


@register("_image_flip_top_bottom")
def flip_top_bottom(data):
    return _flip(data, 0)


def _coin():
    """``jax.random.bernoulli(key, 0.5)``, drawn on the host."""
    return bool(_random.bernoulli(_random.next_key(), 0.5, ()))


@register("_image_random_flip_left_right", is_random=True)
def random_flip_left_right(data):
    return _flip(data, 1) if _coin() else data


@register("_image_random_flip_top_bottom", is_random=True)
def random_flip_top_bottom(data):
    return _flip(data, 0) if _coin() else data


def _uniform(lo, hi, like):
    """One f32 factor ``uniform(key, (), lo, hi)``, drawn on the host and
    placed beside ``like``."""
    a = _random.uniform(_random.next_key(), (), torch.float32, lo, hi)
    return a.to(like.device)


def _blend(a, b, alpha):
    return alpha * a + (1.0 - alpha) * b


@register("_image_random_brightness", is_random=True)
def random_brightness(data, *, min_factor, max_factor):
    return data.to(torch.float32) * _uniform(min_factor, max_factor, data)


_GRAY = (0.299, 0.587, 0.114)


def _to_gray(x):
    return (x * _vec(_GRAY, x)).sum(-1, keepdim=True)


@register("_image_random_contrast", is_random=True)
def random_contrast(data, *, min_factor, max_factor):
    alpha = _uniform(min_factor, max_factor, data)
    x = data.to(torch.float32)
    return _blend(x, _to_gray(x).mean((-3, -2), keepdim=True), alpha)


@register("_image_random_saturation", is_random=True)
def random_saturation(data, *, min_factor, max_factor):
    alpha = _uniform(min_factor, max_factor, data)
    x = data.to(torch.float32)
    return _blend(x, _to_gray(x), alpha)


_T_YIQ = ((0.299, 0.587, 0.114), (0.5959, -0.2746, -0.3213),
          (0.2115, -0.5227, 0.3112))
_T_RGB = ((1.0, 0.9563, 0.6210), (1.0, -0.2721, -0.6474),
          (1.0, -1.1070, 1.7046))


@register("_image_random_hue", is_random=True)
def random_hue(data, *, min_factor, max_factor):
    """Hue rotation in YIQ space by ``(factor - 1) * pi``."""
    alpha = _uniform(min_factor, max_factor, data)
    theta = (alpha - 1.0) * math.pi
    u, w = torch.cos(theta), torch.sin(theta)
    dev = data.device
    rot = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                       device=dev) \
        + u * torch.tensor([[0., 0., 0.], [0., 1., 0.], [0., 0., 1.]],
                           device=dev) \
        + w * torch.tensor([[0., 0., 0.], [0., 0., 1.], [0., -1., 0.]],
                           device=dev)
    m = torch.tensor(_T_RGB, device=dev) @ rot @ torch.tensor(_T_YIQ,
                                                              device=dev)
    return torch.einsum("...c,dc->...d", data.to(torch.float32), m)


@register("_image_random_color_jitter", is_random=True)
def random_color_jitter(data, *, brightness=0.0, contrast=0.0,
                        saturation=0.0, hue=0.0):
    x = data.to(torch.float32)
    if brightness > 0:
        x = x * _uniform(max(0.0, 1 - brightness), 1 + brightness, x)
    if contrast > 0:
        a = _uniform(max(0.0, 1 - contrast), 1 + contrast, x)
        x = _blend(x, _to_gray(x).mean((-3, -2), keepdim=True), a)
    if saturation > 0:
        a = _uniform(max(0.0, 1 - saturation), 1 + saturation, x)
        x = _blend(x, _to_gray(x), a)
    if hue > 0:
        x = random_hue(x, min_factor=1 - hue, max_factor=1 + hue)
    return x


_EIG_VAL = (55.46, 4.794, 1.148)
_EIG_VEC = ((-0.5675, 0.7192, 0.4009), (-0.5808, -0.0045, -0.8140),
            (-0.5836, -0.6948, 0.4203))


@register("_image_random_lighting", is_random=True)
def random_lighting(data, *, alpha_std=0.05):
    """AlexNet-style PCA lighting noise: three normal draws."""
    alpha = _random.normal(_random.next_key(), (3,)).to(data.device) \
        * alpha_std
    rgb = torch.tensor(_EIG_VEC, device=data.device) \
        @ (alpha * torch.tensor(_EIG_VAL, device=data.device))
    return data.to(torch.float32) + rgb


def _triangle(x):
    return torch.clamp_min(1 - x.abs(), 0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos3(x):
    radius = 3.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    safe = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


# OpenCV interpolation codes -> jax.image methods; area (3) resamples as
# linear with antialiasing, as in the JAX op
_METHODS = {0: "nearest", 1: _triangle, 2: _keys_cubic, 3: _triangle,
            4: _lanczos3}


def _weights(m, n, kernel, device):
    """``jax.image``'s ``compute_weight_mat``: (m in, n out) f32 weights
    for a scale ``n / m``, antialiased."""
    scale = n / m
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = ((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
              * inv - 0.5)
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kscale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(_np.finfo(_np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@register("_image_resize")
def image_resize(data, *, size, keep_ratio=False, interp=1):
    """Resize HWC/NHWC to ``size`` ((w, h), or an int for a square)."""
    ow, oh = (size, size) if isinstance(size, int) else tuple(size)
    x = data if data.dim() == 4 else data[None]
    n, h, w, c = x.shape
    method = _METHODS.get(int(interp), _triangle)
    if method == "nearest":
        out = x
        for axis, (m, k) in ((1, (h, oh)), (2, (w, ow))):
            if m != k:
                idx = torch.floor((torch.arange(k, dtype=torch.float32)
                                   + 0.5) * m / k).to(torch.int64)
                out = out.index_select(axis, idx.to(x.device))
        out = out.to(torch.float32)
    else:
        out = x.to(torch.float32)
        if h != oh:
            out = torch.einsum("nhwc,hk->nkwc", out,
                               _weights(h, oh, method, x.device))
        if w != ow:
            out = torch.einsum("nhwc,wk->nhkc", out,
                               _weights(w, ow, method, x.device))
    if data.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    else:
        out = out.to(data.dtype)
    return out if data.dim() == 4 else out[0]


@register("_image_crop")
def image_crop(data, *, x, y, width, height):
    """The (height, width) window at (y, x), placed as
    ``lax.dynamic_slice`` places it: a negative start counts from the
    end, and a window that would leave the image starts earlier."""
    def start(v, dim, size):
        v = int(v) + (dim if int(v) < 0 else 0)
        return min(max(v, 0), dim - size)
    y = start(y, data.shape[-3], height)
    x = start(x, data.shape[-2], width)
    return data[..., y:y + height, x:x + width, :]
