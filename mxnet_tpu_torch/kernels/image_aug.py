"""The image record augment pass: crop, border, mirror, BGR -> RGB,
normalisation, HWC -> CHW and cast, over a batch.

No TPU kernel stands behind it: the JAX package runs this transform on
the host (``mxnet_tpu/io/image_record_iter.py`` ``_build_augmenter``,
cv2 and numpy). The port decodes records on the card
(:mod:`~mxnet_tpu_torch.kernels.nvjpeg`) and runs the transform there,
as the hand-written CUDA kernel ``csrc/image_aug.cu``: one launch a
batch.

:func:`augment` launches the kernel when ``out`` lies on a card, and
raises on what the kernel does not take; on the CPU it takes
:func:`_plain_augment`, the same function in plain torch, with the same
f32 operations in the JAX package's order (each rounded on its own), so
the two agree bitwise. Every launch adds one to ``launches``; nothing
else does.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as _np
import torch

from ..base import MXNetError
from . import _build

__all__ = ["augment", "launch_table", "launches", "reset_launches"]

# threads per block; a block covers that many output pixels of one image
_THREADS = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

launches = 0
_count_lock = threading.Lock()

_F3 = ctypes.c_float * 3
_SIGNATURES = {
    "mxk_image_aug": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _F3, _F3, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)),
    "mxk_error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}


def reset_launches():
    global launches
    with _count_lock:
        launches = 0


def _plain_augment(srcs, crops, out, pad, fill, mean, std, scale,
                   normalize):
    """The kernel's function in plain torch, image by image."""
    _, _, th, tw = out.shape
    mean_t = torch.tensor(mean, dtype=torch.float32, device=out.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=out.device)
    scale_t = torch.tensor(scale, dtype=torch.float32, device=out.device)
    for i, (img, (y0, x0, flip)) in enumerate(zip(srcs, crops)):
        h, w = img.shape[:2]
        if pad > 0:
            padded = torch.full((h + 2 * pad, w + 2 * pad, 3), fill,
                                dtype=torch.uint8, device=img.device)
            padded[pad:pad + h, pad:pad + w] = img
            img = padded
        crop = img[y0:y0 + th, x0:x0 + tw]
        if flip:
            crop = crop.flip(1)
        v = crop.flip(2).to(torch.float32)            # BGR -> RGB
        if normalize:
            v = (v - mean_t) / std_t * scale_t
        out[i] = v.permute(2, 0, 1).to(out.dtype)
    return out


def _check(srcs, crops, out, pad, fill):
    _check_out(out, pad, fill)
    B, _, th, tw = out.shape
    if len(srcs) != B or len(crops) != B:
        raise MXNetError("image_aug kernel: %d images and %d crops for a "
                         "batch of %d" % (len(srcs), len(crops), B))
    for img, (y0, x0, _flip) in zip(srcs, crops):
        if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3 \
                or not img.is_contiguous() or img.device != out.device:
            raise MXNetError("image_aug kernel: each image must be a "
                             "contiguous (H, W, 3) uint8 tensor on %s"
                             % out.device)
        h, w = img.shape[:2]
        if not (0 <= y0 and y0 + th <= h + 2 * pad and 0 <= x0
                and x0 + tw <= w + 2 * pad):
            raise MXNetError("image_aug kernel: crop (%d, %d) of %dx%d does "
                             "not fit a %dx%d image padded by %d"
                             % (y0, x0, th, tw, h, w, pad))


def _check_out(out, pad, fill):
    if out.dtype not in _DTYPE_CODE or out.dim() != 4 \
            or out.shape[1] != 3 or not out.is_contiguous():
        raise MXNetError("image_aug kernel: out must be a contiguous (B, 3, "
                         "H, W) f32, bf16 or f16 tensor, got %s %s"
                         % (tuple(out.shape), out.dtype))
    if not 0 <= int(fill) <= 255 or pad < 0:
        raise MXNetError("image_aug kernel: fill must be a byte and pad "
                         ">= 0, got %r and %r" % (fill, pad))


def _norm_args(mean, std, scale, normalize):
    mean = tuple(float(_np.float32(m)) for m in mean)
    std = tuple(float(_np.float32(s)) for s in std)
    scale = float(_np.float32(scale))
    if normalize is None:
        normalize = any(m != 0 for m in mean) or any(s != 1 for s in std) \
            or scale != 1.0
    return mean, std, scale, bool(normalize)


def launch_table(table, out, *, pad=0, fill=255, mean=(0.0, 0.0, 0.0),
                 std=(1.0, 1.0, 1.0), scale=1.0, normalize=None):
    """The kernel over a ``(B, 6)`` int64 table of (address of an ``(h,
    w, 3)`` uint8 image on ``out``'s card, h, w, y0, x0, mirror), the
    form a batch made on the card takes; :func:`augment` otherwise. The
    crops are checked; the images must stay alive and unwritten until
    the launch has run on the current stream."""
    mean, std, scale, normalize = _norm_args(mean, std, scale, normalize)
    _check_out(out, pad, fill)
    table = _np.ascontiguousarray(table, _np.int64)
    B, _, th, tw = out.shape
    if out.device.type != "cuda" or table.shape != (B, 6):
        raise MXNetError("image_aug.launch_table: a (%d, 6) table and an "
                         "output on a card, got %s on %s"
                         % (B, table.shape, out.device))
    h, w, y0, x0 = table[:, 1], table[:, 2], table[:, 3], table[:, 4]
    bad = (y0 < 0) | (y0 + th > h + 2 * pad) | (x0 < 0) \
        | (x0 + tw > w + 2 * pad)
    if bad.any():
        i = int(_np.argmax(bad))
        raise MXNetError("image_aug kernel: crop (%d, %d) of %dx%d does "
                         "not fit a %dx%d image padded by %d"
                         % (y0[i], x0[i], th, tw, h[i], w[i], pad))
    # pinned, so the copy is queued on the stream like the launch
    dev_table = torch.from_numpy(table).pin_memory().to(out.device,
                                                        non_blocking=True)
    return _launch(dev_table, out, pad, fill, mean, std, scale, normalize)


def _launch(dev_table, out, pad, fill, mean, std, scale, normalize):
    """The launch alone, over a checked table already on ``out``'s card,
    on the current stream."""
    global launches
    lib = _build.load("image_aug", _SIGNATURES)
    B, _, th, tw = out.shape
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mxk_image_aug(
            dev_table.data_ptr(), out.data_ptr(), B, th, tw,
            _DTYPE_CODE[out.dtype], _F3(*mean), _F3(*std), float(scale),
            1 if normalize else 0, int(pad), int(fill), _THREADS, stream)
    if err != 0:
        raise MXNetError("image_aug kernel launch failed: CUDA error %d (%s)"
                         % (err, lib.mxk_error_string(err).decode()))
    with _count_lock:
        launches += 1
    return out


def augment(srcs, crops, out, *, pad=0, fill=255, mean=(0.0, 0.0, 0.0),
            std=(1.0, 1.0, 1.0), scale=1.0, normalize=None):
    """Write ``out[i]`` (``(B, 3, th, tw)``) from image ``srcs[i]`` (an
    ``(h, w, 3)`` uint8 tensor, B, G, R) under ``crops[i] = (y0, x0,
    mirror)``: the crop's top-left corner in the image padded by ``pad``
    bytes of ``fill`` on every side. ``normalize`` (default: whenever
    mean, std or scale is not the identity) applies ``(v - mean) / std *
    scale`` per RGB channel in f32. The card's images must stay alive
    and unwritten until the launch has run on the current stream."""
    crops = [(int(y0), int(x0), bool(f)) for y0, x0, f in crops]
    _check(srcs, crops, out, pad, fill)
    if out.device.type == "cuda":
        table = _np.array([(img.data_ptr(), img.shape[0], img.shape[1], y0,
                            x0, 1 if f else 0)
                           for img, (y0, x0, f) in zip(srcs, crops)],
                          _np.int64).reshape(-1, 6)
        return launch_table(table, out, pad=pad, fill=fill, mean=mean,
                            std=std, scale=scale, normalize=normalize)
    if out.device.type == "cpu":
        mean, std, scale, normalize = _norm_args(mean, std, scale, normalize)
        return _plain_augment(srcs, crops, out, pad, int(fill), mean, std,
                              scale, normalize)
    raise MXNetError("image_aug: no kernel for %s tensors"
                     % out.device.type)
