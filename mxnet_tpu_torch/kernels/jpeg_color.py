"""JPEG chroma upsampling and YCbCr -> BGR, libjpeg-turbo's integer
arithmetic (``csrc/jpeg_color.cu``).

No TPU kernel stands behind it: the JAX package decodes with cv2, whose
libjpeg-turbo upsamples and converts on the host. The port decodes on
the card with nvJPEG to planes (Y, Cb, Cr as stored in the JPEG) and
finishes the decode here, so that from the same planes it gives cv2's
bytes: the "fancy" triangle upsampling of 4:2:0 and 4:2:2 chroma and the
16-bit fixed-point conversion tables (the source's header has the
formulas).

:func:`ycc_to_bgr` launches the kernel, one launch for a list of images,
when the output lies on a card, and raises on what it does not take; on
the CPU it takes :func:`_plain_image`, the same arithmetic in torch
integers, image by image. Every launch adds one to ``launches``.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as _np
import torch

from ..base import MXNetError
from . import _build

__all__ = ["ycc_to_bgr", "MODES", "launches", "reset_launches"]

_THREADS = 256
# subsampling -> the kernel's mode
MODES = {"444": 1, "422": 2, "420": 3}

launches = 0
_count_lock = threading.Lock()

_SIGNATURES = {
    "mxk_jpeg_color": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p)),
    "mxk_error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}


def reset_launches():
    global launches
    with _count_lock:
        launches = 0


def chroma_shape(h, w, mode):
    """(rows, columns) of a chroma plane, libjpeg's rounding up."""
    return {1: (h, w), 2: (h, (w + 1) // 2),
            3: ((h + 1) // 2, (w + 1) // 2)}[mode]


def _up_cols(p, w):
    """Fancy 2x horizontal upsampling of a (rows, cw) int plane to w."""
    cw = p.shape[1]
    if cw <= 2:
        return p.repeat_interleave(2, dim=1)[:, :w]
    left = torch.cat([p[:, :1], p[:, :-1]], 1)
    right = torch.cat([p[:, 1:], p[:, -1:]], 1)
    even = (3 * p + left + 1) >> 2
    odd = (3 * p + right + 2) >> 2
    even[:, 0] = p[:, 0]
    odd[:, -1] = p[:, -1]
    return torch.stack([even, odd], 2).reshape(p.shape[0], -1)[:, :w]


def _up_h2v2(p, h, w):
    """Fancy 2x2 upsampling of a (ch, cw) int plane to (h, w)."""
    ch, cw = p.shape
    if cw <= 2:
        return p.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]
    above = torch.cat([p[:1], p[:-1]], 0)
    below = torch.cat([p[1:], p[-1:]], 0)
    rows = []
    for near in (3 * p + above, 3 * p + below):     # even, odd output rows
        left = torch.cat([near[:, :1], near[:, :-1]], 1)
        right = torch.cat([near[:, 1:], near[:, -1:]], 1)
        even = (3 * near + left + 8) >> 4
        odd = (3 * near + right + 7) >> 4
        even[:, 0] = (4 * near[:, 0] + 8) >> 4
        odd[:, -1] = (4 * near[:, -1] + 7) >> 4
        rows.append(torch.stack([even, odd], 2).reshape(ch, -1))
    return torch.stack(rows, 1).reshape(2 * ch, -1)[:h, :w]


def _plain_image(y, cb, cr, out, mode):
    """One image: planes (uint8) -> out (h, w, 3) uint8, B, G, R."""
    h, w = y.shape
    yi = y.to(torch.int32)
    cbi, cri = cb.to(torch.int32), cr.to(torch.int32)
    if mode == 2:
        cbi, cri = _up_cols(cbi, w), _up_cols(cri, w)
    elif mode == 3:
        cbi, cri = _up_h2v2(cbi, h, w), _up_h2v2(cri, h, w)
    xb, xr = cbi - 128, cri - 128
    r = yi + ((91881 * xr + 32768) >> 16)
    b = yi + ((116130 * xb + 32768) >> 16)
    g = yi + (((-22554) * xb + 32768 + (-46802) * xr) >> 16)
    out.copy_(torch.stack([b, g, r], 2).clamp_(0, 255).to(torch.uint8))
    return out


def _check(images):
    for y, cb, cr, out, mode in images:
        h, w = y.shape
        if mode not in (1, 2, 3):
            raise MXNetError("jpeg_color: unknown mode %r" % (mode,))
        planes = [y, cb, cr, out]
        if any(p.dtype != torch.uint8 or not p.is_contiguous()
               or p.device != out.device for p in planes):
            raise MXNetError("jpeg_color: planes and output must be "
                             "contiguous uint8 tensors on one device")
        if tuple(out.shape) != (h, w, 3):
            raise MXNetError("jpeg_color: output %s for a %dx%d image"
                             % (tuple(out.shape), h, w))
        if tuple(cb.shape) != chroma_shape(h, w, mode) \
                or cr.shape != cb.shape:
            raise MXNetError("jpeg_color: chroma planes %s, %s for a %dx%d "
                             "image in mode %d" % (tuple(cb.shape),
                                                   tuple(cr.shape), h, w,
                                                   mode))


def descriptors(y, cb, cr, out, h, w, mode):
    """The kernel's ``(n, 10)`` int64 descriptor table (the source's
    layout) from per-image arrays: the addresses of the Y, Cb and Cr
    planes and of the output on one card, the size and the mode."""
    h, w, mode = (_np.asarray(v, _np.int64) for v in (h, w, mode))
    ch = _np.where(mode == 3, (h + 1) // 2, h)
    cw = _np.where(mode >= 2, (w + 1) // 2, w)
    return _np.stack([_np.asarray(v, _np.int64) for v in
                      (y, cb, cr, out, h, w, cw, ch, mode,
                       _np.zeros_like(h))], 1)


def _launch_table(tab, device):
    """One launch over :func:`descriptors`' ``tab`` on the current
    stream of ``device``. The caller owns the memory it points at."""
    dev_table = torch.from_numpy(_np.ascontiguousarray(tab, _np.int64)) \
        .pin_memory().to(device, non_blocking=True)
    _launch(dev_table, len(tab), int((tab[:, 4] * tab[:, 5]).max()), device)


def _launch(dev_table, n, max_pixels, device):
    """The launch alone, over a table already on ``device``."""
    global launches
    lib = _build.load("jpeg_color", _SIGNATURES)
    with torch.cuda.device(device):
        err = lib.mxk_jpeg_color(
            dev_table.data_ptr(), n, int(max_pixels), _THREADS,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise MXNetError("jpeg_color kernel launch failed: CUDA error %d "
                         "(%s)" % (err, lib.mxk_error_string(err).decode()))
    with _count_lock:
        launches += 1


def ycc_to_bgr(images):
    """Finish the decode of each ``(y, cb, cr, out, mode)`` in
    ``images``: planes as stored (Y ``(h, w)``, chroma
    :func:`chroma_shape`) into ``out``, an
    ``(h, w, 3)`` uint8 tensor of B, G, R. One launch for the list on
    the current stream of a card."""
    images = list(images)
    if not images:
        return
    _check(images)
    dev = images[0][3].device
    if dev.type == "cuda":
        cols = list(zip(*images))
        ptrs = [[t.data_ptr() for t in c] for c in cols[:4]]
        _launch_table(descriptors(*ptrs, [y.shape[0] for y in cols[0]],
                                  [y.shape[1] for y in cols[0]], cols[4]),
                      dev)
    elif dev.type == "cpu":
        for y, cb, cr, out, mode in images:
            _plain_image(y, cb, cr, out, mode)
    else:
        raise MXNetError("jpeg_color: no kernel for %s tensors" % dev.type)
