"""Serving-side int8 operators for post-training quantization
(``mxnet_tpu_torch/quant``): the two ops the rewrite pass lowers eligible
FullyConnected / Convolution sites onto.

Counterpart of ``mxnet_tpu/ops/quant_serve.py``. The calibrated
activation scale is a static hyper-parameter and the per-output-channel
dequant scale / bias (the inference BatchNorm affine and any bias folded
in) ride along as small f32 parameters. One op per site:

    f32 data -> static-scale int8 quantize -> int8 x int8 product with
    int32 accumulation (``torch._int_mm``) -> fused dequant epilogue
    ``act(acc * scale[oc] + bias[oc])`` -> f32

The product is a library call, as the JAX package leaves it to XLA
outside any Pallas kernel: :func:`_int8_matmul` puts ``torch._int_mm``
(cuBLASLt's int8 tensor-core GEMM on the card) behind one helper that
pads its operands on every device the way the card needs them (more than
16 rows; K and N multiples of 8; zeros leave every int32 sum unchanged),
so the CPU runs what the card runs. A convolution is an im2col of the
int8 input (a strided view; one copy where the GEMM needs a dense
operand) followed by that GEMM, and its (N*OH*OW, O) accumulator is the
epilogue's per-column form; the result is viewed back as NCHW, channels
in the innermost memory dimension.

The epilogue dispatches through the kernel tier (``kernels/
int8_dequant``, B6); at tier off it runs the kernel's plain version, as
the JAX package runs its pure-JAX branch. Inference only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..kernels import int8_dequant as _k
from ..kernels import tier as _tier
from .registry import register

__all__ = ["quantized_fc_int8", "quantized_conv_int8"]

# cuBLASLt's int8 GEMM (torch._int_mm on CUDA) takes more than 16 rows,
# and K and N that are multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def _ceil(v, m):
    return -(-v // m) * m


def _quantize_static(data, act_scale):
    """f32 -> int8 with the calibrated per-tensor scale (symmetric). The
    product stays in f32 (``act_scale`` is an f32 value) and
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    q = torch.round(data.float() * float(act_scale))
    return q.clamp_(-127, 127).to(torch.int8)


def _patches(xq, kernel, stride, pad, dilate):
    """int8 NCHW -> (N, OH, OW, C, kh, kw) strided view of the
    convolution's input windows; flattened, its last three dims are the
    OIHW weight's (C, kh, kw) order."""
    ph, pw = pad
    if ph or pw:
        xq = F.pad(xq, (pw, pw, ph, ph))
    N, C, H, W = xq.shape
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilate
    OH = (H - dh * (kh - 1) - 1) // sh + 1
    OW = (W - dw * (kw - 1) - 1) // sw + 1
    sN, sC, sH, sW = xq.stride()
    return xq.as_strided((N, OH, OW, C, kh, kw),
                         (sN, sH * sh, sW * sw, sC, sH * dh, sW * dw),
                         xq.storage_offset())


def _int8_matmul(patches, weight):
    """Exact int32 ``rows(patches) @ weight.reshape(O, K).T`` through
    ``torch._int_mm``, on the CPU and the card alike.

    ``patches`` is any int8 tensor whose leading dims flatten to the M
    rows and trailing dims to the K = ``weight[0].numel()`` columns.
    Rows pad to at least 17 and K and N to multiples of 8 with zeros,
    written in the one copy that makes the operand dense. The card takes
    one operand layout: the rows row-major (a 1x1 convolution over
    channels-innermost memory is one already, a view; over NCHW memory
    the view is column-major and is copied) and the weight (O, K)
    row-major, handed over transposed, a view wherever no padding is
    needed (every ResNet-50 site but conv0's K = 147). -> int32 (M, O),
    contiguous.
    """
    O = weight.shape[0]
    K = weight[0].numel()
    M = patches.numel() // K
    Mp, Kp, Np = max(M, _MIN_ROWS), _ceil(K, _ALIGN), _ceil(O, _ALIGN)
    if (Mp, Kp) == (M, K):
        a = patches.reshape(M, K).contiguous()
    else:
        a = patches.new_zeros((Mp, Kp))
        a[:M, :K].view(patches.shape).copy_(patches)
    w = weight.reshape(O, K).contiguous()
    if (Np, Kp) != (O, K):
        w = F.pad(w, (0, Kp - K, 0, Np - O))
    acc = torch._int_mm(a, w.t())
    if Np != O:
        return acc[:M, :O].contiguous()
    return acc[:M] if Mp != M else acc


def _epilogue(acc, scale, bias, act):
    """Fused dequant -> affine -> act over the (rows, channels) int32
    accumulator (B6's per-column form), kernel-tier dispatched; at tier
    off (or when the guard declines) the kernel's plain version."""
    sc, sh = scale.float(), bias.float()
    reason = _k.eligible(tuple(acc.shape), act=act)
    go, cfg = _tier.should_dispatch(_k.OP_NAME,
                                    _k.shape_key_shapes(tuple(acc.shape)),
                                    "int32", _k.DEFAULT_CONFIG,
                                    guard_reason=reason)
    if go:
        return _k.dequant_epilogue(acc, sc, sh, per_row=False, act=act,
                                   config=cfg)
    return _k._plain_dequant(acc, sc, sh, False, act)


@register("_contrib_quantized_fc_int8")
def quantized_fc_int8(data, weight_q, out_scale, out_bias, *, num_hidden,
                      act_scale, act="identity", flatten=True):
    """int8 FullyConnected for the serving path.

    data f32 (quantized in-op with the static calibrated ``act_scale``),
    weight_q int8 (K, D), out_scale/out_bias f32 (K,) holding
    dequant * BN-affine and BN-shift + dequantized bias.
    """
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    xq = _quantize_static(x, act_scale)
    acc = _int8_matmul(xq, weight_q.to(torch.int8))
    y = _epilogue(acc, out_scale, out_bias, act)
    return y.reshape(tuple(x.shape[:-1]) + (y.shape[-1],))


@register("_contrib_quantized_conv_int8")
def quantized_conv_int8(data, weight_q, out_scale, out_bias, *, kernel,
                        num_filter, act_scale, stride=None, dilate=None,
                        pad=None, act="identity"):
    """int8 NCHW Convolution for the serving path (2-D, groups=1 only:
    the only form the rewrite emits). Same scale/bias contract as the FC
    op, per output channel (axis 1)."""
    n = len(kernel)
    if n != 2 or data.dim() != 4:
        raise MXNetError("_contrib_quantized_conv_int8: the port quantizes "
                         "2-D NCHW convolutions only, got kernel %s on "
                         "%d-D data" % (tuple(kernel), data.dim()))
    stride = tuple(s if s else 1 for s in (stride or (1,) * n))
    dilate = tuple(d if d else 1 for d in (dilate or (1,) * n))
    pad = tuple(pad or (0,) * n)
    xq = _quantize_static(data, act_scale)
    p = _patches(xq, tuple(kernel), stride, pad, dilate)
    acc = _int8_matmul(p, weight_q.to(torch.int8))
    y = _epilogue(acc, out_scale, out_bias, act)
    N, OH, OW = p.shape[:3]
    return y.view(N, OH, OW, -1).permute(0, 3, 1, 2)
