"""Port parity for the convolution and pooling layers
(``gluon/nn/conv_layers.py`` over the ``Convolution``, ``Deconvolution``,
``Pooling`` and ``pad`` ops) against the JAX package, on the CPU.

Every layer class at 1, 2 and 3 D, with strides, dilation, groups,
``output_padding`` (an ``adj`` past torch's ``output_padding`` limit
among them), ``ceil_mode`` and ``count_include_pad``: the forward, the
input's gradient and every parameter's gradient under a fixed cotangent,
from the JAX package's weights, each within 1e-5 of that tensor's
largest magnitude (f32, the same sums in other orders). The port's
layers refuse a layout other than channel-first, where the JAX
package's compute as if it were.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

CPU = mt.cpu()
TOL = 1e-5


def _arr(pkg, a):
    return mt.nd.array(a, ctx=CPU) if pkg is mt else mx.nd.array(a)


def _np(x):
    return np.array(x.asnumpy(), np.float32, copy=True)


def _run(pkg, make, x_np, weights=None, hybrid=False):
    blk = make(pkg.gluon.nn)
    np.random.seed(0)
    if pkg is mt:
        blk.initialize(mt.init.Xavier(), ctx=CPU)
    else:
        blk.initialize(mx.init.Xavier())
    x = _arr(pkg, x_np)
    with pkg.autograd.predict_mode():
        blk(x)
    rel = {n[len(blk.prefix):]: p for n, p in blk.collect_params().items()}
    if weights is None:
        weights = {k: _np(p.data()) for k, p in rel.items()}
    else:
        mt.gluon.utils.params_from_reference(blk, weights)
    if hybrid:
        blk.hybridize()
    x.attach_grad()
    with pkg.autograd.record():
        out = blk(x)
        cot = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
        (out * _arr(pkg, cot)).sum().backward()
    grads = {k: _np(p.grad()) for k, p in rel.items()
             if p.grad_req != "null"}
    return weights, _np(out), _np(x.grad), grads


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


CASES = {
    "conv1d": (lambda nn: nn.Conv1D(4, 3, strides=2, padding=1, dilation=2),
               (2, 2, 9)),
    "conv1d_groups": (lambda nn: nn.Conv1D(4, 3, groups=2, use_bias=False),
                      (2, 4, 7)),
    "conv2d": (lambda nn: nn.Conv2D(6, (3, 2), strides=(2, 1),
                                    padding=(1, 0), dilation=(1, 2),
                                    groups=3), (2, 3, 7, 8)),
    "conv2d_act": (lambda nn: nn.Conv2D(4, 1, activation="relu",
                                        in_channels=3), (2, 3, 5, 5)),
    "conv3d": (lambda nn: nn.Conv3D(4, 2, strides=2, padding=1),
               (1, 2, 5, 5, 4)),
    "conv1d_t": (lambda nn: nn.Conv1DTranspose(3, 3, strides=2, padding=1,
                                               output_padding=1), (2, 2, 5)),
    "conv2d_t_groups": (lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, groups=2),
        (2, 4, 4, 5)),
    "conv2d_t_dilated": (lambda nn: nn.Conv2DTranspose(
        2, 3, padding=1, dilation=2), (1, 3, 5, 5)),
    "conv2d_t_wide_adj": (lambda nn: nn.Conv2DTranspose(
        2, 3, strides=1, padding=0, output_padding=2), (1, 2, 4, 4)),
    "conv3d_t": (lambda nn: nn.Conv3DTranspose(2, 2, strides=2),
                 (1, 2, 3, 3, 3)),
    "maxpool1d_ceil": (lambda nn: nn.MaxPool1D(3, 2, 1, ceil_mode=True),
                       (2, 3, 10)),
    "maxpool2d": (lambda nn: nn.MaxPool2D(3, 2, 1), (2, 3, 9, 9)),
    "maxpool2d_ceil": (lambda nn: nn.MaxPool2D(2, ceil_mode=True),
                       (1, 2, 7, 7)),
    "maxpool3d": (lambda nn: nn.MaxPool3D(2), (1, 2, 4, 6, 4)),
    "avgpool1d_excl": (lambda nn: nn.AvgPool1D(3, 2, 1,
                                               count_include_pad=False),
                       (2, 3, 10)),
    "avgpool2d_ceil_excl": (lambda nn: nn.AvgPool2D(
        3, 2, 1, ceil_mode=True, count_include_pad=False), (1, 2, 8, 8)),
    "avgpool2d": (lambda nn: nn.AvgPool2D(2), (2, 3, 6, 6)),
    "avgpool3d_incl": (lambda nn: nn.AvgPool3D(3, 1, 1), (1, 2, 4, 4, 3)),
    "global_max1d": (lambda nn: nn.GlobalMaxPool1D(), (2, 3, 7)),
    "global_max2d": (lambda nn: nn.GlobalMaxPool2D(), (2, 3, 5, 4)),
    "global_max3d": (lambda nn: nn.GlobalMaxPool3D(), (1, 2, 3, 4, 5)),
    "global_avg1d": (lambda nn: nn.GlobalAvgPool1D(), (2, 3, 7)),
    "global_avg2d": (lambda nn: nn.GlobalAvgPool2D(), (2, 3, 5, 4)),
    "global_avg3d": (lambda nn: nn.GlobalAvgPool3D(), (1, 2, 3, 4, 5)),
    "reflection_pad2d": (lambda nn: nn.ReflectionPad2D(2), (1, 2, 5, 6)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_forward_and_gradients_match(name):
    make, shape = CASES[name]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = _run(mx, make, x)
    for hybrid in (False, True):
        got = _run(mt, make, x, weights=want[0], hybrid=hybrid)
        _close(got[1], want[1])
        _close(got[2], want[2])
        assert sorted(got[3]) == sorted(want[3])
        for k in want[3]:
            _close(got[3][k], want[3][k])


@pytest.mark.parametrize("target", [(10, 10), (9, 11)])
def test_deconvolution_target_shape(target):
    rng = np.random.RandomState(2)
    x = rng.randn(1, 3, 5, 5).astype(np.float32)
    w = rng.randn(3, 2, 3, 3).astype(np.float32)
    outs = [_np(pkg.nd.Deconvolution(_arr(pkg, x), _arr(pkg, w),
                                     kernel=(3, 3), stride=(2, 2),
                                     num_filter=2, target_shape=target))
            for pkg in (mx, mt)]
    assert outs[0].shape[2:] == target
    _close(outs[1], outs[0])
    with pytest.raises(ValueError, match="too big target shape"):
        mt.nd.Deconvolution(_arr(mt, x), _arr(mt, w), kernel=(3, 3),
                            stride=(2, 2), num_filter=2,
                            target_shape=(20, 20))


@pytest.mark.parametrize("make", [
    lambda nn: nn.Conv2D(3, 3, layout="NHWC"),
    lambda nn: nn.Conv1D(3, 3, layout="NWC"),
    lambda nn: nn.Conv3DTranspose(3, 3, layout="NDHWC"),
    lambda nn: nn.MaxPool2D(layout="NHWC"),
    lambda nn: nn.GlobalAvgPool3D(layout="NDHWC"),
])
def test_a_channel_last_layout_raises(make):
    with pytest.raises(mt.MXNetError, match="layout"):
        make(mt.gluon.nn)
    make(mx.gluon.nn)      # the JAX package takes it and computes NC...


def test_convolution_op_refuses_a_kernel_of_the_wrong_rank():
    with pytest.raises(mt.MXNetError, match="Convolution"):
        mt.nd.Convolution(mt.nd.array(np.ones((1, 2, 5, 5)), ctx=CPU),
                          mt.nd.array(np.ones((3, 2, 3)), ctx=CPU),
                          kernel=(3,), num_filter=3, no_bias=True)
