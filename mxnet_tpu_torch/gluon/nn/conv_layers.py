"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): Conv1D/2D/3D and their
transposes over the ``Convolution``/``Deconvolution`` ops, Max/Avg/
GlobalMax/GlobalAvg pooling in 1-3 D over ``Pooling``, and
ReflectionPad2D over ``pad``.

The layers compute in the channel-first layouts (NCW, NCHW, NCDHW) only,
as the JAX package's do; where the JAX package takes another layout
string and computes as if it were channel-first, the port refuses it.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _check_layout(layout, n):
    if layout is not None and layout != _LAYOUTS[n]:
        raise MXNetError("layout %r: the %d-D layers compute in %s only"
                         % (layout, n, _LAYOUTS[n]))


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        assert len(v) == n
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _Conv(HybridBlock):
    """Shared conv implementation over the Convolution/Deconvolution ops."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution",
                 adj=None, **kwargs):
        super().__init__(**kwargs)
        _check_layout(layout, len(kernel_size))
        self._channels = channels
        self._in_channels = in_channels
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        with self.name_scope():
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups
                          if in_channels else 0) + kernel_size
            else:  # Deconvolution: (in_channels, channels//groups, *kernel)
                wshape = (in_channels, channels // groups) + kernel_size
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                from .activations import Activation
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _layer_infer_shape(self, x_shape, *rest):
        in_c = int(x_shape[1])
        groups = self._kwargs["num_group"]
        kernel = self._kwargs["kernel"]
        if self._op_name == "Convolution":
            self.weight._finish_deferred_init(
                (self._channels, in_c // groups) + tuple(kernel))
        else:
            self.weight._finish_deferred_init(
                (in_c, self._channels // groups) + tuple(kernel))
        if self.bias is not None:
            self.bias._finish_deferred_init((self._channels,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        mapping = "%s -> %s" % (self._in_channels or None, self._channels)
        return s.format(name=type(self).__name__, mapping=mapping,
                        kernel=self._kwargs["kernel"],
                        stride=self._kwargs["stride"]) + ")"


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 1),
                         _tuplize(strides, 1), _tuplize(padding, 1),
                         _tuplize(dilation, 1), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 2),
                         _tuplize(strides, 2), _tuplize(padding, 2),
                         _tuplize(dilation, 2), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 3),
                         _tuplize(strides, 3), _tuplize(padding, 3),
                         _tuplize(dilation, 3), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, in_channels,
                 activation, use_bias, weight_initializer, bias_initializer,
                 **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         **kwargs)


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 1),
                         _tuplize(strides, 1), _tuplize(padding, 1),
                         _tuplize(output_padding, 1), _tuplize(dilation, 1),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 2),
                         _tuplize(strides, 2), _tuplize(padding, 2),
                         _tuplize(output_padding, 2), _tuplize(dilation, 2),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplize(kernel_size, 3),
                         _tuplize(strides, 3), _tuplize(padding, 3),
                         _tuplize(output_padding, 3), _tuplize(dilation, 3),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout=None, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        _check_layout(layout, len(pool_size))
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, padding=%s)" % (
            type(self).__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"])


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 1),
                         None if strides is None else _tuplize(strides, 1),
                         _tuplize(padding, 1), ceil_mode, False, "max",
                         layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 2),
                         None if strides is None else _tuplize(strides, 2),
                         _tuplize(padding, 2), ceil_mode, False, "max",
                         layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplize(pool_size, 3),
                         None if strides is None else _tuplize(strides, 3),
                         _tuplize(padding, 3), ceil_mode, False, "max",
                         layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tuplize(pool_size, 1),
                         None if strides is None else _tuplize(strides, 1),
                         _tuplize(padding, 1), ceil_mode, False, "avg",
                         layout, count_include_pad=count_include_pad,
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuplize(pool_size, 2),
                         None if strides is None else _tuplize(strides, 2),
                         _tuplize(padding, 2), ceil_mode, False, "avg",
                         layout, count_include_pad=count_include_pad,
                         **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuplize(pool_size, 3),
                         None if strides is None else _tuplize(strides, 3),
                         _tuplize(padding, 3), ceil_mode, False, "avg",
                         layout, count_include_pad=count_include_pad,
                         **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max", layout,
                         **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max", layout,
                         **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         layout, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg", layout,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", layout,
                         **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
