"""Fused recurrent layers (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``): ``RNN``, ``LSTM`` and ``GRU`` over
the fused ``RNN`` op.

Each layer and direction keeps its own Parameters
(``{l,r}{layer}_{i2h,h2h}_{weight,bias}``), concatenated per call into
the flat vector the op takes, in its order: every (i2h, h2h) weight
pair, then every bias pair. ``layout`` is ``TNC`` or ``NTC``; without
states the call starts from zeros and returns the output alone, with
them it returns ``(output, states)``. ``_unfuse`` gives the same
network as a ``SequentialRNNCell`` of cells sharing these parameters.
"""
from __future__ import annotations

import torch

from ... import ndarray as _ndarray
from ...ops.nn import _rnn_param_names
from ..block import HybridBlock
from . import rnn_cell

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError("Invalid layout %s; must be one of ['TNC' or "
                             "'NTC']" % layout)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param(
                    "%s%d_i2h_weight" % (j, i), (ng * nh, ni),
                    i2h_weight_initializer)
                self._register_param(
                    "%s%d_h2h_weight" % (j, i), (ng * nh, nh),
                    h2h_weight_initializer)
                self._register_param(
                    "%s%d_i2h_bias" % (j, i), (ng * nh,),
                    i2h_bias_initializer)
                self._register_param(
                    "%s%d_h2h_bias" % (j, i), (ng * nh,),
                    h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        self._reg_params[name] = p
        setattr(self, name, p)

    def __repr__(self):
        s = "{name}({mapping}, {layout}"
        if self._num_layers != 1:
            s += ", num_layers={num_layers}"
        if self._dropout != 0:
            s += ", dropout={dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "%s -> %s" % (shape[1] if shape[1] else None,
                                shape[0] // self._gates)
        return s.format(name=type(self).__name__, mapping=mapping,
                        num_layers=self._num_layers, layout=self._layout,
                        dropout=self._dropout)

    def _layer_infer_shape(self, x_shape, *rest):
        ni = int(x_shape[2]) if len(x_shape) == 3 else int(x_shape[-1])
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, "%s%d_i2h_weight" % (j, i)) \
                    ._finish_deferred_init((ng * nh, ni))
                getattr(self, "%s%d_h2h_weight" % (j, i)) \
                    ._finish_deferred_init((ng * nh, nh))
                getattr(self, "%s%d_i2h_bias" % (j, i)) \
                    ._finish_deferred_init((ng * nh,))
                getattr(self, "%s%d_h2h_bias" % (j, i)) \
                    ._finish_deferred_init((ng * nh,))
            ni = nh * self._dir

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        if func is None:
            func = _ndarray.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **info))
        return states

    def _unfuse(self):
        """An unfused SequentialRNNCell with the same structure and
        parameters."""
        get_cell = {
            "rnn_relu": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="relu", **kw),
            "rnn_tanh": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="tanh", **kw),
            "lstm": lambda **kw: rnn_cell.LSTMCell(self._hidden_size, **kw),
            "gru": lambda **kw: rnn_cell.GRUCell(self._hidden_size, **kw),
        }[self._mode]
        stack = rnn_cell.SequentialRNNCell(prefix=self.prefix,
                                           params=self.params)
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                kwargs = {"input_size": ni}
                if self._dir == 2:
                    stack.add(rnn_cell.BidirectionalCell(
                        get_cell(prefix="l%d_" % i, **kwargs),
                        get_cell(prefix="r%d_" % i, **kwargs)))
                else:
                    stack.add(get_cell(prefix="l%d_" % i, **kwargs))
                if self._dropout > 0 and i != self._num_layers - 1:
                    stack.add(rnn_cell.DropoutCell(self._dropout))
                ni = self._hidden_size * self._dir
        return stack

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        skip_states = states is None
        if skip_states:
            if F is _ndarray or isinstance(inputs, _ndarray.NDArray):
                states = self.begin_state(
                    inputs.shape[1], ctx=getattr(inputs, "context", None))
            elif isinstance(inputs, torch.Tensor):
                states = self.begin_state(
                    inputs.shape[1], func=lambda shape, **kw: torch.zeros(
                        shape, dtype=inputs.dtype, device=inputs.device))
            else:
                # symbolic: zeros whose batch dim follows the input
                states = [F._rnn_begin_state(
                    inputs, state_shape=info["shape"], batch_axis=1)
                    for info in self.state_info(0)]
        if isinstance(states, _StateTypes):
            states = [states]
        # the fused op's order (ops/nn.py _rnn_param_order)
        flat = [params[n].reshape((-1,))
                for n in _rnn_param_names(self._num_layers, self._dir == 2)]
        packed = F.concat(*flat, dim=0)
        rnn_args = list(states)
        outputs = F.RNN(inputs, packed, *rnn_args,
                        state_size=self._hidden_size,
                        num_layers=self._num_layers, mode=self._mode,
                        bidirectional=self._dir == 2, p=self._dropout,
                        state_outputs=True)
        if self._mode == "lstm":
            outputs, states = outputs[0], [outputs[1], outputs[2]]
        else:
            outputs, states = outputs[0], [outputs[1]]
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, states


_StateTypes = (_ndarray.NDArray, torch.Tensor)


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (relu or tanh)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
