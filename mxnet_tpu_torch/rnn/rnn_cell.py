"""Symbolic RNN cells (``mx.rnn``; counterpart of
``mxnet_tpu/rnn/rnn_cell.py``).

``RNNParams``, ``BaseRNNCell`` with ``unroll``, ``RNNCell``,
``LSTMCell`` (its h2h bias initialized by ``LSTMBias``), ``GRUCell``,
``FusedRNNCell`` over the fused ``RNN`` op (its packed vector carries a
``FusedRNN`` initializer; ``unpack_weights``/``pack_weights`` split it
into the per-gate names and back; ``unfuse`` gives the unfused stack,
which the JAX package's cell lacks), ``SequentialRNNCell``,
``BidirectionalCell`` and ``DropoutCell``. They build Symbols with the
JAX package's node and variable names; a bound Symbol runs through the
executor, op by op. ``unroll`` with ``begin_state=None`` derives zero
states from the input (``_rnn_begin_state``), so no state variables
need binding.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import symbol as _sym
from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell"]


def _host(v):
    """An NDArray, tensor or array as a numpy array."""
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return _np.asarray(v)


def _like(ref, a):
    """numpy ``a`` as the kind of value ``ref`` is, on its device."""
    from ..ndarray import ndarray as _nd
    if isinstance(ref, _nd.NDArray):
        return _nd.array(a, ctx=ref.context)
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(_np.ascontiguousarray(a)).to(ref.device)
    return a


class RNNParams:
    """Container for cell parameter symbols, shared by name."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = _sym.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract cell: ``cell(inputs, states) -> (output, states)`` over
    symbols, plus ``unroll``."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def _gate_names(self):
        return ()

    def __call__(self, inputs, states):
        raise NotImplementedError

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def begin_state(self, func=None, **kwargs):
        """Initial state symbols. Default: named Variables, which
        simple_bind allocates zero-filled (the zero initial state); pass
        their shapes at bind time for inference. ``unroll`` with
        ``begin_state=None`` derives zero states from the input symbol
        instead, so no extra bind arguments are needed."""
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if func is None:
                state = _sym.Variable(
                    "%sbegin_state_%d" % (self._prefix, self._init_counter),
                    **kwargs)
            else:
                state = func(
                    name="%sbegin_state_%d" % (self._prefix,
                                               self._init_counter),
                    **{**info, **kwargs})
            states.append(state)
        return states

    def _zero_state_from(self, ref, batch_axis=0):
        """Zero states shaped off a reference symbol's batch dim — shape
        inference flows forward, unlike free begin-state Variables."""
        return [_sym._rnn_begin_state(ref, state_shape=info["shape"],
                                      batch_axis=batch_axis)
                for info in self.state_info]

    def unpack_weights(self, args):
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    @staticmethod
    def _default_inputs(length, input_prefix):
        """Per-step named placeholders for ``unroll(inputs=None)`` — the one
        place the naming contract lives."""
        return [_sym.Variable("%st%d_data" % (input_prefix, i))
                for i in range(length)]

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Unroll for `length` steps."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = self._default_inputs(length, input_prefix)
        elif not isinstance(inputs, (list, tuple)):
            inputs = list(_sym.SliceChannel(inputs, num_outputs=length,
                                            axis=axis, squeeze_axis=1))
        if begin_state is None:
            begin_state = self._zero_state_from(inputs[0])
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(inputs[i], states)
            outputs.append(out)
        if merge_outputs:
            outputs = [_sym.expand_dims(o, axis=axis) for o in outputs]
            outputs = _sym.Concat(*outputs, dim=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = _sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                  num_hidden=self._num_hidden,
                                  name="%si2h" % name)
        h2h = _sym.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                                  num_hidden=self._num_hidden,
                                  name="%sh2h" % name)
        output = _sym.Activation(i2h + h2h, act_type=self._activation,
                                 name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (gate order i, f, c, o)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        from ..initializer import LSTMBias
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        # the forget gate starts open
        self._hB = self.params.get("h2h_bias",
                                   init=LSTMBias(forget_bias=forget_bias))
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = _sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                  num_hidden=self._num_hidden * 4,
                                  name="%si2h" % name)
        h2h = _sym.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                                  num_hidden=self._num_hidden * 4,
                                  name="%sh2h" % name)
        gates = i2h + h2h
        sliced = list(_sym.SliceChannel(gates, num_outputs=4, axis=1,
                                        name="%sslice" % name))
        in_gate = _sym.Activation(sliced[0], act_type="sigmoid")
        forget_gate = _sym.Activation(sliced[1], act_type="sigmoid")
        in_transform = _sym.Activation(sliced[2], act_type="tanh")
        out_gate = _sym.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * _sym.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (gate order r, z, n)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev = states[0]
        i2h = _sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                  num_hidden=self._num_hidden * 3,
                                  name="%si2h" % name)
        h2h = _sym.FullyConnected(prev, weight=self._hW, bias=self._hB,
                                  num_hidden=self._num_hidden * 3,
                                  name="%sh2h" % name)
        i2h_r, i2h_z, i2h_n = list(_sym.SliceChannel(
            i2h, num_outputs=3, axis=1, name="%si2h_slice" % name))
        h2h_r, h2h_z, h2h_n = list(_sym.SliceChannel(
            h2h, num_outputs=3, axis=1, name="%sh2h_slice" % name))
        reset = _sym.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = _sym.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = _sym.Activation(i2h_n + reset * h2h_n, act_type="tanh")
        next_h = (1.0 - update) * next_h_tmp + update * prev
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN over the RNN operator; its parameters live
    in one packed vector."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 prefix=None, params=None, forget_bias=1.0):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        # the packed vector carries a FusedRNN initializer attr, so that
        # Module.init_params with any global initializer unpacks it,
        # initializes each gate's piece and packs it again
        from .. import initializer as _init
        self._param = self.params.get(
            "parameters",
            init=_init.FusedRNN(None, num_hidden, num_layers, mode,
                                bidirectional, forget_bias))

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _directions(self):
        return ["l", "r"] if self._bidirectional else ["l"]

    def _slice_weights(self, flat, num_input, lh):
        """name -> (offset, shape) map over the packed vector, derived by
        walking ops/nn.py ``_rnn_param_shapes`` — the SAME layout the RNN
        operator unpacks at execution time, so the naming layer can never
        desync from the compute layer. Each gate-stacked block is split
        into per-gate names (``{prefix}{dir}{layer}_i2h{gate}_weight``
        and so on)."""
        from ..ops.nn import _rnn_param_order, _rnn_param_shapes
        gate_names = self._gate_names
        dirs = self._directions
        shapes = _rnn_param_shapes(self._mode, num_input, lh,
                                   self._num_layers, self._bidirectional)
        order = _rnn_param_order(self._num_layers, self._bidirectional)
        group = {"wx": ("i2h", "weight"), "wh": ("h2h", "weight"),
                 "bx": ("i2h", "bias"), "bh": ("h2h", "bias")}
        spans = {}
        p = 0
        for (kind, layer, d), (_, shape) in zip(order, shapes):
            grp, suffix = group[kind]
            gshape = (lh,) if suffix == "bias" else (lh, shape[-1])
            per = 1
            for s in gshape:
                per *= s
            for gate in gate_names:
                name = "%s%s%d_%s%s_%s" % (self._prefix, dirs[d], layer,
                                           grp, gate, suffix)
                spans[name] = (p, gshape)
                p += per
        if p != flat.size:
            raise MXNetError("Invalid parameters size for FusedRNNCell: "
                             "%d != %d" % (flat.size, p))
        return spans

    def unpack_weights(self, args):
        """Split the packed vector into named per-gate i2h/h2h weights
        and biases, each of the packed value's kind (NDArray, tensor or
        numpy array) and device."""
        args = dict(args)
        arr = args.pop(self._param.name)
        flat = _host(arr).reshape(-1)
        b = len(self._directions)
        m = len(self._gate_names)
        h = self._num_hidden
        num_input = flat.size // b // h // m \
            - (self._num_layers - 1) * (h + b * h + 2) - h - 2
        for name, (p, shape) in self._slice_weights(flat, num_input,
                                                    h).items():
            n = int(_np.prod(shape))
            args[name] = _like(arr, flat[p:p + n].reshape(shape))
        return args

    def pack_weights(self, args):
        """Inverse of :meth:`unpack_weights`."""
        args = dict(args)
        c0 = "%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])
        w0 = args[c0]
        num_input = w0.shape[1]
        b = len(self._directions)
        m = len(self._gate_names)
        h = self._num_hidden
        total = (num_input + h + 2) * h * m * b \
            + (self._num_layers - 1) * m * h * (h + b * h + 2) * b
        flat = _np.zeros((total,), dtype=_host(w0).dtype)
        for name, (p, shape) in self._slice_weights(flat, num_input,
                                                    h).items():
            n = int(_np.prod(shape))
            flat[p:p + n] = _host(args.pop(name)).reshape(-1)
        args[self._param.name] = _like(w0, flat)
        return args

    @property
    def state_info(self):
        b = self._num_layers * (2 if self._bidirectional else 1)
        info = [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append({"shape": (b, 0, self._num_hidden),
                         "__layout__": "LNC"})
        return info

    def unfuse(self):
        """The same network as a SequentialRNNCell of unfused cells
        (``{prefix}l{i}_`` and, bidirectional, ``{prefix}r{i}_``), with a
        DropoutCell between layers. Their stacked gate weights are the
        concatenation, in gate order, of :meth:`unpack_weights`'s
        per-gate pieces."""
        make = {"rnn_relu": lambda p: RNNCell(self._num_hidden, "relu",
                                              prefix=p),
                "rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh",
                                              prefix=p),
                "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p,
                                           forget_bias=self._forget_bias),
                "gru": lambda p: GRUCell(self._num_hidden, prefix=p)}[
                    self._mode]
        stack = SequentialRNNCell()
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make("%sl%d_" % (self._prefix, i)),
                    make("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(make("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, i)))
        return stack

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = self._default_inputs(length, input_prefix)
        if isinstance(inputs, (list, tuple)):
            inputs = _sym.Concat(*[_sym.expand_dims(i, axis=0)
                                   for i in inputs], dim=0)  # (T, N, C)
        else:
            if layout == "NTC":
                inputs = _sym.transpose(inputs, axes=(1, 0, 2))
        if begin_state is None:
            begin_state = self._zero_state_from(inputs, batch_axis=1)
        states = list(begin_state)
        state = states[0]
        state_cell = states[1] if self._mode == "lstm" else None
        args = [inputs, self._param, state]
        if state_cell is not None:
            args.append(state_cell)
        outs = _sym.RNN(*args, state_size=self._num_hidden,
                        num_layers=self._num_layers, mode=self._mode,
                        bidirectional=self._bidirectional, p=self._dropout,
                        state_outputs=self._get_next_state,
                        name="%srnn" % self._prefix)
        if self._get_next_state:
            outs = list(outs)
            output, states = outs[0], outs[1:]
        else:
            output, states = outs, []
        if layout == "NTC":
            output = _sym.transpose(output, axes=(1, 0, 2))
        if merge_outputs is False:
            output = list(_sym.SliceChannel(output, num_outputs=length,
                                            axis=axis, squeeze_axis=1))
        return output, states


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in sequence. ``unroll`` steps the whole
    stack once a time step (the JAX package's graph); a stack holding a
    BidirectionalCell, which cannot step, unrolls cell after cell."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return sum((c.state_info for c in self._cells), [])

    def begin_state(self, **kwargs):
        return sum((c.begin_state(**kwargs) for c in self._cells), [])

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            out, st = cell(inputs, states[p:p + n])
            inputs = out
            next_states.extend(st)
            p += n
        return inputs, next_states

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        if not any(isinstance(c, BidirectionalCell) for c in self._cells):
            return super().unroll(length, inputs, begin_state, input_prefix,
                                  layout, merge_outputs)
        self.reset()
        if begin_state is None:
            begin_state = [None] * len(self._cells)
        else:
            split, p = [], 0
            for c in self._cells:
                n = len(c.state_info)
                split.append(begin_state[p:p + n])
                p += n
            begin_state = split
        states = []
        for i, (cell, st) in enumerate(zip(self._cells, begin_state)):
            last = i == len(self._cells) - 1
            inputs, st = cell.unroll(length, inputs=inputs, begin_state=st,
                                     input_prefix=input_prefix,
                                     layout=layout,
                                     merge_outputs=merge_outputs if last
                                     else None)
            states.extend(st)
        return inputs, states

    def reset(self):
        super().reset()
        for c in self._cells:
            c.reset()


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cells over the sequence."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._l_cell = l_cell
        self._r_cell = r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l_cell.state_info + self._r_cell.state_info

    def begin_state(self, **kwargs):
        return (self._l_cell.begin_state(**kwargs)
                + self._r_cell.begin_state(**kwargs))

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = self._default_inputs(length, input_prefix)
        elif not isinstance(inputs, (list, tuple)):
            inputs = list(_sym.SliceChannel(inputs, num_outputs=length,
                                            axis=axis, squeeze_axis=1))
        if begin_state is None:
            begin_state = (self._l_cell._zero_state_from(inputs[0])
                           + self._r_cell._zero_state_from(inputs[0]))
        nl = len(self._l_cell.state_info)
        l_out, l_states = self._l_cell.unroll(
            length, inputs=list(inputs), begin_state=begin_state[:nl],
            layout=layout, merge_outputs=False)
        r_out, r_states = self._r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[nl:], layout=layout,
            merge_outputs=False)
        outputs = [
            _sym.Concat(l, r, dim=1,
                        name="%st%d" % (self._output_prefix, i))
            for i, (l, r) in enumerate(zip(l_out, reversed(r_out)))]
        if merge_outputs:
            outputs = [_sym.expand_dims(o, axis=axis) for o in outputs]
            outputs = _sym.Concat(*outputs, dim=axis)
        return outputs, l_states + r_states

    def reset(self):
        super().reset()
        self._l_cell.reset()
        self._r_cell.reset()


class DropoutCell(BaseRNNCell):
    """Applies dropout to inputs."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = _sym.Dropout(inputs, p=self._dropout)
        return inputs, states
