"""Recurrent cells (counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``):
the ``RecurrentCell`` base with ``begin_state`` and ``unroll`` (merged
or per-step outputs, ``valid_length``), ``RNNCell``, ``LSTMCell``,
``GRUCell``, ``SequentialRNNCell``, ``DropoutCell``, the modifier cells
(``ZoneoutCell``, ``ResidualCell``) and ``BidirectionalCell``.

Gate orders match the fused RNN op (``ops/nn.py``): LSTM (i, f, g, o),
GRU (r, z, n), so an unrolled cell and the fused layer agree on the same
parameters. A cell steps eagerly (``F`` the ndarray module), or, inside
a hybridized call, on raw tensors; ``unroll`` is a Python loop either
way.
"""
from __future__ import annotations

import torch

from ... import ndarray as _ndarray
from ..block import Block, HybridBlock
from ..parameter import DeferredInitializationError

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, batch_size=0, **kwargs):
    return sum([c.begin_state(batch_size=batch_size, **kwargs)
                for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is None:
        ctx = inputs.context if hasattr(inputs, "context") else None
        with _no_autograd():
            begin_state = cell.begin_state(batch_size=batch_size,
                                           func=_zeros_fn(F, inputs),
                                           ctx=ctx)
    return begin_state


def _zeros_fn(F, like=None):
    def fn(shape, ctx=None, **kw):
        if F is _ndarray:
            return _ndarray.zeros(shape, ctx=ctx)
        # a hybridized call: a tensor on the input's device
        return torch.zeros(shape, dtype=getattr(like, "dtype", None),
                           device=getattr(like, "device", None))
    return fn


class _no_autograd:
    def __enter__(self):
        from ... import autograd
        self._scope = autograd.pause()
        return self._scope.__enter__()

    def __exit__(self, *a):
        return self._scope.__exit__(*a)


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Normalize inputs to a list of (N, C) steps or a merged tensor."""
    if inputs is None:
        raise ValueError("unroll needs inputs")
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        # list elements are per-step (batch, C) tensors: batch is axis 0
        batch_size = _shape_of(inputs[0])[0]
        if merge is True:
            F = _F_of(inputs[0])
            inputs = F.stack(*inputs, axis=axis)
        return inputs, axis, batch_size
    batch_size = _shape_of(inputs)[batch_axis]
    if merge is False:
        F = _F_of(inputs)
        seq = F.split(inputs, num_outputs=length, axis=axis,
                      squeeze_axis=True)
        if not isinstance(seq, (list, tuple)):
            seq = [seq]
        return list(seq), axis, batch_size
    return inputs, axis, batch_size


def _mask_sequence_variable_length(F, data, length, valid_length, time_axis,
                                   merge):
    if not isinstance(data, (list, tuple)):
        return F.SequenceMask(data, valid_length, use_sequence_length=True,
                              axis=time_axis)
    outputs = [F.where(F.broadcast_lesser_equal(
        _F_of(x).ones_like(x) * (i + 1),
        valid_length.reshape((-1, 1))), x, _F_of(x).zeros_like(x))
        for i, x in enumerate(data)]
    if merge:
        outputs = F.stack(*outputs, axis=time_axis)
    return outputs


def _F_of(x):
    if isinstance(x, _ndarray.NDArray):
        from ... import ndarray as F
        return F
    from ..block import _F_TORCH
    return _F_TORCH


def _check_unmodified(cell):
    if cell._modified:
        raise ValueError("After applying modifier cells the base cell cannot "
                         "be called directly. Call the modifier cell "
                         "instead.")


class RecurrentCell(Block):
    """Abstract recurrent step cell."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        _check_unmodified(self)
        if func is None:
            func = _ndarray.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell for `length` steps (a Python loop, eager or
        inside a hybridized call)."""
        self.reset()
        F = _F_of(inputs if not isinstance(inputs, (list, tuple))
                  else inputs[0])
        inputs_list, axis, batch_size = _format_sequence(
            length, inputs, layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs_list[0],
                                       batch_size)
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs_list[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [F.SequenceLast(F.stack(*ele_list, axis=0),
                                     valid_length,
                                     use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = _mask_sequence_variable_length(
                F, outputs, length, valid_length, axis, True)
            if merge_outputs is False:
                outputs = F.split(outputs, num_outputs=length, axis=axis,
                                  squeeze_axis=True)
        elif merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        raise NotImplementedError


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Recurrent cell implemented via hybrid_forward."""

    def __init__(self, prefix=None, params=None):
        RecurrentCell.__init__(self, prefix=prefix, params=params)

    def forward(self, inputs, states):
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _shape_of(x):
    return tuple(x.shape)


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell: h' = act(W_i x + b_i + W_h h + b_h)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def _layer_infer_shape(self, x_shape, *rest):
        self.i2h_weight._finish_deferred_init(
            (self._hidden_size, int(x_shape[-1])))
        self.h2h_weight._finish_deferred_init(
            (self._hidden_size, self._hidden_size))
        self.i2h_bias._finish_deferred_init((self._hidden_size,))
        self.h2h_bias._finish_deferred_init((self._hidden_size,))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell; gate order (i, f, g, o) matching the fused RNN op."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def _layer_infer_shape(self, x_shape, *rest):
        h = self._hidden_size
        self.i2h_weight._finish_deferred_init((4 * h, int(x_shape[-1])))
        self.h2h_weight._finish_deferred_init((4 * h, h))
        self.i2h_bias._finish_deferred_init((4 * h,))
        self.h2h_bias._finish_deferred_init((4 * h,))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h = self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=4 * h)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * h)
        gates = i2h + h2h
        parts = F.split(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(parts[0])
        forget_gate = F.sigmoid(parts[1])
        in_transform = F.tanh(parts[2])
        out_gate = F.sigmoid(parts[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell; gate order (r, z, n) matching the fused RNN op."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def _layer_infer_shape(self, x_shape, *rest):
        h = self._hidden_size
        self.i2h_weight._finish_deferred_init((3 * h, int(x_shape[-1])))
        self.h2h_weight._finish_deferred_init((3 * h, h))
        self.i2h_bias._finish_deferred_init((3 * h,))
        self.h2h_bias._finish_deferred_init((3 * h,))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h = self._hidden_size
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=3 * h)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias, num_hidden=3 * h)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h_n + reset_gate * h2h_n)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack multiple cells."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        _check_unmodified(self)
        return _cells_begin_state(self._children.values(), batch_size,
                                  **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            if isinstance(cell, BidirectionalCell):
                raise NotImplementedError(
                    "Bidirectional cannot be stepped. Please use unroll")
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        num_cells = len(self._children)
        F = _F_of(inputs if not isinstance(inputs, (list, tuple))
                  else inputs[0])
        inputs_list, axis, batch_size = _format_sequence(
            length, inputs, layout, None)
        begin_state = _get_begin_state(
            self, F, begin_state,
            inputs_list[0] if isinstance(inputs_list, list) else inputs_list,
            batch_size)
        p = 0
        next_states = []
        outputs = inputs
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            outputs, states = cell.unroll(
                length, outputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(states)
        return outputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout on cell outputs between steps."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if not isinstance(rate, (int, float)):
            raise TypeError("DropoutCell rate must be a number, got %r"
                            % (rate,))
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base for cells wrapping another cell."""

    def __init__(self, base_cell):
        if base_cell._modified:
            raise ValueError("Cell %s is already modified." % base_cell.name)
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        _check_unmodified(self)
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, BidirectionalCell):
            raise TypeError("ZoneoutCell cannot wrap a BidirectionalCell")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None
        self._prev_trace = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None
        self._prev_trace = None

    def hybrid_forward(self, F, inputs, states):
        from ..block import _current_trace
        cell = self.base_cell
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)
        # the remembered output is only valid within the same hybridized
        # call (or eagerly): a tensor of a finished call must not leak in
        tctx = _current_trace()
        prev_output = self._prev_output \
            if self._prev_trace is tctx else None
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0.0 else next_output)
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0.0 else next_states)
        self._prev_output = output
        self._prev_trace = tctx
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds residual connection: out = cell(x) + x."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def _alias(self):
        return "residual"

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        F = _F_of(outputs if not isinstance(outputs, (list, tuple))
                  else outputs[0])
        if isinstance(outputs, (list, tuple)):
            inputs_list, _, _ = _format_sequence(length, inputs, layout,
                                                 False)
            outputs = [o + i for o, i in zip(outputs, inputs_list)]
        else:
            merged_inputs, _, _ = _format_sequence(length, inputs, layout,
                                                   True)
            outputs = outputs + merged_inputs
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Runs l_cell forward and r_cell backward over the sequence."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        _check_unmodified(self)
        return _cells_begin_state(self._children.values(), batch_size,
                                  **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        F = _F_of(inputs if not isinstance(inputs, (list, tuple))
                  else inputs[0])
        inputs_list, axis, batch_size = _format_sequence(
            length, inputs, layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs_list[0],
                                       batch_size)
        states = begin_state
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs_list, begin_state=states[:n_l],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_inputs = list(reversed(inputs_list))
        else:
            # reverse each sample's valid prefix in place, so the backward
            # cell sees real data first (a plain reversal would feed it
            # the padding first)
            seq = F.stack(*inputs_list, axis=0)  # (T, N, C)
            rev = F.SequenceReverse(seq, valid_length,
                                    use_sequence_length=True, axis=0)
            r_inputs = list(F.split(rev, num_outputs=length, axis=0,
                                    squeeze_axis=True)) \
                if length > 1 else [F.Reshape(rev, shape=rev.shape[1:])]
        r_outputs, r_states = r_cell.unroll(
            length, inputs=r_inputs, begin_state=states[n_l:],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            reversed_r = list(reversed(r_outputs))
        else:
            rseq = F.stack(*r_outputs, axis=0)
            rrev = F.SequenceReverse(rseq, valid_length,
                                     use_sequence_length=True, axis=0)
            reversed_r = list(F.split(rrev, num_outputs=length, axis=0,
                                      squeeze_axis=True)) \
                if length > 1 else [F.Reshape(rrev, shape=rrev.shape[1:])]
        outputs = [F.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed_r)]
        if merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        states = l_states + r_states
        return outputs, states
