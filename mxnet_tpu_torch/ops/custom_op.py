"""The ``Custom`` operator: a user's Python ``mt.operator.CustomOp`` run
inside any execution mode (counterpart of
``mxnet_tpu/ops/custom_op.py``).

The JAX package escapes a compiled program to the host through
``jax.pure_callback``; the port walks its graphs eagerly, so the op is a
``torch.autograd.Function`` (:class:`_CustomFn`) whose forward and
backward run the user's ``forward`` and ``backward`` on the host. Shapes
and dtypes come from the Prop's ``infer_shape``/``infer_type`` (also on
``meta`` tensors, so shape inference passes through the op without
running it).

Where the data is. The user's operator sees NDArrays on the CPU: the
inputs (and in the backward the outputs and their cotangents) are copied
from wherever they lie to the host, the ``out_data``/``in_grad`` arrays
are host arrays of the declared shapes and dtypes, and whatever the
operator writes into them, from any device, is copied back to the inputs'
device. Every copy runs on the caller's current stream and is waited for
there, so the consumers on that stream need no event; the op therefore
syncs the card twice a training step, once in the forward and once in the
backward, and is marked ``host`` in the registry (a train step holding it
is never captured as a CUDA graph: ``module.fused``).

State. Each forward execution creates a fresh operator instance from
the Prop and keeps it in the autograd context for its own backward, so
interleaved forwards of one op never share state (the JAX package's
token table does the same). Auxiliary states raise, as in the JAX
package; integer inputs get no gradient.

``round_trips`` counts the host round trips (a forward or a backward
each), ``round_trip_us`` their host time from the stream's drain to the
results back on the device (copies and the user's Python), ``drain_us``
the time the host first waited for the stream's queued work.
"""
from __future__ import annotations

import time

import numpy as _np
import torch

from ..base import dtype_name
from .registry import register

__all__ = ["round_trips", "round_trip_us", "drain_us", "reset_counts"]

round_trips = 0
round_trip_us = 0.0
drain_us = 0.0


def reset_counts():
    global round_trips, round_trip_us, drain_us
    round_trips = 0
    round_trip_us = 0.0
    drain_us = 0.0


def _params(kwargs):
    return {k: v for k, v in kwargs.items() if k not in ("op_type",
                                                         "_training")}


def _custom_num_outputs(params):
    from .. import operator as _operator
    return len(_operator.make_prop(params["op_type"],
                                   _params(params)).list_outputs())


def _torch_dtype(t):
    return torch.from_numpy(_np.empty(0, _np.dtype(t))).dtype


class _Spec:
    """What one call of the op needs: its Prop's make, the signature and
    the declared outputs."""

    def __init__(self, op_type, kwargs, is_train, sig, out_spec):
        self.op_type, self.kwargs, self.is_train = op_type, kwargs, is_train
        self.sig = sig              # ((shape, numpy dtype), ...) inputs
        self.out_spec = out_spec    # ((shape, torch dtype), ...) outputs

    def new_operator(self):
        from .. import operator as _operator
        from ..context import cpu
        prop = _operator.make_prop(self.op_type, self.kwargs)
        return prop.create_operator(cpu(), [list(s) for s, _ in self.sig],
                                    [d for _, d in self.sig])


def _host(tensors):
    """Host NDArrays of ``tensors`` (copies where they lie elsewhere)."""
    from ..context import cpu
    from ..ndarray.ndarray import NDArray
    return [NDArray(t.detach().to("cpu", copy=True), ctx=cpu())
            for t in tensors]


def _zeros(spec):
    from ..context import cpu
    from ..ndarray.ndarray import NDArray
    return [NDArray(torch.zeros(s, dtype=d), ctx=cpu()) for s, d in spec]


class _RoundTrip:
    """Times one host round trip: the drain of the device's queue, then
    the copies and the user's Python."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.t1 = time.perf_counter()
        self.drain = self.t1 - t0
        return self

    def __exit__(self, *exc):
        global round_trips, round_trip_us, drain_us
        if exc[0] is None:
            round_trips += 1
            round_trip_us += (time.perf_counter() - self.t1) * 1e6
            drain_us += self.drain * 1e6
        return False


class _CustomFn(torch.autograd.Function):
    """The user's forward and backward on the host, between two copies."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        device = inputs[0].device if inputs else torch.device("cpu")
        with _RoundTrip(device):
            op = spec.new_operator()
            in_data = _host(inputs)
            out_data = _zeros(spec.out_spec)
            op.forward(is_train=spec.is_train,
                       req=["write"] * len(out_data), in_data=in_data,
                       out_data=out_data, aux=[])
            host_out = [o.data.detach().to("cpu", d)
                        for o, (_s, d) in zip(out_data, spec.out_spec)]
            outs = tuple(h.to(device) for h in host_out)
        ctx.op, ctx.spec, ctx.device = op, spec, device
        ctx.host_in, ctx.host_out = [a.data for a in in_data], host_out
        ctx.is_float = [x.is_floating_point() for x in inputs]
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *cots):
        from ..context import cpu
        from ..ndarray.ndarray import NDArray
        spec = ctx.spec
        with _RoundTrip(ctx.device):
            out_grad = _host([torch.zeros(s, dtype=d) if g is None else g
                              for g, (s, d) in zip(cots, spec.out_spec)])
            in_grad = _zeros([(s, _torch_dtype(d)) for s, d in spec.sig])
            ctx.op.backward(
                req=["write"] * len(in_grad), out_grad=out_grad,
                in_data=[NDArray(t, ctx=cpu()) for t in ctx.host_in],
                out_data=[NDArray(t, ctx=cpu()) for t in ctx.host_out],
                in_grad=in_grad, aux=[])
            grads = [g.data.detach().to(ctx.device, _torch_dtype(d))
                     if f else None
                     for g, (_s, d), f in zip(in_grad, spec.sig,
                                              ctx.is_float)]
        return (None,) + tuple(grads)


@register("Custom", num_outputs=_custom_num_outputs, host=True)
def custom(*inputs, op_type, _training=False, **kwargs):
    """Run the ``CustomOp`` registered as ``op_type`` (``mt.nd.Custom``,
    ``mt.sym.Custom``); its other keywords reach the Prop as strings."""
    from .. import operator as _operator
    prop = _operator.make_prop(op_type, kwargs)
    if prop.list_auxiliary_states():
        raise NotImplementedError(
            "custom ops with auxiliary states are not supported yet")
    in_types = [_np.dtype(dtype_name(x.dtype)) for x in inputs]
    _, out_shapes, _ = prop.infer_shape([list(x.shape) for x in inputs])
    _, out_types, _ = prop.infer_type(in_types)
    out_spec = tuple((tuple(int(d) for d in s), _torch_dtype(t))
                     for s, t in zip(out_shapes, out_types))
    if any(x.is_meta for x in inputs):
        outs = tuple(torch.empty(s, dtype=d, device="meta")
                     for s, d in out_spec)
    else:
        sig = tuple((tuple(x.shape), t) for x, t in zip(inputs, in_types))
        spec = _Spec(op_type, dict(kwargs), bool(_training), sig, out_spec)
        outs = _CustomFn.apply(spec, *inputs)
    return outs if len(outs) > 1 else outs[0]
