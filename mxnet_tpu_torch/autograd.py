"""Autograd over eager NDArray ops (counterpart of ``mxnet_tpu/autograd.py``).

``record``, ``pause``, ``train_mode``, ``predict_mode``, ``is_recording``,
``is_training``, ``mark_variables``, ``backward``, ``grad`` and
``Function``, built on ``torch.autograd`` with the JAX package's
semantics where they differ from torch's defaults:

* Only ops run inside ``record()`` are differentiable: the eager invoke
  path and the hybridized call run under ``torch.no_grad()`` outside it.
* ``is_training`` is a flag of its own, independent of recording
  (``record(train_mode=False)``, ``train_mode()``).
* A marked variable (``attach_grad``, ``mark_variables``, a Parameter)
  owns a gradient NDArray of its own; torch's ``.grad`` is not used.
  :func:`backward` takes ``torch.autograd.grad`` of the heads with
  respect to every live marked variable (``allow_unused``) and writes
  each result by its ``grad_req``: 'write' replaces the buffer, 'add'
  adds to it, 'null' does nothing. A variable the heads do not reach
  keeps its old gradient. A written variable is marked ``fresh``; the
  Gluon Trainer reads that mark.
* :func:`grad` returns new gradient NDArrays and, as the JAX package's
  (which runs ``backward`` into temporary sinks), writes the buffer of
  every other marked variable its backward reaches.
* ``grad(create_graph=True)`` raises NotImplementedError, as in the JAX
  package.

One difference stays, by choice: torch frees a graph's saved tensors
when a backward without ``retain_graph=True`` ends, so a second
backward (or ``grad``) through the same graph needs ``retain_graph=True``
on the first and raises MXNetError otherwise. The JAX package's tape
frees nothing: there a second backward through the same graph runs and
writes the gradients again. Keeping every graph alive would keep a
training step's activations alive into the next step's forward, which
the port's Gluon training does not pay for.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables", "backward", "grad", "Function"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    """Set the recording flag -> the previous one."""
    prev = _st().recording
    _state.recording = bool(is_record)
    return prev


def set_training(train_mode):
    """Set the training flag -> the previous one."""
    prev = _st().training
    _state.training = bool(train_mode)
    return prev


def grad_mode():
    """torch's grad mode for the ops run now: enabled while recording."""
    return torch.enable_grad() if _st().recording else torch.no_grad()


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode

    def __enter__(self):
        s = _st()
        self._prev_record = s.recording
        self._prev_train = s.training
        if self._enter_is_record is not None:
            s.recording = self._enter_is_record
        if self._enter_train_mode is not None:
            s.training = self._enter_train_mode
        return self

    def __exit__(self, *a):
        s = _st()
        s.recording = self._prev_record
        s.training = self._prev_train


def record(train_mode=True):
    """Scope in which eager ops are recorded for :func:`backward`."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


# ---------------------------------------------------------------------------
# marked variables
# ---------------------------------------------------------------------------

class AGInfo:
    """A marked variable's gradient sink."""

    __slots__ = ("grad", "grad_req", "fresh")

    def __init__(self, grad=None, grad_req="write"):
        self.grad = grad              # NDArray sink
        self.grad_req = grad_req
        self.fresh = False            # written since the last optimizer step


_marked = {}                          # id(NDArray) -> weakref
_marked_lock = threading.Lock()
# keys of marked variables that died: a weakref callback may run inside
# any allocation, the garbage collector's included, so also on a thread
# that holds ``_marked_lock``; it only appends (atomic), and the lock's
# holders purge the dead entries
_dead = []


def _forget(key):
    _dead.append(key)


def _purge():
    """Drop the entries of dead variables; the caller holds the lock. A
    key may have been reused by a live variable since: its entry stays."""
    while _dead:
        key = _dead.pop()
        ref = _marked.get(key)
        if ref is not None and ref() is None:
            del _marked[key]


def _as_leaf(t):
    """``t`` as a leaf that torch differentiates (floating dtypes)."""
    t = t.detach()
    if t.is_floating_point():
        t.requires_grad_(True)
    return t


def mark_variables(variables, gradients, grad_reqs="write"):
    """Give each NDArray the gradient NDArray it writes into."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if not v._data.is_leaf or not v._data.requires_grad:
            v._data = _as_leaf(v._data)
        v._ag = AGInfo(grad=g, grad_req=req)
        key = id(v)
        ref = weakref.ref(v, lambda _r, key=key: _forget(key))
        with _marked_lock:
            _purge()
            _marked[key] = ref


def _live_variables():
    with _marked_lock:
        _purge()
        refs = list(_marked.values())
    out = []
    for r in refs:
        v = r()
        if v is None or v._ag is None or v._ag.grad is None \
                or v._ag.grad_req == "null" or not v._data.requires_grad:
            continue
        out.append(v)
    return out


def _heads(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    outs, gouts = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue
        outs.append(t)
        gouts.append(torch.ones_like(t) if hg is None
                     else hg._data.to(t.device, t.dtype))
    return outs, gouts


def _grads(outs, inputs, gouts, retain_graph):
    try:
        return torch.autograd.grad(outs, inputs, gouts,
                                   retain_graph=retain_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        if "second time" in str(e):
            raise MXNetError(
                "backward through a graph whose buffers were freed: pass "
                "retain_graph=True to the first backward") from e
        raise


def _accumulate(info, g):
    gr = info.grad
    g = g.detach().to(gr._data.dtype).reshape(gr._data.shape)
    if info.grad_req == "add":
        gr._data = gr._data + g
    else:
        gr._data = g
    gr._version += 1
    info.fresh = True


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into every marked variable they reach."""
    outs, gouts = _heads(heads, head_grads)
    if not outs:
        return
    variables = _live_variables()
    if not variables:
        return
    grads = _grads(outs, [v._data for v in variables], gouts,
                   bool(retain_graph))
    for v, g in zip(variables, grads):
        if g is not None:
            _accumulate(v._ag, g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    new NDArrays (zeros where a variable is not reached). As in the JAX
    package, whose ``grad`` runs ``backward`` into temporary sinks, the
    backward also writes the buffer of every other marked variable it
    reaches, by that variable's ``grad_req``; the buffers of
    ``variables`` themselves are left alone."""
    from .ndarray import ndarray as _nd
    if create_graph:
        raise NotImplementedError("create_graph=True (higher-order eager "
                                  "grad): use the symbolic executor")
    single = not isinstance(variables, (list, tuple))
    if single:
        variables = [variables]
    outs, gouts = _heads(heads, head_grads)
    asked = {id(v) for v in variables}
    live = [v for v in variables if v._data.requires_grad]
    others = [v for v in _live_variables() if id(v) not in asked]
    got = {}
    if outs and (live or others):
        res = _grads(outs, [v._data for v in live + others], gouts,
                     bool(retain_graph))
        got = {id(v): g for v, g in zip(live, res)}
        for v, g in zip(others, res[len(live):]):
            if g is not None:
                _accumulate(v._ag, g)
    sinks = []
    for v in variables:
        g = got.get(id(v))
        t = torch.zeros_like(v._data).detach() if g is None else g.detach()
        sinks.append(_nd.NDArray(t, ctx=v.context))
    return sinks[0] if single else sinks


# ---------------------------------------------------------------------------
# custom differentiable Function
# ---------------------------------------------------------------------------

class _Bridge(torch.autograd.Function):
    """Carries a :class:`Function`'s outputs into torch's graph; its
    backward calls the Function's own ``backward``."""

    @staticmethod
    def forward(ctx, fn, outs, *inputs):
        ctx.fn = fn
        ctx.n_in = len(inputs)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *gouts):
        from .ndarray import ndarray as _nd
        with pause():
            igrads = ctx.fn.backward(*[_nd.NDArray(g) for g in gouts])
        if not isinstance(igrads, (list, tuple)):
            igrads = [igrads]
        return (None, None) + tuple(
            None if g is None else g._data for g in igrads[:ctx.n_in])


class Function:
    """User-defined differentiable op: subclass and implement
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` on
    NDArrays. Both run outside recording."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *arrays):
        self._saved = arrays

    def __call__(self, *inputs):
        from .ndarray import ndarray as _nd
        with pause():
            outputs = self.forward(*inputs)
        single = not isinstance(outputs, (list, tuple))
        outs = [outputs] if single else list(outputs)
        if is_recording() and any(x._data.requires_grad for x in inputs):
            with torch.enable_grad():
                ts = _Bridge.apply(self, [o._data for o in outs],
                                   *[x._data for x in inputs])
            outs = [_nd.NDArray(t, ctx=o.context) for t, o in zip(ts, outs)]
        return outs[0] if single else outs

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
