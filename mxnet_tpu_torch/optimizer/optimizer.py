"""Optimizers (counterpart of a subset of ``mxnet_tpu/optimizer/optimizer.py``).

``Optimizer`` keeps the JAX package's bookkeeping: per-parameter update
counts, the learning rate (or schedule) times ``lr_mult``, the weight
decay times ``wd_mult`` (0 for every parameter whose name ends neither
in ``_weight`` nor in ``_gamma``, so biases and betas do not decay;
``__lr_mult__``/``__wd_mult__`` symbol attributes override). ``SGD``
(with momentum) and ``Adam`` have two forms:

* the eager ``update(index, weight, grad, state)`` the ``Updater``
  applies per parameter (Adam's bias correction folded into ``lr_t`` in
  Python floats);
* ``fused_ops()`` -> ``(state_init, update)`` for the fused train step
  and the Gluon Trainer's fused pass, ``update(w, g, state, lr, wd,
  rescale) -> (w, state)`` with lr, wd and rescale as f32 values: Python
  floats, or 0-d f32 tensors on the weight's device, which a captured
  CUDA graph reads anew on every replay. ``lr`` is what
  ``fused_lr(lr, t)`` made of the schedule's rate at update count t on
  the host, in numpy f32 (Adam folds its bias correction in there).

Both update the weight and the state tensors in place (the counterpart
of the JAX package donating them to XLA) through the same functions,
whose gradient preparation keeps the order of
``mxnet_tpu/ops/optimizer_ops.py``: rescale, then clip, then ``+ wd*w``.

``multi_precision=True`` gives a float16 or bfloat16 weight an f32
master copy in its eager state (``create_state_multi_precision``): the
update runs on the master and the weight is its rounding
(``update_multi_precision``; SGD through ``mp_sgd_update_`` and
``mp_sgd_mom_update_``). The ``Updater`` goes through both. On f32
weights the flag changes nothing here; the fused train step reads it as
bf16 compute over the f32 weights (``module.Module``).

``AdaGrad`` and ``GroupAdaGrad`` (one accumulator per row, no weight
decay) come with the same two forms. A row-sparse gradient
(``ndarray.sparse.RowSparseNDArray``, what the Gluon Trainer passes for
a ``grad_stype="row_sparse"`` parameter) takes the lazy row update of
each optimizer (SGD and Adam unless ``lazy_update=False``; AdaGrad and
GroupAdaGrad always): only the rows the gradient holds are read,
updated and written back in place; the others get no weight decay and
no momentum tick.

``NAG``, ``AdaDelta``, ``RMSProp`` (plain and centered), ``Ftrl``,
``Signum`` and ``SignSGD`` (``Signum`` without momentum) run the update
ops of :mod:`ops.optimizer_ops` and copy the results into the weight and
the states, eagerly and in ``fused_ops``. ``FTML`` does so eagerly only
(its rule needs the update count inside the step, which the fused
update does not get). ``Nadam``, ``DCASGD`` and ``LBSGD`` (SGD scaled
by the ratio of the weight's norm to the gradient's, read back per
update) are eager only, as in the JAX package. A row-sparse gradient is
densified for them.
"""
from __future__ import annotations

import math
import pickle

import numpy as _np
import torch

from ..ops import optimizer_ops as _ops
from ..ops.optimizer_ops import (adagrad_update_, adam_update_,
                                 group_adagrad_update_, mp_sgd_mom_update_,
                                 mp_sgd_update_, sgd_mom_update_,
                                 sgd_update_)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "GroupAdaGrad",
           "AdaDelta", "RMSProp", "Ftrl", "Signum", "SignSGD", "FTML",
           "Nadam", "DCASGD", "LBSGD", "Test", "create", "register", "Updater",
           "get_updater"]

_OPT_REGISTRY = {}


def _is_lowp_float(dtype):
    """True for the low-precision float dtypes that take an f32 master
    copy under ``multi_precision``."""
    return dtype in (torch.float16, torch.bfloat16)


def _is_row_sparse(grad):
    from ..ndarray.sparse import RowSparseNDArray
    return isinstance(grad, RowSparseNDArray)


def _dense(grad):
    """A gradient as a dense tensor (a row-sparse one densified: the
    reference's storage fallback, where an update is not lazy)."""
    return grad._data if _is_row_sparse(grad) else grad


def _f32(grad):
    """A gradient in f32, a row-sparse one kept sparse (else the lazy
    update would densify into non-lazy semantics)."""
    if _is_row_sparse(grad):
        from ..ndarray.sparse import RowSparseNDArray
        return RowSparseNDArray(grad._values.float(), grad._indices,
                                grad.shape, ctx=grad.context)
    return grad.float()


def _sparse_grad_rows(opt, grad):
    """(rows, values) of a row-sparse gradient, rescaled and clipped
    (on the stored values only)."""
    g = grad._values * opt.rescale_grad
    if opt.clip_gradient is not None and opt.clip_gradient > 0:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    return grad._indices, g


def _gather_rows(weight, rows):
    """The weight's values at the gradient's rows; a row-sparse weight
    stays sparse (rows it lacks read as zero)."""
    if _is_row_sparse(weight):
        from ..ndarray.sparse import retain
        return retain(weight, rows)._values
    return weight[rows]


def _apply_rows(weight, rows, new_rows):
    """Write updated rows back: in place into a dense weight, inserted
    into a row-sparse one."""
    if _is_row_sparse(weight):
        from ..ndarray.sparse import write_rows
        write_rows(weight, rows, new_rows)
    else:
        weight.index_copy_(0, rows, new_rows)


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    try:
        return _OPT_REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise ValueError("Cannot find optimizer %s; candidates: %s"
                         % (name, sorted(_OPT_REGISTRY))) from None


class Optimizer:
    """Base optimizer: schedule, multipliers and update counts."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = ((sym.attr_dict(), sym.list_arguments())
                         if sym is not None else None)
        # the Gluon Trainer's {index: Parameter}: lr_mult and wd_mult are
        # read from the Parameter, live, in place of the name rules
        self.param_dict = param_dict or {}
        self.multi_precision = multi_precision
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """``(state, f32 master)`` for a low-precision weight under
        ``multi_precision``, else the plain state."""
        if self.multi_precision and _is_lowp_float(weight.dtype):
            w32 = weight.detach().float()
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler overwrites learning rate")
        self.lr = lr

    def _sym_mults(self, key):
        out = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and key in attr[name]:
                    out[name] = float(attr[name][key])
        return out

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Names not ending in ``_weight``/``_gamma`` get wd 0; symbol
        ``__wd_mult__`` attrs and ``args_wd_mult`` override."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight")
                                or n.endswith("_gamma"))}
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _name(self, index):
        return self.idx2name.get(index, index if isinstance(index, str)
                                 else None)

    def _get_lr(self, index, num_update=None):
        """lr for a param; ``num_update`` overrides the schedule position
        (the fused step peeks at the count before committing it)."""
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update if num_update is None
                                   else num_update)
        else:
            lr = self.lr
        if index in self.param_dict:
            return lr * getattr(self.param_dict[index], "lr_mult", 1.0)
        return lr * self.lr_mult.get(self._name(index), 1.0)

    def _get_wd(self, index):
        if index in self.param_dict:
            return self.wd * getattr(self.param_dict[index], "wd_mult", 1.0)
        return self.wd * self.wd_mult.get(self._name(index), 1.0)

    def _clip_const(self):
        return -1.0 if self.clip_gradient is None else self.clip_gradient

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """The update on the f32 master of a low-precision weight under
        ``multi_precision``, the weight then its rounding; else
        :meth:`update`."""
        if self.multi_precision and _is_lowp_float(weight.dtype):
            inner, w32 = state
            self.update(index, w32, _f32(grad), inner)
            with torch.no_grad():
                weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

    def fused_ops(self):
        """``(state_init, update)`` for the fused train step, or None.
        ``state_init(w)`` -> tuple of state tensors (the eager
        ``create_state`` result flattened: None -> (), x -> (x,));
        ``update(w, g, state, lr, wd, rescale)`` updates w and the state
        in place and returns ``(w, state)``; ``lr`` comes from
        :meth:`fused_lr`."""
        return None

    def fused_lr(self, lr, t):
        """The learning rates (an f32 array, one per parameter) the fused
        update applies at update count ``t``: ``lr`` itself here."""
        return _np.asarray(lr, _np.float32)


@register
class SGD(Optimizer):
    """SGD with optional momentum."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if _is_row_sparse(grad) and self.lazy_update:
            with torch.no_grad():
                rows, g = _sparse_grad_rows(self, grad)
                wr = _gather_rows(weight, rows)
                g = g + wd * wr
                if state is None:
                    _apply_rows(weight, rows, wr - lr * g)
                else:
                    mr = self.momentum * state[rows] - lr * g
                    state.index_copy_(0, rows, mr)
                    _apply_rows(weight, rows, wr + mr)
            return
        grad = _dense(grad)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip_const())
        if state is None:
            sgd_update_(weight, grad, **kw)
        else:
            sgd_mom_update_(weight, grad, state, momentum=self.momentum,
                            **kw)

    def update_multi_precision(self, index, weight, grad, state):
        if _is_row_sparse(grad) or not (self.multi_precision
                                        and _is_lowp_float(weight.dtype)):
            super().update_multi_precision(index, weight, grad, state)
            return
        self._update_count(index)
        inner, w32 = state
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip_const())
        if inner is None:
            mp_sgd_update_(weight, grad, w32, **kw)
        else:
            mp_sgd_mom_update_(weight, grad, inner, w32,
                               momentum=self.momentum, **kw)

    def fused_ops(self):
        mom, clip = self.momentum, self._clip_const()
        if mom == 0.0:
            def upd0(w, g, s, lr, wd, rescale):
                sgd_update_(w, g, lr=lr, wd=wd, rescale_grad=rescale,
                            clip_gradient=clip)
                return w, ()
            return (lambda w: ()), upd0

        def upd(w, g, s, lr, wd, rescale):
            sgd_mom_update_(w, g, s[0], lr=lr, momentum=mom, wd=wd,
                            rescale_grad=rescale, clip_gradient=clip)
            return w, s
        return (lambda w: (torch.zeros_like(w),)), upd


@register
class Adam(Optimizer):
    """Adam; the bias correction is folded into ``lr_t``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        if _is_row_sparse(grad) and self.lazy_update:
            mean, var = state
            with torch.no_grad():
                rows, g = _sparse_grad_rows(self, grad)
                wr = _gather_rows(weight, rows)
                g = g + wd * wr
                mr = self.beta1 * mean[rows] + (1 - self.beta1) * g
                vr = self.beta2 * var[rows] + (1 - self.beta2) * g.square()
                mean.index_copy_(0, rows, mr)
                var.index_copy_(0, rows, vr)
                _apply_rows(weight, rows,
                            wr - lr_t * mr / (vr.sqrt() + self.epsilon))
            return
        adam_update_(weight, _dense(grad), state[0], state[1], lr=lr_t,
                     beta1=self.beta1, beta2=self.beta2,
                     epsilon=self.epsilon, wd=wd,
                     rescale_grad=self.rescale_grad,
                     clip_gradient=self._clip_const())

    def fused_ops(self):
        b1, b2, eps, clip = self.beta1, self.beta2, self.epsilon, \
            self._clip_const()

        def upd(w, g, s, lr, wd, rescale):
            adam_update_(w, g, s[0], s[1], lr=lr, beta1=b1, beta2=b2,
                         epsilon=eps, wd=wd, rescale_grad=rescale,
                         clip_gradient=clip)
            return w, s
        return (lambda w: (torch.zeros_like(w), torch.zeros_like(w))), upd

    def fused_lr(self, lr, t):
        """``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` in f32."""
        one, tf = _np.float32(1.0), _np.float32(t)
        return _np.asarray(lr, _np.float32) \
            * _np.sqrt(one - _np.float32(self.beta2) ** tf) \
            / (one - _np.float32(self.beta1) ** tf)


@register
class AdaGrad(Optimizer):
    """AdaGrad; a row-sparse gradient always updates lazily."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if _is_row_sparse(grad):
            with torch.no_grad():
                rows, g = _sparse_grad_rows(self, grad)
                wr = _gather_rows(weight, rows)
                g = g + wd * wr
                hr = state[rows] + g.square()
                state.index_copy_(0, rows, hr)
                _apply_rows(weight, rows, wr - lr * g / (
                    hr + self.float_stable_eps).sqrt())
            return
        adagrad_update_(weight, grad, state, lr=lr, wd=wd,
                        epsilon=self.float_stable_eps,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self._clip_const())

    def fused_ops(self):
        eps, clip = self.float_stable_eps, self._clip_const()

        def upd(w, g, s, lr, wd, rescale):
            adagrad_update_(w, g, s[0], lr=lr, wd=wd, epsilon=eps,
                            rescale_grad=rescale, clip_gradient=clip)
            return w, s
        return (lambda w: (torch.zeros_like(w),)), upd


def _row_history(w):
    """GroupAdaGrad's accumulator: (N, 1) for a matrix, else (N,)."""
    shape = (w.shape[0], 1) if w.dim() == 2 else tuple(w.shape[:1])
    return torch.zeros(shape, dtype=w.dtype, device=w.device)


@register
class GroupAdaGrad(Optimizer):
    """Row-wise AdaGrad: one accumulator per row, no weight decay. A
    row-sparse gradient always updates lazily."""

    def __init__(self, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        assert weight.dim() == 2, \
            "GroupAdaGrad requires 2-d weights (rows x features)"
        return _row_history(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        assert wd == 0, "Weight decay is not supported for GroupAdaGrad"
        if _is_row_sparse(grad):
            with torch.no_grad():
                rows, g = _sparse_grad_rows(self, grad)
                wr = _gather_rows(weight, rows)
                hr = state[rows] + g.square().mean(dim=1, keepdim=True)
                state.index_copy_(0, rows, hr)
                _apply_rows(weight, rows, wr - lr * g / (
                    hr + self.float_stable_eps).sqrt())
            return
        group_adagrad_update_(weight, grad, state, lr=lr,
                              epsilon=self.float_stable_eps,
                              rescale_grad=self.rescale_grad,
                              clip_gradient=self._clip_const())

    def fused_ops(self):
        eps, clip = self.float_stable_eps, self._clip_const()

        def upd(w, g, s, lr, wd, rescale):
            group_adagrad_update_(w, g, s[0], lr=lr, epsilon=eps,
                                  rescale_grad=rescale, clip_gradient=clip)
            return w, s
        return (lambda w: (_row_history(w),)), upd


@torch.no_grad()
def _run(op, targets, *inputs, **params):
    """Update op ``op`` on ``targets`` (the weight, then the states it
    returns) and ``inputs``; its outputs copied into the targets."""
    outs = op(*targets[:1], *inputs, *targets[1:], **params)
    for t, o in zip(targets, outs if isinstance(outs, tuple) else (outs,)):
        t.copy_(o)


def _zeros(n):
    return lambda w: tuple(torch.zeros_like(w) for _ in range(n))


@register
class NAG(Optimizer):
    """Nesterov momentum (plain SGD without momentum)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else torch.zeros_like(weight)

    def _kw(self, lr, wd, rescale):
        return dict(lr=lr, wd=wd, rescale_grad=rescale,
                    clip_gradient=self._clip_const())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._kw(self._get_lr(index), self._get_wd(index),
                      self.rescale_grad)
        if state is None:
            _run(_ops.sgd_update, [weight], _dense(grad), **kw)
        else:
            _run(_ops.nag_mom_update, [weight, state], _dense(grad),
                 momentum=self.momentum, **kw)

    def fused_ops(self):
        n = 0 if self.momentum == 0.0 else 1

        def upd(w, g, s, lr, wd, rescale):
            if n:
                _run(_ops.nag_mom_update, [w, s[0]], g,
                     momentum=self.momentum, **self._kw(lr, wd, rescale))
            else:
                _run(_ops.sgd_update, [w], g, **self._kw(lr, wd, rescale))
            return w, s
        return _zeros(n), upd


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(2)(weight)

    def _step(self, w, g, s, wd, rescale):
        _run(_ops.adadelta_update, [w, *s], g, rho=self.rho,
             epsilon=self.epsilon, wd=wd, rescale_grad=rescale,
             clip_gradient=self._clip_const())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._step(weight, _dense(grad), state, self._get_wd(index),
                   self.rescale_grad)

    def fused_ops(self):
        def upd(w, g, s, lr, wd, rescale):
            self._step(w, g, s, wd, rescale)
            return w, s
        return _zeros(2), upd


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered`` keeps the gradient's running mean too
    (Graves' form, ``rmspropalex_update``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return _zeros(3)(weight)
        return torch.zeros_like(weight)

    def _step(self, w, g, s, lr, wd, rescale):
        kw = dict(lr=lr, wd=wd, gamma1=self.gamma1, epsilon=self.epsilon,
                  clip_weights=self.clip_weights or -1.0,
                  rescale_grad=rescale, clip_gradient=self._clip_const())
        if self.centered:
            _run(_ops.rmspropalex_update, [w, *s], g, gamma2=self.gamma2,
                 **kw)
        else:
            _run(_ops.rmsprop_update, [w, s], g, **kw)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._step(weight, _dense(grad), state, self._get_lr(index),
                   self._get_wd(index), self.rescale_grad)

    def fused_ops(self):
        def upd(w, g, s, lr, wd, rescale):
            self._step(w, g, s if self.centered else s[0], lr, wd, rescale)
            return w, s
        return _zeros(3 if self.centered else 1), upd


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(2)(weight)

    def _step(self, w, g, s, lr, wd, rescale):
        _run(_ops.ftrl_update, [w, *s], g, lr=lr, wd=wd,
             lamda1=self.lamda1, beta=self.beta, rescale_grad=rescale,
             clip_gradient=self._clip_const())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._step(weight, _dense(grad), state, self._get_lr(index),
                   self._get_wd(index), self.rescale_grad)

    def fused_ops(self):
        def upd(w, g, s, lr, wd, rescale):
            self._step(w, g, s, lr, wd, rescale)
            return w, s
        return _zeros(2), upd


@register
class Signum(Optimizer):
    """The sign of the momentum (of the gradient without momentum)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else torch.zeros_like(weight)

    def _step(self, w, g, s, lr, wd, rescale):
        kw = dict(lr=lr, wd=wd, rescale_grad=rescale,
                  clip_gradient=self._clip_const())
        if s is None:
            _run(_ops.signsgd_update, [w], g, **kw)
        else:
            _run(_ops.signum_update, [w, s], g, momentum=self.momentum,
                 wd_lh=self.wd_lh, **kw)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._step(weight, _dense(grad), state, self._get_lr(index),
                   self._get_wd(index), self.rescale_grad)

    def fused_ops(self):
        n = 0 if self.momentum == 0.0 else 1

        def upd(w, g, s, lr, wd, rescale):
            self._step(w, g, s[0] if n else None, lr, wd, rescale)
            return w, s
        return _zeros(n), upd


@register
class SignSGD(Signum):
    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class FTML(Optimizer):
    """Follow the moving leader (eager only: its rule reads the update
    count)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(3)(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _run(_ops.ftml_update, [weight, *state], _dense(grad),
             lr=self._get_lr(index), wd=self._get_wd(index),
             beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
             t=self._index_update_count[index],
             rescale_grad=self.rescale_grad,
             clip_grad=self._clip_const())


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum and the momentum schedule
    ``m_schedule`` (one product over every update of every
    parameter, as in the JAX package)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros(2)(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        grad = _dense(grad) * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        m_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        m_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1)
                                                  * self.schedule_decay))
        self.m_schedule = self.m_schedule * m_t
        m_schedule_next = self.m_schedule * m_t_1
        mean, var = state
        mean.mul_(self.beta1).add_((1.0 - self.beta1) * grad)
        var.mul_(self.beta2).add_((1.0 - self.beta2) * grad * grad)
        g_prime = grad / (1.0 - self.m_schedule)
        m_prime = mean / (1.0 - m_schedule_next)
        v_prime = var / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - m_t) * g_prime + m_t_1 * m_prime
        weight.sub_(lr * m_bar / (v_prime.sqrt() + self.epsilon))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the gradient corrected by
    ``lamda * g^2 * (w - w_prev)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = torch.zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.detach().clone())

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = _dense(grad) * self.rescale_grad
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        mom, prev_w = state
        comp = grad + wd * weight + self.lamda * grad * grad * (
            weight - prev_w)
        if mom is None:
            delta = -lr * comp
        else:
            mom.mul_(self.momentum).sub_(lr * comp)
            delta = mom
        prev_w.copy_(weight)
        weight.add_(delta)


@register
class LBSGD(SGD):
    """Large-batch SGD: the rate scaled per update by
    ``eta * |w| / (|g| + wd * |w|)`` (both norms read back)."""

    def __init__(self, eta=0.001, **kwargs):
        super().__init__(**kwargs)
        self.eta = eta

    def fused_ops(self):
        return None

    def update_multi_precision(self, index, weight, grad, state):
        Optimizer.update_multi_precision(self, index, weight, grad, state)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = _dense(grad)
        wn = float(torch.sqrt(torch.sum(torch.square(weight.detach()))))
        gn = float(torch.sqrt(torch.sum(torch.square(grad)))) \
            * self.rescale_grad
        if wn > 0 and gn > 0:
            lr = lr * self.eta * wn / (gn + wd * wn + 1e-9)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip_const())
        if state is None:
            sgd_update_(weight, grad, **kw)
        else:
            sgd_mom_update_(weight, grad, state, momentum=self.momentum,
                            **kw)


@register
class Test(Optimizer):
    """The dist kvstore tests' optimizer: ``w += rescale_grad * g``, its
    state a copy of the weight after the update."""

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight += grad * self.rescale_grad
            state.copy_(weight)


def _state_to(state, fn):
    """``fn`` applied to every tensor (or array) of an optimizer state:
    None, one tensor, or a tuple of states."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_to(s, fn) for s in state)
    return fn(state)


class Updater:
    """Applies (index, grad, weight) to the optimizer, creating each
    index's state at its first update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def get_states(self, dump_optimizer=False):
        """The states as a pickle of numpy arrays, with the optimizer
        (its ``param_dict`` left out) when ``dump_optimizer``."""
        st = {k: _state_to(v, lambda t: t.detach().cpu().numpy().copy())
              for k, v in self.states.items()}
        if not dump_optimizer:
            return pickle.dumps(st)
        opt = self.optimizer
        keep, opt.param_dict = opt.param_dict, {}
        try:
            return pickle.dumps((st, opt))
        finally:
            opt.param_dict = keep

    def set_states(self, states, device=None):
        """Load what :meth:`get_states` wrote; ``device(index)`` places
        each index's state (the CPU when None)."""
        obj = pickle.loads(states)
        if isinstance(obj, tuple) and len(obj) == 2 \
                and isinstance(obj[1], Optimizer):
            obj, self.optimizer = obj
        self.states = {
            k: _state_to(v, lambda a, k=k: torch.from_numpy(a).to(
                device(k) if device is not None else "cpu"))
            for k, v in obj.items()}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
