"""Module: a Symbol bound for training on one device (counterpart of
``mxnet_tpu/module/module.py``, single device).

``bind`` -> ``init_params`` -> ``init_optimizer`` -> ``fit`` (or the
per-batch ``forward``/``backward``/``update``). With
``kvstore="tpu_sync"`` the Module drives every step through
:class:`~.fused.FusedStep`; with ``local``/``device`` (or None) it runs
the eager path, the executor's forward and backward and then one
optimizer update per parameter. The default ``rescale_grad`` is
``1 / batch_size``. The fused step computes in bf16 over the f32 master
weights when the optimizer has ``multi_precision`` (the JAX package's
choice), and ``MXNET_COMPUTE_DTYPE`` (``config.compute_dtype``) can
force bf16 or f16 or veto the downcast; BatchNorm's gamma and beta stay
f32 (:meth:`Module._norm_stat_params`). Other kvstores, several
devices, checkpoints and the device-resident metric are not ported and
raise.
"""
from __future__ import annotations

import logging

import torch

from .. import config as _config
from .. import optimizer as _opt
from ..base import MXNetError
from ..context import Context, current_context, resolve_device
from ..executor import _as_tensor, simple_bind
from ..initializer import InitDesc
from .base_module import BaseModule
from .fused import FusedStep

__all__ = ["Module"]

_KVSTORES = (None, "local", "device", "tpu_sync")


def _normalize_shapes(shapes):
    """DataDesc list, (name, shape) list or dict -> [(name, shape)]."""
    if shapes is None:
        return []
    if isinstance(shapes, dict):
        shapes = list(shapes.items())
    out = []
    for item in shapes:
        if hasattr(item, "name") and hasattr(item, "shape"):
            out.append((item.name, tuple(item.shape)))
        else:
            out.append((item[0], tuple(item[1])))
    return out


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("Module: %d contexts; the port trains on "
                                 "one device (data parallelism is not "
                                 "ported)" % len(context))
            context = context[0]
        self._context = context
        self._device = resolve_device(context)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        inputs = self._data_names + self._label_names + self._state_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._optimizer = None
        self._updater = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused = None
        self._fused_opt_state = None
        self._fused_grads = None

    # ------------------------------------------------------------ properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return [(n, tuple(o.shape)) for n, o in
                zip(self._output_names, self._exec.outputs)]

    # ------------------------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self._fused = None
        self._fused_opt_state = None
        self._fused_grads = None
        self.optimizer_initialized = False
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = _normalize_shapes(data_shapes)
        self._label_shapes = _normalize_shapes(label_shapes)
        shapes = dict(self._data_shapes + self._label_shapes)
        req = {}
        for name in self._symbol.list_arguments():
            if name in self._data_names:
                req[name] = "write" if inputs_need_grad else "null"
            elif (name in self._label_names or name in self._state_names
                  or name in self._fixed_param_names):
                req[name] = "null"
            else:
                req[name] = grad_req if for_training else "null"
        prev = self._exec
        self._exec = simple_bind(self._symbol, self._device, grad_req=req,
                                 **shapes)
        self.binded = True
        if self._arg_params is not None:
            # the moving statistics from the executor: a training forward
            # rebinds its aux entries
            self._exec.copy_params_from(self._arg_params, prev.aux_dict,
                                        allow_extra_params=True)

    # ------------------------------------------------------------ parameters
    def _var_attrs(self, name):
        for node in self._symbol._topo():
            if node.is_variable and node.name == name:
                return dict(node.attrs)
        return {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before initializing parameters")
        ex = self._exec
        for names, given, dst in ((self._param_names, arg_params,
                                   ex.arg_dict),
                                  (self._aux_names, aux_params,
                                   ex.aux_dict)):
            for name in names:
                arr = dst[name]
                if given is not None and name in given:
                    with torch.no_grad():
                        arr.copy_(_as_tensor(given[name], arr.device,
                                             arr.dtype))
                elif initializer is not None:
                    initializer(InitDesc(name, self._var_attrs(name)), arr)
                elif not allow_missing and dst is ex.arg_dict:
                    raise MXNetError("parameter %r missing and no "
                                     "initializer" % name)
        self.params_initialized = True
        self._arg_params = {n: ex.arg_dict[n] for n in self._param_names}

    def get_params(self):
        """Copies of (arg_params, aux_params), as tensors on the
        Module's device."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("get_params needs a bound, initialized module")
        ex = self._exec
        return ({k: ex.arg_dict[k].detach().clone()
                 for k in self._param_names},
                {k: ex.aux_dict[k].detach().clone() for k in self._aux_names})

    # ------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer needs a bound, initialized "
                             "module")
        if self.optimizer_initialized and not force_init:
            return
        if kvstore not in _KVSTORES:
            raise MXNetError("kvstore %r is not ported (the port has %s)"
                             % (kvstore, [k for k in _KVSTORES if k]))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            # default rescale_grad = 1/batch_size, so sum-style loss heads
            # (SoftmaxOutput) yield mean gradients
            if "rescale_grad" not in optimizer_params and self._data_shapes:
                batch_size = self._data_shapes[0][1][0]
                optimizer_params["rescale_grad"] = 1.0 / max(batch_size, 1)
            optimizer = _opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._updater = _opt.get_updater(optimizer)
        self._fused = None
        self._fused_opt_state = None
        self._fused_grads = None
        ex = self._exec
        if (kvstore == "tpu_sync" and self.for_training
                and not self.inputs_need_grad
                and optimizer.fused_ops() is not None
                and not any(ex._grad_req.get(n) == "add"
                            for n in self._param_names)
                # low-precision parameters keep the eager path and its
                # multi-precision f32 masters
                and all(ex.arg_dict[n].dtype == torch.float32
                        for n in self._param_names)):
            default = ("bfloat16" if getattr(optimizer, "multi_precision",
                                             False) else None)
            cdt = _config.compute_dtype(default=default)
            self._fused = FusedStep(
                ex, optimizer, self._param_names,
                compute_dtype=None if cdt is None else getattr(torch, cdt),
                data_names=self._data_names,
                keep_f32=self._norm_stat_params())
            self._fused_opt_state = self._fused.init_state()
        self.optimizer_initialized = True

    def _norm_stat_params(self):
        """Names of the parameters that stay f32 under a low-precision
        compute dtype: BatchNorm's gamma and beta, which the op takes in
        f32 whatever the data dtype."""
        keep = set()
        for node in self._symbol._topo():
            if not node.is_variable and node.op.name == "BatchNorm":
                for slot in (1, 2):
                    if slot < len(node.inputs):
                        src = node.inputs[slot][0]
                        if src.is_variable:
                            keep.add(src.name)
        return frozenset(keep)

    # --------------------------------------------------------------- running
    def _feed(self, data_batch):
        feed = dict(zip(self._data_names, data_batch.data))
        if self._label_shapes and data_batch.label:
            feed.update(zip(self._label_names, data_batch.label))
        return feed

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward needs a bound, initialized module")
        if is_train is None:
            is_train = self.for_training
        self._exec.forward(is_train=is_train, **self._feed(data_batch))

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("backward needs a bound, initialized module")
        self._exec.backward(out_grads=out_grads)

    def _commit(self, outs, auxu):
        ex = self._exec
        for k, v in auxu.items():
            ex.aux_dict[k] = v.detach()
        ex.outputs = [o.detach() for o in outs]
        ex._pending = None

    def forward_backward(self, data_batch):
        """On the fused path: the forward and the gradients, held for
        :meth:`update` (the weights do not move before it). Otherwise
        the executor's forward and backward."""
        if self._fused is None or not self.optimizer_initialized:
            super().forward_backward(data_batch)
            return
        self._exec.set_inputs(**self._feed(data_batch))
        outs, auxu, leaves = self._fused.forward()
        self._fused_grads = self._fused.backward(outs, leaves)
        self._commit(outs, auxu)

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("update needs init_optimizer")
        if self._fused_grads is not None:
            self._fused.apply(self._fused_grads, self._fused_opt_state)
            self._fused_grads = None
            return
        ex = self._exec
        for i, name in enumerate(self._param_names):
            grad = ex.grad_dict.get(name)
            if grad is not None:
                self._updater(i, grad, ex.arg_dict[name])

    def _fit_step(self, data_batch):
        if self._fused is None:
            super()._fit_step(data_batch)
            return
        self._exec.set_inputs(**self._feed(data_batch))
        self._commit(*self._fused.step(self._fused_opt_state))

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels or [])),
            dict(zip(self._output_names, self._exec.outputs)))
