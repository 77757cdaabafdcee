"""BucketingModule: training over variable-length sequences
(counterpart of ``mxnet_tpu/module/bucketing_module.py``).

``sym_gen(bucket_key)`` builds one Symbol per bucket (a sequence
length); each bucket gets its own :class:`Module`, bound at that
bucket's shapes the first time a batch of it arrives. Every bucket's
executor holds the SAME parameter tensors (the default bucket's), so an
update in one bucket is the weight every other bucket reads, with no
copy; the moving statistics, which a training forward rebinds, follow
the active bucket on every switch. The optimizer, its updater and the
fused step's optimizer state are shared too: one accumulator and one
update count per weight, as the JAX package keeps them by mirroring
them across buckets. ``fit`` runs per step, as the JAX package's does
for a bucketing module (no grouped dispatch, the metric on the host).
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        if group2ctxs:
            raise MXNetError("group2ctxs device placement is not ported: "
                             "the port trains on one device")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._grad_req = "write"
        self._kvstore = None

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    # ------------------------------------------------------------ properties
    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    # ------------------------------------------------------------ parameters
    def get_params(self):
        if not self.params_initialized:
            raise MXNetError("get_params needs initialized parameters")
        return self._curr_module.get_params()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before initializing parameters")
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        if shared_module is not None:
            raise MXNetError("BucketingModule.bind: shared_module is not "
                             "supported")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self._buckets = {}
        self.params_initialized = False
        self.optimizer_initialized = False
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True

    def _share_into(self, module):
        """Point a newly bound bucket's executor at the default bucket's
        parameter tensors, and its optimizer at the shared one."""
        default = self._buckets[self._default_bucket_key]
        src, dst = default._exec, module._exec
        for name in module._param_names:
            if name not in src.arg_dict:
                raise MXNetError("bucket parameter %r is not in the default "
                                 "bucket's symbol" % name)
            if tuple(src.arg_dict[name].shape) != \
                    tuple(dst.arg_dict[name].shape):
                raise MXNetError("bucket parameter %r: shape %s, default "
                                 "bucket's %s" % (
                                     name, tuple(dst.arg_dict[name].shape),
                                     tuple(src.arg_dict[name].shape)))
            dst.arg_dict[name] = src.arg_dict[name]
        module._arg_params = {n: dst.arg_dict[n]
                              for n in module._param_names}
        module.params_initialized = True
        if self.optimizer_initialized:
            if module._param_names != default._param_names:
                raise MXNetError("bucket %r orders its parameters unlike the "
                                 "default bucket; the shared optimizer "
                                 "counts updates by index"
                                 % (module.symbol.name,))
            module.init_optimizer(self._kvstore, default._optimizer)
            module._updater = default._updater
            if module._fused is not None:
                module._fused_opt_state = default._fused_opt_state

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        if not self.binded:
            raise MXNetError("call bind before switching bucket")
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self.inputs_need_grad, force_rebind=False,
                        grad_req=self._grad_req)
            self._buckets[bucket_key] = module
            if self.params_initialized:
                self._share_into(module)
        prev = self._curr_module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key
        if prev is not self._curr_module and self.params_initialized:
            # the moving statistics, rebound by each training forward
            aux = self._curr_module._exec.aux_dict
            for k, v in prev._exec.aux_dict.items():
                if k in aux:
                    aux[k] = v

    # ------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer needs a bound, initialized "
                             "module")
        if self.optimizer_initialized and not force_init:
            return
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init=force_init)
        self._kvstore = kvstore
        self.optimizer_initialized = True
        for mod in self._buckets.values():
            if mod is not default:
                self._share_into(mod)

    # --------------------------------------------------------------- running
    def _fit_step(self, data_batch):
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module._fit_step(data_batch)

    def prepare(self, data_batch):
        if not (self.binded and self.params_initialized):
            raise MXNetError("prepare needs a bound, initialized module")
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward needs a bound, initialized module")
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)
