"""BaseModule: the training-loop surface (counterpart of
``mxnet_tpu/module/base_module.py``, single device).

``fit`` keeps the reference epoch loop: bind, init_params,
init_optimizer, then per batch one step (``_fit_step``: the fused step
when the Module has one, else forward, backward, update), the metric
update and the batch-end callbacks; per epoch the metric log, the
epoch-end callbacks and an optional evaluation pass (``score``).
``eval_metric=None`` updates no metric, so the loop reads nothing back
from the device. Not ported: checkpointing and resume, monitors, and
grouping several steps into one dispatch (``steps_per_dispatch``).
The session dtype policy (``MXNET_COMPUTE_DTYPE``) is obeyed by the
Module's fused step.
"""
from __future__ import annotations

import logging
import os
import time
from typing import NamedTuple

from .. import metric as _metric
from ..base import MXNetError

__all__ = ["BaseModule", "BatchEndParam"]


class BatchEndParam(NamedTuple):
    epoch: int
    nbatch: int
    eval_metric: object
    locals: dict


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    # ------------------------------------------------------------ high level
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def _fit_step(self, data_batch):
        self.forward_backward(data_batch)
        self.update()

    def prepare(self, data_batch):
        """Hook run before each batch; nothing to prepare here."""

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        if not (self.binded and self.params_initialized):
            raise MXNetError("score needs a bound, initialized module")
        if reset:
            eval_data.reset()
        eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for cb in _as_list(batch_end_callback or []):
                cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
        for cb in _as_list(score_end_callback or []):
            cb(BatchEndParam(epoch, num_batch or 0, eval_metric, locals()))
        return eval_metric.get_name_value()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, steps_per_dispatch=None,
            checkpoint=None):
        """The epoch loop. ``monitor``, ``sparse_row_id_fn``,
        ``checkpoint`` and ``steps_per_dispatch`` > 1 are not ported and
        raise; so do the settings the JAX package's fit obeys and the port
        does not: ``MXNET_CHECKPOINT_DIR`` or ``MXNET_RESUME_DIR`` set
        (elastic checkpointing and resume)."""
        from .. import initializer as _init
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        if monitor is not None or sparse_row_id_fn is not None or \
                checkpoint is not None:
            raise MXNetError("fit: monitor, sparse_row_id_fn and checkpoint "
                             "are not ported")
        if steps_per_dispatch is not None and steps_per_dispatch != 1:
            raise MXNetError("fit: steps_per_dispatch=%r: grouping steps "
                             "into one dispatch is not ported (ROADMAP "
                             "A1b); pass 1 or None" % (steps_per_dispatch,))
        for env in ("MXNET_CHECKPOINT_DIR", "MXNET_RESUME_DIR"):
            if os.environ.get(env):
                raise MXNetError("fit: %s is set, but checkpointing and "
                                 "resume are not ported" % env)
        if initializer is None:
            initializer = _init.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if eval_metric is None and eval_data is not None \
                and validation_metric is None:
            raise ValueError("eval_metric=None needs an explicit "
                             "validation_metric when eval_data is given")
        if validation_metric is None:
            validation_metric = eval_metric
        if eval_metric is not None:
            eval_metric = _metric.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            if eval_metric is not None:
                eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            try:
                next_batch = next(data_iter)
            except StopIteration:
                end_of_batch = True
            while not end_of_batch:
                data_batch = next_batch
                self._fit_step(data_batch)
                if eval_metric is not None:
                    self.update_metric(eval_metric, data_batch.label)
                try:
                    next_batch = next(data_iter)
                    self.prepare(next_batch)
                except StopIteration:
                    end_of_batch = True
                for cb in _as_list(batch_end_callback or []):
                    cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
                nbatch += 1
            for name, val in (eval_metric.get_name_value()
                              if eval_metric is not None else []):
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_p, aux_p = self.get_params()
            for cb in _as_list(epoch_end_callback or []):
                cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
