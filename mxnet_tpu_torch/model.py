"""Checkpoint files, ``BatchEndParam`` and the legacy ``FeedForward``
trainer (counterpart of ``mxnet_tpu/model.py``).

``save_checkpoint`` writes ``prefix-symbol.json`` and
``prefix-NNNN.params`` (the ``.params`` format of ``nd.save``, the JAX
package's bytes), each through ``checkpoint.atomic_replace``, so a kill
during a save leaves the old file or the new one whole;
``load_checkpoint`` reads them back. Files written by either package
load in the other. ``FeedForward`` is the JAX package's facade over
``Module``: fit, predict, score, save, load and create.
"""
from __future__ import annotations

import numpy as _np

from . import symbol as _symbol
from .module.base_module import BatchEndParam
from .ndarray import ndarray as _nd

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]


def _as_nd(v):
    return v if isinstance(v, _nd.NDArray) else _nd.NDArray(v.detach())


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write prefix-symbol.json and prefix-NNNN.params, atomically.
    Parameters may be NDArrays or tensors."""
    from .checkpoint import atomic_replace
    if symbol is not None:
        with atomic_replace("%s-symbol.json" % prefix) as tmp:
            symbol.save(tmp)
    save_dict = {("arg:%s" % k): _as_nd(v) for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): _as_nd(v)
                      for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    with atomic_replace(param_name) as tmp:
        _nd.save(tmp, save_dict)


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) of a checkpoint; the arrays are
    NDArrays on ``ctx`` (default: the current context)."""
    symbol = _symbol.load("%s-symbol.json" % prefix)
    save_dict = _nd.load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The v0.x trainer: symbol, context and optimizer bundled, with
    fit/predict/score/save/load, over :class:`~.module.Module`."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as _init
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or _init.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _ctx_list(self):
        if self.ctx is None:
            return None
        return self.ctx if isinstance(self.ctx, (list, tuple)) else [self.ctx]

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        from .module import Module
        from .io import NDArrayIter, ResizeIter
        if not hasattr(X, "provide_data"):  # numpy (X, y)
            X = NDArrayIter(_np.asarray(X), _np.asarray(y),
                            batch_size=self.numpy_batch_size, shuffle=True)
        if self.epoch_size is not None:
            # an epoch is epoch_size batches of a (possibly endless)
            # stream; the iterator rewinds only when it runs dry
            X = ResizeIter(X, self.epoch_size, reset_internal=False)
        label_names = [n for n in self.symbol.list_arguments()
                       if n.endswith("label")] or ["softmax_label"]
        self._module = Module(self.symbol,
                              data_names=[d[0] for d in X.provide_data],
                              label_names=label_names,
                              context=self._ctx_list())
        self._module.fit(
            X, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer, optimizer_params=dict(self.kwargs),
            initializer=self.initializer, arg_params=self.arg_params,
            aux_params=self.aux_params,
            allow_missing=self.arg_params is not None,
            begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
            eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback,
            monitor=monitor)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        from .io import NDArrayIter
        if not hasattr(X, "provide_data"):
            X = NDArrayIter(_np.asarray(X),
                            batch_size=min(self.numpy_batch_size,
                                           len(_np.asarray(X))))
        mod = self._predict_module(X)
        if return_data:
            # (outputs, datas, labels), the data and labels trimmed by
            # each batch's pad as the outputs are
            if reset:
                X.reset()
            outs, datas, labels = [], [], []
            for batch_outs, _, batch in mod.iter_predict(
                    X, num_batch=num_batch, reset=False):
                pad = getattr(batch, "pad", None) or 0
                if batch.label:
                    out_h, d, lab = _nd.asnumpy_all(
                        batch_outs[0], batch.data[0], batch.label[0])
                else:
                    out_h, d = _nd.asnumpy_all(batch_outs[0],
                                               batch.data[0])
                    lab = None
                outs.append(out_h)
                datas.append(d[:d.shape[0] - pad] if pad else d)
                if lab is not None:
                    labels.append(lab[:lab.shape[0] - pad] if pad else lab)
            return (_np.concatenate(outs),
                    _np.concatenate(datas),
                    _np.concatenate(labels) if labels else None)
        out = mod.predict(X, num_batch=num_batch, reset=reset,
                          always_output_list=False)
        if isinstance(out, list):
            return [o.asnumpy() for o in out]
        return out.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None, reset=True):
        from . import metric as _metric
        from .io import NDArrayIter
        if not hasattr(X, "provide_data"):
            # numpy without labels is scored against zeros
            X = _np.asarray(X)
            X = NDArrayIter(X, _np.zeros(X.shape[0], dtype=_np.float32),
                            batch_size=min(self.numpy_batch_size, len(X)),
                            label_name="softmax_label")
        mod = self._predict_module(X)
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        mod.score(X, eval_metric, num_batch=num_batch, reset=reset)
        return eval_metric.get()[1]

    def _predict_module(self, X):
        from .module import Module
        if self._module is not None and self._module.binded:
            return self._module
        assert self.arg_params is not None, "call fit() or load() first"
        label_names = [n for n in self.symbol.list_arguments()
                       if n.endswith("label")]
        mod = Module(self.symbol,
                     data_names=[d[0] for d in X.provide_data],
                     label_names=label_names, context=self._ctx_list())
        mod.bind(X.provide_data,
                 X.provide_label if label_names else None,
                 for_training=False)
        mod.init_params(arg_params=self.arg_params,
                        aux_params=self.aux_params,
                        allow_missing=False,
                        allow_extra=self.allow_extra_params)
        self._module = mod
        return mod

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch or 0
        assert self.arg_params is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        c = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=c)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               epoch_size=None, optimizer="sgd", initializer=None,
               eval_data=None, eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Train a new model from scratch."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
