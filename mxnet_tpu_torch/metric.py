"""Evaluation metrics (counterpart of a subset of ``mxnet_tpu/metric.py``):
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``MCC``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Perplexity``,
``Loss`` (with its aliases ``Torch`` and ``Caffe``), ``CustomMetric``
(``create(callable)``, ``np(feval)``) and ``create``. Labels and
predictions are copied to the host as numpy arrays once per
``update_dict``, arrays that still answer ``asnumpy()`` (a user metric
written against NDArrays, ``preds[0].asnumpy()``, keeps working);
``fit(eval_metric=None)`` calls no metric at all, so it reads nothing
back from the device, and ``fit`` folds the metrics that
``device_metric`` supports into the fused step."""
from __future__ import annotations

import math

import numpy as _np
import torch

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Perplexity",
           "Loss", "Torch", "Caffe", "CustomMetric", "np", "create",
           "register"]

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if callable(metric) and not isinstance(metric, (EvalMetric, type)):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    name = str(metric).lower()
    aliases = {"acc": "accuracy", "ce": "crossentropy",
               "nll_loss": "negativeloglikelihood",
               "top_k_accuracy": "topkaccuracy",
               "pearsonr": "pearsoncorrelation"}
    name = aliases.get(name, name)
    try:
        return _METRIC_REGISTRY[name](*args, **kwargs)
    except KeyError:
        raise ValueError("unknown metric %r; the port has %s"
                         % (metric, sorted(_METRIC_REGISTRY))) from None


class _HostArray(_np.ndarray):
    """A numpy array that answers the NDArray host API."""

    def asnumpy(self):
        return _np.asarray(self)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    elif hasattr(x, "asnumpy"):
        x = x.asnumpy()
    return _np.asarray(x).view(_HostArray)


def _check(labels, preds):
    if len(labels) != len(preds):
        raise ValueError("labels/preds count mismatch: %d vs %d"
                         % (len(labels), len(preds)))


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names if n in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names if n in label]
        else:
            label = list(label.values())
        self.update([_as_np(x) for x in label], [_as_np(x) for x in pred])

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get`` lists their names and
    values."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        labels = [_as_np(x) for x in labels]
        preds = [_as_np(x) for x in preds]
        for m in self.metrics:
            m.update(labels, preds)

    def update_dict(self, labels, preds):
        # one host copy of each array for all the metrics
        labels = {k: _as_np(v) for k, v in labels.items()}
        preds = {k: _as_np(v) for k, v in preds.items()}
        for m in self.metrics:
            m.update_dict(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(n if isinstance(n, list) else [n])
            values.extend(v if isinstance(v, list) else [v])
        return names, values


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        _check(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_np.int32).ravel()
            label = label.astype(_np.int32).ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.top_k = top_k
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        _check(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_np(label).astype(_np.int32)
            pred = _as_np(pred)
            idx = _np.argsort(pred, axis=1)[:, -self.top_k:]
            self.sum_metric += (idx == label.reshape(-1, 1)).any(axis=1).sum()
            self.num_inst += len(label)


def _binary_preds(pred):
    """Class-1 decisions: column 1 of (N, 2) scores, else the scores,
    over 0.5."""
    pred = pred[:, 1] if pred.ndim == 2 else pred
    return (pred > 0.5).astype(_np.int32)


class _BinaryCounts(EvalMetric):
    """Running confusion counts of a binary classifier."""

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = self._tn = 0.0

    def _count(self, label, pred):
        label = _as_np(label).ravel().astype(_np.int32)
        pred = _binary_preds(_as_np(pred))
        self._tp += ((pred == 1) & (label == 1)).sum()
        self._fp += ((pred == 1) & (label == 0)).sum()
        self._fn += ((pred == 0) & (label == 1)).sum()
        self._tn += ((pred == 0) & (label == 0)).sum()


@register
class F1(_BinaryCounts):
    """F1 of the positive class over every update so far."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average

    def update(self, labels, preds):
        _check(labels, preds)
        for label, pred in zip(labels, preds):
            self._count(label, pred)
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            self.sum_metric = 2 * prec * rec / max(prec + rec, 1e-12)
            self.num_inst = 1


@register
class MCC(_BinaryCounts):
    """Matthews correlation coefficient over every update so far."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        _check(labels, preds)
        for label, pred in zip(labels, preds):
            self._count(label, pred)
            tp, fp, fn, tn = self._tp, self._fp, self._fn, self._tn
            den = math.sqrt(max((tp + fp) * (tp + fn) * (tn + fp)
                                * (tn + fn), 1e-12))
            self.sum_metric = (tp * tn - fp * fn) / den
            self.num_inst = 1


def _columns(label, pred):
    """Label and prediction as numpy, a 1-D one as a column."""
    label, pred = _as_np(label), _as_np(pred)
    if label.ndim == 1:
        label = label.reshape(label.shape[0], 1)
    if pred.ndim == 1:
        pred = pred.reshape(pred.shape[0], 1)
    return label, pred


class _Regression(EvalMetric):
    """Mean over batches of ``_batch(label - pred)``."""

    def __init__(self, name, output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        _check(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _columns(label, pred)
            self.sum_metric += self._batch(label - pred)
            self.num_inst += 1


@register
class MAE(_Regression):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _batch(d):
        return _np.abs(d).mean()


@register
class MSE(_Regression):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _batch(d):
        return (d ** 2.0).mean()


@register
class RMSE(_Regression):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _batch(d):
        return _np.sqrt((d ** 2.0).mean())


@register
class PearsonCorrelation(EvalMetric):
    """Mean over batches of the correlation of predictions and labels."""

    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        _check(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += _np.corrcoef(_as_np(pred).ravel(),
                                            _as_np(label).ravel())[0, 1]
            self.num_inst += 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        _check(labels, preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel().astype(_np.int64)
            pred = _as_np(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                probs = _np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= _np.log(_np.maximum(probs, 1e-10)).sum()
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        _check(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel()
            pred = _as_np(pred)
            if label.shape[0] != pred.shape[0]:
                raise ValueError("CrossEntropy: %d labels for %d rows"
                                 % (label.shape[0], pred.shape[0]))
            prob = pred[_np.arange(label.shape[0]), label.astype(_np.int64)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class Loss(EvalMetric):
    """Mean of the raw loss output."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            pred = _as_np(pred)
            self.sum_metric += pred.sum()
            self.num_inst += pred.size


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, returning
    a value or ``(sum, count)``."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__ if feval.__name__ != "<lambda>" \
                else "custom"
        super().__init__("custom(%s)" % name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            _check(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                self.sum_metric += reval[0]
                self.num_inst += reval[1]
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` over a numpy ``feval``."""
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
