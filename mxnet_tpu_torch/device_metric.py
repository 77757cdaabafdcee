"""Device-resident metric accumulation for the fused train step
(counterpart of ``mxnet_tpu/device_metric.py``).

The host fit loop pays one device-to-host copy per batch to update an
``EvalMetric``. For the common classification metrics (acc / top_k /
ce / nll / loss) the accumulation runs inside the fused step instead: a
``(sum f32, count int32)`` pair of 0-d tensors per metric on the
module's device, updated in place (so a captured CUDA graph of the step
updates the same tensors on every replay), and copied to the host only
when someone reads the metric: one copy of the whole carry per read.

The host ``EvalMetric`` object stays the one the user sees: publish
overwrites its ``sum_metric``/``num_inst`` and its own ``get()`` formats
the value. Device sums accumulate in f32, the host path in float64;
counts are integers either way, CE/loss sums agree to f32 rounding. The
device path is bitwise stable against itself: the same steps at any
engine depth or steps_per_dispatch give the same bits.
"""
from __future__ import annotations

import torch

from . import metric as _metric

__all__ = ["plan_for", "DeviceMetricPlan", "DeviceMetricProxy"]


def _leaves(metric):
    """Flatten a (possibly composite) metric into its leaf metrics."""
    if isinstance(metric, _metric.CompositeEvalMetric):
        out = []
        for m in metric.metrics:
            out.extend(_leaves(m))
        return out
    return [metric]


def _select_names(m, out_names, label_names):
    """``EvalMetric.update_dict``'s name selection, made once."""
    if m.output_names is not None:
        preds = [n for n in m.output_names if n in out_names]
    else:
        preds = list(out_names)
    if m.label_names is not None:
        labels = [n for n in m.label_names if n in label_names]
    else:
        labels = list(label_names)
    return labels, preds


def _build_update(m):
    """An in-place update ``(sum, count, labels, preds)`` with ``m.update``'s
    math in torch ops, or None where ``m`` cannot be folded (stateful F1/MCC,
    per-batch-mean regression metrics, custom fevals, Perplexity)."""
    f32, i32 = torch.float32, torch.int32
    # exact class checks (not isinstance): a subclass may override update
    # with math the closure below would misrepresent.
    # NegativeLogLikelihood is the one subclass that changes no math.
    klass = type(m)

    if klass is _metric.Accuracy:
        axis = m.axis

        def upd(s, n, labels, preds):
            for label, pred in zip(labels, preds):
                if pred.dim() > label.dim():
                    pred = pred.argmax(dim=axis)
                pred = pred.to(i32).reshape(-1)
                label = label.to(i32).reshape(-1)
                s.add_((pred == label).sum().to(f32))
                n.add_(label.numel())
        return upd

    if klass is _metric.TopKAccuracy:
        top_k = m.top_k

        def upd(s, n, labels, preds):
            for label, pred in zip(labels, preds):
                label = label.to(i32)
                idx = torch.argsort(pred, dim=1, stable=True)[:, -top_k:]
                hit = (idx == label.reshape(-1, 1)).any(dim=1)
                s.add_(hit.sum().to(f32))
                n.add_(label.shape[0])
        return upd

    if klass in (_metric.CrossEntropy, _metric.NegativeLogLikelihood):
        eps = m.eps

        def upd(s, n, labels, preds):
            for label, pred in zip(labels, preds):
                label = label.reshape(-1).to(i32).long()
                prob = pred.to(f32).gather(1, label.unsqueeze(1))[:, 0]
                s.add_((-torch.log(prob + eps)).sum())
                n.add_(label.shape[0])
        return upd

    if klass in (_metric.Loss, _metric.Torch, _metric.Caffe):
        def upd(s, n, labels, preds):
            for pred in preds:
                s.add_(pred.sum().to(f32))
                n.add_(pred.numel())
        return upd

    return None


def plan_for(metric, out_names, label_names):
    """A :class:`DeviceMetricPlan` for ``metric`` over a module with the
    given output/label names, or None when any leaf's math cannot be
    replicated on the device (the caller keeps the per-batch host
    path)."""
    leaves = _leaves(metric)
    if not leaves:
        return None
    entries = []
    for m in leaves:
        lab_keys, pred_keys = _select_names(m, out_names, label_names)
        if not pred_keys:
            return None
        needs_labels = not isinstance(m, _metric.Loss)
        if needs_labels and len(lab_keys) != len(pred_keys):
            # host update would zip-truncate or raise; don't guess
            return None
        upd = _build_update(m)
        if upd is None:
            return None
        entries.append((m, lab_keys, pred_keys, upd))
    return DeviceMetricPlan(entries)


class DeviceMetricPlan:
    """Step-side accumulation: :meth:`update` runs inside the fused step;
    :meth:`init_state` and :meth:`publish` bracket it on the host."""

    def __init__(self, entries):
        self._entries = entries

    def init_state(self, device):
        """Fresh zero carry on ``device``: one (sum f32, count int32)
        pair of 0-d tensors per leaf."""
        return tuple((torch.zeros((), dtype=torch.float32, device=device),
                      torch.zeros((), dtype=torch.int32, device=device))
                     for _ in self._entries)

    def update(self, state, label_dict, pred_dict):
        """Add one step's outputs and labels to ``state``, in place."""
        with torch.no_grad():
            for (_m, lab_keys, pred_keys, upd), (s, n) in zip(
                    self._entries, state):
                labels = [label_dict[k] for k in lab_keys if k in label_dict]
                preds = [pred_dict[k] for k in pred_keys if k in pred_dict]
                upd(s, n, labels, preds)

    def publish(self, host_state):
        """Overwrite each leaf metric's host accumulators from a carry
        fetched to the host: a sequence of (sum, count) pairs."""
        for (m, _, _, _), (s, n) in zip(self._entries, host_state):
            m.sum_metric = float(s)
            m.num_inst = int(n)


class DeviceMetricProxy:
    """Stands in for the wrapped EvalMetric in fit's loop and callbacks,
    with the accumulation on the device: reads (``get`` /
    ``get_name_value``) publish the device carry into the wrapped metric
    first; ``update``/``update_dict`` do nothing (the fused step already
    accumulated the batch); ``reset`` zeros both sides."""

    _device_resident = True

    def __init__(self, module, inner):
        self._module = module
        self.inner = inner
        self._pub_version = -1

    @property
    def name(self):
        return self.inner.name

    @property
    def sum_metric(self):
        self._publish()
        return self.inner.sum_metric

    @property
    def num_inst(self):
        self._publish()
        return self.inner.num_inst

    def _publish(self):
        mod = self._module
        version = getattr(mod, "_device_met_version", 0)
        if version != self._pub_version:
            mod._publish_device_metric()
            self._pub_version = version

    def update(self, labels, preds):
        pass  # accumulated inside the fused step

    def update_dict(self, label, pred):
        pass  # accumulated inside the fused step

    def reset(self):
        self._module._reset_device_metric()
        self.inner.reset()
        self._pub_version = getattr(self._module, "_device_met_version", 0)

    def get(self):
        self._publish()
        return self.inner.get()

    def get_name_value(self):
        self._publish()
        return self.inner.get_name_value()

    def __str__(self):
        return "DeviceMetricProxy(%s)" % self.inner
