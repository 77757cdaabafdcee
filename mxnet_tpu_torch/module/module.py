"""Module: a Symbol bound for training on one device (counterpart of
``mxnet_tpu/module/module.py``).

``bind`` -> ``init_params`` -> ``init_optimizer`` -> ``fit`` (or the
per-batch ``forward``/``backward``/``update``). ``init_optimizer`` takes
a kvstore by name or as a ``KVStore`` object, with the JAX package's
rule for ``update_on_kvstore``: a ``dist_*`` store applies the update on
push (the step pushes each gradient and pulls the weights back; across
processes the push all-reduces it, in one process no reduce runs), any
other store leaves the update to the Module. Under ``MXNET_DDP`` a
``dist_sync`` store across processes hands the exchange to the bucketed
all-reduce instead (the JAX package's ``module.py:233-251``): the fused
step reduces its gradients through a ``parallel.ddp.GradReducer`` and
every rank runs the optimizer; a batch the world does not divide keeps
the kvstore path with a warning. ``ddp_stats()`` reports the buckets.
With ``kvstore="tpu_sync"``, and on a card with
``local``/``device`` (or None), the Module drives every step through
:class:`~.fused.FusedStep`; otherwise (and once a monitor is installed)
it runs the eager path, the executor's forward and backward and then
one optimizer update per parameter. The default ``rescale_grad`` is
``1 / batch_size``. The fused step computes in bf16 over the f32 master
weights when the optimizer has ``multi_precision`` (the JAX package's
choice), and ``MXNET_COMPUTE_DTYPE`` (``config.compute_dtype``) can
force bf16 or f16 or veto the downcast; BatchNorm's gamma and beta stay
f32 (:meth:`Module._norm_stat_params`). ``fit`` groups K steps into
one dispatch (:meth:`Module._fit_group`, ``FusedStep.run_k``) and folds
a supported metric into the step (:meth:`Module._engage_device_metric`).
The state surface is the JAX package's: ``get_states``/``set_states``,
``reshape``, ``install_monitor`` (drops the fused step, keeping its
optimizer state), ``save_checkpoint``/``load``,
``save_optimizer_states``/``load_optimizer_states`` (the Updater's
file, whichever path trained) and the hooks ``checkpoint.py`` uses.
Several devices in one process raise: data parallelism runs one process
a device (``python -m mxnet_tpu_torch.tools.launch``).
"""
from __future__ import annotations

import logging
import pickle

import numpy as _np
import torch

from .. import config as _config
from .. import kvstore as _kvstore
from .. import optimizer as _opt
from ..base import MXNetError
from ..context import Context, current_context, resolve_device
from ..executor import _as_tensor, simple_bind
from ..initializer import InitDesc
from .base_module import BaseModule
from .fused import FusedStep, _tensor

__all__ = ["Module"]


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
                 context=None, fixed_param_names=None, state_names=None,
                 compression_params=None):
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
        self._compression_params = compression_params
        self._arg_params = None
        self._aux_params = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._monitor_installed = False
        self._preload_opt_states = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused = None
        self._fused_opt_state = None
        self._fused_grads = None
        # the device-resident metric (device_metric.py): its plan, the
        # (sum, count) carry the fused step adds to, the proxy fit uses,
        # and a version bumped whenever the carry moves
        self._device_plan = None
        self._fused_met_state = None
        self._device_proxy = None
        self._device_met_version = 0
        self._warned_group_fallback = False
        self._stage_stream = None   # the staged feed's stream on a card
        self._ddp = False           # the bucketed all-reduce (MXNET_DDP)

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
        self._detach_device_metric()
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
            # the moving statistics from the executor (a training forward
            # rebinds its aux entries), or those Module.load read
            self._exec.copy_params_from(
                self._arg_params,
                prev.aux_dict if prev is not None else self._aux_params,
                allow_extra_params=True)
            self._arg_params = {n: self._exec.arg_dict[n]
                                for n in self._param_names}

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
        kv = None
        update_on_kvstore = False
        if kvstore:
            kv = _kvstore.create(kvstore) if isinstance(kvstore, str) \
                else kvstore
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            # a dist_* store applies the update on push (the reference's
            # server); tpu_sync, local and device leave it to the Module
            update_on_kvstore = kv.type.startswith("dist")
        self._ddp = False
        if update_on_kvstore and not kv.type.endswith("async"):
            # MXNET_DDP: dist_sync's exchange becomes the bucketed
            # all-reduce in the step, the optimizer on every rank
            from ..parallel import ddp as _ddp
            from ..parallel import dist as _dist
            if _ddp.enabled():
                world = _dist.num_workers()
                batch = self._data_shapes[0][1][0] \
                    if self._data_shapes else 0
                if world > 1 and batch % world == 0:
                    update_on_kvstore = False
                    self._ddp = True
                elif world > 1:
                    self.logger.warning(
                        "MXNET_DDP: batch %d not divisible by dp mesh "
                        "size %d; falling back to the kvstore path",
                        batch, world)
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        ex = self._exec
        if kv is not None:
            for name in self._param_names:
                kv.init(name, ex.arg_dict[name])
            if update_on_kvstore:
                kv.set_optimizer(optimizer)
        if not update_on_kvstore:
            self._updater = _opt.get_updater(optimizer)
        self._init_fused_step(kv)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _init_fused_step(self, kv):
        """The fused step (``FusedStep``) where it can stand in for the
        eager forward, backward and update: with ``tpu_sync`` always, with
        ``local``/``device``/no store on a card; never with the update on
        the kvstore or a monitor installed."""
        self._detach_device_metric()
        self._fused = None
        self._fused_opt_state = None
        self._fused_grads = None
        ex, optimizer = self._exec, self._optimizer
        kv_type = kv.type if kv is not None else None
        on_card = self._device.type == "cuda"
        if ((kv_type == "tpu_sync" or self._ddp
             or (on_card and kv_type in (None, "local", "device")))
                and not self._update_on_kvstore
                and not self._monitor_installed
                and self.for_training
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
            reducer = None
            if self._ddp:
                # parameter order is the forward's, so the reducer's
                # reversed walk is the backward's production order
                from ..parallel import ddp as _ddp
                from ..parallel import dist as _dist
                reducer = _ddp.GradReducer(
                    [(k, tuple(ex.arg_dict[k].shape), ex.arg_dict[k].dtype)
                     for k in self._param_names
                     if ex._grad_req.get(k, "null") == "write"],
                    axis_size=_dist.num_workers())
            self._fused = FusedStep(
                ex, optimizer, self._param_names,
                compute_dtype=None if cdt is None else getattr(torch, cdt),
                data_names=self._data_names,
                keep_f32=self._norm_stat_params(), reducer=reducer)
            self._fused_opt_state = self._fused.init_state()

    def _drop_fused(self):
        """Leave the fused step (a monitor watches the eager one), its
        optimizer state carried into the eager Updater first."""
        if self._fused is None:
            return
        if self._fused_opt_state is not None and self._updater is not None:
            self._updater.states = self._fused.state_to_updater(
                self._fused_opt_state)
        self._detach_device_metric()
        self._fused.release_graphs()
        self._fused = None
        self._fused_opt_state = None
        self._fused_grads = None

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
        if self._update_on_kvstore and self._kvstore is not None:
            for name in self._param_names:
                grad = ex.grad_dict.get(name)
                if grad is None:
                    continue
                self._kvstore.push(name, grad)
                # the weights always come back, even from a sparse store
                self._kvstore.pull(name, ex.arg_dict[name],
                                   ignore_sparse=False)
            return
        if self._ddp:
            # DDP without a fused step (an optimizer with no fused form):
            # one bucketed all-reduce a dtype bucket over the gradients
            from ..parallel import dist as _dist
            names = [n for n in self._param_names
                     if ex.grad_dict.get(n) is not None]
            reduced = _dist.allreduce_tree([ex.grad_dict[n] for n in names])
            with torch.no_grad():
                for n, g in zip(names, reduced):
                    ex.grad_dict[n].copy_(g)
        for i, name in enumerate(self._param_names):
            grad = ex.grad_dict.get(name)
            if grad is not None:
                self._updater(i, grad, ex.arg_dict[name])

    def _fit_step(self, data_batch):
        if self._fused is None:
            super()._fit_step(data_batch)
            return
        ex = self._exec
        ex.set_inputs(**self._feed(data_batch))
        ex.outputs = self._fused.step(self._fused_opt_state,
                                      met_state=self._fused_met_state)
        ex._pending = None
        if self._fused_met_state is not None:
            self._device_met_version += 1

    def _fit_group(self, data_batches, eval_metric=None, staged=None):
        """fit's grouped entry (``steps_per_dispatch``): the batches
        through :meth:`_fit_step_k`, then ``eval_metric`` updated once
        per sub-batch from the stacked per-step outputs (the per-step
        loop's metric semantics), or nothing to replay when the metric
        is device-resident. One batch, or no fused step, takes the
        per-step path. ``staged`` is the window's feed from
        :meth:`_stage_group`, made ahead on the feeder thread."""
        if self._fused is None or not self.optimizer_initialized \
                or len(data_batches) == 1:
            if len(data_batches) > 1 and not self._warned_group_fallback:
                self._warned_group_fallback = True
                self.logger.warning(
                    "steps_per_dispatch: fused step not engaged "
                    "(optimizer/kvstore/grad_req unfusable?) - falling "
                    "back to one dispatch per batch")
            for b in data_batches:
                self._fit_step(b)
                if eval_metric is not None:
                    self.update_metric(eval_metric, b.label)
            return
        outs = self._fit_step_k(data_batches, staged=staged)
        if getattr(eval_metric, "_device_resident", False):
            return  # accumulated inside the step; nothing to replay
        if eval_metric is not None:
            ex = self._exec
            last = ex.outputs
            for i, b in enumerate(data_batches):
                ex.outputs = [o[i] for o in outs]
                self.update_metric(eval_metric, b.label)
            ex.outputs = last

    def _stage_group(self, data_batches):
        """One K-step window's feed, stacked ahead of its dispatch: the
        ``stage_fn`` of :class:`~mxnet_tpu_torch.data.StagedKFeed`, run
        on the feeder thread while earlier windows run. The same
        ``stack_feeds`` the unstaged window runs, so the staged feed is
        bitwise the unstaged one; on a card on :meth:`_staging_stream`
        (fit makes it the feeder thread's current stream, so a card
        iterator's batches are ordered on it), after whatever the
        calling thread's stream was told to wait for, and ending in an
        event that ``run_k`` waits for. Reads only the executor's metadata. Returns
        ``({"stacked", "last", "ready"}, bytes copied from the
        host)``."""
        from .base_module import _host_bytes
        fused, dev = self._fused, self._device
        feeds = [self._feed(b) for b in data_batches]
        nbytes = sum(_host_bytes(b) for b in data_batches) \
            if dev.type == "cuda" else 0
        if dev.type != "cuda":
            return {"stacked": fused.stack_feeds(feeds), "last": feeds[-1],
                    "ready": None}, nbytes
        side = self._staging_stream()
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for f in feeds:
                for v in f.values():
                    t = _tensor(v)
                    if t.device.type == "cuda":
                        t.record_stream(side)   # read on this stream
            stacked = fused.stack_feeds(feeds)
            ready = torch.cuda.Event()
            ready.record(side)
        return {"stacked": stacked, "last": feeds[-1], "ready": ready}, \
            nbytes

    def _staging_stream(self):
        """The stream the staged feed runs on (a card's only), made once,
        at high priority as the input pipeline's streams."""
        if self._device.type != "cuda":
            return None
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(device=self._device,
                                                   priority=-1)
        return self._stage_stream

    def _fit_step_k(self, data_batches, staged=None):
        """K fit steps in one dispatch (``FusedStep.run_k``). The caller
        (:meth:`_fit_group`) guarantees the fused step is engaged and
        K > 1. K keys are drawn from the chain, one an inner step as the
        per-step path draws them (never staged). The window's feed is
        ``staged`` when given, else stacked here; after the window the
        executor's inputs take the last feed (shape checks, later
        forward() calls). Returns the stacked per-step outputs (a list
        of ``(K, ...)`` tensors)."""
        from .. import random as _random
        ex, fused = self._exec, self._fused
        keys = _np.stack([_random.next_key() for _ in data_batches])
        if staged is None:
            feeds = [self._feed(b) for b in data_batches]
            last = feeds[-1]
            outs = fused.run_k(fused.stack_feeds(feeds), keys,
                               self._fused_opt_state,
                               met_state=self._fused_met_state)
        else:
            last = staged["last"]
            outs = fused.run_k(None, keys, self._fused_opt_state,
                               met_state=self._fused_met_state,
                               staged=staged)
        with torch.no_grad():
            for name, val in last.items():
                dst = ex.arg_dict.get(name)
                if dst is not None:
                    dst.copy_(fused._stage(_tensor(val).to(dtype=dst.dtype)
                                           .reshape(dst.shape)))
        ex.outputs = [o[-1] for o in outs]
        ex._pending = None
        if self._fused_met_state is not None:
            self._device_met_version += 1
        return outs

    # ------------------------------------------------- device-resident metric
    def _engage_device_metric(self, eval_metric):
        """Fold ``eval_metric``'s accumulation into the fused step
        (``device_metric``): a :class:`DeviceMetricProxy` for fit's loop,
        or None when the metric's math has no device form or the fused
        step is not engaged (the caller keeps the per-batch host
        path)."""
        from .. import device_metric as _dm
        # under DDP each rank's carry would count only its own batches:
        # the host metric path (a per-worker metric, as dist_sync's)
        if self._fused is None or not _config.flags.device_metrics \
                or self._ddp or eval_metric is None \
                or getattr(eval_metric, "_device_resident", False):
            self._detach_device_metric()
            return None
        out_names = list(self._output_names)
        label_names = list(self._label_names)
        plan = _dm.plan_for(eval_metric, out_names, label_names)
        if plan is None:
            # a previous fit() may have attached a carry for another
            # metric; a stale one would ride every step for nothing
            self._detach_device_metric()
            return None
        ex = self._exec

        def met_fn(state, outs, feed):
            src = dict(ex.arg_dict)
            src.update(feed or {})
            plan.update(state, {k: src[k] for k in label_names if k in src},
                        dict(zip(out_names, outs)))

        self._device_plan = plan
        self._fused.attach_metric(met_fn)
        self._fused_met_state = plan.init_state(self._device)
        self._device_met_version += 1
        proxy = _dm.DeviceMetricProxy(self, eval_metric)
        proxy._pub_version = self._device_met_version
        self._device_proxy = proxy
        return proxy

    def _reset_device_metric(self):
        """Zero the device carry in place (stream-ordered after the steps
        in flight, and the tensors a captured graph adds to stay)."""
        if self._fused_met_state is None:
            return
        with torch.no_grad():
            for pair in self._fused_met_state:
                for t in pair:
                    t.zero_()
        self._device_met_version += 1

    def _publish_device_metric(self):
        """ONE device-to-host copy of the whole metric carry, written into
        the wrapped metric's host accumulators: the only copy the
        device-metric path pays, and only when someone reads it."""
        if self._device_plan is None or self._fused_met_state is None:
            return
        flat = torch.stack([t.to(torch.float64)
                            for pair in self._fused_met_state
                            for t in pair]).cpu().tolist()
        self._device_plan.publish(list(zip(flat[0::2], flat[1::2])))

    def _detach_device_metric(self):
        if self._fused is not None:
            self._fused.detach_metric()
        self._fused_met_state = None
        self._device_plan = None
        self._device_proxy = None

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

    def get_states(self, merge_multi_context=True):
        return [self._exec.arg_dict[n] for n in self._state_names]

    def set_states(self, states=None, value=None):
        """The state inputs from ``states`` (arrays, in ``state_names``
        order), or every one filled with ``value``."""
        ex = self._exec
        with torch.no_grad():
            if states is not None:
                for name, v in zip(self._state_names, states):
                    dst = ex.arg_dict[name]
                    dst.copy_(_as_tensor(v, dst.device, dst.dtype))
            elif value is not None:
                for name in self._state_names:
                    ex.arg_dict[name].fill_(value)

    def install_monitor(self, mon):
        """Watch the executor with ``mon``. A monitor reads the values of
        the eager step, so the fused step is dropped (its optimizer state
        goes on in the Updater) and not built again."""
        self._monitor_installed = True
        self._drop_fused()
        mon.install(self._exec)

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    def save_optimizer_states(self, fname):
        """The Updater's pickled states, in its layout whichever path
        trained (the fused state is mirrored into it first)."""
        if not self.optimizer_initialized:
            raise MXNetError("save_optimizer_states needs init_optimizer")
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.save_optimizer_states(fname)
            return
        self._mirror_fused_state()
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if not self.optimizer_initialized:
            raise MXNetError("load_optimizer_states needs init_optimizer")
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._set_updater_states(self._updater, f.read())

    def ddp_stats(self):
        """The DDP reducer's plan (``GradReducer.stats``: buckets, their
        bytes, the modelled overlap) with what its reduces cost here:
        ``reduce_ms`` (host ms of each step's reduce) and
        ``collectives``; None when the DDP path is off."""
        if not self._ddp or self._fused is None:
            return None
        red = self._fused.reducer
        return dict(red.stats(), reduce_ms=list(red.step_ms),
                    collectives=red.collectives)

    def _mirror_fused_state(self):
        """The fused state into the Updater's layout (shared tensors)."""
        if self._fused is not None and self._fused_opt_state is not None \
                and self._updater is not None:
            self._updater.states = self._fused.state_to_updater(
                self._fused_opt_state)

    def _set_updater_states(self, updater, blob):
        """Load an Updater's pickled states, each on its weight's device,
        and carry them into the fused state's tensors."""
        ex = self._exec

        def device(k):
            # the Module's Updater keys by index, a dist_* store's by name
            name = self._param_names[k] if isinstance(k, int) else k
            return ex.arg_dict[name].device
        updater.set_states(blob, device=device)
        if self._fused is not None and updater is self._updater:
            self._fused.state_from_updater(updater.states,
                                           self._fused_opt_state)

    # ------------------------------------------------- elastic checkpoints
    def _live_updater(self):
        """The Updater applying the updates: the kvstore's when it
        updates on push, the Module's otherwise."""
        if self._update_on_kvstore and self._kvstore is not None:
            return getattr(self._kvstore, "_updater", None)
        return self._updater

    def _optimizer_state_bytes(self):
        """The optimizer's trajectory for a checkpoint: the Updater's
        states and the update counts (schedules, Adam's bias
        correction), in the JAX package's pickle."""
        if not self.optimizer_initialized:
            return None
        updater = self._live_updater()
        states_blob = None
        if updater is not None:
            self._mirror_fused_state()
            states_blob = updater.get_states(dump_optimizer=False)
        opt = self._optimizer
        return pickle.dumps({
            "states": states_blob,
            "num_update": opt.num_update,
            "index_counts": dict(opt._index_update_count),
        }, protocol=2)

    def _set_optimizer_state_bytes(self, blob):
        if not self.optimizer_initialized or blob is None:
            return
        obj = pickle.loads(bytes(blob))
        updater = self._live_updater()
        if updater is not None and obj.get("states") is not None:
            self._set_updater_states(updater, obj["states"])
        # the counts go INTO the live optimizer: the kvstore's updater and
        # the fused step hold this object
        opt = self._optimizer
        opt.num_update = obj["num_update"]
        opt._index_update_count.clear()
        opt._index_update_count.update(obj["index_counts"])

    def _sync_params_to_kvstore(self):
        """The kvstore's copy of the weights from the executor's: under
        dist_* that copy is the one updated on push and pulled back."""
        kv = self._kvstore
        if kv is None or not self.binded:
            return
        for name in self._param_names:
            if name in kv._store:
                kv._store[name] = self._exec.arg_dict[name].detach().clone()

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol and parameters (read onto
        the Module's context); ``load_optimizer_states`` loads
        ``prefix-NNNN.states`` at ``init_optimizer``."""
        from ..model import load_checkpoint
        ctx = kwargs.get("context")
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=ctx)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def reshape(self, data_shapes, label_shapes=None):
        """Bind again for new input shapes, the parameters kept."""
        if not self.binded:
            raise MXNetError("reshape needs a bound module")
        arg_params, aux_params = self.get_params()
        self.bind(data_shapes, label_shapes, self.for_training,
                  self.inputs_need_grad, force_rebind=True)
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, force_init=True)
