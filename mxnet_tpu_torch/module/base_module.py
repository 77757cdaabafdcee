"""BaseModule: the training-loop surface (counterpart of
``mxnet_tpu/module/base_module.py``).

``fit`` keeps the reference epoch loop: bind, init_params,
init_optimizer, then per batch one step (``_fit_step``: the fused step
when the Module has one, else forward, backward, update), the metric
update and the batch-end callbacks; per epoch the metric log, the
epoch-end callbacks and an optional evaluation pass (``score``).
``eval_metric=None`` updates no metric, so the loop reads nothing back
from the device. Grouped dispatch (``steps_per_dispatch``, and the
automatic K), the staged K-step feed (``data.StagedKFeed``), the
device-resident metric and the bounded in-flight queue are the JAX
package's. ``fit`` keeps its input-side numbers in ``data_stats``: for
each dispatch, the ms the loop waited for its batches and the bytes
they brought from the host. Checkpoints and resume are the JAX
package's: ``fit(checkpoint=CheckpointManager(...))`` or
``MXNET_CHECKPOINT_DIR`` snapshots the whole training state every
``save_every`` steps (at window ends under grouped dispatch, with the
data cursor of an iterator that has one), and ``MXNET_RESUME_DIR``
restores the newest snapshot and goes on from its step; across
processes every rank restores the newest step that all ranks saved
(``_common_resume_step``, one all-gather), so that no two ranks resume
from different weights. Fault injection (``MXNET_FAULT_INJECT``,
``parallel/faultinject.py``) fires its ``step`` point before each step,
or each window under grouped dispatch, with the number of steps done.
A monitor (``fit(monitor=)``) runs the per-step eager path. ``predict``,
``iter_predict`` and ``score`` run the inference forward. The session
dtype policy (``MXNET_COMPUTE_DTYPE``) is obeyed by the Module's fused
step.
"""
from __future__ import annotations

import logging
import time
from typing import NamedTuple

import numpy as _np
import torch

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


def _host_bytes(batch):
    """Bytes of a batch's arrays that lie on the host (what a step on a
    card copies over); metadata only, nothing read from a device."""
    n = 0
    for arr in list(batch.data or []) + list(batch.label or []):
        t = getattr(arr, "_data", arr)
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size() if t.device.type == "cpu" else 0
        else:
            n += _np.asarray(t).nbytes
    return n


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self.data_stats = None

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

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Per batch: (outputs trimmed by the batch's pad, nbatch,
        batch)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("iter_predict needs a bound, initialized "
                             "module")
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """The outputs over ``eval_data`` as NDArrays where the module
        runs: merged across batches (one array per output, one array
        alone unless ``always_output_list``), or a list per batch."""
        from ..ndarray.ndarray import NDArray
        if not (self.binded and self.params_initialized):
            raise MXNetError("predict needs a bound, initialized module")
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([out[0:out.shape[0] - pad].detach().clone()
                                for out in self.get_outputs()])
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            if any(len(out) != num_outputs for out in output_list):
                raise MXNetError("Cannot merge batches: different number "
                                 "of outputs per batch")
            merged = [NDArray(torch.cat([out[i] for out in output_list]))
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return [[NDArray(o) for o in out] for out in output_list]

    def install_monitor(self, mon):
        raise NotImplementedError

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
        """The epoch loop.

        ``steps_per_dispatch=K > 1`` groups K batches into ONE dispatch
        (``FusedStep.run_k``: a captured CUDA graph of the step replayed
        K times on a card, a loop of eager steps on the CPU). Metric
        updates stay per batch; ``batch_end_callback`` fires per batch
        but only after its group completes; a short tail runs per step;
        lr/wd schedules advance in steps of K. Needs a module with a
        grouped fused step (plain :class:`Module`) and no monitor. With
        ``MXNET_DATA_STAGED_FEED`` (on by default) a
        :class:`~mxnet_tpu_torch.data.StagedKFeed` stacks each window's
        feed on a feeder thread (``Module._stage_group``) while the
        previous window runs; the steps are bitwise the unstaged ones.

        ``steps_per_dispatch=None`` (default) picks K automatically:
        ``flags.steps_per_dispatch`` (MXNET_STEPS_PER_DISPATCH, default
        16) when nothing in the loop needs per-step host attention: no
        monitor/batch_end_callback/checkpoint/sparse_row_id_fn/
        lr_scheduler, and the eval metric either absent or folded into
        the device step (``device_metric``), and a graph with no op that
        reads back to the host mid-step (``FusedStep.host_ops``: a
        ``Custom`` op, ``Proposal``) and no DDP all-reduce in the step
        (both make ``FusedStep.dispatch`` eager). Otherwise K = 1,
        reference per-step semantics. An explicit K over such a step runs
        its K steps uncaptured.

        Dispatches are not waited for one by one: a
        :class:`~mxnet_tpu_torch.engine.DepthController`
        (``flags.engine_depth``, default 2) bounds the in-flight queue,
        and the loop waits for all of it at epoch ends, at checkpoint
        snapshots, and before the metric, the parameters and the scoring
        are read.

        ``checkpoint``: a :class:`~mxnet_tpu_torch.checkpoint.
        CheckpointManager` (default: one from ``MXNET_CHECKPOINT_DIR`` or
        ``MXNET_RESUME_DIR`` when set). The whole training state is
        snapshotted every ``save_every`` steps; with ``MXNET_RESUME_DIR``
        set, fit first restores the newest valid snapshot and goes on
        from its step, bitwise as an uninterrupted run. A checkpoint
        makes the automatic K 1; an explicit K saves at window ends.
        ``sparse_row_id_fn`` is not ported and raises."""
        from .. import checkpoint as _ckpt
        from .. import initializer as _init
        from ..config import flags as _flags
        from ..engine import DepthController
        from ..parallel import faultinject as _fi
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        # validate an EXPLICIT steps_per_dispatch BEFORE any side effect;
        # None = decide automatically once the module is set up
        explicit_k = steps_per_dispatch is not None
        if explicit_k:
            if steps_per_dispatch < 1:
                raise ValueError("steps_per_dispatch must be >= 1, got %r"
                                 % (steps_per_dispatch,))
            if steps_per_dispatch > 1:
                if not hasattr(self, "_fit_group"):
                    raise ValueError(
                        "steps_per_dispatch > 1 needs a module with a "
                        "grouped fused step (plain Module); %s has none"
                        % type(self).__name__)
                if monitor is not None or sparse_row_id_fn is not None:
                    raise ValueError(
                        "steps_per_dispatch > 1 is incompatible with "
                        "monitor / sparse_row_id_fn")
        if sparse_row_id_fn is not None:
            raise MXNetError("fit: sparse_row_id_fn is not ported")
        if initializer is None:
            initializer = _init.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
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

        # checkpoints: restore the newest snapshot when resuming
        ckpt = checkpoint if checkpoint is not None \
            else _ckpt.CheckpointManager.from_env()
        global_step = 0
        resume_epoch, resume_nbatch, resume_cursor = begin_epoch, 0, None
        if ckpt is not None and _ckpt.CheckpointManager.should_resume():
            state, manifest = ckpt.restore_latest()
            mine = manifest["step"] if manifest is not None else -1
            common = self._common_resume_step(mine)
            if common >= 0 and common != mine:
                # a rank died between its own save and a peer's: go back
                # to the newest step every rank has, or the all-reduces
                # after the resume would mix two weight histories
                state, manifest = ckpt.restore(step=common)
            if common >= 0 and state is not None:
                resume_cursor = _ckpt.cursor_from_state(state)
                _ckpt.restore_module(self, state)
                global_step = manifest["step"]
                resume_epoch = manifest["epoch"]
                resume_nbatch = manifest["nbatch"]
                self.logger.info(
                    "resumed from checkpoint step %d (epoch %d, batch %d) "
                    "in %s", global_step, resume_epoch, resume_nbatch,
                    ckpt.directory)
            else:
                self.logger.warning(
                    "MXNET_RESUME_DIR set but no common valid checkpoint "
                    "across ranks in %s; starting from scratch",
                    ckpt.directory)
        meta = {"kvstore": kvstore if isinstance(kvstore, str)
                else getattr(kvstore, "type", None)}
        has_cursor = hasattr(train_data, "get_cursor") \
            and hasattr(train_data, "seek")
        data_cursor = [None]     # the cursor of the last consumed batch

        def snap_state():
            # a snapshot reads a settled trajectory: wait for the steps
            # in flight first
            depth_ctl.quiesce()
            state = _ckpt.module_state(self)
            if data_cursor[0] is not None:
                state[_ckpt.DATA_CURSOR_KEY] = \
                    _ckpt.encode_cursor(data_cursor[0])
            return state

        # 1. fold the metric into the device step when its math allows:
        #    per-batch update_metric becomes a no-op on the proxy and the
        #    (sum, count) carry moves to the host only when read
        if hasattr(self, "_engage_device_metric"):
            if eval_metric is not None and monitor is None:
                proxy = self._engage_device_metric(eval_metric)
                if proxy is not None:
                    eval_metric = proxy
            else:
                self._detach_device_metric()
        # 2. with no per-step host observer left, run K steps a dispatch
        if not explicit_k:
            auto_k = (batch_end_callback is None and monitor is None
                      and ckpt is None
                      and hasattr(self, "_fit_group")
                      and getattr(self, "_fused", None) is not None
                      and self._fused.dispatch == "graph"
                      and (eval_metric is None or
                           getattr(eval_metric, "_device_resident", False))
                      and getattr(getattr(self, "_optimizer", None),
                                  "lr_scheduler", None) is None)
            steps_per_dispatch = max(1, int(_flags.steps_per_dispatch)) \
                if auto_k else 1
        self._fit_k = steps_per_dispatch   # the K this fit runs at
        grouped = steps_per_dispatch > 1
        # 3. dispatch without waiting; bound the in-flight queue
        depth_ctl = DepthController()
        # 4. the input side, per dispatch: the ms the loop waited for its
        #    batches (the input stall) and the bytes they brought from the
        #    host; host-held values only, no device read
        staging = grouped and bool(_flags.data_staged_feed) \
            and getattr(self, "_fused", None) is not None \
            and self.optimizer_initialized and hasattr(self, "_stage_group")
        self.data_stats = stats = {"staged": staging, "input_stall_ms": [],
                                   "h2d_bytes": [], "steps": []}

        def note(stall_ms, nbytes, steps):
            stats["input_stall_ms"].append(stall_ms)
            stats["h2d_bytes"].append(nbytes)
            stats["steps"].append(steps)

        def timed_next(it):
            t0 = time.perf_counter()
            try:
                return next(it)
            finally:
                acc[0] += (time.perf_counter() - t0) * 1e3

        acc = [0.0, 0]     # stall ms and host bytes since the last note

        def batch_end(epoch, nbatch, frame):
            for cb in _as_list(batch_end_callback or []):
                cb(BatchEndParam(epoch, nbatch, eval_metric, frame))

        for epoch in range(max(begin_epoch, resume_epoch), num_epoch):
            tic = time.time()
            if eval_metric is not None:
                eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            if ckpt is not None and epoch == resume_epoch and resume_nbatch:
                if resume_cursor is not None and has_cursor:
                    # seek to the position the snapshot had consumed
                    train_data.seek(resume_cursor)
                    data_iter = iter(train_data)
                    data_cursor[0] = dict(resume_cursor)
                else:
                    # replay the (deterministic) iterator past the
                    # batches consumed before the snapshot
                    for _ in range(resume_nbatch):
                        try:
                            next(data_iter)
                        except StopIteration:
                            break
                nbatch = resume_nbatch
            if grouped:
                # one dispatch per K batches; callbacks fire per batch,
                # from this frame, after the group's dispatch
                feed = None
                if staging:
                    from ..data.feed import StagedKFeed
                    feed = StagedKFeed(data_iter, steps_per_dispatch,
                                       self._stage_group,
                                       depth=max(2, int(
                                           _flags.data_feed_depth)),
                                       cursor_fn=(train_data.get_cursor
                                                  if has_cursor else None),
                                       stream=self._staging_stream())
                try:
                    group, staged, win_cursor = [], None, None
                    while not end_of_batch:
                        if feed is not None:
                            t0 = time.perf_counter()
                            try:
                                win = feed.next_window()
                            except StopIteration:
                                win = None
                                end_of_batch = True
                            acc[0] += (time.perf_counter() - t0) * 1e3
                            if win is not None:
                                group, staged = list(win.batches), win.staged
                                win_cursor = win.cursor
                                acc[1] += win.h2d_bytes
                                if len(group) < steps_per_dispatch:
                                    end_of_batch = True   # the tail
                        else:
                            try:
                                b = timed_next(data_iter)
                                group.append(b)
                                acc[1] += _host_bytes(b)
                            except StopIteration:
                                end_of_batch = True
                        if len(group) == steps_per_dispatch or \
                                (end_of_batch and group):
                            _fi.fire("step", step=global_step)
                            if len(group) == steps_per_dispatch:
                                self._fit_group(group, eval_metric,
                                                staged=staged)
                                depth_ctl.admit(self._dispatch_handles())
                            else:
                                # tail: the per-step path
                                for b in group:
                                    self._fit_group([b], eval_metric)
                                    depth_ctl.admit(
                                        self._dispatch_handles())
                            note(acc[0], acc[1], len(group))
                            acc[0], acc[1] = 0.0, 0
                            for data_batch in group:
                                batch_end(epoch, nbatch, locals())
                                nbatch += 1
                            global_step += len(group)
                            if win_cursor is not None:
                                data_cursor[0] = win_cursor
                            elif has_cursor and feed is None:
                                # fit is the only reader: the iterator's
                                # cursor is the consumed position
                                data_cursor[0] = train_data.get_cursor()
                            if ckpt is not None:
                                ckpt.maybe_save(snap_state, global_step,
                                                epoch=epoch, nbatch=nbatch,
                                                meta=meta)
                            group, staged, win_cursor = [], None, None
                finally:
                    if feed is not None:
                        feed.close()
            else:
                try:
                    next_batch = timed_next(data_iter)
                    acc[1] += _host_bytes(next_batch)
                except StopIteration:
                    end_of_batch = True
                while not end_of_batch:
                    data_batch = next_batch
                    if monitor is not None:
                        monitor.tic()
                    # global_step steps are done (and, on the save grid,
                    # snapshotted): "kill@step=N" dies here, and the
                    # supervised restart resumes at step N
                    _fi.fire("step", step=global_step)
                    self._fit_step(data_batch)
                    depth_ctl.admit(self._dispatch_handles())
                    if eval_metric is not None:
                        self.update_metric(eval_metric, data_batch.label)
                    if has_cursor:
                        # before the next batch is read: the cursor of
                        # the batches consumed, not of the read-ahead
                        data_cursor[0] = train_data.get_cursor()
                    note(acc[0], acc[1], 1)
                    acc[0], acc[1] = 0.0, 0
                    try:
                        next_batch = timed_next(data_iter)
                        acc[1] += _host_bytes(next_batch)
                        self.prepare(next_batch)
                    except StopIteration:
                        end_of_batch = True
                    if monitor is not None:
                        monitor.toc_print()
                    batch_end(epoch, nbatch, locals())
                    nbatch += 1
                    global_step += 1
                    if ckpt is not None:
                        ckpt.maybe_save(snap_state, global_step,
                                        epoch=epoch, nbatch=nbatch,
                                        meta=meta)
            # epoch boundary: drain the in-flight dispatches before the
            # host reads the metric and the parameters
            depth_ctl.quiesce()
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
        if ckpt is not None:
            ckpt.wait()  # join a save in flight; raise its error

    @staticmethod
    def _common_resume_step(mine):
        """The newest checkpoint step EVERY rank can restore (the least
        of an all-gather); -1 when a rank has none. In one process,
        ``mine``."""
        from ..parallel import dist as _dist
        if not _dist.initialized() or _dist.num_workers() <= 1:
            return mine
        steps = _dist.allgather(torch.tensor([int(mine)], dtype=torch.int64))
        return int(steps.min())

    def ddp_stats(self):
        """The bucketed all-reduce's plan and what it cost (``GradReducer.
        stats`` with ``reduce_ms`` and ``collectives``), or None when the
        DDP path is off."""
        return None

    def _dispatch_handles(self):
        """Tensors standing for the most recent dispatch, for the
        :class:`~mxnet_tpu_torch.engine.DepthController`: the first
        output (an event after it marks the whole dispatch, one
        stream)."""
        try:
            outs = self.get_outputs()
        except MXNetError:
            return []
        return list(outs[:1])
