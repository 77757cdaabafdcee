"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` scales the gradients by ``1 / batch_size``
(``rescale_grad``), reduces them across devices (one device here: a
no-op) and updates every parameter whose gradient a backward wrote
since the last step; a stale one raises unless ``ignore_stale_grad``.
Each step is admitted to a ``DepthController`` (``MXNET_ENGINE_DEPTH``),
so the host runs at most that many steps ahead of the card;
``quiesce()`` waits for all of them.

With ``MXNET_TRAINER_FUSED_UPDATE`` on (the default, as in the JAX
package) the update is one pass over all parameters through the
optimizer's ``fused_ops``, in place under ``torch.no_grad()``, so every
``Parameter.data()`` tensor stays the same object; off, the
optimizer's ``Updater`` runs once per parameter. Both use the same
update functions and the same state. The fused pass rounds lr, wd and
rescale to f32 and computes Adam's bias correction in f32, as the JAX
package's fused program does, so its Adam steps differ from the
per-parameter path's by that rounding (SGD's agree bit for bit). A
parameter with ``grad_stype="row_sparse"`` (``Embedding(sparse_grad=
True)``, ``contrib.nn.SparseEmbedding``) stays out of the fused pass:
its gradient is cast to row_sparse, whose rows are those of nonzero
gradient (a looked-up row whose gradient sums to exactly 0.0 is left
alone, as in the JAX package), and the optimizer's lazy row update
writes only those rows.

``kvstore`` is a name or a ``KVStore`` object, made at the first step
as the JAX package's ``_init_kvstore`` makes it: ``compression_params``
set on it, every updated parameter ``init``'ed, and
``update_on_kvstore`` (default: a ``dist_*`` store) pushing each
gradient for the store's optimizer and pulling the weights back.
Otherwise the step pushes each gradient to the store and pulls the
reduced (with ``compression_params``, the 2-bit quantized) gradient
back into the parameter's gradient before the update; ``device`` and
``local`` stores do the same. Across processes ``dist_sync`` all-reduces
each push and ``dist_async`` sends it to rank 0's server
(``kvstore.py``); under ``MXNET_DDP`` a ``dist_sync`` store leaves the
exchange to one bucketed all-reduce a dtype bucket over every gradient
(``parallel.dist.allreduce_tree``) and the optimizer runs on every rank,
as the JAX package's Trainer does. ``step`` fires the ``step`` fault
point (``parallel/faultinject.py``) with the number of steps done. ``checkpoint=`` (or
``MXNET_CHECKPOINT_DIR``) snapshots the parameters, the optimizer state
and the key chain every ``save_every`` steps, and with
``MXNET_RESUME_DIR`` the first step restores the newest snapshot;
``save_checkpoint``/``restore_checkpoint`` do it on demand.
"""
from __future__ import annotations

import pickle as _pickle

import numpy as _np
import torch

from ..base import MXNetError
from .. import kvstore as _kv
from .. import optimizer as _opt
from ..optimizer.optimizer import _is_lowp_float
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _flat_state(state):
    """An optimizer state as a tuple of tensors (None -> (), x -> (x,))."""
    if state is None:
        return ()
    if isinstance(state, tuple):
        return state
    return (state,)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, checkpoint=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % type(params))
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s."
                                 % type(param))
            self._param2idx[param.name] = i
            self._params.append(param)
            param._trainer = self
        self._compression_params = compression_params
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, _opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = _opt.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = param_dict
        self._updaters = [_opt.get_updater(self._optimizer)]
        self._fused_ops_cache = False
        self._depth_ctl = None
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._ddp = False
        if checkpoint is None:
            from ..checkpoint import CheckpointManager
            checkpoint = CheckpointManager.from_env()
        self._checkpoint = checkpoint
        self._global_step = 0
        self._resumed = False

    def _init_kvstore(self):
        config = self._kvstore_params
        kvstore = config["kvstore"]
        update_on_kvstore = config["update_on_kvstore"]
        if kvstore is None:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            kv = kvstore if isinstance(kvstore, _kv.KVStore) \
                else _kv.create(kvstore)
            self._kvstore = kv
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if update_on_kvstore is None:
                # dist_*: the optimizer runs in the store
                update_on_kvstore = kv.type.startswith("dist")
                # MXNET_DDP: dist_sync's exchange is one bucketed
                # all-reduce a dtype bucket, the optimizer on every rank;
                # dist_async keeps its server
                if update_on_kvstore and not kv.type.endswith("async"):
                    from ..parallel import ddp as _ddp
                    if _ddp.enabled():
                        update_on_kvstore = False
                        self._ddp = True
            self._update_on_kvstore = bool(update_on_kvstore)
            for i, param in enumerate(self._params):
                if param.grad_req == "null":
                    continue
                kv.init(i, param.data())
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce, then the update, the gradients scaled by
        ``1 / batch_size``."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._checkpoint is not None and not self._resumed:
            self._resumed = True
            from ..checkpoint import CheckpointManager
            if CheckpointManager.should_resume():
                self.restore_checkpoint()
        from ..parallel import faultinject as _fi
        _fi.fire("step", step=self._global_step)
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)
        self._global_step += 1
        # enqueue, don't wait: one updated parameter stands for the
        # step; the controller waits only past flags.engine_depth
        if self._depth_ctl is None:
            from ..engine import DepthController
            self._depth_ctl = DepthController()
        self._depth_ctl.admit(self._step_handles())
        if self._checkpoint is not None:
            from ..checkpoint import trainer_state

            def _state():
                # settle the steps in flight before the snapshot
                self.quiesce()
                return trainer_state(self)

            self._checkpoint.maybe_save(_state, self._global_step)

    def _step_handles(self):
        for param in self._params:
            if param.grad_req != "null" and param._data is not None:
                return [param.data()._data]
        return []

    def quiesce(self):
        """Wait until every step in flight has completed on the device."""
        if self._depth_ctl is not None:
            self._depth_ctl.quiesce()

    def allreduce_grads(self):
        """Reduce the gradients through the kvstore (push, then pull back
        into each parameter's gradient)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise AssertionError(
                "allreduce_grads() when parameters are updated on kvstore "
                "is not supported. Try setting `update_on_kvstore` to False.")
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None or self._update_on_kvstore:
            return  # on the kvstore, push and pull happen in _update
        if self._ddp:
            # one collective a dtype bucket over every gradient, not a
            # push and a pull a parameter
            from ..parallel import dist as _dist
            grads = [p.grad()._data for p in self._params
                     if p.grad_req != "null"]
            with torch.no_grad():
                for g, r in zip(grads, _dist.allreduce_tree(grads)):
                    g.copy_(r)
            return
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            self._kvstore.push(i, param.grad())
            self._kvstore.pull(i, param.grad(), ignore_sparse=False)

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        assert not self._update_on_kvstore, \
            "update() when parameters are updated on kvstore is not " \
            "supported. Try setting `update_on_kvstore` to False."
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        work = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            info = param._data._ag if param._data is not None else None
            if info is None or not info.fresh:
                if not ignore_stale_grad:
                    raise UserWarning(
                        "Gradient of Parameter `%s` has not been updated by "
                        "backward since last `step`. This could mean a bug "
                        "in your model that made it only use a subset of the "
                        "Parameters for this iteration. If you are "
                        "intentionally only using a subset, call step with "
                        "ignore_stale_grad=True to suppress this warning"
                        % param.name)
                continue
            if self._update_on_kvstore:
                g = param.grad()
                if param.grad_stype == "row_sparse":
                    # the store's updater takes the lazy row update too
                    from ..ndarray.sparse import cast_storage
                    g = cast_storage(g, "row_sparse")
                self._kvstore.push(i, g)
                # the weights always come back, even from a sparse store
                self._kvstore.pull(i, param.data(), ignore_sparse=False)
            else:
                work.append((i, param))
            info.fresh = False
        # a row_sparse parameter takes the optimizer's lazy row update:
        # its gradient cast to row_sparse (the touched rows are the rows
        # of nonzero gradient; one host copy of their occupancy), and it
        # stays out of the fused dense pass
        sparse_work = [(i, p) for i, p in work
                       if p.grad_stype == "row_sparse"]
        if sparse_work:
            from ..ndarray.sparse import cast_storage
            work = [(i, p) for i, p in work
                    if p.grad_stype != "row_sparse"]
            upd = self._updaters[0]
            for i, param in sparse_work:
                upd(i, cast_storage(param.grad(), "row_sparse"),
                    param.data()._data)
        if work and not self._fused_update(work):
            upd = self._updaters[0]
            for i, param in work:
                upd(i, param.grad()._data, param.data()._data)

    def _fused_update(self, work):
        """One pass of the optimizer's fused update over ``work``, as
        the JAX package's fused program: lr, wd and rescale rounded to
        f32, ``t`` per parameter. False where the flag is off, the
        optimizer has no fused form, or a low-precision weight has no
        f32 master (the per-parameter path takes those)."""
        from ..config import flags
        if not flags.trainer_fused_update:
            return False
        if self._fused_ops_cache is False:
            self._fused_ops_cache = self._optimizer.fused_ops()
        if self._fused_ops_cache is None:
            return False
        update = self._fused_ops_cache[1]
        opt, upd0 = self._optimizer, self._updaters[0]
        for _i, param in work:
            w = param.data()._data
            if w.dtype != torch.float32 and not (
                    opt.multi_precision and _is_lowp_float(w.dtype)):
                return False
        for i, param in work:
            if i not in upd0.states:
                upd0.states[i] = opt.create_state_multi_precision(
                    i, param.data()._data)
        for i, _p in work:
            opt._update_count(i)
        f32 = lambda v: float(_np.float32(v))  # noqa: E731
        rescale = f32(opt.rescale_grad)
        with torch.no_grad():
            for i, param in work:
                w, g = param.data()._data, param.grad()._data
                lr = opt.fused_lr(_np.float32(opt._get_lr(i)),
                                  opt._index_update_count[i])
                args = (float(lr), f32(opt._get_wd(i)), rescale)
                if w.dtype != torch.float32:
                    inner, w32 = upd0.states[i]
                    update(w32, g.float(), _flat_state(inner), *args)
                    w.copy_(w32)
                else:
                    update(w, g, _flat_state(upd0.states[i]), *args)
        return True

    def save_states(self, fname):
        self.quiesce()
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
            self._fused_ops_cache = False
            return
        with open(fname, "rb") as f:
            blob = f.read()
        self._set_states(self._updaters[0], blob)
        self._fused_ops_cache = False

    def _set_states(self, upd, blob):
        """An Updater's pickled states, each on its parameter's device;
        the trainer's optimizer stays (it holds the Parameters)."""
        upd.set_states(blob, device=self._state_device)
        upd.optimizer = self._optimizer

    def _state_device(self, i):
        if isinstance(i, int) and i < len(self._params):
            return self._params[i].data()._data.device
        return "cpu"

    # -- checkpoints --------------------------------------------------------
    def _live_updater(self):
        if self._update_on_kvstore:
            return getattr(self._kvstore, "_updater", None)
        return self._updaters[0]

    def _updater_state_bytes(self):
        """The optimizer's trajectory (the Updater's states and the update
        counts) for a checkpoint, in the JAX package's pickle."""
        if not self._kv_initialized:
            self._init_kvstore()
        upd = self._live_updater()
        opt = self._optimizer
        return _pickle.dumps({
            "states": upd.get_states(dump_optimizer=False)
            if upd is not None else None,
            "num_update": opt.num_update,
            "index_counts": dict(opt._index_update_count),
        }, protocol=2)

    def _set_updater_state_bytes(self, blob):
        if not self._kv_initialized:
            self._init_kvstore()
        obj = _pickle.loads(bytes(blob))
        upd = self._live_updater()
        if upd is not None and obj.get("states") is not None:
            self._set_states(upd, obj["states"])
        opt = self._optimizer
        opt.num_update = obj["num_update"]
        opt._index_update_count.clear()
        opt._index_update_count.update(obj["index_counts"])
        self._fused_ops_cache = False

    def save_checkpoint(self, step=None, blocking=True):
        """Snapshot the parameters, the optimizer state and the key chain
        through the trainer's CheckpointManager; False without one."""
        if self._checkpoint is None:
            return False
        self.quiesce()
        from ..checkpoint import trainer_state
        step = self._global_step if step is None else step
        self._checkpoint.save(trainer_state(self), step, blocking=blocking)
        return True

    def restore_checkpoint(self, step=None):
        """Restore the newest valid snapshot (at or before ``step``) ->
        the restored step, or None."""
        if self._checkpoint is None:
            return None
        self.quiesce()
        if not self._kv_initialized:
            self._init_kvstore()
        state, manifest = self._checkpoint.restore(step=step)
        if state is None:
            return None
        from ..checkpoint import restore_trainer
        restore_trainer(self, state)
        # the kvstore's copy of the weights too: under dist_* it is the
        # one updated on push and pulled back
        if self._kvstore is not None:
            for i, param in enumerate(self._params):
                if i in self._kvstore._store:
                    self._kvstore._store[i] = \
                        param.data()._data.detach().clone()
        self._global_step = manifest["step"]
        return self._global_step
