"""The fused train step of ``Module`` (counterpart of
``mxnet_tpu/module/fused.py``, single device).

The JAX package compiles forward, backward and the optimizer update into
one XLA program and donates the weights and optimizer state to it. Here
one Python function does the same work eagerly: the forward over the
executor's DAG under autograd and ``torch.autograd.grad`` with ones
cotangents (the loss heads ignore them), then every parameter's update
under ``torch.no_grad()``, in place on the executor's tensors and the
optimizer state (the counterpart of donation: no second copy of the
weights). Dynamic hyperparameters come from the optimizer per step
(:meth:`FusedStep.hyper_peek`), so a schedule moves without rebuilding.

Not ported: the K-step ``run_k`` (``lax.scan`` over stacked batches; a
CUDA graph is its counterpart), data-parallel buckets, the
mixed-precision downcast and the device-resident metric.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["FusedStep"]


class FusedStep:
    """Forward, backward and update of a Module's bound executor.

    :meth:`forward`, :meth:`backward` and :meth:`apply` are the three
    parts of :meth:`step`; the Module's ``forward_backward``/``update``
    pair runs the first two, then the third, so the weights do not move
    before ``update()``.
    """

    def __init__(self, executor, optimizer, param_names):
        fused = optimizer.fused_ops()
        if fused is None:
            raise ValueError("optimizer %s has no fused form"
                             % type(optimizer).__name__)
        self._exec = executor
        self._opt = optimizer
        self._state_init, self._update = fused
        # only grad_req == 'write' params are updated; 'null' pass through
        self.param_names = [n for n in param_names
                            if executor._grad_req.get(n, "null") == "write"]
        self._name2idx = {n: i for i, n in enumerate(param_names)}

    def init_state(self):
        """Zero optimizer state for every updated parameter."""
        return {k: self._state_init(self._exec.arg_dict[k])
                for k in self.param_names}

    def hyper_peek(self):
        """(lr, wd) per parameter as f32 arrays, rescale as f32 and the
        update count t, AS IF the counts had been bumped; the bump
        itself is :meth:`commit_counts`, after the update."""
        opt = self._opt
        idxs = [self._name2idx[k] for k in self.param_names]
        peek = {i: opt._index_update_count.get(i, opt.begin_num_update) + 1
                for i in idxs}
        num_update = max([opt.num_update] + list(peek.values()))
        lr_vec = [opt._get_lr(i, num_update=num_update) for i in idxs]
        wd_vec = [opt._get_wd(i) for i in idxs]
        t = int(peek[idxs[0]]) if idxs else int(num_update)
        return (_np.asarray(lr_vec, _np.float32),
                _np.asarray(wd_vec, _np.float32),
                _np.float32(opt.rescale_grad), t)

    def commit_counts(self):
        for k in self.param_names:
            self._opt._update_count(self._name2idx[k])

    def forward(self):
        """The training forward under autograd -> (outputs, aux updates,
        {name: leaf}); the leaves share storage with the weights."""
        ex = self._exec
        leaves = {k: ex.arg_dict[k].detach().requires_grad_(True)
                  for k in self.param_names}
        with torch.enable_grad():
            outs, auxu = ex._run(True, leaves)
        return outs, auxu, leaves

    @staticmethod
    def backward(outs, leaves):
        """Gradients with all-ones head cotangents -> {name: grad}."""
        pairs = [o for o in outs if o.requires_grad]
        names = list(leaves)
        grads = torch.autograd.grad(
            pairs, [leaves[k] for k in names],
            [torch.ones_like(o) for o in pairs], allow_unused=True) \
            if pairs else [None] * len(names)
        return {k: (torch.zeros_like(leaves[k]) if g is None else g)
                for k, g in zip(names, grads)}

    @torch.no_grad()
    def apply(self, grads, opt_state):
        """Every parameter's update, in place; then the counts."""
        lr_vec, wd_vec, rescale, t = self.hyper_peek()
        ex = self._exec
        for i, k in enumerate(self.param_names):
            _w, opt_state[k] = self._update(
                ex.arg_dict[k], grads[k], opt_state[k], float(lr_vec[i]),
                float(wd_vec[i]), float(rescale), t)
        self.commit_counts()

    def step(self, opt_state):
        """One whole step -> (outputs, aux updates); weights and
        ``opt_state`` are updated in place."""
        outs, auxu, leaves = self.forward()
        grads = self.backward(outs, leaves)
        del leaves
        self.apply(grads, opt_state)
        return [o.detach() for o in outs], auxu
