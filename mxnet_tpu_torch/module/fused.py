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

Mixed precision, as the JAX package's step: with a ``compute_dtype``
(bf16 or f16) the forward casts the f32 data inputs and every f32
parameter that is neither in ``keep_f32`` (BatchNorm's gamma and beta)
nor empty to that dtype inside the differentiated function, so the
gradients come back to the f32 master weights in f32 and the update
applies there; labels are not cast, the ones cotangents take each
output's dtype, and the aux updates go back to the aux dtype.

Not ported: the K-step ``run_k`` (``lax.scan`` over stacked batches; a
CUDA graph is its counterpart), data-parallel buckets and the
device-resident metric.
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

    def __init__(self, executor, optimizer, param_names, compute_dtype=None,
                 data_names=(), keep_f32=()):
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
        self.compute_dtype = compute_dtype
        self._data_names = frozenset(data_names)
        self._keep_f32 = frozenset(keep_f32)

    def _cast(self, leaves):
        """The executor's values to run the forward on: the leaves, and
        under a compute dtype the data inputs and the parameters cast
        to it (a differentiable cast, so gradients return in f32)."""
        cdt = self.compute_dtype
        if cdt is None:
            return leaves
        vals = {k: v.to(cdt) for k, v in self._exec.arg_dict.items()
                if k in self._data_names and v.dtype == torch.float32}
        for k, v in leaves.items():
            vals[k] = (v.to(cdt) if v.dtype == torch.float32
                       and k not in self._keep_f32 and v.numel() > 0 else v)
        return vals

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
            outs, auxu = ex._run(True, self._cast(leaves))
        auxu = {k: v.to(ex.aux_dict[k].dtype) for k, v in auxu.items()}
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
