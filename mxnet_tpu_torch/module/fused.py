"""The fused train step of ``Module`` (counterpart of
``mxnet_tpu/module/fused.py``).

The JAX package compiles forward, backward and the optimizer update into
one XLA program and donates the weights and optimizer state to it. Here
one Python function does the same work eagerly: the forward over the
executor's DAG under autograd and ``torch.autograd.grad`` with ones
cotangents (the loss heads ignore them), then every parameter's update
under ``torch.no_grad()``, in place on the executor's tensors and the
optimizer state (the counterpart of donation: no second copy of the
weights), then the moving statistics and the device-resident metric
carry (``device_metric``), also in place. Dynamic hyperparameters come
from the optimizer per step (:meth:`FusedStep.hyper_rows`, made on the
host in numpy f32) and reach the update as 0-d f32 tensors on the
device, so a schedule moves without rebuilding anything.

K steps per dispatch (:meth:`FusedStep.run_k`, the JAX package's
``lax.scan`` over stacked batches): the K feeds are cast and stacked
into ``(K, ...)`` on the device, the K keys and the K steps'
hyperparameters staged there too (lr and wd evaluated once per
dispatch; the update count t, and with it Adam's bias correction,
advancing per inner step). On a CPU tensor the K steps run as a loop
over the eager step, which is run_k's plain version. On a CUDA tensor
one step (forward, ``autograd.grad``, update, aux copy, metric carry) is
captured once as a CUDA graph reading its feed, key and hyperparameters
from static device buffers, and replayed K times, each replay's inputs
copied in from slice i of the window (:class:`_StepGraph`). The first
steps of the first window run eagerly on a side stream to warm up
(cuDNN, cuBLAS, the allocator, first-use kernel builds); they are real
steps with the same arithmetic, and capture itself runs nothing. One
graph is kept per (feed shapes and dtypes, kernel tier, metric carry);
a failed capture raises ``MXNetError``, never falls back.

A graph holding an op that reads values back to the host mid-step (a
``Custom`` op's user Python, the NMS walk of ``Proposal`` or
``box_nms``: ops registered ``host``) cannot be captured. That is read
from the graph when the step is made (:attr:`FusedStep.host_ops`), never
learnt from a failed capture: such a step's K steps run as the loop of
eager steps on a card too (:attr:`FusedStep.dispatch` is ``"eager"``,
``"graph"`` otherwise), and ``fit``'s automatic K is 1 for it.

Mixed precision, as the JAX package's step: with a ``compute_dtype``
(bf16 or f16) the forward casts the f32 data inputs and every f32
parameter that is neither in ``keep_f32`` (BatchNorm's gamma and beta)
nor empty to that dtype inside the differentiated function, so the
gradients come back to the f32 master weights in f32 and the update
applies there; labels are not cast, the ones cotangents take each
output's dtype, and the aux updates go back to the aux dtype. A grouped
window casts its data before stacking (half the stacked bytes; the same
bits as the cast inside the step).

A window's feed may come staged (``run_k(staged=)``, the feed
``Module._stage_group`` stacked ahead on the feeder thread's stream):
the step's stream waits for the staged window's event, marks the staged
tensors as read on it (so the allocator reuses none of them while a
replay reads them), and copies slice i into the graph's static buffers
before replay i, as for an unstaged window. One set of static buffers
and a copy a step (a batch, ~38 MB in bf16 at ResNet-50's batch 128,
some 25 us at the card's bandwidth) was chosen over two captured
buffer sets alternating, which would hold a second graph and its memory
pool for a saving too small to see. The capture runs in the
thread-local capture mode: the input pipeline's threads keep decoding
and staging, on streams of their own, while the step is captured.

``state_to_updater`` and ``state_from_updater`` carry the optimizer
state between this layout ({name: tuple of tensors}) and the eager
``Updater``'s, for ``save_optimizer_states``, checkpoints and a
monitor's eager steps.

Data parallelism across processes (``MXNET_DDP``, the JAX package's
``ddp_mesh`` mode): with a ``reducer`` (``parallel.ddp.GradReducer``)
the gradients of every step pass through it between the backward and
the update, one flattened all-reduce a bucket over the process group,
so every rank applies the same summed gradient to the same weights. The
JAX package lets XLA overlap those collectives with the rest of the
backward inside its program; here they run eagerly after it. A gloo
collective synchronizes with the host and cannot sit inside a captured
CUDA graph, so a DDP step's K-step windows run their K steps uncaptured
(:attr:`FusedStep.dispatch` is ``"eager"``, as for host ops), and fit's
automatic K is 1 for it: the cost is the host's launch time of every
step, which a replayed graph would have saved. A device-resident metric
cannot fold into a DDP step (each rank would count only its own
batches): :meth:`attach_metric` refuses it, and the Module keeps the
host metric.
"""
from __future__ import annotations

import time

import numpy as _np
import torch

from ..base import MXNetError
from ..kernels import tier as _tier

__all__ = ["FusedStep"]

# eager steps that warm a new graph up before its capture (at most K - 1)
_WARMUP_STEPS = 2


def _tensor(v):
    """A batch value as a tensor where it lies (an NDArray's own tensor,
    a numpy array on the host)."""
    if isinstance(v, torch.Tensor):
        return v
    data = getattr(v, "_data", None)
    if isinstance(data, torch.Tensor):
        return data
    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    return torch.from_numpy(_np.ascontiguousarray(_np.asarray(v)))


class FusedStep:
    """Forward, backward and update of a Module's bound executor.

    :meth:`forward`, :meth:`backward` and :meth:`apply` are the three
    parts of :meth:`step`; the Module's ``forward_backward``/``update``
    pair runs the first two, then the third, so the weights do not move
    before ``update()``. :meth:`run_k` runs K whole steps.
    """

    def __init__(self, executor, optimizer, param_names, compute_dtype=None,
                 data_names=(), keep_f32=(), reducer=None):
        fused = optimizer.fused_ops()
        if fused is None:
            raise ValueError("optimizer %s has no fused form"
                             % type(optimizer).__name__)
        self._exec = executor
        self._device = executor._device
        self._opt = optimizer
        self._state_init, self._update = fused
        # only grad_req == 'write' params are updated; 'null' pass through
        self.param_names = [n for n in param_names
                            if executor._grad_req.get(n, "null") == "write"]
        self._name2idx = {n: i for i, n in enumerate(param_names)}
        self.compute_dtype = compute_dtype
        self._data_names = frozenset(data_names)
        self._keep_f32 = frozenset(keep_f32)
        self._met_fn = None
        self._graphs = {}
        # ops that read back to the host mid-step: no CUDA graph
        self.host_ops = tuple(sorted({
            n.op.name for n in executor._symbol._topo()
            if not n.is_variable and n.op.reads_back(n.params)}))
        # the DDP all-reduce between backward and update (None: one
        # process's gradients as they are)
        self.reducer = reducer
        self.dispatch = "eager" if self.host_ops or reducer is not None \
            else "graph"
        # census of how steps ran: graphs captured, inner steps replayed
        # from a graph, steps run eagerly (per-step path, CPU windows,
        # windows of a graph with host ops and the warm-up before a
        # capture)
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0
        self.capture_ms = []   # host time of each capture

    def _cast(self, leaves, feed=None):
        """The values to run the forward on: ``feed`` (a grouped step's
        inputs) over the executor's bound inputs, the leaves, and under a
        compute dtype the f32 data inputs and parameters cast to it (a
        differentiable cast, so gradients return in f32)."""
        cdt = self.compute_dtype
        vals = dict(feed or {})
        if cdt is None:
            vals.update(leaves)
            return vals
        for k in self._data_names:
            v = vals.get(k, self._exec.arg_dict.get(k))
            if v is not None and v.dtype == torch.float32:
                vals[k] = v.to(cdt)
        for k, v in leaves.items():
            vals[k] = (v.to(cdt) if v.dtype == torch.float32
                       and k not in self._keep_f32 and v.numel() > 0 else v)
        return vals

    def init_state(self):
        """Zero optimizer state for every updated parameter."""
        return {k: self._state_init(self._exec.arg_dict[k])
                for k in self.param_names}

    def state_to_updater(self, opt_state):
        """The fused state in the eager ``Updater``'s layout ({index:
        None, a tensor, or a tuple}), sharing its tensors, so that
        ``save_optimizer_states`` writes the same file whichever path
        trained."""
        out = {}
        for k, st in opt_state.items():
            st = tuple(st)
            out[self._name2idx[k]] = (None if not st else
                                      st[0] if len(st) == 1 else st)
        return out

    @torch.no_grad()
    def state_from_updater(self, updater_states, opt_state):
        """Eager ``Updater`` states (after ``load_optimizer_states`` or a
        restore) copied into the fused state ``opt_state`` in place (a
        captured graph reads its tensors); an index without a state
        starts at zero. -> ``opt_state``."""
        for k in self.param_names:
            idx = self._name2idx[k]
            st = updater_states.get(idx)
            if st is None and idx not in updater_states:
                src = self._state_init(self._exec.arg_dict[k])
            else:
                src = () if st is None else \
                    st if isinstance(st, tuple) else (st,)
            for dst, s in zip(opt_state[k], src):
                dst.copy_(s)
        return opt_state

    # ---------------------------------------------------------- metric
    def attach_metric(self, met_fn):
        """Fold a metric update into the step: ``met_fn(state, outs,
        feed)`` adds one step's outputs to the carry in place. A change
        drops the captured graphs (they hold the old step). Refused
        under DDP: the carry would count only this rank's batches."""
        if met_fn is not None and self.reducer is not None:
            raise ValueError("device metrics cannot fold into a DDP step; "
                             "keep the host metric path (MXNET_DDP)")
        if self._met_fn is not met_fn:
            self._met_fn = met_fn
            self._graphs.clear()

    def detach_metric(self):
        self.attach_metric(None)

    def release_graphs(self):
        """Drop every captured graph and the memory its pool holds."""
        self._graphs.clear()

    # ---------------------------------------------------- hyperparameters
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

    def hyper_rows(self, n):
        """The next ``n`` steps' hyperparameters, an ``(n, 2P + 1)`` f32
        array for P updated parameters: row i holds the update's learning
        rates at count t + i (``Optimizer.fused_lr``), the weight decays
        and rescale_grad. lr and wd are evaluated once (a schedule moves
        in steps of n), as the JAX package's run_k does."""
        lr_vec, wd_vec, rescale, t = self.hyper_peek()
        P = len(self.param_names)
        rows = _np.empty((n, 2 * P + 1), _np.float32)
        rows[:, P:2 * P] = wd_vec
        rows[:, 2 * P] = rescale
        for i in range(n):
            rows[i, :P] = self._opt.fused_lr(lr_vec, t + i)
        return rows

    def _stage(self, x):
        """A host array or tensor on the executor's device: on a card
        through pinned memory without waiting (the caching host
        allocator reuses a pinned block only once its copy is done)."""
        t = torch.from_numpy(_np.ascontiguousarray(x)) \
            if isinstance(x, _np.ndarray) else x
        if self._device.type != "cuda" or t.device == self._device:
            return t.to(self._device)
        return t.pin_memory().to(self._device, non_blocking=True)

    def commit_counts(self):
        for k in self.param_names:
            self._opt._update_count(self._name2idx[k])

    # ------------------------------------------------------------ a step
    def forward(self, feed=None, key=None):
        """The training forward under autograd -> (outputs, aux updates,
        {name: leaf}); the leaves share storage with the weights.
        ``feed`` overrides the executor's inputs, ``key`` the key drawn
        from the chain."""
        ex = self._exec
        leaves = {k: ex.arg_dict[k].detach().requires_grad_(True)
                  for k in self.param_names}
        with torch.enable_grad():
            outs, auxu = ex._run(True, self._cast(leaves, feed), key)
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
    def _apply(self, grads, opt_state, hyp):
        """Every parameter's update in place, hyperparameters read from
        ``hyp``, one row of :meth:`hyper_rows` as a tensor."""
        ex = self._exec
        P = len(self.param_names)
        lrs, wds = hyp[:P].unbind(), hyp[P:2 * P].unbind()
        rescale = hyp[2 * P]
        for k, lr, wd in zip(self.param_names, lrs, wds):
            self._update(ex.arg_dict[k], grads[k], opt_state[k], lr, wd,
                         rescale)

    def _reduced(self, grads):
        """The gradients summed over the group under DDP, else as they
        are."""
        return grads if self.reducer is None else self.reducer.reduce(grads)

    def apply(self, grads, opt_state):
        """Every parameter's update, in place; then the counts."""
        self._apply(self._reduced(grads), opt_state,
                    self._stage(self.hyper_rows(1)[0]))
        self.commit_counts()

    def _body(self, opt_state, hyp, feed=None, key=None, met_state=None,
              aux_into=None):
        """One whole step: weights, ``opt_state`` and the metric carry
        updated in place; the moving statistics copied into ``aux_into``
        (a captured graph's tensors) or else bound to the executor (no
        copy kernels on an eager step; a graph copies rebound ones back
        before it replays). The body of the per-step path, of run_k's
        loop and of its CUDA graph -> the outputs."""
        outs, auxu, leaves = self.forward(feed, key)
        grads = self._reduced(self.backward(outs, leaves))
        del leaves
        self._apply(grads, opt_state, hyp)
        ex = self._exec
        with torch.no_grad():
            for k, v in auxu.items():
                if aux_into is None:
                    ex.aux_dict[k] = v.detach()
                else:
                    aux_into[k].copy_(v)
            if met_state is not None and self._met_fn is not None:
                self._met_fn(met_state, outs, feed)
        return [o.detach() for o in outs]

    def step(self, opt_state, met_state=None):
        """One whole step on the executor's inputs -> its outputs;
        weights, ``opt_state``, the moving statistics and ``met_state``
        are updated."""
        outs = self._body(opt_state, self._stage(self.hyper_rows(1)[0]),
                          met_state=met_state)
        self.commit_counts()
        self.eager_steps += 1
        return outs

    # ---------------------------------------------------- K steps at once
    def stack_feeds(self, feeds):
        """K per-step ``{input_name: value}`` feeds -> ``{input_name:
        (K, ...) tensor}`` on the device: each value in its bound dtype,
        data inputs cast to the compute dtype BEFORE the stack (the step
        would cast each slice anyway; this halves the stacked buffer),
        stacked where the values lie and staged once to the device."""
        ex = self._exec
        cdt = self.compute_dtype
        stacked = {}
        for name in feeds[0]:
            dst = ex.arg_dict[name]
            vals = [_tensor(f[name]).to(dtype=dst.dtype).reshape(dst.shape)
                    for f in feeds]
            if cdt is not None and name in self._data_names \
                    and dst.dtype == torch.float32:
                vals = [v.to(cdt) for v in vals]
            if all(v.device == self._device for v in vals):
                stacked[name] = torch.stack(vals)
            else:
                stacked[name] = self._stage(torch.stack([v.cpu()
                                                         for v in vals]))
        return stacked

    def run_k(self, stacked, keys, opt_state, met_state=None, staged=None):
        """K fused steps: ``stacked`` the window from :meth:`stack_feeds`
        (or ``staged``, a window stacked ahead: ``{"stacked", "last",
        "ready"}`` from ``Module._stage_group``), ``keys`` K PRNG keys (a
        ``(K, 2)`` array). Weights, ``opt_state``, the moving statistics
        and ``met_state`` are updated and the optimizer's counts advanced
        K times. Returns each output stacked ``(K, ...)``, so the caller
        can update a host metric per sub-batch."""
        if staged is not None:
            stacked = self._await_staged(staged)
        keys = _np.asarray(keys, _np.int64).reshape(-1, 2)
        K = keys.shape[0]
        hyp = self._stage(self.hyper_rows(K))
        keys = self._stage(keys)
        if self._device.type == "cuda" and self.dispatch == "graph":
            outs = self._run_graph(stacked, keys, hyp, opt_state, met_state)
        else:
            per = [self._body(opt_state, hyp[i],
                              {n: v[i] for n, v in stacked.items()},
                              keys[i], met_state) for i in range(K)]
            self.eager_steps += K
            outs = [torch.stack(o) for o in zip(*per)]
        for _ in range(K):
            self.commit_counts()
        return outs

    def _await_staged(self, staged):
        """Order the current stream after a staged window's making, and
        keep the allocator from reusing its tensors (the stacked feed,
        the last batch's values) before this stream has read them."""
        ready = staged.get("ready")
        if ready is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ready)
            for v in list(staged["stacked"].values()) + [
                    _tensor(v) for v in staged["last"].values()]:
                if v.device.type == "cuda":
                    v.record_stream(cur)
        return staged["stacked"]

    def _run_graph(self, stacked, keys, hyp, opt_state, met_state):
        K = keys.shape[0]
        gkey = (tuple((n, tuple(v.shape[1:]), v.dtype)
                      for n, v in sorted(stacked.items())),
                _tier.tier(), met_state is not None)
        graph = self._graphs.get(gkey)
        out_win, start = None, 0
        if graph is None:
            graph = _StepGraph(self, stacked, opt_state, met_state)
            out_win, start = graph.warm_up(self, stacked, keys, hyp,
                                           min(_WARMUP_STEPS, K - 1))
            self.eager_steps += start
            t0 = time.perf_counter()
            graph.capture(self)
            self.capture_ms.append((time.perf_counter() - t0) * 1e3)
            self.captures += 1
            self._graphs[gkey] = graph
        graph.adopt(self._exec)
        if out_win is None:
            out_win = _window(graph.outs, K)
        for i in range(start, K):
            graph.load(stacked, keys, hyp, i)
            graph.graph.replay()
            for w, o in zip(out_win, graph.outs):
                w[i].copy_(o)
        self.replays += K - start
        return out_win


def _window(outs, K):
    """Empty ``(K, ...)`` buffers for K steps' outputs like ``outs``."""
    return [torch.empty((K,) + tuple(o.shape), dtype=o.dtype,
                        device=o.device) for o in outs]


class _StepGraph:
    """One fused step captured as a CUDA graph: static device buffers for
    its feed, key and hyperparameters (filled before each replay), the
    tensors it read and wrote when captured (weights, inputs, moving
    statistics, optimizer state, metric carry: updated in place, so every
    replay finds them where the capture did; :meth:`adopt` puts back an
    executor entry an eager step rebound) and its outputs, which each
    replay overwrites."""

    def __init__(self, fused, stacked, opt_state, met_state):
        ex = fused._exec
        self.feed = {n: torch.empty_like(v[0]) for n, v in stacked.items()}
        self.key = torch.zeros(2, dtype=torch.int64, device=fused._device)
        self.hyp = torch.zeros(2 * len(fused.param_names) + 1,
                               dtype=torch.float32, device=fused._device)
        self.args = dict(ex.arg_dict)
        self.aux = dict(ex.aux_dict)
        # the module keeps both for the FusedStep's life; a new metric
        # carry comes with a new metric function, which drops the graphs
        self.opt_state = opt_state
        self.met_state = met_state
        self.graph = torch.cuda.CUDAGraph()
        self.outs = None

    def adopt(self, ex):
        """Put back the tensors the graph reads where the executor moved
        on: a rebound input or moving statistic (a later eager forward)
        is copied into the captured tensor, which takes its place."""
        with torch.no_grad():
            for cur, mine in ((ex.arg_dict, self.args),
                              (ex.aux_dict, self.aux)):
                for k, t in mine.items():
                    if cur[k] is not t:
                        t.copy_(cur[k])
                        cur[k] = t

    def load(self, stacked, keys, hyp, i):
        """Slice i of the window into the static buffers."""
        for n, buf in self.feed.items():
            buf.copy_(stacked[n][i])
        self.key.copy_(keys[i])
        self.hyp.copy_(hyp[i])

    def body(self, fused):
        return fused._body(self.opt_state, self.hyp, self.feed, self.key,
                           self.met_state, aux_into=self.aux)

    def warm_up(self, fused, stacked, keys, hyp, n):
        """The window's first ``n`` steps, eagerly through the static
        buffers on a side stream -> (the window's output buffers, n)."""
        dev = fused._device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        out_win = None
        with torch.cuda.stream(side):
            for i in range(n):
                self.load(stacked, keys, hyp, i)
                outs = self.body(fused)
                if out_win is None:
                    out_win = _window(outs, keys.shape[0])
                for w, o in zip(out_win, outs):
                    w[i].copy_(o)
        main = torch.cuda.current_stream(dev)
        main.wait_stream(side)
        for w in out_win or ():
            # made on the side stream, used and freed on the main one
            w.record_stream(main)
        return out_win, n

    def capture(self, fused):
        """Record one step; nothing runs, so no state moves."""
        try:
            # thread-local: the input pipeline's threads may allocate or
            # synchronize their own streams while this one captures
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.outs = self.body(fused)
        except Exception as e:
            raise MXNetError(
                "run_k: capturing the fused step as a CUDA graph failed "
                "(%s: %s); something in the step reads the device from "
                "the host or copies from pageable host memory"
                % (type(e).__name__, e)) from e
