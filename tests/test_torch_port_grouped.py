"""Port parity for grouped dispatch in ``Module.fit``: ``steps_per_dispatch``
and the automatic K, ``FusedStep.run_k``, the device-resident metric
(``device_metric``) and the bounded in-flight queue (``engine``).

Both packages get the same numpy inputs on the CPU (the JAX package's
Pallas kernels in interpret mode where tier auto reaches them, the
port's kernels as their plain versions). On the CPU ``run_k`` is a loop
over the eager step, the plain version of the CUDA graph the card
replays; ``tests/test_torch_port_gpu.py`` holds the graph against it.

Tolerances, each beside its test:
- port grouped against the JAX package's grouped fit: the small MLP
  with BatchNorm of ``tests/test_module_fused.py`` at that file's
  grouped tolerance, rtol 2e-5 and atol 2e-6 for SGD with momentum and
  rtol 2e-4, atol 2e-6 for Adam (the JAX package's own grouped-vs-
  per-step Adam bound); the GPT of ``tests/test_torch_port_train.py``
  cut to one layer at that file's per-step fit tolerances (outputs rtol
  1e-4, atol 1e-5; parameters atol 1e-5);
- port grouped against port per step: bitwise (the same arithmetic in
  the same order, one key an inner step);
- device metric against the host path: accuracy and top-k exact, the
  f32 sums of CE, NLL and loss within rtol 1e-5 of the host's float64;
- the key chain after a grouped run: bitwise the JAX package's.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import engine as tengine

N, DIM, CLASSES, BATCH = 64, 8, 4, 16


def _mlp(sym, bn=True, dropout=0.0):
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    if bn:
        net = sym.BatchNorm(net, name="bn1")
    net = sym.Activation(net, act_type="relu")
    if dropout:
        net = sym.Dropout(net, p=dropout)
    net = sym.FullyConnected(net, num_hidden=CLASSES, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, DIM).astype(np.float32)
    Y = rng.randint(0, CLASSES, (n,)).astype(np.float32)
    return X, Y


def _params(sym, seed=3):
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=(BATCH, DIM))
    return {name: rng.uniform(-0.1, 0.1, shp).astype(np.float32)
            for name, shp in zip(sym.list_arguments(), shapes)
            if name not in ("data", "softmax_label")}


def _np(v):
    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, dtype=np.float32, copy=True)


def _state(mod):
    args, aux = mod.get_params()
    return {k: _np(v) for k, v in {**args, **aux}.items()}


def _quiet(mod):
    import logging
    log = logging.getLogger("grouped_test")
    log.addHandler(logging.NullHandler())
    log.propagate = False
    mod.logger = log
    return mod


def _fit(pkg, k, opt="sgd", opt_params=None, n=N, num_epoch=3,
         eval_metric=None, cb=None, sym_fn=_mlp, seed=7, **kw):
    """Each package's Module.fit on the MLP from fixed numpy weights."""
    sym = sym_fn(pkg.sym)
    X, Y = _data(n)
    it = pkg.io.NDArrayIter(X, Y, batch_size=BATCH,
                            label_name="softmax_label")
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    mod = _quiet(pkg.mod.Module(sym, context=ctx))
    args = _params(sym)
    pkg.random.seed(seed)
    mod.fit(it, num_epoch=num_epoch, kvstore="tpu_sync", optimizer=opt,
            optimizer_params=opt_params or {"learning_rate": 0.1,
                                            "momentum": 0.9},
            arg_params={k_: (mx.nd.array(v) if pkg is mx else v)
                        for k_, v in args.items()},
            initializer=None, eval_metric=eval_metric,
            steps_per_dispatch=k, batch_end_callback=cb, **kw)
    return mod


def _close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------- against the JAX package
# Adam at epsilon 1e-4: the BatchNorm after fc1 makes fc1's bias
# gradient exactly zero, which comes out as float noise, and Adam at the
# default epsilon moves such an element by up to lr whichever way the
# noise points (tests/test_torch_port_train.py's docstring)
ADAM = {"learning_rate": 0.01, "epsilon": 1e-4}
CASES = [("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 4, 64, 2e-5),
         ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 2, 80, 2e-5),
         ("adam", ADAM, 4, 64, 2e-4),
         ("adam", ADAM, 2, 80, 2e-4)]


@pytest.mark.parametrize("opt,params,k,n,rtol", CASES,
                         ids=["%s-k%d-n%d" % (c[0], c[2], c[3])
                              for c in CASES])
def test_grouped_fit_matches_the_jax_package(opt, params, k, n, rtol):
    """K = 4 over 4 batches an epoch (one window), and K = 2 over 5 (two
    windows and a one-batch tail), 3 epochs; weights and moving
    statistics at the JAX test's grouped tolerances."""
    want = _state(_fit(mx, k, opt, params, n=n))
    mod = _fit(mt, k, opt, params, n=n)
    assert mod._fused is not None
    assert mod._fused.eager_steps == 3 * (n // BATCH)
    _close(_state(mod), want, rtol=rtol, atol=2e-6)


V, C, H, T, B = 96, 128, 4, 32, 2


def _gpt(sym):
    return mt.models.gpt_lm(V, C, H, 1, T, sym=sym)


def test_grouped_gpt_fit_matches_the_jax_package():
    """The GPT of test_torch_port_train.py cut to one layer, Adam, tier
    off, K = 2 over 5 batches (two windows and a tail): outputs of the
    last step and every parameter at the per-step fit tolerances."""
    rng = np.random.RandomState(0)
    xs, ys = zip(*[mt.models.make_copy_batch(rng, B, T, V, 5)
                   for _ in range(5)])
    X, Y = np.concatenate(xs), np.concatenate(ys)
    opt = {"learning_rate": 1e-3, "wd": 0.01, "epsilon": 1e-4}
    with jconfig.override(kernel_tier="off"):
        jmod = _quiet(mx.mod.Module(_gpt(mx.sym), context=mx.cpu()))
        jmod.bind([("data", (B, T))], [("softmax_label", (B, T))])
        np.random.seed(0)
        jmod.init_params(mx.initializer.Xavier())
        args0 = {k: _np(v) for k, v in jmod.get_params()[0].items()}
        jmod.fit(mx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                 kvstore="tpu_sync", optimizer="adam", optimizer_params=opt,
                 eval_metric=None, steps_per_dispatch=2)
        want_out = _np(jmod.get_outputs()[0])
        want = {k: _np(v) for k, v in jmod.get_params()[0].items()}
    net = _gpt(mt.sym)
    args, _ = mt.serving.params_from_reference(
        args0, {}, net, "cpu", data_shapes={"data": (B, T)})
    with mt.config.override(kernel_tier="off"):
        mod = _quiet(mt.mod.Module(net, context=mt.cpu()))
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                kvstore="tpu_sync", optimizer="adam", optimizer_params=opt,
                arg_params=args, eval_metric=None, steps_per_dispatch=2)
    np.testing.assert_allclose(_np(mod.get_outputs()[0]), want_out,
                               rtol=1e-4, atol=1e-5)
    got = {k: _np(v) for k, v in mod.get_params()[0].items()}
    _close(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------- grouped vs per step
@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3})])
@pytest.mark.parametrize("k,n", [(4, 64), (2, 80)])
def test_grouped_equals_per_step_bitwise(opt, params, k, n):
    per = _fit(mt, 1, opt, params, n=n)
    grp = _fit(mt, k, opt, params, n=n)
    _equal(_state(grp), _state(per))
    np.testing.assert_array_equal(_np(grp.get_outputs()[0]),
                                  _np(per.get_outputs()[0]))
    assert grp._optimizer.num_update == per._optimizer.num_update == \
        3 * (n // BATCH)


def test_grouped_gpt_equals_per_step_bitwise_at_tier_auto():
    """The cut GPT at tier auto (the plain versions of B2, B3 and B5 in
    the step), Adam: K = 4 against K = 1."""
    rng = np.random.RandomState(1)
    xs, ys = zip(*[mt.models.make_copy_batch(rng, B, T, V, 5)
                   for _ in range(4)])
    X, Y = np.concatenate(xs), np.concatenate(ys)
    runs = []
    for k in (1, 4):
        mod = _quiet(mt.mod.Module(_gpt(mt.sym), context=mt.cpu()))
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1,
                kvstore="tpu_sync", optimizer="adam",
                optimizer_params={"learning_rate": 1e-3, "wd": 0.01},
                initializer=mt.init.Xavier(seed=0), eval_metric=None,
                steps_per_dispatch=k)
        runs.append(_state(mod))
    _equal(runs[1], runs[0])


def test_callbacks_fire_once_per_batch_in_order():
    """K = 2 over 5 batches, 2 epochs: every batch's callback, in order,
    after its group, with the fit frame's data_batch the batch's own."""
    seen = []
    X, _ = _data(80)

    def cb(p):
        seen.append((p.epoch, p.nbatch,
                     _np(p.locals["data_batch"].data[0])[0, 0]))
    _fit(mt, 2, n=80, num_epoch=2, cb=cb)
    assert [(e, i) for e, i, _ in seen] == \
        [(e, i) for e in range(2) for i in range(5)]
    assert [x for _, _, x in seen] == [X[i * BATCH, 0] for i in range(5)] * 2


def test_host_metric_per_sub_batch_equals_per_step():
    """With the metric on the host (device metrics off), the grouped
    loop replays it per sub-batch: where a group ends (K = 2 over 5
    batches: after batches 1, 3 and the tail's 4) the callback reads the
    per-step loop's value exactly (callbacks fire after their group, so
    inside a group they see the whole group's metric, as in the JAX
    package)."""
    vals = {}
    for k in (1, 2):
        seen = []
        m = mt.metric.create(["acc", "ce"])
        with mt.config.override(device_metrics=False):
            mod = _fit(mt, k, n=80, num_epoch=2, eval_metric=m,
                       cb=lambda p: seen.append(
                           tuple(p.eval_metric.get_name_value())))
        assert mod._device_plan is None
        vals[k] = seen
    ends = [i for i in range(10) if i % 5 in (1, 3, 4)]
    assert len(vals[1]) == len(vals[2]) == 10
    assert [vals[2][i] for i in ends] == [vals[1][i] for i in ends]


def test_device_metric_grouped_equals_per_step():
    vals = {}
    for k in (1, 4):
        m = mt.metric.create(["acc", "ce"])
        mod = _fit(mt, k, eval_metric=m)
        assert mod._device_plan is not None
        vals[k] = m.get_name_value()
    assert vals[4] == vals[1]


def _chosen_k(pkg, monkeypatch, **kw):
    """The K fit picks: the largest group it hands to _fit_group, 1 when
    it never groups."""
    sizes = []
    sym = _mlp(pkg.sym)
    mod = _quiet(pkg.mod.Module(sym, context=(mt.cpu() if pkg is mt
                                              else mx.cpu())))
    real = mod._fit_group

    def spy(batches, *a, **k):
        sizes.append(len(batches))
        return real(batches, *a, **k)
    monkeypatch.setattr(mod, "_fit_group", spy)
    X, Y = _data(128)
    args = _params(sym)
    opt_params = dict(kw.pop("opt_params", {"learning_rate": 0.1}))
    if kw.pop("scheduler", False):
        opt_params["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(
            step=2, factor=0.5)
    flag = kw.pop("device_metrics", True)
    over = jconfig.override if pkg is mx else mt.config.override
    with over(steps_per_dispatch=4, device_metrics=flag):
        mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=BATCH,
                                   label_name="softmax_label"),
                num_epoch=1, optimizer="sgd", optimizer_params=opt_params,
                arg_params={k_: (mx.nd.array(v) if pkg is mx else v)
                            for k_, v in args.items()},
                initializer=None, **kw)
    return max(sizes) if sizes else 1


AUTO = {"metric None": dict(eval_metric=None, kvstore="tpu_sync"),
        "acc": dict(eval_metric="acc", kvstore="tpu_sync"),
        "composite": dict(eval_metric=["acc", "ce", "loss"],
                          kvstore="tpu_sync"),
        "perplexity": dict(eval_metric="perplexity", kvstore="tpu_sync"),
        "device metrics off": dict(eval_metric="acc", kvstore="tpu_sync",
                                   device_metrics=False),
        "batch_end_callback": dict(eval_metric=None, kvstore="tpu_sync",
                                   batch_end_callback=lambda p: None),
        "lr_scheduler": dict(eval_metric=None, kvstore="tpu_sync",
                             scheduler=True),
        "local kvstore": dict(eval_metric=None, kvstore="local")}


@pytest.mark.parametrize("case", list(AUTO))
def test_automatic_k_matches_the_jax_package(case, monkeypatch):
    want = _chosen_k(mx, monkeypatch, **dict(AUTO[case]))
    got = _chosen_k(mt, monkeypatch, **dict(AUTO[case]))
    assert got == want
    assert got == (4 if case in ("metric None", "acc", "composite") else 1)


def _module(pkg):
    return pkg.mod.Module(_mlp(pkg.sym),
                          context=mt.cpu() if pkg is mt else mx.cpu())


def _no_group(pkg):
    """A module without a grouped step (the same class name in both
    packages, for the message)."""
    return type("NoGroup", (pkg.mod.BaseModule,), {})()


EXPLICIT = {"k 0": (_module, dict(steps_per_dispatch=0)),
            "k -1": (_module, dict(steps_per_dispatch=-1)),
            "no grouped step": (_no_group, dict(steps_per_dispatch=4)),
            "sparse_row_id_fn": (_module,
                                 dict(steps_per_dispatch=4,
                                      sparse_row_id_fn=lambda b: {})),
            "monitor": (_module, dict(steps_per_dispatch=2,
                                      monitor=object()))}


@pytest.mark.parametrize("case", list(EXPLICIT))
def test_explicit_k_errors_match_the_jax_package(case):
    """An explicit K is checked before anything is bound, with the JAX
    package's ValueError and message."""
    make, kw = EXPLICIT[case]
    msgs = []
    for pkg in (mx, mt):
        mod = make(pkg)
        X, Y = _data(16)
        with pytest.raises(ValueError) as err:
            mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=BATCH,
                                       label_name="softmax_label"),
                    num_epoch=1, **kw)
        assert not mod.binded
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------- the metric
METRICS = {"acc": lambda: mt.metric.Accuracy(),
           "top_k": lambda: mt.metric.TopKAccuracy(top_k=2),
           "ce": lambda: mt.metric.CrossEntropy(),
           "nll": lambda: mt.metric.NegativeLogLikelihood(),
           "loss": lambda: mt.metric.Loss(),
           "composite": lambda: mt.metric.create(
               ["acc", "ce", mt.metric.TopKAccuracy(top_k=3)])}


@pytest.mark.parametrize("name", list(METRICS))
def test_device_metric_matches_the_host_path(name):
    """The same fit (K = 4) with the metric on the device and on the
    host: counts exact, f32 sums against float64 within rtol 1e-5."""
    m_dev, m_host = METRICS[name](), METRICS[name]()
    dev = _fit(mt, 4, eval_metric=m_dev, num_epoch=2)
    assert dev._device_plan is not None
    with mt.config.override(device_metrics=False):
        host = _fit(mt, 4, eval_metric=m_host, num_epoch=2)
    assert host._device_plan is None
    got, want = dict(m_dev.get_name_value()), dict(m_host.get_name_value())
    assert sorted(got) == sorted(want)
    for k in want:
        if "acc" in k:
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _equal(_state(dev), _state(host))


def test_device_metric_matches_the_jax_packages():
    m_j = mx.metric.create(["acc", "ce", "loss"])
    m_t = mt.metric.create(["acc", "ce", "loss"])
    _fit(mx, 4, eval_metric=m_j, num_epoch=2)
    _fit(mt, 4, eval_metric=m_t, num_epoch=2)
    got, want = dict(m_t.get_name_value()), dict(m_j.get_name_value())
    assert sorted(got) == sorted(want)
    assert got["accuracy"] == want["accuracy"]
    for k in ("cross-entropy", "loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_unsupported_metric_falls_back_to_the_host():
    """Perplexity has no device form: fit keeps the host path (and, with
    no explicit K, one step a dispatch), as the JAX package does."""
    m = mt.metric.Perplexity()
    mod = _fit(mt, None, eval_metric=m)
    assert mod._device_plan is None
    assert mod._fused.eager_steps == 3 * (N // BATCH)
    assert m.num_inst == N   # the last epoch's labels, counted on the host


def test_device_metric_reads_publish_once_per_change():
    """A read copies the carry to the host once; reads with no step in
    between copy nothing more; reset zeros it on both sides."""
    m = mt.metric.Accuracy()
    mod = _fit(mt, 4, eval_metric=m, num_epoch=1)
    calls = []
    real = mod._publish_device_metric
    mod._publish_device_metric = lambda: (calls.append(1), real())[1]
    proxy = mod._device_proxy
    proxy.get(), proxy.get(), proxy.num_inst
    assert len(calls) <= 1 and m.num_inst == N
    proxy.reset()
    assert proxy.get_name_value()[0][0] == "accuracy"
    assert proxy.num_inst == 0 and m.num_inst == 0


# ------------------------------------------------------- the queue, keys
@pytest.mark.parametrize("k", [1, 4])
def test_engine_depths_are_bitwise_equal(k):
    """Depth 0 (unbounded), 1 (lockstep) and 2 train the same bits, with
    the same device metric: depth moves when the host waits, not what is
    computed."""
    runs = []
    for depth in (0, 1, 2):
        m = mt.metric.create("acc")
        with mt.config.override(engine_depth=depth):
            mod = _fit(mt, k, eval_metric=m)
        runs.append((_state(mod), m.get_name_value()))
    for state, vals in runs[1:]:
        _equal(state, runs[0][0])
        assert vals == runs[0][1]


def test_depth_controller_bounds_nothing_on_the_cpu():
    ctl = tengine.DepthController(depth=1)
    for _ in range(3):
        ctl.admit([torch.zeros(2)])
    assert ctl._inflight == []
    ctl.quiesce()
    assert tengine.DepthController().depth == mt.config.flags.engine_depth


def _dropout_net(sym):
    return _mlp(sym, bn=False, dropout=0.5)


def test_dropout_grouped_equals_per_step_and_the_jax_package():
    """An MLP with Dropout(0.5): grouped (K = 4, the keys staged as
    tensors) against per step, bitwise, so no mask repeats; the key
    chain after the grouped run is the JAX package's after its run_k,
    and the weights are the JAX package's (the same masks)."""
    runs = {}
    for k in (1, 4):
        mod = _fit(mt, k, sym_fn=_dropout_net, num_epoch=2)
        runs[k] = (_state(mod), mt.random.get_state()[0].copy())
    _equal(runs[4][0], runs[1][0])
    np.testing.assert_array_equal(runs[4][1], runs[1][1])
    jmod = _fit(mx, 4, sym_fn=_dropout_net, num_epoch=2)
    np.testing.assert_array_equal(
        runs[4][1], np.asarray(mx.random.get_state()[0], np.uint32))
    _close(runs[4][0], _state(jmod), rtol=2e-5, atol=2e-6)


def test_tensor_keys_draw_the_host_keys_bits():
    """A key staged as an int64 tensor folds, splits and draws exactly
    as the same key on the host."""
    from mxnet_tpu_torch import random as trandom
    key = trandom.prng_key(11)
    tkey = torch.as_tensor(key.astype(np.int64))
    np.testing.assert_array_equal(trandom.fold_in(tkey, 5).numpy(),
                                  trandom.fold_in(key, 5).astype(np.int64))
    np.testing.assert_array_equal(trandom.split(tkey, 3).numpy(),
                                  trandom.split(key, 3).astype(np.int64))
    for fn in (lambda k: trandom.uniform(k, (5, 7)),
               lambda k: trandom.bernoulli(k, 0.3, (64,)),
               lambda k: trandom.normal(k, (9,)),
               lambda k: trandom.randint(k, (6,), -3, 90)):
        np.testing.assert_array_equal(fn(tkey).numpy(), fn(key).numpy())


# ----------------------------------------------------- capture rehearsal
class _HostReads(TorchDispatchMode):
    """Records the ops a captured CUDA graph cannot hold: a read of a
    device value on the host (``item``, ``float()``, ``bool()``),
    ``nonzero`` (its size is data), and a tensor made from host data
    (``torch.tensor``, ``as_tensor``: a copy from the host)."""

    BAD = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh",
           "aten.item")

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.BAD):
            self.found.append(name)
        return func(*args, **(kwargs or {}))


STEPS = {"resnet bf16": (lambda: mt.models.resnet(
             num_layers=20, num_classes=10, image_shape=(3, 8, 8)),
         (2, 3, 8, 8), 10, "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                   "multi_precision": True}),
         "gpt": (lambda: _gpt(mt.sym), (B, T), V, "adam",
                 {"learning_rate": 1e-3}),
         "dropout": (lambda: _dropout_net(mt.sym), (BATCH, DIM), CLASSES,
                     "sgd", {"learning_rate": 0.1})}


@pytest.mark.parametrize("case", list(STEPS))
def test_the_grouped_step_reads_nothing_back(case):
    """The body run_k captures on the card, rehearsed on the CPU at tier
    auto with a metric carry: no op of the forward, the backward, the
    update, the aux copy or the metric reads the device from the host
    or makes a tensor from host data, so the capture can hold it."""
    make, shape, ncls, opt, params = STEPS[case]
    sym = make()
    rng = np.random.RandomState(0)
    X = (rng.randint(0, ncls, shape) if case == "gpt"
         else rng.randn(*shape)).astype(np.float32)
    Y = rng.randint(0, ncls, shape if case == "gpt" else shape[:1]) \
        .astype(np.float32)
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind([("data", X.shape)], [("softmax_label", Y.shape)])
    mod.init_params(mt.init.Xavier(seed=0))
    mod.init_optimizer(kvstore="tpu_sync", optimizer=opt,
                       optimizer_params=params)
    proxy = mod._engage_device_metric(mt.metric.create(
        "acc" if case != "gpt" else "loss"))
    assert proxy is not None
    fused = mod._fused
    batches = [mt.io.DataBatch([torch.from_numpy(X)], [torch.from_numpy(Y)])
               for _ in range(2)]
    stacked = fused.stack_feeds([mod._feed(b) for b in batches])
    keys = fused._stage(np.stack([mt.random.next_key()] * 2)
                        .astype(np.int64))
    hyp = fused._stage(fused.hyper_rows(2))
    feed = {n: v[0] for n, v in stacked.items()}
    with _HostReads() as mode:
        outs = fused._body(mod._fused_opt_state, hyp[0], feed, keys[0],
                           mod._fused_met_state)
    assert mode.found == []
    assert all(torch.isfinite(o.float()).all() for o in outs)
