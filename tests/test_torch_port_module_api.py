"""Port parity for the Module/model/callback surface: ``Module``'s state
methods (``get_states``/``set_states``, ``reshape``, ``load``,
``save_optimizer_states`` from the fused step, ``install_monitor``),
``predict``/``iter_predict``/``score``, ``monitor.Monitor``,
``model.FeedForward``, the callbacks' log lines, ``io.MNISTIter`` and
``NDArrayIter``'s ``last_batch_handle``.

Both packages get the same ``RandomState`` inputs on the CPU (a small
MLP, batch 4). Tolerances: iterators, files and log lines exact;
forwards, predictions and trained parameters within f32
``rtol=atol=1e-5`` (the same math summed in another order by another
library); the monitor's statistics exact against ``asnumpy()`` of the
same arrays in the same package.
"""
import gzip
import logging
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

N, DIM, CLASSES, BATCH = 18, 8, 4, 4
OPT = {"learning_rate": 0.05, "momentum": 0.9}


def _mlp(sym):
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=CLASSES, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, DIM).astype(np.float32),
            rng.randint(0, CLASSES, (n,)).astype(np.float32))


def _params(seed=3):
    rng = np.random.RandomState(seed)
    shapes, _, _ = _mlp(mt.sym).infer_shape(data=(BATCH, DIM))
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(_mlp(mt.sym).list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().copy()
    return np.array(v.asnumpy(), copy=True)


def _ctx(pkg):
    return mt.cpu() if pkg is mt else mx.cpu()


def _args(pkg):
    return {k: (v if pkg is mt else mx.nd.array(v))
            for k, v in _params().items()}


def _trained(pkg, kvstore="tpu_sync", steps=None):
    X, Y = _data(16)
    mod = pkg.mod.Module(_mlp(pkg.sym), context=_ctx(pkg))
    mod.fit(pkg.io.NDArrayIter(X[:steps * BATCH] if steps else X,
                               Y[:steps * BATCH] if steps else Y,
                               batch_size=BATCH),
            num_epoch=1, optimizer="sgd", optimizer_params=dict(OPT),
            arg_params=_args(pkg), initializer=None, kvstore=kvstore,
            eval_metric=None)
    return mod


# ------------------------------------------------------------ NDArrayIter
@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarrayiter_last_batch_handle_matches(handle, shuffle):
    """Any ``last_batch_handle``: ``discard`` drops the tail, any other
    value wraps it from the epoch's start, and only ``pad`` reports the
    pad; the batches equal the JAX package's (shuffled from the same
    numpy seed)."""
    X, Y = _data(10)
    got = {}
    for pkg in (mx, mt):
        np.random.seed(4)
        it = pkg.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=shuffle,
                                last_batch_handle=handle)
        got[pkg] = [(_host(b.data[0]), _host(b.label[0]), b.pad,
                     list(b.index)) for b in it]
    assert len(got[mt]) == (2 if handle == "discard" else 3)
    for a, b in zip(got[mx], got[mt]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
    assert got[mt][-1][2] == (2 if handle == "pad" else 0)


# -------------------------------------------------------------- MNISTIter
@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_mnistiter_reads_idx_files(gz, flat, tmp_path):
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (10, 5, 6)).astype(np.uint8)
    labs = rng.randint(0, 10, (10,)).astype(np.uint8)
    op = gzip.open if gz else open
    ext = ".gz" if gz else ""
    ipath, lpath = str(tmp_path / ("i" + ext)), str(tmp_path / ("l" + ext))
    with op(ipath, "wb") as f:
        f.write(struct.pack(">IIII", 0x0803, 10, 5, 6) + imgs.tobytes())
    with op(lpath, "wb") as f:
        f.write(struct.pack(">II", 0x0801, 10) + labs.tobytes())
    got = {}
    for pkg in (mx, mt):
        it = pkg.io.MNISTIter(image=ipath, label=lpath, batch_size=4,
                              shuffle=False, flat=flat)
        got[pkg] = [(_host(b.data[0]), _host(b.label[0]), b.pad)
                    for b in it]
    assert got[mt][0][0].shape == ((4, 30) if flat else (4, 1, 5, 6))
    for a, b in zip(got[mx], got[mt]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    np.testing.assert_array_equal(got[mt][0][0].reshape(4, 5, 6),
                                  imgs[:4] / np.float32(255))


# --------------------------------------------------- predict and friends
def test_predict_iter_predict_and_score_match():
    X, Y = _data()
    got = {}
    for pkg in (mx, mt):
        mod = pkg.mod.Module(_mlp(pkg.sym), context=_ctx(pkg))
        it = pkg.io.NDArrayIter(X, Y, batch_size=BATCH)
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        mod.init_params(arg_params=_args(pkg))
        out = mod.predict(it)
        per = [[_host(o) for o in outs] for outs, _, _ in
               mod.iter_predict(it)]
        lists = mod.predict(it, merge_batches=False)
        score = mod.score(it, "acc")
        got[pkg] = (_host(out), per, [_host(b[0]) for b in lists], score)
    assert got[mt][0].shape == (N, CLASSES)
    np.testing.assert_allclose(got[mt][0], got[mx][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(got[mx][1], got[mt][1]):
        np.testing.assert_allclose(b[0], a[0], rtol=1e-5, atol=1e-5)
    assert [x.shape for x in got[mt][2]] == [x.shape for x in got[mx][2]]
    assert got[mt][3] == got[mx][3]


def test_feedforward_fit_predict_score_save_load(tmp_path):
    X, Y = _data(16)
    got = {}
    for pkg in (mx, mt):
        ff = pkg.model.FeedForward(_mlp(pkg.sym), ctx=_ctx(pkg),
                                   num_epoch=2, numpy_batch_size=BATCH,
                                   arg_params=_args(pkg), **OPT)
        it = pkg.io.NDArrayIter(X, Y, batch_size=BATCH)
        ff.fit(it)
        pred = ff.predict(X)
        outs, datas, labels = ff.predict(it, return_data=True)
        score = ff.score(it)
        prefix = str(tmp_path / pkg.__name__)
        ff.save(prefix)
        back = pkg.model.FeedForward.load(prefix, 2, ctx=_ctx(pkg))
        got[pkg] = (pred, outs, datas, labels, score, back.predict(X),
                    {k: _host(v) for k, v in ff.arg_params.items()})
    np.testing.assert_allclose(got[mt][0], got[mx][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[mt][1], got[mx][1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[mt][2], X)
    np.testing.assert_array_equal(got[mt][3], Y)
    assert got[mt][4] == pytest.approx(got[mx][4])
    np.testing.assert_array_equal(got[mt][5], got[mt][0])
    for k in got[mx][6]:
        np.testing.assert_allclose(got[mt][6][k], got[mx][6][k], rtol=1e-5,
                                   atol=1e-5)


# ----------------------------------------------------- the state surface
def test_states_reshape_and_load(tmp_path):
    """``state_names`` inputs through ``get_states``/``set_states`` (a
    kept divergence: ``value=`` fills them);
    ``reshape`` to batch 2 keeps the parameters; ``Module.load`` rebuilds
    a module over a checkpoint whose forward matches the JAX package's
    ``Module.load``."""
    X, _ = _data()
    outs = {}
    for pkg in (mx, mt):
        data = pkg.sym.Variable("data")
        st = pkg.sym.Variable("state")
        net = pkg.sym.FullyConnected(data, num_hidden=5, name="fc") + st
        mod = pkg.mod.Module(pkg.sym.Group([net]), label_names=None,
                             state_names=["state"], context=_ctx(pkg))
        mod.bind([("data", (BATCH, DIM)), ("state", (BATCH, 5))],
                 for_training=False)
        mod.init_params(pkg.init.One())
        mod.set_states(value=2.0)
        a = _host(mod.get_states()[0])
        mk = (lambda v: mt.nd.array(v, ctx=mt.cpu())) if pkg is mt \
            else mx.nd.array
        mod.set_states([mk(np.full((BATCH, 5), 3, np.float32))])
        mod.forward(pkg.io.DataBatch([mk(X[:BATCH]),
                                      mk(np.zeros((BATCH, 5), np.float32))],
                                     []), is_train=False)
        out_a = _host(mod.get_outputs()[0])
        mod.reshape([("data", (2, DIM)), ("state", (2, 5))])
        mod.forward(pkg.io.DataBatch([mk(X[:2]),
                                      mk(np.ones((2, 5), np.float32))], []),
                    is_train=False)
        out_b = _host(mod.get_outputs()[0])
        outs[pkg] = (a, out_a, out_b)
    # set_states(value=) fills the states, as the reference's does; the
    # JAX package's ignores value (its states keep their zeros)
    np.testing.assert_array_equal(outs[mt][0], 2.0)
    np.testing.assert_array_equal(outs[mx][0], 0.0)
    for x, y in zip(outs[mx][1:], outs[mt][1:]):
        np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5)
    assert outs[mt][2].shape == (2, 5)
    # Module.load over a port checkpoint, the forward against the JAX one
    prefix = str(tmp_path / "m")
    tmod = _trained(mt, steps=2)
    tmod.save_checkpoint(prefix, 1)
    fwd = {}
    for pkg in (mx, mt):
        mod = pkg.mod.Module.load(prefix, 1, context=_ctx(pkg))
        mod.bind([("data", (BATCH, DIM))], for_training=False)
        mod.forward(pkg.io.DataBatch([(mt.nd.array(X[:BATCH], ctx=mt.cpu())
                                       if pkg is mt
                                       else mx.nd.array(X[:BATCH]))], []),
                    is_train=False)
        fwd[pkg] = _host(mod.get_outputs()[0])
    np.testing.assert_allclose(fwd[mt], fwd[mx], rtol=1e-5, atol=1e-5)


def test_optimizer_states_from_the_fused_step(tmp_path):
    """``save_optimizer_states`` after fused steps writes the Updater's
    layout: the JAX package's Module loads it, its momentum equals the
    port's, the port's file equals the JAX package's after the same
    steps within 1e-5, and ``Module.load(load_optimizer_states=True)``
    puts it back into a new port Module's fused state."""
    import pickle
    tmod = _trained(mt, steps=3)
    jmod = _trained(mx, steps=3)
    assert tmod._fused is not None
    tp, jp = str(tmp_path / "t.states"), str(tmp_path / "j.states")
    tmod.save_optimizer_states(tp)
    jmod.save_optimizer_states(jp)
    ts, js = pickle.load(open(tp, "rb")), pickle.load(open(jp, "rb"))
    assert sorted(ts) == sorted(js)
    for i in ts:
        np.testing.assert_allclose(ts[i], js[i], rtol=1e-5, atol=1e-5)
    jmod.load_optimizer_states(tp)
    jmod.save_optimizer_states(jp)
    for i, v in pickle.load(open(jp, "rb")).items():
        np.testing.assert_array_equal(v, ts[i])
    prefix = str(tmp_path / "m")
    tmod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    back = mt.mod.Module.load(prefix, 3, load_optimizer_states=True,
                              context=mt.cpu())
    X, Y = _data(16)
    back.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))])
    back.init_optimizer(kvstore="tpu_sync", optimizer="sgd",
                        optimizer_params=dict(OPT))
    for i, name in enumerate(back._param_names):
        np.testing.assert_array_equal(_host(back._fused_opt_state[name][0]),
                                      ts[i])


def test_monitor_drops_the_fused_step_and_keeps_its_state():
    """``install_monitor`` after fused steps: the fused step goes, the
    momentum goes on in the Updater (the same tensors), the eager steps
    train on, and each statistic the Monitor reports equals ``asnumpy``
    of the array it names, as the JAX package's Monitor reports them."""
    tmod = _trained(mt, steps=2)
    mom = {n: tmod._fused_opt_state[n][0] for n in tmod._param_names}
    mon = mt.monitor.Monitor(1, pattern="fc.*|softmax.*", sort=True)
    tmod.install_monitor(mon)
    assert tmod._fused is None
    for i, n in enumerate(tmod._param_names):
        assert tmod._updater.states[i] is mom[n]
    X, Y = _data(8, seed=5)
    it = mt.io.NDArrayIter(X, Y, batch_size=BATCH)
    stats = []
    for b in it:
        mon.tic()
        tmod.forward_backward(b)
        tmod.update()
        res = mon.toc()
        ex = tmod._exec
        want = {n: np.abs(_host(a)).mean() for n, a in
                list(zip(ex._symbol.list_outputs(), ex.outputs))}
        for step, name, stat in res:
            if name in want:
                assert stat == want[name]
        stats.append(res)
    names = [n for _, n, _ in stats[0]]
    assert names == sorted(names) and "softmax_output" in names
    assert "fc1_weight" in names and "data" not in names
    # the JAX package's Monitor names the same arrays
    jmod = _trained(mx, steps=2)
    jmon = mx.monitor.Monitor(1, pattern="fc.*|softmax.*", sort=True)
    jmod.install_monitor(jmon)
    jmon.tic()
    jmod.forward_backward(next(iter(mx.io.NDArrayIter(X, Y,
                                                      batch_size=BATCH))))
    jmod.update()
    assert [n for _, n, _ in jmon.toc()] == names


# ------------------------------------------------------------- callbacks
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _lines(pkg, monkeypatch, caplog):
    monkeypatch.setattr(pkg.callback.time, "time", _Clock())
    metric = pkg.metric.create("acc")
    metric.update([pkg.nd.array(np.array([0, 1], np.float32))],
                  [pkg.nd.array(np.array([[0.9, 0.1], [0.2, 0.8]],
                                         np.float32))])
    cbs = [pkg.callback.Speedometer(4, 2, auto_reset=False),
           pkg.callback.Speedometer(4, 2),
           pkg.callback.log_train_metric(2),
           pkg.callback.ProgressBar(6, length=10)]
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for nbatch in range(6):
            for cb in cbs:
                cb(pkg.model.BatchEndParam(epoch=1, nbatch=nbatch,
                                           eval_metric=metric,
                                           locals=None))
            cbs[0](pkg.model.BatchEndParam(1, nbatch, None, None))
    return [r.getMessage() for r in caplog.records]


def test_callback_lines_match(monkeypatch, caplog):
    with mt.cpu():
        want = _lines(mx, monkeypatch, caplog)
        got = _lines(mt, monkeypatch, caplog)
    assert got == want and len(got) > 10
    assert any("Speed: " in g for g in got)


def test_checkpoint_callbacks_write_the_files(tmp_path):
    mod = _trained(mt, steps=1)
    arg, aux = mod.get_params()
    mt.callback.do_checkpoint(str(tmp_path / "a"), period=2)(
        1, mod.symbol, arg, aux)
    mt.callback.module_checkpoint(mod, str(tmp_path / "b"), 1, True)(0)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["a-0002.params", "a-symbol.json", "b-0001.params",
                     "b-0001.states", "b-symbol.json"]
    _, jarg, _ = mx.model.load_checkpoint(str(tmp_path / "a"), 2)
    for k in arg:
        np.testing.assert_array_equal(jarg[k].asnumpy(), _host(arg[k]))


def _fit_lines(pkg, monkeypatch, caplog, k):
    """``fit`` for 2 epochs of 16 samples (4 batches) with
    ``Speedometer(4, 2)`` (auto_reset) and metric acc at
    ``steps_per_dispatch=k`` -> the Speedometer's and the epochs' metric
    lines, speeds cut out."""
    monkeypatch.setattr(pkg.callback.time, "time", _Clock())
    X, Y = _data(16)
    mod = pkg.mod.Module(_mlp(pkg.sym), context=_ctx(pkg))
    caplog.clear()
    with caplog.at_level(logging.INFO):
        mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=BATCH), num_epoch=2,
                optimizer="sgd", optimizer_params=dict(OPT),
                arg_params=_args(pkg), initializer=None,
                kvstore="tpu_sync", eval_metric="acc",
                batch_end_callback=pkg.callback.Speedometer(BATCH, 2),
                steps_per_dispatch=k)
    out = []
    for r in caplog.records:
        m = r.getMessage()
        if "Speed" in m or "Train-" in m:
            out.append(m.split("\tSpeed")[0] + m.split("samples/sec")[-1]
                       if "Speed" in m else m)
    return out


@pytest.mark.parametrize("k", [1, 4])
def test_speedometer_auto_reset_over_grouped_steps_matches(monkeypatch,
                                                           caplog, k):
    """R7: at ``steps_per_dispatch`` K > 1 the callbacks of a window fire
    after its K steps, so ``Speedometer(auto_reset=True)`` resets a
    metric that already holds the whole window, and an epoch that ends
    inside the window reads ``Train-accuracy=nan``: the JAX package's
    behaviour, kept."""
    with mt.cpu():
        want = _fit_lines(mx, monkeypatch, caplog, k)
        got = _fit_lines(mt, monkeypatch, caplog, k)
    assert got == want and len(got) == 4
    assert ("nan" in got[1]) == (k > 1)
