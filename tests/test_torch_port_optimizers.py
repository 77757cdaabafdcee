"""Port parity: the optimizer surface and the eager entry points against
the JAX package's.

* the ten optimizers ``NAG``, ``AdaDelta``, ``RMSProp`` (plain and
  centered), ``Ftrl``, ``Signum``, ``SignSGD``, ``FTML``, ``Nadam``,
  ``DCASGD`` and ``LBSGD``: three updates of two parameters through each
  package's ``Updater`` from the same weights and gradients, in f32 and
  with ``multi_precision`` on f16 weights (every JAX class takes it
  through its base class), and their ``fused_ops`` against the eager
  update; f32 ``rtol 1e-5, atol 1e-6`` (the same formulas, rounded
  alike but for the transcendental steps and LBSGD's norms), f16 within
  one f16 ulp of the JAX weights (``rtol 1e-3``);
* the update ops through ``nd.<op>(..., out=)``, in place as
  ``invoke(out=)`` writes: ``rtol 1e-6, atol 1e-7``;
* the seven metrics on the same labels and predictions: ``rtol 1e-6``;
* ``MSRAPrelu`` (after ``numpy.random.seed`` on the JAX side, the same
  ``RandomState`` seed on the port's) and ``Bilinear``: bitwise;
* ``Block.summary``'s text, ``Parameter.reset_ctx`` and
  ``ParameterDict.reset_ctx``, ``nd.imperative_invoke``,
  ``autograd.set_recording``/``set_training``: exact.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

F32 = dict(rtol=1e-5, atol=1e-6)

OPTIMIZERS = {
    "nag": {"momentum": 0.9, "wd": 0.01},
    "adadelta": {"rho": 0.9, "wd": 0.01},
    "rmsprop": {"learning_rate": 0.01, "clip_weights": 0.9},
    "rmsprop_centered": {"learning_rate": 0.01, "centered": True},
    "ftrl": {"wd": 0.01},
    "signum": {"wd": 0.01, "wd_lh": 0.01},
    "signsgd": {"wd": 0.01},
    "ftml": {"wd": 0.01},
    "nadam": {"wd": 0.01},
    "dcasgd": {"momentum": 0.9, "wd": 0.01},
    "lbsgd": {"momentum": 0.9, "wd": 0.01, "learning_rate": 0.1},
}


def _create(pkg, key, **extra):
    name = key.split("_")[0]
    return pkg.optimizer.create(name, rescale_grad=0.5, clip_gradient=0.8,
                                **OPTIMIZERS[key], **extra)


def _weights(dtype):
    rng = np.random.RandomState(0)
    return [rng.randn(4, 3).astype(dtype), rng.randn(5).astype(dtype)]


def _grads(step, dtype):
    rng = np.random.RandomState(10 + step)
    return [rng.randn(4, 3).astype(dtype), rng.randn(5).astype(dtype)]


def _updates(pkg, key, dtype, mp):
    up = pkg.optimizer.get_updater(_create(pkg, key, multi_precision=mp))
    if pkg is mt:
        ws = [torch.from_numpy(w) for w in _weights(dtype)]
    else:
        ws = [mx.nd.array(w, dtype=dtype) for w in _weights(dtype)]
    for step in range(3):
        for i, (w, g) in enumerate(zip(ws, _grads(step, dtype))):
            up(i, torch.from_numpy(g) if pkg is mt
               else mx.nd.array(g, dtype=dtype), w)
    return [w.numpy() if pkg is mt else w.asnumpy() for w in ws], up


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "f16_mp"])
@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_optimizer_updates_match(key, mp):
    dtype = np.float16 if mp else np.float32
    want, jup = _updates(mx, key, dtype, mp)
    got, tup = _updates(mt, key, dtype, mp)
    tol = dict(rtol=1e-3, atol=1e-3) if mp else F32
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32), **tol)
    # the states have the JAX package's structure
    assert set(tup.states) == set(jup.states)
    for k in jup.states:
        js, ts = jup.states[k], tup.states[k]
        assert type(js) is type(ts) or (js is None) == (ts is None)
        if isinstance(js, tuple):
            assert len(js) == len(ts)


@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_fused_form_matches_the_eager_update(key):
    """Where the port has a fused form, one update through it equals the
    eager update; FTML, Nadam, DCASGD and LBSGD have none."""
    opt = _create(mt, key)
    fused = opt.fused_ops()
    if key in ("ftml", "nadam", "dcasgd", "lbsgd"):
        assert fused is None
        return
    init, upd = fused
    w0, g = _weights(np.float32)[0], _grads(0, np.float32)[0]
    w_eager = torch.from_numpy(w0.copy())
    mt.optimizer.get_updater(opt)(0, torch.from_numpy(g), w_eager)
    w_fused = torch.from_numpy(w0.copy())
    state = init(w_fused)
    upd(w_fused, torch.from_numpy(g), state,
        torch.tensor(opt._get_lr(0), dtype=torch.float32),
        torch.tensor(opt._get_wd(0), dtype=torch.float32),
        torch.tensor(opt.rescale_grad, dtype=torch.float32))
    np.testing.assert_allclose(w_fused.numpy(), w_eager.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_create_names_match():
    for name in ("nag", "adadelta", "rmsprop", "ftrl", "signum", "signsgd",
                 "ftml", "nadam", "dcasgd", "lbsgd"):
        assert type(mt.optimizer.create(name)).__name__ \
            == type(mx.optimizer.create(name)).__name__
    assert issubclass(mt.optimizer.LBSGD, mt.optimizer.SGD)
    assert issubclass(mt.optimizer.SignSGD, mt.optimizer.Signum)


@pytest.mark.parametrize("op,n_states,params", [
    ("sgd_update", 0, {"lr": 0.1, "wd": 0.01}),
    ("sgd_mom_update", 1, {"lr": 0.1, "momentum": 0.9}),
    ("adam_update", 2, {"lr": 0.01}),
    ("ftml_update", 3, {"lr": 0.01, "t": 3})])
def test_update_ops_write_out_in_place(op, n_states, params):
    rng = np.random.RandomState(4)
    arrays = [rng.randn(3, 2).astype(np.float32)
              for _ in range(2 + n_states)]
    arrays[2:] = [np.abs(a) for a in arrays[2:]]
    outs = {}
    for pkg in (mx, mt):
        with (mt.cpu() if pkg is mt else mx.cpu()):
            nds = [pkg.nd.array(a) for a in arrays]
            targets = [nds[0]] + nds[2:]
            getattr(pkg.nd, op)(*nds, out=targets[0] if not n_states
                                else targets, **params)
            outs[pkg] = [t.asnumpy() for t in targets]
    for g, w in zip(outs[mt], outs[mx]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    assert not np.allclose(outs[mt][0], arrays[0])


# ---------------------------------------------------------------- metrics
def _metric_data():
    rng = np.random.RandomState(2)
    labels = [rng.randint(0, 2, (8,)).astype(np.float32) for _ in range(2)]
    probs = [rng.rand(8, 2).astype(np.float32) for _ in range(2)]
    reg = [rng.randn(6, 1).astype(np.float32) for _ in range(2)]
    return labels, probs, reg


@pytest.mark.parametrize("name", ["f1", "mcc", "mae", "mse", "rmse",
                                  "pearsonr", "custom"])
def test_metrics_match(name):
    labels, probs, reg = _metric_data()
    got = {}
    for pkg in (mx, mt):
        if name == "custom":
            m = pkg.metric.create(lambda l, p: float(np.abs(l - p).sum()))
            m2 = pkg.metric.np(lambda l, p: (float(l.sum()), 2))
        else:
            m, m2 = pkg.metric.create(name), None
        for step in range(2):
            if name in ("f1", "mcc"):
                m.update([labels[step]], [probs[step]])
            else:
                m.update([reg[step][:, 0]], [reg[1 - step]])
            if m2 is not None:
                m2.update([reg[step]], [reg[1 - step]])
        got[pkg] = [m.get()] + ([m2.get()] if m2 is not None else [])
    for (gn, gv), (wn, wv) in zip(got[mt], got[mx]):
        assert gn == wn
        np.testing.assert_allclose(gv, wv, rtol=1e-6)


# ---------------------------------------------------------- initializers
def test_msraprelu_and_bilinear_match():
    np.random.seed(5)
    w = mx.nd.zeros((6, 4, 3, 3))
    mx.init.MSRAPrelu(factor_type="in", slope=0.1)(
        mx.init.InitDesc("c_weight"), w)
    t = torch.zeros(6, 4, 3, 3)
    mt.init.MSRAPrelu(factor_type="in", slope=0.1, seed=5)(
        mt.init.InitDesc("c_weight"), t)
    np.testing.assert_array_equal(t.numpy(), w.asnumpy())
    b = mx.nd.zeros((2, 1, 4, 6))
    mx.init.Bilinear()(mx.init.InitDesc("up_weight"), b)
    tb = torch.zeros(2, 1, 4, 6)
    mt.init.Bilinear()(mt.init.InitDesc("up_weight"), tb)
    np.testing.assert_array_equal(tb.numpy(), b.asnumpy())
    assert type(mt.init.create("msraprelu")).__name__ == "MSRAPrelu"


# ------------------------------------------------------ eager entry points
def _dense_net(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(5, activation="relu", in_units=3))
        net.add(pkg.gluon.nn.Dense(2, in_units=5))
    net.initialize(ctx=mt.cpu() if pkg is mt else mx.cpu())
    return net


def test_summary_text_matches(capsys):
    x = np.ones((2, 3), np.float32)
    want = _dense_net(mx).summary(mx.nd.array(x))
    with mt.cpu():
        got = _dense_net(mt).summary(mt.nd.array(x))
    assert got == want
    assert "Total params: 32" in got
    assert got in capsys.readouterr().out


def test_reset_ctx_moves_data_and_resets_grad():
    with mt.cpu():
        net = _dense_net(mt)
        params = net.collect_params()
        before = {k: p.data().asnumpy() for k, p in params.items()}
        p0 = params[sorted(params.keys())[0]]
        p0.grad()[:] = 1.0
        params.reset_ctx(mt.cpu())
        assert all(np.array_equal(p.data().asnumpy(), before[k])
                   for k, p in params.items())
        assert p0.grad().asnumpy().sum() == 0
        p0.reset_ctx([mt.cpu()])
        assert p0.list_ctx() == [mt.cpu()]


def test_imperative_invoke_matches():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    want = mx.nd.imperative_invoke("topk", mx.nd.array(a), k=2,
                                   ret_typ="value").asnumpy()
    with mt.cpu():
        got = mt.nd.imperative_invoke("topk", mt.nd.array(a), k=2,
                                      ret_typ="value").asnumpy()
        out = mt.nd.zeros((2, 3))
        mt.nd.imperative_invoke("_plus_scalar", mt.nd.array(a), scalar=1.0,
                                out=out)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(out.asnumpy(), a + 1)


def test_set_recording_and_set_training_return_the_previous_state():
    for pkg in (mx, mt):
        ag = pkg.autograd
        assert ag.set_recording(True) is False
        assert ag.is_recording()
        assert ag.set_recording(False) is True
        assert ag.set_training(True) is False
        assert ag.is_training()
        with ag.record(train_mode=False):
            assert ag.set_training(True) is False
        assert ag.set_training(False) is True
        assert not ag.is_recording() and not ag.is_training()
