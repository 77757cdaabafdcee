"""Port parity: BASELINE configuration 3's ``super_resolution.py`` and
configuration 1's ``train_mnist.py``/``train_cifar10.py`` at small size,
against the JAX package from the same weights.

``tests/example_nets.py`` spells the examples over a package argument;
the first tests hold those spellings to the examples' own graphs. Then:

* the ESPCN net (``n=16``, ``size=8``, factor 2) hybridized, two Adam
  steps through ``Trainer``: parameters within ``rtol 1e-5, atol 1e-5``
  (the same convolutions summed in another order);
* ``train_mnist.py``'s MLP and ``train_cifar10.py``'s ResNet-20 through
  ``Module.fit``, two steps at batch 2 (kvstore ``local``; ResNet-20 with
  the example's SGD, weight decay and ``MultiFactorScheduler``):
  parameters and moving statistics within ``rtol 1e-4, atol 1e-5``.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.models  # noqa: F401  (mx.models)

import mxnet_tpu_torch as mt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import example_nets as en  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _example(name):
    """``examples/<name>.py`` as a module (it imports the JAX package)."""
    sys.path.insert(0, EXAMPLES)
    try:
        spec = importlib.util.spec_from_file_location(
            "example_" + name, os.path.join(EXAMPLES, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(EXAMPLES)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else v.asnumpy()


def test_spellings_are_the_examples():
    sr = _example("super_resolution")
    mn = _example("train_mnist")
    with mx.name.NameManager():
        want = sr.SuperResolutionNet(2, prefix="sr_")(mx.sym.var("data"))
    with mx.name.NameManager():
        got = en.sr_net(mx.gluon, 2, prefix="sr_")(mx.sym.var("data"))
    assert got.tojson() == want.tojson()
    port = en.sr_net(mt.gluon, 2, prefix="sr_")(mt.sym.var("data"))
    assert port.list_arguments() == want.list_arguments()
    with mx.name.NameManager():
        want = mn.mlp_symbol().tojson()
    with mx.name.NameManager():
        assert en.mlp_symbol(mx.sym).tojson() == want
    for a, b in zip(sr.synthetic_pairs(n=3, size=8), en.synthetic_pairs(
            n=3, size=8)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- ESPCN
N_SR, SIZE, BATCH_SR = 16, 8, 8


def _sr_train(pkg, weights, lo, hi):
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    net = en.sr_net(pkg.gluon, 2, prefix="sr_")
    net.initialize(pkg.init.Zero(), ctx=ctx)
    net(pkg.nd.array(lo[:1], ctx=ctx))          # finish the deferred init
    for name, p in net.collect_params().items():
        p.set_data(pkg.nd.array(weights[name], ctx=ctx))
    net.hybridize(static_alloc=True)
    it = pkg.io.NDArrayIter(lo, hi, batch_size=BATCH_SR, shuffle=False,
                            label_name="label")
    loss_fn = pkg.gluon.loss.L2Loss()
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
    losses = []
    for batch in it:
        x = batch.data[0].as_in_context(ctx)
        y = batch.label[0].as_in_context(ctx)
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    pred = _np(net(pkg.nd.array(lo, ctx=ctx)))
    return {k: _np(p.data()) for k, p in net.collect_params().items()}, \
        losses, pred


def test_espcn_two_adam_steps_match():
    lo, hi = en.synthetic_pairs(n=N_SR, size=SIZE)
    np.random.seed(0)
    ref = en.sr_net(mx.gluon, 2, prefix="sr_")
    ref.initialize(mx.init.Orthogonal(), ctx=mx.cpu())
    ref(mx.nd.array(lo[:1]))
    weights = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    want, wl, wp = _sr_train(mx, weights, lo, hi)
    got, gl, gp = _sr_train(mt, weights, lo, hi)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    np.testing.assert_allclose(gp, wp, rtol=1e-5, atol=1e-5)
    assert np.isfinite(en.psnr(gp, hi))


# ------------------------------------------------------- Module examples
def _module_fit(pkg, sym, X, Y, args, aux, opt):
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    conv = (lambda v: v) if pkg is mt else mx.nd.array
    mod = pkg.mod.Module(sym, context=ctx)
    mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=2), num_epoch=1,
            optimizer="sgd", optimizer_params=opt(pkg),
            arg_params={k: conv(v.copy()) for k, v in args.items()},
            aux_params={k: conv(v.copy()) for k, v in aux.items()},
            initializer=None, kvstore="local", eval_metric="acc")
    arg, aux_ = mod.get_params()
    return {k: _np(v) for k, v in list(arg.items()) + list(aux_.items())}


def _draw(sym, shape, seed=3):
    """Arguments from a RandomState (He-scaled), moving means 0 and
    variances 1."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        fan_in = int(np.prod(s[1:])) if len(s) > 1 else 1
        scale = np.sqrt(2.0 / fan_in) if len(s) > 1 else 0.1
        base = 1.0 if n.endswith("gamma") else 0.0
        args[n] = (base + rng.randn(*s) * scale).astype(np.float32)
    aux = {n: (np.ones(s) if n.endswith("var") else np.zeros(s))
           .astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


@pytest.mark.parametrize("example", ["mnist", "cifar10"])
def test_module_examples_two_steps_match(example):
    if example == "mnist":
        X, Y, _, _ = en.mnist_data()
        syms = {pkg: en.mlp_symbol(pkg.sym) for pkg in (mx, mt)}

        def opt(pkg):
            return {"learning_rate": 0.1, "momentum": 0.9}
    else:
        X, Y, _, _ = en.cifar_data()
        syms = {pkg: pkg.models.resnet_symbol(10, 20, (3, 28, 28))
                for pkg in (mx, mt)}

        def opt(pkg):
            return {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
                    "lr_scheduler": pkg.lr_scheduler.MultiFactorScheduler(
                        step=[1, 200], factor=0.1)}
    X, Y = X[:4], Y[:4]
    args, aux = _draw(syms[mt], (2,) + X.shape[1:])
    want = _module_fit(mx, syms[mx], X, Y, args, aux, opt)
    got = _module_fit(mt, syms[mt], X, Y, args, aux, opt)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert any(not np.array_equal(got[k], args[k]) for k in args)
