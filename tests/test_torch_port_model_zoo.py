"""Port parity for ``gluon.model_zoo`` against the JAX package, on the
CPU: ``resnet18_v1`` and ``resnet18_v2`` at ``thumbnail=True``,
``classes=10``, 32x32 images, batch 2.

Both packages load the same JAX-written ``.params`` file (the port into
a net it never initialized). The inference forward agrees within 1e-5
of the logits' largest magnitude. Then each package trains two steps,
SGD with momentum 0.9 and weight decay, on batches from a shuffled
``DataLoader`` under the same seed, the port hybridized: the losses
agree within 1e-5 relative, and the gradients and parameters as below.

At batch 2 the ResNets' backward is rounding-chaotic: a ReLU input
within f32 noise of 0 may fall on the other side in the other package,
and one such flip moves every gradient below it by up to ~40 % (a 1e-7
random change of the port's own input does as much). So the port
differentiates through the JAX package's ReLU decisions, recorded from
its eager forward (``_ReluLog``), as ``chip_smoke.py``'s cut-depth
checks recompute through the card's; the flips themselves are held to
at most 8, each within 1e-4 of its tensor's largest magnitude from 0.
Through the same decisions the remaining differences are f32 sums in
other orders, amplified by batch-2 BatchNorm: gradients are held within
``GRAD_TOL`` = 1e-4 of each tensor's largest magnitude (measured 4.4e-5)
and parameters after two steps within ``PARAM_TOL`` = 3e-5 (measured
1.5e-5); a moving mean of zero-mean activations is rounding around 0
and is held within 1e-6 absolute. ``get_model`` knows every name of
the JAX package's zoo: each builds the JAX package's class, and
``pretrained=True`` raises.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

CPU = mt.cpu()
GRAD_TOL = 1e-4
PARAM_TOL = 3e-5
N_IMG = 4
IMAGES = np.random.RandomState(0).rand(N_IMG, 3, 32, 32).astype(np.float32)
LABELS = np.random.RandomState(1).randint(0, 10, N_IMG).astype(np.float32)


def _np(x):
    return np.array(x.asnumpy(), np.float32, copy=True)


def _rel(net):
    return {n[len(net.prefix):]: p for n, p in net.collect_params().items()}


def _close(got, want, tol=1e-5, floor=0.0):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=max(tol * scale,
                                                           floor))


class _ReluLog:
    """Wraps the ``Activation`` op of one package: records each relu
    input (the JAX package's, eager) or applies a recorded decision
    (the port's), so both differentiate through the same ReLU masks."""

    def __init__(self, op):
        self.op, self.fn = op, op.fn
        self.inputs, self.masks, self.flips = [], None, []
        self.capture = False

    def record(self, data, *, act_type="relu"):
        if act_type == "relu" and self.capture:
            self.inputs.append(np.asarray(data))
        return self.fn(data, act_type=act_type)

    def replay(self, data, *, act_type="relu"):
        if act_type != "relu":
            return self.fn(data, act_type=act_type)
        want = self.masks.pop(0)
        own = (data > 0).detach().cpu().numpy()
        x = data.detach().cpu().numpy()
        for i in np.argwhere(own != want):
            self.flips.append(abs(float(x[tuple(i)]))
                              / max(float(np.abs(x).max()), 1e-30))
        import torch
        return data * torch.as_tensor(want, device=data.device)


def _train(pkg, net, log, steps=2):
    """Two SGD steps on DataLoader batches -> (losses, gradients before
    each update, parameters after). The JAX package's net runs eagerly
    and ``log`` records its ReLU decisions (a train-mode forward whose
    moving-statistics update is undone); the port's runs hybridized
    through those decisions."""
    if pkg is mt:
        net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9,
                                 "wd": 1e-4})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    if pkg is mt:
        ds = mt.gluon.data.ArrayDataset(mt.nd.array(IMAGES, ctx=CPU),
                                        LABELS)
    else:
        ds = mx.gluon.data.ArrayDataset(mx.nd.array(IMAGES), LABELS)
    pkg.random.seed(0)
    loader = pkg.gluon.data.DataLoader(ds, batch_size=2, shuffle=True,
                                       last_batch="discard")
    losses, grads = [], []
    rel = _rel(net)
    stats = [p for p in rel.values() if p.grad_req == "null"]
    with (CPU if pkg is mt else mx.cpu()):
        for i, (x, y) in enumerate(loader):
            if i == steps:
                break
            if pkg is mx:
                keep = [p.data().copy() for p in stats]
                log.inputs, log.capture = [], True
                with mx.autograd.train_mode():
                    net(x)
                log.capture = False
                log.masks_by_step.append([v > 0 for v in log.inputs])
                for p, v in zip(stats, keep):
                    p.set_data(v)
            else:
                log.masks = list(log.masks_by_step[i])
            with pkg.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            grads.append({k: _np(p.grad()) for k, p in rel.items()
                          if p.grad_req != "null"})
            trainer.step(2)
            losses.append(float(loss.mean().asscalar()))
    return losses, grads, {k: _np(p.data()) for k, p in rel.items()}


@pytest.mark.parametrize("version", [1, 2])
def test_resnet18_thumbnail_loads_jax_params_forwards_and_trains(
        tmp_path, monkeypatch, version):
    name = "resnet18_v%d" % version
    np.random.seed(0)
    jnet = mx.gluon.model_zoo.vision.get_model(name, thumbnail=True,
                                               classes=10)
    jnet.initialize(mx.init.Xavier(magnitude=2))
    jnet(mx.nd.array(IMAGES[:2]))
    path = str(tmp_path / (name + ".params"))
    jnet.save_parameters(path)

    tnet = mt.gluon.model_zoo.vision.get_model(name, thumbnail=True,
                                               classes=10)
    tnet.load_parameters(path, ctx=CPU)
    jagain = mx.gluon.model_zoo.vision.get_model(name, thumbnail=True,
                                                 classes=10)
    jagain.load_parameters(path)
    want = {k: _np(p.data()) for k, p in _rel(jagain).items()}
    got = {k: _np(p.data()) for k, p in _rel(tnet).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    with mx.autograd.predict_mode():
        jout = _np(jagain(mx.nd.array(IMAGES[:2])))
    with mt.autograd.predict_mode():
        tout = _np(tnet(mt.nd.array(IMAGES[:2], ctx=CPU)))
    _close(tout, jout)

    jop = mx.ops.registry.get("Activation")
    log = _ReluLog(jop)
    log.masks_by_step = []
    monkeypatch.setattr(jop, "fn", log.record)
    jl, jg, jp = _train(mx, jagain, log)
    monkeypatch.setattr(jop, "fn", log.fn)
    top = mt.ops.registry.get("Activation")
    tlog = _ReluLog(top)
    tlog.masks_by_step = log.masks_by_step
    monkeypatch.setattr(top, "fn", tlog.replay)
    tl, tg, tp = _train(mt, tnet, tlog)
    assert not tlog.masks, "the port ran fewer ReLUs than the JAX package"
    # ReLU inputs within rounding of 0 may take the other side in the
    # port: few, and each within 1e-4 of its tensor's largest magnitude
    assert len(tlog.flips) <= 8 and max(tlog.flips, default=0) <= 1e-4
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for step in range(2):
        for k in jg[step]:
            _close(tg[step][k], jg[step][k], tol=GRAD_TOL)
    for k in jp:
        # a moving mean of zero-mean activations is rounding around 0
        _close(tp[k], jp[k], tol=PARAM_TOL,
               floor=1e-6 if k.endswith("running_mean") else 0.0)


def test_get_model_covers_every_name():
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    names = sorted(mt.gluon.model_zoo.vision._MODELS)
    assert len(names) == 34
    for n in names:
        net = mt.gluon.model_zoo.get_model(n, classes=7)
        assert type(net).__name__ == type(jvision.get_model(
            n, classes=7)).__name__
        with pytest.raises(mt.MXNetError, match="pretrained"):
            mt.gluon.model_zoo.get_model(n, pretrained=True)
    with pytest.raises(ValueError, match="not supported"):
        mt.gluon.model_zoo.get_model("resnet19_v1")
