"""Port parity for the Gluon vision zoo beyond the ResNets (AlexNet, VGG
with and without BatchNorm, SqueezeNet, MobileNet v1 and v2, DenseNet,
Inception v3) and ``gluon.contrib.nn``'s tower containers, against the
JAX package on the CPU.

- Every one of the 34 ``get_model`` names builds, called on a symbol,
  the JAX package's graph: the same JSON node for node, so the same
  parameter names and shapes. ``pretrained=True`` raises for each.
- One network of each family at the smallest input its JAX net accepts
  (MobileNets, which take any, at 32x32), at the smallest multiplier or
  depth where it has one (VGG-11 with BatchNorm, whose convolution stack
  is VGG-11's), batch 1, inference: Xavier weights (numpy seed 0),
  BatchNorm's statistics and affine parameters drawn from numpy so that
  every normalization does work; the JAX net's graph (called on a
  symbol, the graph its hybridized call runs) bound to them and run by
  the JAX executor, one compile where the hybridized JAX net's first call
  takes twice as long; the JAX package's arrays cross to a fresh net of
  the port's by ``gluon.utils.params_from_reference`` or, for
  DenseNet-121 and Inception v3, by a ``.params`` file the JAX package
  writes. That net, eager and hybridized, gives the JAX outputs within
  ``TOL`` = 1e-5 of their largest magnitude (f32, the same sums in other
  orders).
- ``Concurrent``, ``HybridConcurrent`` (eager and hybridized) and
  ``Identity``: forward within ``TOL``.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import name as jname
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

CPU = mt.cpu()
TOL = 1e-5
NAMES = sorted(tvision._MODELS)
# (name, input side, carried by the .params file)
FAMILIES = [("alexnet", 63, False), ("vgg11_bn", 32, False),
            ("squeezenet1.0", 29, False),
            ("squeezenet1.1", 25, False), ("mobilenet0.25", 32, False),
            ("mobilenetv2_0.25", 32, False), ("densenet121", 221, True),
            ("inceptionv3", 299, True)]
# BatchNorm's parameters and statistics, drawn so that each does work
BN_DRAWS = {"gamma": (0.5, 1.5), "beta": (-0.1, 0.1),
            "running_mean": (-0.1, 0.1), "running_var": (0.5, 1.5)}


def _np(x):
    return np.array(x.asnumpy(), np.float32, copy=True)


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _rel(net):
    return {n[len(net.prefix):]: p for n, p in net.collect_params().items()}


@pytest.mark.parametrize("name", NAMES)
def test_get_model_builds_the_jax_graph(name):
    j = jvision.get_model(name, classes=7, prefix="net_")
    t = mt.gluon.model_zoo.get_model(name, classes=7, prefix="net_")
    assert type(t).__name__ == type(j).__name__
    # op nodes take their names from a per-process counter: a fresh one
    # in each package
    with jname.NameManager():
        jsym = j(mx.sym.var("data"))
    with tname.NameManager():
        tsym = t(mt.sym.var("data"))
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    with pytest.raises(mt.MXNetError, match="pretrained"):
        mt.gluon.model_zoo.get_model(name, pretrained=True)


@pytest.mark.parametrize("name,side,by_file", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_forward_matches_the_jax_net(tmp_path, name, side, by_file):
    x = np.random.RandomState(1).randn(1, 3, side, side).astype(np.float32)
    xt = mt.nd.array(x, ctx=CPU)
    # the weights: Xavier (numpy seed 0) on a net of the port's, its
    # BatchNorm parameters and statistics then drawn from numpy
    src = mt.gluon.model_zoo.get_model(name, classes=10, prefix="net_")
    np.random.seed(0)
    src.initialize(mt.init.Xavier(), ctx=CPU)
    with mt.autograd.predict_mode():
        src(xt)
    rng = np.random.RandomState(2)
    for k, p in sorted(src.collect_params().items()):
        for suffix, (lo, hi) in BN_DRAWS.items():
            if k.endswith(suffix):
                p.set_data(rng.uniform(lo, hi, p.shape).astype(np.float32))
    weights = {k: _np(p.data()) for k, p in src.collect_params().items()}
    # the JAX net: its graph on a symbol (the graph its hybridized call
    # runs) bound to those arrays, one forward of the JAX executor
    with jname.NameManager():
        jsym = jvision.get_model(name, classes=10, prefix="net_")(
            mx.sym.var("data"))
    aux_names = set(jsym.list_auxiliary_states())
    ex = jsym.bind(mx.cpu(), args=dict(
        {k: mx.nd.array(v) for k, v in weights.items()
         if k not in aux_names}, data=mx.nd.array(x)),
        aux_states={k: mx.nd.array(v) for k, v in weights.items()
                    if k in aux_names}, grad_req="null")
    want = _np(ex.forward(is_train=False)[0])
    # back to a fresh net of the port's from the JAX package's arrays
    jarrays = {k[len("net_"):]: v for k, v in
               list(ex.arg_dict.items()) + list(ex.aux_dict.items())
               if k != "data"}
    tnet = mt.gluon.model_zoo.get_model(name, classes=10)
    if by_file:
        path = str(tmp_path / (name + ".params"))
        mx.nd.save(path, jarrays)
        tnet.load_parameters(path, ctx=CPU)
    else:
        mt.gluon.utils.params_from_reference(
            tnet, {k: _np(v) for k, v in jarrays.items()}, ctx=CPU)
    with mt.autograd.predict_mode():
        _close(_np(tnet(xt)), want)
        tnet.hybridize()
        _close(_np(tnet(xt)), want)


def _towers(pkg):
    cnn = pkg.gluon.contrib.nn
    nn = pkg.gluon.nn
    outer = cnn.HybridConcurrent(axis=1, prefix="cat_")
    with outer.name_scope():
        outer.add(cnn.Identity())
        outer.add(nn.Conv2D(4, 3, padding=1))
        inner = cnn.HybridConcurrent(axis=1)
        inner.add(nn.Conv2D(2, 1), nn.AvgPool2D(3, 1, 1))
        outer.add(inner)
    eager = cnn.Concurrent(axis=-1, prefix="seq_")
    with eager.name_scope():
        eager.add(nn.Dense(3, flatten=False), cnn.Identity(),
                  nn.Dense(2, flatten=False))
    return outer, eager


def test_concurrent_hybrid_concurrent_and_identity_match():
    x = np.random.RandomState(3).randn(2, 3, 5, 5).astype(np.float32)
    np.random.seed(0)
    jnets = _towers(mx)
    tnets = _towers(mt)
    for jn, tn in zip(jnets, tnets):
        jn.initialize(mx.init.Xavier())
        jout = _np(jn(mx.nd.array(x)))
        tn.initialize(ctx=CPU)
        tn(mt.nd.array(x, ctx=CPU))
        assert sorted(_rel(tn)) == sorted(_rel(jn))
        mt.gluon.utils.params_from_reference(
            tn, {k: _np(p.data()) for k, p in _rel(jn).items()})
        _close(_np(tn(mt.nd.array(x, ctx=CPU))), jout)
        if isinstance(tn, mt.gluon.HybridBlock):
            tn.hybridize()
            _close(_np(tn(mt.nd.array(x, ctx=CPU))), jout)
    assert jout.shape == (2, 3, 5, 5 + 3 + 2)
