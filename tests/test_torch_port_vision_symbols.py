"""Port parity for the symbolic vision networks against the JAX package,
on the CPU: the ``LRN`` op, Inception-v3 (``models.inception_v3_symbol``)
tower by tower and whole, AlexNet (``models.alexnet_symbol``), and the
``lenet``/``mlp`` builders.

Both packages build each graph under a fresh name manager and must write
the same JSON. Inputs and weights are numpy draws from fixed seeds, fed
to both packages' executors (the JAX package's under its own jit, as
``tests/test_model_symbols.py`` runs it).

Tolerances, f32 throughout (the same sums in other orders):

- ``LRN``: forward within rtol 1e-5, and the input gradient (``jax.grad``
  of the JAX op against torch autograd of the port's) within 1e-5 of its
  largest magnitude.
- Towers and the stem, in training mode (batch statistics): outputs and
  every gradient under a fixed cotangent within ``TOL`` = 1e-4 of each
  tensor's largest magnitude. BatchNorm at batch 2 divides by per-channel
  deviations of a few values, which amplifies rounding; the towers are
  at most five convolutions deep, and the largest difference seen is
  3e-6.
- The whole Inception-v3 at (1, 3, 139, 139), inference with
  ``dropout=0.0`` as ``tests/test_model_symbols.py`` runs it: the softmax
  within 1e-5 absolute, through the executor and through a dynamic-batch
  artifact served by ``Server`` (the JAX arrays carried across by
  ``serving.params_from_reference``). Its fusion plan routes 94
  ``bn_act`` sites in both packages.
- AlexNet at batch 2 and 67x67 (its smallest input), training mode: the
  dropout masks come from each package's key chain after the same seed
  (bitwise equal since the key chain was ported), outputs and gradients
  within ``TOL`` of each tensor's largest magnitude; fc6 and fc7 each
  dispatch one fused bias + ReLU (B5).

Each JAX graph is built and compiled once in the file (the whole
Inception-v3, with its shapes, in a module-scoped fixture that the graph
test and the forward share); those compiles are most of the file's time.
The JAX executors are bound to arrays made from numpy rather than by
``simple_bind``, whose zeros and shape inference compile and trace as
much again.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.models  # noqa: F401  (not imported by the package)
from mxnet_tpu import config as jconfig
from mxnet_tpu import models as jmodels
from mxnet_tpu import name as jname
from mxnet_tpu.kernels import graph_fuse as jfuse
from mxnet_tpu.models import inception_v3 as jinc
from mxnet_tpu.ops import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.kernels import graph_fuse as tfuse
from mxnet_tpu_torch.kernels import tier as ttier
from mxnet_tpu_torch.models import inception_v3 as tinc
from mxnet_tpu_torch.ops import nn as tnn

TOL = 1e-4
B = 2


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _build(build_j, build_t):
    with jname.NameManager():
        j = build_j(mx.sym)
    with tname.NameManager():
        t = build_t(mt.sym)
    assert json.loads(t.tojson()) == json.loads(j.tojson())
    return j, t


def _np(x):
    x = x.asnumpy() if hasattr(x, "asnumpy") else x.detach().cpu().numpy()
    return np.array(x, np.float32, copy=True)


def _draw(sym, shapes, seed, inferred=None):
    """uniform(-0.5, 0.5) / sqrt(fan-in) arguments, moving means
    uniform(-0.1, 0.1), moving variances uniform(0.5, 1.5), at the
    shapes the port's ``sym`` infers (the JSON is the JAX package's), or
    at ``inferred``, its ``infer_shape`` result already in hand."""
    arg_shapes, _, aux_shapes = inferred or sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in shapes or n.endswith("label"):
            continue
        fan = max(int(np.prod(s[1:])), 1) if len(s) > 1 else 1
        args[n] = (rng.uniform(-0.5, 0.5, s) / np.sqrt(fan)
                   * (3.0 if len(s) > 1 else 1.0)).astype(np.float32)
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("var")
               else rng.uniform(-0.1, 0.1, s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _run(pkg, sym, args, aux, inputs, is_train=True, seed=None,
         grads=True):
    """One forward of ``sym`` in ``pkg`` and with ``grads`` a backward
    under a head gradient of ones (the JAX executor computes it with the
    forward, in one compiled program) -> (output, {name: gradient}) as
    numpy."""
    shapes = {k: v.shape for k, v in inputs.items()}
    req = "write" if grads else "null"
    if pkg is mt:
        ex = sym.simple_bind(mt.cpu(), grad_req=req, **shapes)
        ex.copy_params_from(args, aux)
        feed = inputs
    else:
        # bound to arrays made from numpy: ``simple_bind`` would compile a
        # zeros program for every distinct shape and infer every node's
        # shape by tracing, most of the JAX side's time at these sizes
        # shapes, as ``simple_bind`` does (a label not fed is zeros)
        vals = dict(args, **inputs)
        vals.update({k: np.zeros(len(inputs["data"]), np.float32)
                     for k in sym.list_arguments()
                     if k not in vals and k.endswith("label")})
        want = [k for k in sym.list_arguments() if k in args or k == "data"]
        ex = sym.bind(mx.cpu(), args={
            k: mx.nd.array(v) for k, v in vals.items()},
            args_grad={k: mx.nd.array(np.zeros_like(vals[k]))
                       for k in want} if grads else None,
            grad_req={k: "write" if grads and k in want else "null"
                      for k in sym.list_arguments()},
            aux_states={k: mx.nd.array(v) for k, v in aux.items()})
        feed = {}
    if seed is not None:
        pkg.random.seed(seed)
    outs = ex.forward(is_train=is_train, **feed)
    out = _np(outs[0])
    got = {}
    if grads:
        ex.backward()
        got = {k: _np(g) for k, g in ex.grad_dict.items()
               if g is not None and (k in args or k == "data")}
    return out, got


def _compare(j, t, args, aux, inputs, seed=None, tol=TOL, head=True):
    """Training-mode forward and backward in both packages: every output
    and gradient within ``tol``. With ``head`` the output is multiplied
    by a random input ``head`` first, so the gradients are those under
    that cotangent (a SoftmaxOutput head takes none: its backward ignores
    the cotangent)."""
    if head:
        shape = t.infer_shape(**{k: v.shape for k, v in inputs.items()})[1]
        inputs = dict(inputs, head=np.random.RandomState(11).randn(
            *shape[0]).astype(np.float32))
        with jname.NameManager():
            j = j * mx.sym.var("head")
        with tname.NameManager():
            t = t * mt.sym.var("head")
    jo, jg = _run(mx, j, args, aux, inputs, seed=seed)
    to, tg = _run(mt, t, args, aux, inputs, seed=seed)
    _close(to, jo, tol)
    assert sorted(tg) == sorted(jg) and jg
    for k in jg:
        _close(tg[k], jg[k], tol)
    return jo


# --------------------------------------------------------------------- LRN
@pytest.mark.parametrize("nsize,alpha,beta,knorm", [
    (5, 1e-4, 0.75, 2.0), (3, 1e-2, 0.5, 1.0), (4, 0.1, 0.9, 1.5),
    (1, 2e-3, 0.75, 2.0), (7, 0.5, 1.2, 0.7)])
def test_lrn_matches_the_jax_op_forward_and_gradient(nsize, alpha, beta,
                                                     knorm):
    rng = np.random.RandomState(nsize)
    x = (rng.randn(2, 6, 5, 4) * 3).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    kw = dict(nsize=nsize, alpha=alpha, beta=beta, knorm=knorm)
    want, vjp = jax.jit(lambda d: jax.vjp(lambda v: jnn.lrn(v, **kw),
                                          d))(jnp.asarray(x))
    jgrad = np.asarray(vjp(jnp.asarray(cot))[0])
    want = np.asarray(want)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tnn.lrn(xt, **kw)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-7)
    _close(xt.grad.numpy(), jgrad, 1e-5)


def test_lrn_is_registered_for_sym_and_nd():
    x = np.random.RandomState(0).rand(1, 4, 3, 3).astype(np.float32)
    got = mt.nd.LRN(mt.nd.array(x, ctx=mt.cpu()), nsize=3).asnumpy()
    np.testing.assert_array_equal(
        got, tnn.lrn(torch.from_numpy(x), nsize=3).numpy())
    j, t = _build(lambda s: s.LRN(s.var("data"), nsize=5, alpha=1e-3),
                  lambda s: s.LRN(s.var("data"), nsize=5, alpha=1e-3))
    assert t.infer_shape(data=(2, 8, 4, 4)) == j.infer_shape(
        data=(2, 8, 4, 4))


# ------------------------------------------------------------ Inception-v3
def _stem(pkg_inc, s):
    net = pkg_inc._cb(s.var("data"), 32, (3, 3), stride=(2, 2),
                      name="stem1")
    net = pkg_inc._cb(net, 32, (3, 3), name="stem2")
    net = pkg_inc._cb(net, 64, (3, 3), pad=(1, 1), name="stem3")
    net = pkg_inc._pool(net, (3, 3), (2, 2), name="stem_pool1")
    net = pkg_inc._cb(net, 80, (1, 1), name="stem4")
    net = pkg_inc._cb(net, 192, (3, 3), name="stem5")
    return pkg_inc._pool(net, (3, 3), (2, 2), name="stem_pool2")


# (builder of one package's part, input (C, H, W)): the stem at the
# smallest size its last pool takes, every tower at a small grid with
# few input channels (the towers' own widths are fixed by the builder,
# except tower C's 7x7 width, here 16)
PARTS = {
    "stem": (_stem, (3, 35, 35)),
    "tower_a": (lambda m, s: m._tower_a(s.var("data"), 32, "mixed0"),
                (16, 5, 5)),
    "tower_b": (lambda m, s: m._tower_b(s.var("data"), "mixed3"),
                (16, 7, 7)),
    "tower_c": (lambda m, s: m._tower_c(s.var("data"), 16, "mixed4"),
                (16, 5, 5)),
    "tower_d": (lambda m, s: m._tower_d(s.var("data"), "mixed8"),
                (16, 7, 7)),
    "tower_e": (lambda m, s: m._tower_e(s.var("data"), "mixed9"),
                (16, 3, 3)),
}


@pytest.mark.parametrize("part", sorted(PARTS))
def test_inception_v3_part_matches_forward_and_gradient(part):
    build, chw = PARTS[part]
    j, t = _build(lambda s: build(jinc, s), lambda s: build(tinc, s))
    data = np.random.RandomState(3).randn(B, *chw).astype(np.float32)
    args, aux = _draw(t, {"data": data.shape}, seed=4)
    ttier.reset_stats()
    _compare(j, t, args, aux, {"data": data})
    # the port's training forward ran every conv unit through B1 (its
    # plain version here): one dispatch per BatchNorm -> ReLU
    n_bn = sum(1 for n in t._topo() if not n.is_variable
               and n.op.name == "BatchNorm")
    assert ttier.stats()["dispatch"] == {"bn_act": n_bn}


# the small input, the smallest the symbol takes
SMALL = (1, 3, 139, 139)


@pytest.fixture(scope="module")
def inception():
    """The whole Inception-v3 in both packages, with its shapes at
    ``SMALL`` in each, shared by the graph test and the forward."""
    j, t = _build(lambda s: jmodels.inception_v3_symbol(num_classes=7,
                                                        dropout=0.0),
                  lambda s: mt.models.inception_v3_symbol(num_classes=7,
                                                          dropout=0.0))
    return j, t, j.infer_shape(data=SMALL), t.infer_shape(data=SMALL)


def test_inception_v3_symbol_matches_the_jax_graph(inception):
    # the default symbol (1000 classes, dropout 0.5) writes the same JSON
    _build(lambda s: jmodels.inception_v3_symbol(),
           lambda s: mt.models.inception_v3_symbol())
    j, t, jshapes, tshapes = inception
    assert tshapes == jshapes
    assert t.infer_shape(data=(4, 3, 299, 299)) == j.infer_shape(
        data=(4, 3, 299, 299))
    with jconfig.override(kernel_tier="auto"):
        jplans, _ = jfuse.plan(j._topo(), j._entries)
    with mt.config.override(kernel_tier="auto"):
        tplans, _ = tfuse.plan(t._topo(), t._entries)
        assert mt.serving._kernel_census(t) == {"bn_act": 94}
    assert len(jplans) == len(tplans) == 94
    assert sorted(p.base.name for p in jplans.values()) == \
        sorted(p.base.name for p in tplans.values())
    bn = [n for n in t._topo() if not n.is_variable
          and n.op.name == "BatchNorm"]
    assert len(bn) == 94 and all(n.params["fix_gamma"] is True
                                 and n.params["eps"] == 1e-3 for n in bn)


def test_inception_v3_forward_at_139_and_served(inception, tmp_path):
    j, t, _j, tshapes = inception
    data = np.random.RandomState(5).rand(*SMALL).astype(np.float32)
    args, aux = _draw(t, {"data": data.shape}, seed=6, inferred=tshapes)
    jo, _ = _run(mx, j, args, aux, {"data": data}, False, grads=False)
    ttier.reset_stats()
    to, _ = _run(mt, t, args, aux, {"data": data}, False, grads=False)
    # every BatchNorm -> ReLU ran fused (B1's plain version on the CPU),
    # fix_gamma and eps 1e-3 through its coefficients
    assert ttier.stats()["dispatch"] == {"bn_act": 94}
    assert to.shape == (1, 7)
    np.testing.assert_allclose(to.sum(), 1.0, rtol=1e-4)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5)
    # the serving entry point: the JAX package's arrays carried across,
    # a dynamic-batch artifact, the Server
    targs, taux = mt.serving.params_from_reference(
        {k: mx.nd.array(v) for k, v in args.items()},
        {k: mx.nd.array(v) for k, v in aux.items()}, t, "cpu",
        data_shapes={"data": data.shape})
    path = str(tmp_path / "inception.mxtorch")
    meta = mt.serving.export_compiled(t, targs, taux,
                                      {"data": (None, 3, 139, 139)}, path,
                                      device="cpu")
    assert meta["kernel_tier"]["kernels"] == {"bn_act": 94}
    srv = mt.serve.Server(path, buckets=(1,), device="cpu")
    try:
        served = srv.predict(data=data, timeout_ms=120000)[0]
    finally:
        srv.close()
    np.testing.assert_allclose(served, jo, rtol=0, atol=1e-5)


# ----------------------------------------------------------------- AlexNet
def test_alexnet_forward_and_gradient_with_dropout():
    j, t = _build(lambda s: jmodels.alexnet_symbol(num_classes=10),
                  lambda s: mt.models.alexnet_symbol(num_classes=10))
    assert [n.op.name for n in t._topo() if not n.is_variable].count(
        "LRN") == 2
    data = np.random.RandomState(7).rand(B, 3, 67, 67).astype(np.float32)
    label = np.array([3, 8], np.float32)
    args, aux = _draw(t, {"data": data.shape, "softmax_label": (B,)},
                      seed=8)
    ttier.reset_stats()
    out = _compare(j, t, args, aux, {"data": data, "softmax_label": label},
                   seed=21, head=False)
    assert out.shape == (B, 10)
    # fc6 and fc7 (FullyConnected with a bias -> ReLU) each ran through
    # B5's wrapper (its plain version here), nothing else fused
    assert ttier.stats()["dispatch"] == {"scale_bias_act": 2}


def test_alexnet_fuses_fc6_and_fc7_as_the_jax_package_does():
    """fc6 and fc7 (FullyConnected with a bias -> ReLU) are AlexNet's two
    fused sites in both packages' fusion plans, each run as the product
    without its bias and one B5 launch."""
    j, t = _build(lambda s: jmodels.alexnet_symbol(),
                  lambda s: mt.models.alexnet_symbol())
    with jconfig.override(kernel_tier="auto"):
        jplans, _ = jfuse.plan(j._topo(), j._entries)
    with mt.config.override(kernel_tier="auto"):
        tplans, _ = tfuse.plan(t._topo(), t._entries)
        assert mt.serving._kernel_census(t) == {"fc_act": 2}
    assert sorted((p.kind, p.base.name) for p in tplans.values()) == \
        sorted((p.kind, p.base.name) for p in jplans.values()) == \
        [("fc_act", "fc6"), ("fc_act", "fc7")]


@pytest.mark.parametrize("name", ["lenet", "mlp"])
def test_lenet_and_mlp_match(name):
    j, t = _build(lambda s: getattr(jmodels, name)(num_classes=10),
                  lambda s: getattr(mt.models, name)(num_classes=10))
    data = np.random.RandomState(9).rand(B, 1, 28, 28).astype(np.float32)
    label = np.array([1, 4], np.float32)
    args, aux = _draw(t, {"data": data.shape, "softmax_label": (B,)},
                      seed=10)
    _compare(j, t, args, aux, {"data": data, "softmax_label": label},
             head=False)


def test_backward_with_a_head_gradient_keeps_the_forwards_dropout_masks():
    """R8: after a training forward, ``backward(out_grads=)``
    differentiates that forward's own evaluation, its dropout masks
    included, as upstream MXNet does; the JAX package's executor
    evaluates the graph again under a new key, so its gradient belongs
    to other masks than the outputs it returned. The graph returns the
    dropped input beside the product, so the weight's gradient under a
    head of ones on the product is that input's column sums."""
    def build(s):
        drop = s.Dropout(s.var("data"), p=0.5, name="drop")
        return s.Group([s.FullyConnected(drop, num_hidden=3, name="fc"),
                        drop])
    j, t = _build(build, build)
    data = np.random.RandomState(12).rand(4, 16).astype(np.float32)
    args, _ = _draw(t, {"data": data.shape}, seed=13)
    heads = [np.ones((4, 3), np.float32), np.zeros((4, 16), np.float32)]
    got = {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        ex = (j if pkg is mx else t).simple_bind(ctx, data=data.shape)
        ex.copy_params_from({k: pkg.nd.array(v, ctx=ctx)
                             for k, v in args.items()})
        pkg.random.seed(5)
        outs = ex.forward(is_train=True, data=pkg.nd.array(data, ctx=ctx))
        dropped = _np(outs[1])
        ex.backward(out_grads=[pkg.nd.array(h, ctx=ctx) for h in heads])
        got[pkg] = (dropped, _np(ex.grad_dict["fc_weight"]))
    (jd, jw), (td, tw) = got[mx], got[mt]
    np.testing.assert_array_equal(td, jd)          # one key chain
    np.testing.assert_allclose(tw, heads[0].T @ td, rtol=1e-6)
    assert not np.allclose(jw, heads[0].T @ jd, rtol=1e-3)
