"""Port parity: the rest of ``ops/nn.py`` (the regression heads, the
softmax family's rest, L2Normalization, UpSampling, BilinearResize2D,
AdaptiveAvgPooling2D, CTCLoss and the legacy layer names) and Gluon's
``CTCLoss``, against the JAX package on the same numpy inputs.

Tolerances: outputs are a few f32 operations an element, within
``rtol 1e-6, atol 1e-7`` (the sigmoid and the softmaxes are each
library's own kernel); gradients within ``rtol 1e-6, atol 1e-6`` (a
softmax's gradient ``s * (c - sum(s * c))`` cancels); CTC sums T
log-space steps, within ``rtol 1e-5, atol 1e-5`` for the loss and its
gradient.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu.kernels import graph_fuse as jfuse
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import graph_fuse as tfuse
from mxnet_tpu_torch.ops import registry as treg

TIGHT = dict(rtol=1e-6, atol=1e-7)
GRAD = dict(rtol=1e-6, atol=1e-6)
CTC_TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _both(name, arrays, params, cot=None):
    """(JAX forward, port forward, JAX grads, port grads) of op ``name``
    on ``arrays``; the gradients are of ``sum(out * cot)`` for every
    float input (the same ``cot`` on both sides). An op with several
    outputs is read at its first."""
    def first(f):
        def g(*a, **k):
            out = f(*a, **k)
            return out[0] if isinstance(out, tuple) else out
        return g
    jf, tf = first(jreg.get(name).fn), first(treg.get(name).fn)
    jin = [jnp.asarray(a) for a in arrays]
    if cot is None:
        shape = jax.eval_shape(lambda *a: jf(*a, **params), *jin).shape
        cot = _x(shape, seed=99, lo=0.5, hi=1.5)
    cot = np.asarray(cot, np.float32)
    argn = tuple(i for i, a in enumerate(arrays) if a.dtype.kind == "f")
    # one compiled program for the forward and the vjp: eager JAX
    # compiles every primitive of the CTC scan on its own
    jout, jg = jax.jit(lambda *a: jax.value_and_grad(
        lambda *b: (jnp.sum(jf(*b, **params) * cot), jf(*b, **params)),
        argnums=argn, has_aux=True)(*a))(*jin)
    jout = jout[1]
    tin = [torch.from_numpy(a.copy()).requires_grad_(a.dtype.kind == "f")
           for a in arrays]
    tout = tf(*tin, **params)
    (tout * torch.from_numpy(cot)).sum().backward()
    tg = [tin[i].grad for i in argn]
    tg = [np.zeros_like(arrays[i]) if g is None else g.numpy()
          for i, g in zip(argn, tg)]
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jg], tg)


def _same(name, arrays, params, tol=TIGHT, cot=None, grad_tol=GRAD):
    jo, to, jg, tg = _both(name, arrays, params, cot)
    assert to.shape == jo.shape and to.dtype == jo.dtype, name
    np.testing.assert_allclose(to, jo, err_msg=name, **tol)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g, w, err_msg=name + " grad",
                                   **grad_tol)


# ------------------------------------------------------------- the heads
HEADS = ["LinearRegressionOutput", "MAERegressionOutput",
         "LogisticRegressionOutput"]


@pytest.mark.parametrize("name", HEADS)
def test_regression_head_matches(name):
    data = _x((4, 3))
    label = _x((4, 3), seed=1, lo=0.0, hi=1.0)
    _same(name, [data, label], {"grad_scale": 0.7})
    # without a label: the identity or the sigmoid, differentiated as is
    _same(name, [data], {})


@pytest.mark.parametrize("name", HEADS)
def test_regression_head_ignores_the_cotangent_and_scales_by_outputs(name):
    """The backward is ``grad_fn(out, label) * grad_scale /
    num_output`` whatever cotangent arrives, ``num_output`` the label's
    elements a sample (3 here), not the batch; the label gets none."""
    data, label = _x((4, 3)), _x((4, 3), seed=1, lo=0.0, hi=1.0)
    t = torch.from_numpy(data).requires_grad_(True)
    lab = torch.from_numpy(label).requires_grad_(True)
    out = treg.get(name).fn(t, lab, grad_scale=0.6)
    (out * torch.from_numpy(_x((4, 3), seed=5))).sum().backward()
    o = out.detach().numpy()
    want = {"MAERegressionOutput": np.sign(o - label)}.get(name, o - label)
    np.testing.assert_allclose(t.grad.numpy(), want * np.float32(0.6 / 3),
                               **TIGHT)
    np.testing.assert_array_equal(lab.grad.numpy(), 0.0)


@pytest.mark.parametrize("name,shape,params", [
    ("softmin", (3, 5), {}),
    ("softmin", (3, 5), {"axis": 0, "temperature": 2.0}),
    ("SoftmaxActivation", (2, 3, 4), {}),
    ("SoftmaxActivation", (2, 3, 4), {"mode": "channel"}),
    ("L2Normalization", (2, 3, 4, 5), {}),
    ("L2Normalization", (2, 3, 4, 5), {"mode": "channel"}),
    ("L2Normalization", (2, 3, 4, 5), {"mode": "spatial", "eps": 1e-6}),
], ids=lambda v: str(v))
def test_softmax_family_and_l2_normalization_match(name, shape, params):
    _same(name, [_x(shape)], params)


def test_softmax_cross_entropy_matches():
    data = _x((5, 7))
    label = np.array([0, 6, 3, 3, 1], np.float32)
    _same("softmax_cross_entropy", [data, label], {},
          cot=1.5)


# ---------------------------------------------------- resizes and pools
@pytest.mark.parametrize("inputs,params", [
    ([(2, 3, 4, 5)], {"scale": 2}),
    ([(2, 3, 4, 4), (2, 2, 2, 2)], {"scale": 3, "num_args": 2}),
], ids=["one", "concat"])
def test_upsampling_nearest_matches(inputs, params):
    _same("UpSampling", [_x(s, seed=i) for i, s in enumerate(inputs)],
          params)


def test_upsampling_bilinear_raises_as_the_jax_op():
    x = _x((1, 2, 3, 3))
    with pytest.raises(NotImplementedError) as want:
        jreg.get("UpSampling").fn(jnp.asarray(x), sample_type="bilinear")
    with pytest.raises(NotImplementedError) as got:
        treg.get("UpSampling").fn(torch.from_numpy(x),
                                  sample_type="bilinear")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("params", [
    {"height": 7, "width": 9}, {"height": 2, "width": 1},
    {"scale_height": 1.5, "scale_width": 2.0}], ids=str)
def test_bilinear_resize_matches(params):
    _same("_contrib_BilinearResize2D", [_x((2, 3, 4, 5))], params)


@pytest.mark.parametrize("shape,out", [((2, 3, 6, 8), (3, 4)),
                                       ((2, 3, 7, 5), (3, 2)),
                                       ((1, 2, 5, 5), 1)], ids=str)
def test_adaptive_avg_pooling_matches(shape, out):
    _same("_contrib_AdaptiveAvgPooling2D", [_x(shape)],
          {"output_size": out})


# ------------------------------------------------------------------- CTC
def _ctc_case(seed=0, T=12, N=3, C=6, L=4):
    rng = np.random.RandomState(seed)
    data = rng.randn(T, N, C).astype(np.float32)
    label = rng.randint(1, C - 1, (N, L)).astype(np.float32)
    label[0, 3] = label[0, 2]        # a repeat: no skip across it
    label[1, 3] = 0                  # a pad with the blank first
    label[2, 2:] = -1                # -1 pads
    return data, label


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_loss_matches(blank):
    """The op under each of its four names (one operator in each
    package) against the JAX op's loss and gradient."""
    data, label = _ctc_case()
    cot = _x((3,), seed=99, lo=0.5, hi=1.5)
    jo, _, jg, _ = _both("CTCLoss", [data, label], {"blank_label": blank},
                         cot)
    for name in ("CTCLoss", "ctc_loss", "_contrib_CTCLoss",
                 "_contrib_ctc_loss"):
        t = torch.from_numpy(data.copy()).requires_grad_(True)
        out = treg.get(name).fn(t, torch.from_numpy(label),
                                blank_label=blank)
        (out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), jo, err_msg=name,
                                   **CTC_TOL)
        np.testing.assert_allclose(t.grad.numpy(), jg[0], err_msg=name,
                                   **CTC_TOL)


@pytest.mark.parametrize("blank,lengths", [("first", 2), ("last", 1)],
                         ids=["first-both", "last-data"])
def test_ctc_loss_with_lengths_matches(blank, lengths):
    data, label = _ctc_case(seed=1)
    dlen = np.array([12, 7, 9], np.float32)
    llen = np.array([4, 2, 3], np.float32)
    _same("CTCLoss", [data, label, dlen, llen][:2 + lengths],
          {"use_data_lengths": True, "use_label_lengths": lengths == 2,
           "blank_label": blank}, tol=CTC_TOL, grad_tol=CTC_TOL)


def _gluon_ctc(pkg, layout, label_layout, pred, label, **kw):
    loss = pkg.gluon.loss.CTCLoss(layout, label_layout, weight=0.5)
    args = [pkg.nd.array(pred), pkg.nd.array(label)] + \
        [pkg.nd.array(v) if v is not None else None
         for v in (kw.get("pred_lengths"), kw.get("label_lengths"))]
    while args and args[-1] is None:
        args.pop()
    return loss(*args).asnumpy()


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN")])
def test_gluon_ctc_loss_matches(layout, label_layout):
    data, label = _ctc_case(seed=2, C=5)
    label[label == 4] = 3
    pred = data.transpose(1, 0, 2) if layout == "NTC" else data
    lab = label if label_layout == "NT" else label.T
    llen = np.array([4, 2, 3], np.float32)
    with mt.cpu():
        for kw in ({}, {"label_lengths": llen},
                   {"pred_lengths": np.array([12, 10, 8], np.float32),
                    "label_lengths": llen}):
            want = _gluon_ctc(mx, layout, label_layout, pred, lab, **kw)
            got = _gluon_ctc(mt, layout, label_layout, pred, lab, **kw)
            np.testing.assert_allclose(got, want, err_msg=str(kw),
                                       **CTC_TOL)


# ------------------------------------------------------------ the legacy
@pytest.mark.parametrize("legacy,name", [
    ("BatchNorm_v1", "BatchNorm"), ("CuDNNBatchNorm", "BatchNorm"),
    ("Convolution_v1", "Convolution"), ("Pooling_v1", "Pooling"),
    ("Softmax", "SoftmaxOutput")])
def test_legacy_names_are_the_ops_themselves(legacy, name):
    assert treg.get(legacy) is treg.get(name)
    assert jreg.get(legacy) is jreg.get(name)


def test_legacy_layers_match():
    x = _x((2, 3, 6, 6))
    _same("Convolution_v1", [x, _x((4, 3, 3, 3), seed=1), _x((4,), seed=2)],
          {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)})
    _same("Pooling_v1", [x], {"kernel": (2, 2), "stride": (2, 2),
                              "pool_type": "avg"})
    bn = [x, _x((3,), seed=3, lo=0.5), _x((3,), seed=4), np.zeros(3, "f4"),
          np.ones(3, np.float32)]
    jo = jreg.get("BatchNorm_v1").fn(*[jnp.asarray(a) for a in bn],
                                     fix_gamma=False)
    to = treg.get("BatchNorm_v1").fn(*[torch.from_numpy(a) for a in bn],
                                     fix_gamma=False)
    for j, t in zip(jo, to):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    for name in ("BatchNorm_v1", "CuDNNBatchNorm"):
        # the normalized output and its gradients (data, gamma, beta; the
        # moving statistics get none)
        _same(name, bn, {"fix_gamma": False}, tol=dict(rtol=1e-5, atol=1e-6),
              grad_tol=dict(rtol=1e-5, atol=1e-5))
    _same("Softmax", [_x((4, 5)), np.array([0, 1, 4, 2], np.float32)],
          {"grad_scale": 0.5})


def _bn_relu(pkg, op):
    x = pkg.sym.Variable("data")
    x = getattr(pkg.sym, op)(x, fix_gamma=False, name="bn")
    return pkg.sym.Activation(x, act_type="relu", name="relu")


@pytest.mark.parametrize("op", ["BatchNorm_v1", "CuDNNBatchNorm",
                                "BatchNorm"])
def test_legacy_batchnorm_relu_fuses_as_the_jax_pass_does(op):
    """Both fusion passes read the op itself, not the name it was
    called by: a legacy BatchNorm before a ReLU is one B1 site in each
    package."""
    with mx.config.override(kernel_tier="auto"):
        js = _bn_relu(mx, op)
        jplans, _ = jfuse.plan(js._topo(), list(js._entries))
    with mt.config.override(kernel_tier="auto"):
        ts = _bn_relu(mt, op)
        tplans, _ = tfuse.plan(ts._topo(), list(ts._entries))
    assert len(tplans) == len(jplans) == 1


@pytest.mark.parametrize("head,label", [
    ("LinearRegressionOutput", (4, 3)), ("MAERegressionOutput", (4, 3)),
    ("LogisticRegressionOutput", (4, 3)), ("softmax_cross_entropy", (4,))])
def test_heads_infer_the_label_shape(head, label):
    shapes = []
    for pkg in (mx, mt):
        out = getattr(pkg.sym, head)(
            pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=3,
                                   name="fc"), name="head")
        args, outs, _ = out.infer_shape(data=(4, 5))
        shapes.append((dict(zip(out.list_arguments(), args)), outs))
    assert shapes[1] == shapes[0]
    assert shapes[0][0]["head_label"] == label
