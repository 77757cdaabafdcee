"""Port parity for BASELINE config 4's two examples on the CPU:
``examples/train_rcnn.py``'s Faster R-CNN (a ``Custom`` op fed by
``Proposal``, ROIPooling, the two-head loss) and
``examples/train_ssd.py``'s SSD (MultiBoxPrior/Target, the SoftmaxOutput
and smooth_l1/MakeLoss heads, read through ``ImageDetIter``), spelled in
both packages by ``tests/detection_graphs.py`` and held to the examples'
own graphs node for node.

The JAX package's parameters are carried across (its Xavier draws, as
numpy), both packages run the same few ``Module.fit`` steps at the
examples' settings, and the parameters, moving statistics and outputs
are compared; then SSD's inference head (``MultiBoxDetection``) runs on
the trained weights in both. Each JAX-side run happens once, in a
module-scoped fixture; the examples' whole trainings do not run here.

Tolerances: parameters and moving statistics within ``rtol=1e-5,
atol=1e-6`` (the same f32 steps in other orders; the selections inside,
Proposal's ROIs, the custom op's samples and the mined SSD targets, come
out the same); the outputs after the steps within ``rtol=1e-5`` and 1e-5
of each output's largest magnitude (SSD's smooth_l1 input is the
difference of two O(1) values that already differ in their last bits,
and keeps that absolute error); detections: class ids and the kept rows
bitwise, coordinates and scores ``rtol=1e-5, atol=1e-6``.
The fusion plans: B5 (``scale_bias_act``) once a forward at R-CNN's
``fc6``, B1 (``bn_act``) at SSD's four BatchNorm -> ReLU sites.
"""
import os
import random
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import tier as ttier

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import detection_graphs as dg  # noqa: E402

fixture = dg.det_fixture()

RTOL, ATOL = 1e-5, 1e-6
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4}
RCNN_NAMES = dict(data_names=("data", "im_info", "gt_boxes"),
                  label_names=("rpn_label", "rpn_bbox_target",
                               "rpn_bbox_weight"))


def np_of(v):
    return np.array(v.asnumpy() if hasattr(v, "asnumpy")
                    else v.detach().cpu().numpy(), copy=True)


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def close_out(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-5 * max(float(np.abs(want).max()),
                                               ATOL))


def structure(sym):
    """The graph as (op, params) in order, with its arguments and
    outputs (auto-generated node names left out)."""
    js = __import__("json").loads(sym.tojson())
    nodes = [(n["op"], tuple(sorted((k, v) for k, v in n.get(
        "attrs", {}).items() if not k.startswith("__"))))
        for n in js["nodes"]]
    return nodes, sym.list_arguments(), len(sym.list_outputs())


def example(name):
    """``examples/<name>.py`` as a module (its ``_common`` beside it)."""
    path = os.path.join(os.path.dirname(HERE), "examples")
    sys.path.insert(0, path)
    try:
        return __import__(name)
    finally:
        sys.path.remove(path)


def test_the_spellings_are_the_examples_graphs():
    ssd, rcnn = example("train_ssd"), example("train_rcnn")
    assert structure(dg.ssd_parts(mx).ssd_symbol(3)) == \
        structure(ssd.ssd_symbol(3))
    assert structure(dg.rcnn_parts(mx).rcnn_symbol()) == \
        structure(rcnn.rcnn_symbol())
    np.testing.assert_array_equal(dg.rcnn_parts(mx).anchors,
                                  rcnn.ANCHORS)
    np.testing.assert_array_equal(dg.rcnn_parts(mt).anchors,
                                  rcnn.ANCHORS)
    for pkg in (mx, mt):
        assert structure(dg.ssd_parts(pkg).ssd_symbol(3))[1] == \
            structure(ssd.ssd_symbol(3))[1]


# ------------------------------------------------------------------ R-CNN

def rcnn_fit(pkg, p0, k, kvstore, steps=3):
    P = dg.rcnn_parts(pkg)
    it = P.RCNNIter(n=2 * steps, batch_size=2, seed=7)
    kw = {"context": mt.cpu()} if pkg is mt else {}
    mod = pkg.mod.Module(P.rcnn_symbol(), **RCNN_NAMES, **kw)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    if p0 is None:
        pkg.random.seed(7)
        mod.init_params(pkg.initializer.Xavier())
    else:
        mod.init_params(arg_params={n: pkg.nd.array(v)
                                    for n, v in p0.items()},
                        aux_params={})
    start = {n: np_of(v) for n, v in mod.get_params()[0].items()}
    metric = P.RCNNMetric()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SGD,
            kvstore=kvstore, eval_metric=metric, steps_per_dispatch=k)
    return (mod, start, {n: np_of(v) for n, v in mod.get_params()[0].items()},
            [np_of(o) for o in mod.get_outputs()], metric.get()[1])


@pytest.fixture(scope="module")
def rcnn_ref():
    """The JAX package's three steps at the example's settings."""
    _, p0, params, outs, loss = rcnn_fit(mx, None, 1, "local")
    return p0, params, outs, loss


@pytest.mark.parametrize("k,kvstore", [(1, "local"), (3, "tpu_sync")])
def test_rcnn_fit_matches_the_jax_package(rcnn_ref, k, kvstore):
    p0, want, want_outs, want_loss = rcnn_ref
    ttier.reset_stats()
    with mt.cpu():
        mod, _, got, outs, loss = rcnn_fit(mt, p0, k, kvstore)
    for n in want:
        close(got[n], want[n])
    for g, w in zip(outs, want_outs):
        close_out(g, w)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    # fc6 -> relu ran through the B5 plan once a forward
    assert ttier.stats()["dispatch"].get("scale_bias_act") == 3
    assert mod._fit_k == k
    if kvstore == "tpu_sync":
        assert mod._fused.host_ops == ("Custom", "_contrib_Proposal")
        assert mod._fused.dispatch == "eager"
        assert mod._fused.eager_steps == 3 and mod._fused.captures == 0


# -------------------------------------------------------------------- SSD

@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return fixture.write_records(str(tmp_path_factory.mktemp("ssd") / "d"),
                                 mt.recordio)


def ssd_fit(pkg, rec, p0, aux0, steps=2):
    P = dg.ssd_parts(pkg)
    random.seed(3)
    np.random.seed(3)
    kw = {"ctx": mt.cpu()} if pkg is mt else {}
    it = pkg.image.ImageDetIter(batch_size=8, data_shape=(3, 64, 64),
                                path_imgrec=rec, shuffle=True,
                                rand_mirror=True, mean=True, std=True, **kw)
    it = pkg.io.ResizeIter(it, size=steps)
    kw = {"context": mt.cpu()} if pkg is mt else {}
    mod = pkg.mod.Module(P.ssd_symbol(3), data_names=("data",),
                         label_names=("label",), **kw)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    if p0 is None:
        pkg.random.seed(3)
        mod.init_params(pkg.initializer.Xavier())
    else:
        mod.init_params(
            arg_params={n: pkg.nd.array(v) for n, v in p0.items()},
            aux_params={n: pkg.nd.array(v) for n, v in aux0.items()})
    args, aux = mod.get_params()
    start = ({n: np_of(v) for n, v in args.items()},
             {n: np_of(v) for n, v in aux.items()})
    metric = P.MultiBoxMetric()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SGD,
            kvstore="tpu_sync", eval_metric=metric,
            batch_end_callback=pkg.callback.Speedometer(8, 4))
    args, aux = mod.get_params()
    it.reset()
    return (start, {n: np_of(v) for n, v in args.items()},
            {n: np_of(v) for n, v in aux.items()},
            [np_of(o) for o in mod.get_outputs()], metric.get()[1],
            np_of(next(iter(it)).data[0]))


@pytest.fixture(scope="module")
def ssd_runs(rec):
    (p0, aux0), *want = ssd_fit(mx, rec, None, None)
    ttier.reset_stats()
    with mt.cpu():
        _, *got = ssd_fit(mt, rec, p0, aux0)
    return want, got, ttier.stats()["dispatch"].get("bn_act")


def test_ssd_fit_matches_the_jax_package(ssd_runs):
    (want_p, want_aux, want_outs, want_loss, _), \
        (got_p, got_aux, got_outs, got_loss, _), bn_act = ssd_runs
    for n in want_p:
        close(got_p[n], want_p[n])
    for n in want_aux:
        close(got_aux[n], want_aux[n])
    for g, w in zip(got_outs, want_outs):
        close_out(g, w)
    np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL)
    assert bn_act == 4 * 2       # the four BatchNorm -> ReLU sites a step


def test_ssd_multibox_detection_matches_the_jax_package(ssd_runs):
    """The inference head on the trained weights: the network's outputs
    within the output tolerance, and the JAX op fed the port's own class
    probabilities, offsets and anchors gives the port's detections (a
    near tie among the classes of a 5120-anchor net can fall either way
    under the forwards' float noise, so selections compare on the same
    inputs)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg
    (params, aux, _, _, batch), _, _ = ssd_runs
    params = {n: v for n, v in params.items() if n not in ("data", "label")}
    outs = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        sym = dg.ssd_parts(pkg).detect_symbol(3)
        with ctx:
            mod = pkg.mod.Module(sym, data_names=("data",),
                                 label_names=None, context=ctx)
            mod.bind(data_shapes=[("data", batch.shape)],
                     for_training=False)
            mod.init_params(arg_params={n: pkg.nd.array(v)
                                        for n, v in params.items()},
                            aux_params={n: pkg.nd.array(v)
                                        for n, v in aux.items()})
            mod.forward(pkg.io.DataBatch([pkg.nd.array(batch)]),
                        is_train=False)
            outs.append([np_of(o) for o in mod.get_outputs()])
    (_, *want), (got, *inputs) = outs
    for g, w in zip(inputs, want):
        close_out(g, w)
    assert got.shape == (8, 5120, 6)
    ref = np.asarray(jax.jit(lambda *a: jreg.get(
        "_contrib_MultiBoxDetection").fn(
        *a, nms_threshold=0.5, force_suppress=False,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=400))(
        *[jnp.asarray(x) for x in inputs]))
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_array_equal(got[..., 1] >= 0, ref[..., 1] >= 0)
    close(got, ref)
    assert (got[..., 0] >= 0).any()


class _HostReads(TorchDispatchMode):
    """Records what a captured CUDA graph cannot hold: a device value
    read on the host, ``nonzero``, a tensor made from host data."""

    BAD = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh",
           "aten.item")

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.BAD):
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def test_the_ssd_step_reads_nothing_back():
    """SSD's graph holds no host op, so a K > 1 fit captures its step on
    a card: rehearsed on the CPU, the fused step's forward (MultiBoxPrior,
    MultiBoxTarget's matching and mining), backward (MakeLoss) and update
    read nothing from the device and copy nothing from the host."""
    sym = dg.ssd_parts(mt).ssd_symbol(3)
    rng = np.random.RandomState(0)
    X = rng.randn(2, 3, 32, 32).astype(np.float32)
    Y = np.full((2, 2, 5), -1.0, np.float32)
    Y[:, 0] = [[0, 0.1, 0.1, 0.5, 0.6], [2, 0.3, 0.2, 0.9, 0.7]]
    mod = mt.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=mt.cpu())
    mod.bind([("data", X.shape)], [("label", Y.shape)])
    mod.init_params(mt.init.Xavier(seed=0))
    mod.init_optimizer(kvstore="tpu_sync", optimizer="sgd",
                       optimizer_params=SGD)
    fused = mod._fused
    assert fused.host_ops == () and fused.dispatch == "graph"
    batch = mt.io.DataBatch([torch.from_numpy(X)], [torch.from_numpy(Y)])
    stacked = fused.stack_feeds([mod._feed(batch)])
    keys = fused._stage(np.stack([mt.random.next_key()]).astype(np.int64))
    hyp = fused._stage(fused.hyper_rows(1))
    with _HostReads() as mode:
        outs = fused._body(mod._fused_opt_state, hyp[0],
                           {n: v[0] for n, v in stacked.items()}, keys[0])
    assert mode.found == []
    assert all(torch.isfinite(o).all() for o in outs)
