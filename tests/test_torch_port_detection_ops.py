"""Port parity for the detection and ROI ops against the JAX package, on
the CPU: ``smooth_l1``, ``MakeLoss``, ``box_iou``, ``box_nms``,
``bipartite_matching``, ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection``, ``ROIPooling``, ``ROIAlign`` and ``Proposal``, on
the same numpy inputs made from fixed seeds, with ties (equal scores,
equal background probabilities, all-zero ROI bins), empty and
all-suppressed inputs and batches of more than one.

Tolerances, stated once:
- selections and integer outputs (kept rows, their order, class ids,
  matches, ROI rows, mined targets): bitwise;
- f32 values: ``rtol=1e-5, atol=1e-6`` (``assert_allclose``);
- gradients against ``jax.vjp`` of the JAX op under the same cotangent:
  the same tolerance.
Rows that an op copies (box_nms keeps its input rows) are bitwise too.

The JAX ops run under ``jax.jit`` (the same functions; one compile each
costs less here than their eager Python loops), ROIAlign eagerly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX ops)
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6


def jfn(name, **kw):
    """The JAX op under ``jax.jit`` (one compile; eager dispatch of its
    Python loops costs more here), but ROIAlign eagerly (its unrolled
    bins and samples take longer to compile than to run)."""
    f = lambda *a: jreg.get(name).fn(*a, **kw)  # noqa: E731
    return f if name == "_contrib_ROIAlign" else jax.jit(f)


def jop(name, *ins, **kw):
    out = jfn(name, **kw)(*[jnp.asarray(x) for x in ins])
    if isinstance(out, (tuple, list)):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def top(name, *ins, **kw):
    out = treg.get(name).fn(*[torch.from_numpy(np.asarray(x)) for x in ins],
                            **kw)
    if isinstance(out, tuple):
        return tuple(o.detach().numpy() for o in out)
    return out.detach().numpy()


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def grads_pair(name, ins, cot, wrt, **kw):
    """(port grads, JAX grads) of sum(op(*ins) * cot) for inputs ``wrt``."""
    f = jfn(name, **kw)

    def jf(*diff):
        args = list(jnp.asarray(x) for x in ins)
        for i, d in zip(wrt, diff):
            args[i] = d
        return f(*args)
    _, vjp = jax.vjp(jf, *[jnp.asarray(ins[i]) for i in wrt])
    jg = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    ts = [torch.from_numpy(np.array(x)) for x in ins]
    for i in wrt:
        ts[i].requires_grad_(True)
    out = treg.get(name).fn(*ts, **kw)
    tg = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                             [ts[i] for i in wrt])
    return [g.numpy() for g in tg], jg


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("scalar", [1.0, 3.0, 0.5])
def test_smooth_l1_forward_and_gradient(scalar):
    rng = np.random.RandomState(0)
    s2 = scalar * scalar
    x = rng.uniform(-3, 3, (4, 7)).astype(np.float32)
    x[0, :3] = [1.0 / s2, -1.0 / s2, 0.0]       # on the branch boundary
    close(top("smooth_l1", x, scalar=scalar),
          jop("smooth_l1", x, scalar=scalar))
    cot = rng.randn(4, 7).astype(np.float32)
    tg, jg = grads_pair("smooth_l1", [x], cot, [0], scalar=scalar)
    close(tg[0], jg[0])


@pytest.mark.parametrize("norm,scale,thresh", [
    ("null", 1.0, 0.0), ("batch", 0.5, 0.0), ("valid", 2.0, 0.25),
    ("valid", 1.0, 10.0)])
def test_make_loss_forward_and_gradient(norm, scale, thresh):
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (3, 5)).astype(np.float32)
    kw = dict(grad_scale=scale, normalization=norm, valid_thresh=thresh)
    close(top("MakeLoss", x, **kw), jop("MakeLoss", x, **kw))
    cot = rng.randn(3, 5).astype(np.float32)    # ignored by both
    tg, jg = grads_pair("MakeLoss", [x], cot, [0], **kw)
    close(tg[0], jg[0])
    assert treg.get("make_loss") is treg.get("MakeLoss")


# --------------------------------------------------------------- box ops

def random_boxes(rng, shape, lo=0.0, hi=1.0):
    a = rng.uniform(lo, hi, shape + (2,))
    b = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([np.minimum(a, b), np.maximum(a, b)],
                          axis=-1).astype(np.float32)


def test_box_iou():
    rng = np.random.RandomState(2)
    a, b = random_boxes(rng, (2, 6)), random_boxes(rng, (2, 5))
    b[0, 0] = a[0, 0]
    close(top("_contrib_box_iou", a, b), jop("_contrib_box_iou", a, b))


def nms_case(kind):
    rng = np.random.RandomState(3)
    n = 24
    data = np.zeros((3, n, 6), np.float32)
    data[..., 0] = rng.randint(0, 3, (3, n))
    data[..., 1] = np.round(rng.uniform(0, 1, (3, n)), 1)  # many ties
    data[..., 2:] = random_boxes(rng, (3, n), 0, 0.6)
    if kind == "all_suppressed":
        data[..., 2:] = data[:, :1, 2:]
        data[..., 1] = 0.5
    elif kind == "empty":
        data[..., 1] = -0.5
    return data


@pytest.mark.parametrize("kind,kw", [
    ("ties", dict()),
    ("ties", dict(id_index=0, topk=5, valid_thresh=0.15)),
    ("ties", dict(id_index=0, force_suppress=True, overlap_thresh=0.3)),
    ("all_suppressed", dict()),
    ("empty", dict()),
])
def test_box_nms_bitwise(kind, kw):
    data = nms_case(kind)
    got, want = top("_contrib_box_nms", data, **kw), \
        jop("_contrib_box_nms", data, **kw)
    np.testing.assert_array_equal(got, want)
    # one sample as a 2-D input
    np.testing.assert_array_equal(top("_contrib_box_nms", data[1], **kw),
                                  jop("_contrib_box_nms", data[1], **kw))
    if kind == "all_suppressed":
        assert ((got[..., 1] >= 0).sum(axis=1) == 1).all()
    if kind == "empty":
        assert (got == -1).all()


@pytest.mark.parametrize("kw", [dict(threshold=0.3),
                                dict(threshold=0.6, is_ascend=True),
                                dict(threshold=0.1, topk=2)])
def test_bipartite_matching_bitwise(kw):
    rng = np.random.RandomState(4)
    x = np.round(rng.uniform(0, 1, (2, 5, 4)), 1).astype(np.float32)
    got, want = top("_contrib_bipartite_matching", x, **kw), \
        jop("_contrib_bipartite_matching", x, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------- multibox

@pytest.mark.parametrize("kw", [
    dict(sizes=(0.3, 0.39), ratios=(1.0, 2.0, 0.5)),
    dict(sizes=(0.5,), ratios=(1.0,), clip=True, steps=(0.2, 0.25),
         offsets=(0.3, 0.6)),
    dict(sizes=(0.9, 0.2), ratios=(3.0,), clip=True)])
def test_multibox_prior(kw):
    x = np.zeros((1, 4, 5, 7), np.float32)
    close(top("_contrib_MultiBoxPrior", x, **kw),
          jop("_contrib_MultiBoxPrior", x, **kw))


def target_case(seed=5, tie=False):
    rng = np.random.RandomState(seed)
    anchors = top("_contrib_MultiBoxPrior", np.zeros((1, 1, 6, 6),
                                                     np.float32),
                  sizes=(0.3, 0.5), ratios=(1.0, 2.0))
    n = anchors.shape[1]
    label = np.full((3, 3, 5), -1.0, np.float32)
    for b, k in enumerate((1, 2, 3)):
        label[b, :k, 0] = rng.randint(0, 3, k)
        label[b, :k, 1:] = random_boxes(rng, (k,), 0.05, 0.95)
    label[2, 2, 1:] = [0.0, 0.0, 0.01, 0.01]    # overlaps almost nothing
    conf = rng.randn(3, 4, n).astype(np.float32)
    if tie:
        conf[:, :, : n // 2] = conf[:, :, :1]   # equal background probs
    return anchors, label, conf


@pytest.mark.parametrize("tie,kw", [
    (False, dict()),
    (False, dict(negative_mining_ratio=3, negative_mining_thresh=0.5)),
    (True, dict(negative_mining_ratio=2, minimum_negative_samples=5,
                ignore_label=-1)),
    (True, dict(overlap_threshold=0.0, negative_mining_ratio=1)),
])
def test_multibox_target_bitwise_selection(tie, kw):
    anchors, label, conf = target_case(tie=tie)
    got = top("_contrib_MultiBoxTarget", anchors, label, conf, **kw)
    want = jop("_contrib_MultiBoxTarget", anchors, label, conf, **kw)
    np.testing.assert_array_equal(got[1], want[1])   # the match mask
    np.testing.assert_array_equal(got[2], want[2])   # classes and mining
    close(got[0], want[0])


def detection_case(seed=6):
    rng = np.random.RandomState(seed)
    anchors = top("_contrib_MultiBoxPrior", np.zeros((1, 1, 5, 5),
                                                     np.float32),
                  sizes=(0.3, 0.45), ratios=(1.0, 2.0))
    a = anchors.shape[1]
    logits = rng.randn(2, 4, a).astype(np.float32)
    logits[:, :, :10] = logits[:, :, :1]        # equal scores
    e = np.exp(logits - logits.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).astype(np.float32)
    loc = (rng.randn(2, a * 4) * 0.3).astype(np.float32)
    return prob, loc, anchors


@pytest.mark.parametrize("kw", [dict(), dict(force_suppress=True,
                                             nms_topk=7),
                                dict(threshold=0.4, nms_threshold=0.3)])
def test_multibox_detection(kw):
    prob, loc, anchors = detection_case()
    got = top("_contrib_MultiBoxDetection", prob, loc, anchors, **kw)
    want = jop("_contrib_MultiBoxDetection", prob, loc, anchors, **kw)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])  # ids, -1s
    np.testing.assert_array_equal(got[..., 1] >= 0, want[..., 1] >= 0)
    close(got, want)


# ------------------------------------------------------------------- ROIs

def roi_case(seed=7):
    rng = np.random.RandomState(seed)
    data = np.maximum(rng.randn(2, 3, 9, 11), 0).astype(np.float32)
    data[:, :, 2:5, 3:7] = 0.0                  # all-zero bins after ReLU
    rois = np.array([[0, 0, 0, 160, 128], [1, 16, 8, 95, 60],
                     [0, 40, 33, 60, 47], [1, -20, -16, 300, 250],
                     [0, 48, 32, 120, 80], [1, 100, 100, 100, 100]],
                    np.float32)
    return data, rois


@pytest.mark.parametrize("pooled", [(2, 2), (3, 4)])
def test_roi_pooling_forward_and_gradient(pooled):
    data, rois = roi_case()
    kw = dict(pooled_size=pooled, spatial_scale=1.0 / 16)
    close(top("ROIPooling", data, rois, **kw),
          jop("ROIPooling", data, rois, **kw))
    cot = np.random.RandomState(8).randn(len(rois), 3, *pooled) \
        .astype(np.float32)
    tg, jg = grads_pair("ROIPooling", [data, rois], cot, [0], **kw)
    close(tg[0], jg[0])


@pytest.mark.parametrize("pooled,sr", [((2, 2), -1), ((1, 3), 3)])
def test_roi_align_forward_and_gradients(pooled, sr):
    data, rois = roi_case(9)
    rois[:, 1:] += 0.37                          # off the grid
    kw = dict(pooled_size=pooled, spatial_scale=1.0 / 16, sample_ratio=sr)
    close(top("_contrib_ROIAlign", data, rois, **kw),
          jop("_contrib_ROIAlign", data, rois, **kw))
    cot = np.random.RandomState(10).randn(len(rois), 3, *pooled) \
        .astype(np.float32)
    tg, jg = grads_pair("_contrib_ROIAlign", [data, rois], cot, [0, 1], **kw)
    close(tg[0], jg[0])
    np.testing.assert_allclose(tg[1], jg[1], rtol=RTOL, atol=1e-5)


# ---------------------------------------------------------------- Proposal

def proposal_case(seed=11, n=2, fh=6, fw=7, A=3):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, 2, A, fh, fw).astype(np.float32)
    logits[:, :, :, :2] = logits[:, :, :, :1]   # equal scores
    e = np.exp(logits - logits.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).reshape(n, 2 * A, fh, fw) \
        .astype(np.float32)
    deltas = (rng.randn(n, 4 * A, fh, fw) * 0.2).astype(np.float32)
    deltas[1, 2::4] = -4.0                      # tiny boxes: scored -1
    info = np.array([[96, 112, 1.0], [80, 90, 1.5]], np.float32)[:n]
    return prob, deltas, info


@pytest.mark.parametrize("kw", [
    dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=12, threshold=0.7,
         rpn_min_size=8),
    dict(rpn_pre_nms_top_n=500, rpn_post_nms_top_n=200, threshold=0.5,
         rpn_min_size=4, output_score=True),
    dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=10, threshold=0.6,
         rpn_min_size=4, iou_loss=True, output_score=True),
])
def test_proposal_bitwise_selection(kw):
    prob, deltas, info = proposal_case()
    kw = dict(kw, scales=(2, 4, 6), ratios=(1.0,), feature_stride=16)
    got = top("_contrib_Proposal", prob, deltas, info, **kw)
    want = jop("_contrib_Proposal", prob, deltas, info, **kw)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    rois_t, rois_j = got[0], want[0]
    np.testing.assert_array_equal(rois_t[:, 0], rois_j[:, 0])
    np.testing.assert_array_equal(rois_t[:, 1] == -1, rois_j[:, 1] == -1)
    close(rois_t, rois_j)
    if kw.get("output_score"):
        close(got[1], want[1])
    if kw["rpn_post_nms_top_n"] == 200:          # more rows than survive
        assert (rois_t[:, 1:] == -1).all(axis=1).any()
    assert treg.get("Proposal") is treg.get("_contrib_Proposal")


def test_namespaces_expose_every_detection_op():
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "Proposal", "ROIAlign", "box_nms", "box_iou",
                 "bipartite_matching"):
        assert hasattr(mt.sym.contrib, name) and hasattr(mt.nd.contrib, name)
    for name in ("ROIPooling", "smooth_l1", "MakeLoss", "make_loss",
                 "Custom", "Proposal", "_contrib_box_nms",
                 "_contrib_MultiBoxPrior"):
        assert hasattr(mt.sym, name) and hasattr(mt.nd, name)
    # the eager surface the JAX package's tests call
    with mt.cpu():
        x = mt.nd.array(nms_case("ties"))
        out = mt.nd._contrib_box_nms(x, overlap_thresh=0.5)
    np.testing.assert_array_equal(
        out.asnumpy(), jop("_contrib_box_nms", nms_case("ties"),
                           overlap_thresh=0.5))
