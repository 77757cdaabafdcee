"""The two detection examples' models and loops, spelled over a package
argument so that the JAX package and the port build the same graphs.

``ssd_parts(mx)`` is ``examples/train_ssd.py``'s ``ssd_symbol`` and
``MultiBoxMetric``, with the reference SSD's inference head beside it
(``detect_symbol``: softmax over the classes, then
``MultiBoxDetection``); ``rcnn_parts(mx)`` is ``examples/train_rcnn.py``'s
anchors, ``anchor_targets``, ``ProposalTargetProp``/``ProposalTarget``
(registered under ``op_type="proposal_target"`` in ``mx.operator``),
``rcnn_symbol``, ``RCNNIter`` and ``RCNNMetric``, at the example's sizes.
The anchors come from the package's own ``ops.vision_ops._make_anchors``.

Pass ``mxnet_tpu_torch`` (as ``chip_smoke.py`` does) or ``mxnet_tpu``;
nothing here imports either. :func:`det_fixture` loads the detection
fixture's ``fixture.py`` under a name of its own (the JPEG fixture's
module is also called ``fixture``). The tests hold these spellings to the
examples' own graphs node for node
(``tests/test_torch_port_detection_train.py``).
"""
import importlib
import importlib.util
import os
from types import SimpleNamespace

import numpy as np

# examples/train_rcnn.py's sizes
IMG = 128
STRIDE = 16
FEAT = IMG // STRIDE
SCALES = (2, 4, 6)
RATIOS = (1.0,)
A = len(SCALES) * len(RATIOS)
NUM_CLASSES = 3
ROIS_PER_IMG = 16


def det_fixture():
    """``tests/data/det_fixture/fixture.py`` as the module ``det_fixture``."""
    import sys
    mod = sys.modules.get("det_fixture")
    if mod is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "det_fixture", "fixture.py")
        spec = importlib.util.spec_from_file_location("det_fixture", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["det_fixture"] = mod
    return mod


def ssd_parts(mx):
    def heads(data, num_classes, num_anchors_per_pos):
        def conv_block(x, nf, name, stride=1):
            x = mx.sym.Convolution(x, kernel=(3, 3), stride=(stride, stride),
                                   pad=(1, 1), num_filter=nf, name=name)
            x = mx.sym.BatchNorm(x, name=name + "_bn")
            return mx.sym.Activation(x, act_type="relu")

        x = conv_block(data, 16, "c1")
        x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
        x = conv_block(x, 32, "c2")
        feat1 = conv_block(x, 32, "c3")
        feat2 = conv_block(feat1, 64, "c4", stride=2)

        loc_preds, cls_preds, anchors = [], [], []
        for i, (feat, size) in enumerate([(feat1, 0.3), (feat2, 0.6)]):
            na = num_anchors_per_pos
            loc = mx.sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                                     num_filter=na * 4, name="loc%d" % i)
            loc = mx.sym.Flatten(mx.sym.transpose(loc, axes=(0, 2, 3, 1)))
            loc_preds.append(loc)
            cls = mx.sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                                     num_filter=na * (num_classes + 1),
                                     name="cls%d" % i)
            cls = mx.sym.Flatten(mx.sym.transpose(cls, axes=(0, 2, 3, 1)))
            cls_preds.append(cls)
            anchors.append(mx.sym.contrib.MultiBoxPrior(
                feat, sizes=(size, size * 1.3), ratios=(1.0, 2.0, 0.5),
                name="anchors%d" % i))
        loc_preds = mx.sym.Concat(*loc_preds, dim=1,
                                  name="multibox_loc_pred")
        cls_preds = mx.sym.Concat(*cls_preds, dim=1)
        cls_preds = mx.sym.reshape(cls_preds, shape=(0, -1, num_classes + 1))
        cls_preds = mx.sym.transpose(cls_preds, axes=(0, 2, 1),
                                     name="multibox_cls_pred")
        anchors = mx.sym.Concat(*anchors, dim=1, name="multibox_anchors")
        return loc_preds, cls_preds, anchors

    def ssd_symbol(num_classes=3, num_anchors_per_pos=4):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("label")
        loc_preds, cls_preds, anchors = heads(data, num_classes,
                                              num_anchors_per_pos)
        tmp = mx.sym.contrib.MultiBoxTarget(
            anchors, label, cls_preds, overlap_threshold=0.5,
            ignore_label=-1, negative_mining_ratio=3,
            minimum_negative_samples=0, negative_mining_thresh=0.5,
            variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
        loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]

        cls_prob = mx.sym.SoftmaxOutput(cls_preds, cls_target,
                                        ignore_label=-1, use_ignore=True,
                                        multi_output=True,
                                        normalization="valid",
                                        name="cls_prob")
        loc_loss_ = mx.sym.smooth_l1(
            loc_target_mask * (loc_preds - loc_target), scalar=1.0,
            name="loc_loss_")
        loc_loss = mx.sym.MakeLoss(loc_loss_, normalization="valid",
                                   name="loc_loss")
        cls_label = mx.sym.MakeLoss(cls_target, grad_scale=0,
                                    name="cls_label")
        return mx.sym.Group([cls_prob, loc_loss, cls_label])

    def detect_symbol(num_classes=3, num_anchors_per_pos=4):
        """The inference head of the reference SSD (its get_symbol):
        class probabilities over the classes axis, then detections ->
        Group(detections, class probabilities, box offsets, anchors)."""
        data = mx.sym.Variable("data")
        loc_preds, cls_preds, anchors = heads(data, num_classes,
                                              num_anchors_per_pos)
        cls_prob = mx.sym.softmax(cls_preds, axis=1, name="cls_prob")
        det = mx.sym.contrib.MultiBoxDetection(
            cls_prob, loc_preds, anchors, nms_threshold=0.5,
            force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
            nms_topk=400, name="detection")
        return mx.sym.Group([det, cls_prob, loc_preds, anchors])

    class MultiBoxMetric(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("multibox")

        def update(self, labels, preds):
            cls_prob = preds[0].asnumpy()
            loc_loss = preds[1].asnumpy()
            cls_target = preds[2].asnumpy()
            valid = cls_target >= 0
            idx = cls_target.astype(int)
            probs = np.take_along_axis(
                cls_prob, idx[:, None, :].clip(0), axis=1)[:, 0, :]
            ce = -np.log(np.maximum(probs[valid], 1e-9)).sum()
            self.sum_metric += ce + loc_loss.sum()
            self.num_inst += max(int(valid.sum()), 1)

    return SimpleNamespace(ssd_symbol=ssd_symbol, detect_symbol=detect_symbol,
                           MultiBoxMetric=MultiBoxMetric)


def iou(boxes, gt):
    x1 = np.maximum(boxes[:, 0], gt[0])
    y1 = np.maximum(boxes[:, 1], gt[1])
    x2 = np.minimum(boxes[:, 2], gt[2])
    y2 = np.minimum(boxes[:, 3], gt[3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_g = (gt[2] - gt[0]) * (gt[3] - gt[1])
    return inter / np.maximum(area_b + area_g - inter, 1e-6)


def bbox_transform(anchors, gt):
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + (aw - 1) / 2
    ay = anchors[:, 1] + (ah - 1) / 2
    gw, gh = gt[2] - gt[0] + 1.0, gt[3] - gt[1] + 1.0
    gx, gy = gt[0] + (gw - 1) / 2, gt[1] + (gh - 1) / 2
    return np.stack([(gx - ax) / aw, (gy - ay) / ah,
                     np.log(gw / aw), np.log(gh / ah)], -1)


def rcnn_parts(mx):
    make = importlib.import_module(mx.__name__ + ".ops.vision_ops") \
        ._make_anchors
    base = make(STRIDE, SCALES, RATIOS)
    shifts = np.arange(FEAT) * STRIDE
    sx, sy = np.meshgrid(shifts, shifts)
    grid = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    anchors = (grid + base[None]).reshape(-1, 4)

    def anchor_targets(gt_box):
        overlaps = iou(anchors, gt_box)
        label = np.full(len(anchors), -1.0, np.float32)
        label[overlaps < 0.3] = 0.0
        label[overlaps >= 0.5] = 1.0
        label[overlaps.argmax()] = 1.0
        neg = np.where(label == 0)[0]
        if len(neg) > 3 * max((label == 1).sum(), 1) + 8:
            drop = np.random.RandomState(0).choice(
                neg, len(neg) - (3 * int((label == 1).sum()) + 8),
                replace=False)
            label[drop] = -1.0
        targets = bbox_transform(anchors, gt_box).astype(np.float32)
        weight = (label == 1).astype(np.float32)[:, None] * np.ones(
            (1, 4), np.float32)
        lab = label.reshape(FEAT * FEAT, A).T.reshape(-1)
        tgt = targets.reshape(FEAT, FEAT, A * 4).transpose(2, 0, 1)
        wgt = weight.reshape(FEAT, FEAT, A * 4).transpose(2, 0, 1)
        return lab, tgt, wgt

    @mx.operator.register("proposal_target")
    class ProposalTargetProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["rois", "gt_boxes"]

        def list_outputs(self):
            return ["rois_out", "label", "bbox_target", "bbox_weight"]

        def infer_shape(self, in_shape):
            n_img = in_shape[1][0]
            n = n_img * ROIS_PER_IMG
            return in_shape, [(n, 5), (n,), (n, 4 * NUM_CLASSES),
                              (n, 4 * NUM_CLASSES)], []

        def create_operator(self, ctx, shapes, dtypes):
            return ProposalTarget()

    class ProposalTarget(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            rois = in_data[0].asnumpy()
            gts = in_data[1].asnumpy()
            out_r, out_l, out_t, out_w = [], [], [], []
            for b in range(len(gts)):
                gt = gts[b]
                mine = rois[rois[:, 0] == b][:, 1:]
                mine = mine[mine[:, 2] > mine[:, 0]]
                if len(mine) == 0:
                    mine = anchors[:1]
                pool = np.vstack([mine, gt[None, :4]])
                ov = iou(pool, gt[:4])
                order = np.argsort(-ov)
                fg = order[ov[order] >= 0.5][: ROIS_PER_IMG // 4]
                bg = order[ov[order] < 0.5][: ROIS_PER_IMG - len(fg)]
                keep = np.concatenate([fg, bg])
                if len(keep) < ROIS_PER_IMG:
                    keep = np.resize(keep, ROIS_PER_IMG)
                sel = pool[keep]
                lab = np.zeros(ROIS_PER_IMG, np.float32)
                lab[: len(fg)] = gt[4] + 1
                tgt = np.zeros((ROIS_PER_IMG, 4 * NUM_CLASSES), np.float32)
                wgt = np.zeros_like(tgt)
                deltas = bbox_transform(sel[: len(fg)], gt[:4]) \
                    if len(fg) else np.zeros((0, 4))
                for j in range(len(fg)):
                    c = int(lab[j])
                    tgt[j, 4 * c:4 * c + 4] = deltas[j]
                    wgt[j, 4 * c:4 * c + 4] = 1.0
                out_r.append(np.hstack([np.full((ROIS_PER_IMG, 1), b,
                                                np.float32), sel]))
                out_l.append(lab)
                out_t.append(tgt)
                out_w.append(wgt)
            self.assign(out_data[0], req[0], np.vstack(out_r))
            self.assign(out_data[1], req[1], np.concatenate(out_l))
            self.assign(out_data[2], req[2], np.vstack(out_t))
            self.assign(out_data[3], req[3], np.vstack(out_w))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            for g in in_grad:
                self.assign(g, "write", 0 * g)

    def rcnn_symbol():
        data = mx.sym.Variable("data")
        im_info = mx.sym.Variable("im_info")
        gt_boxes = mx.sym.Variable("gt_boxes")
        rpn_label = mx.sym.Variable("rpn_label")
        rpn_bbox_target = mx.sym.Variable("rpn_bbox_target")
        rpn_bbox_weight = mx.sym.Variable("rpn_bbox_weight")

        def conv_block(x, nf, name, stride=1):
            x = mx.sym.Convolution(x, kernel=(3, 3), stride=(stride, stride),
                                   pad=(1, 1), num_filter=nf, name=name)
            return mx.sym.Activation(x, act_type="relu")

        x = conv_block(data, 16, "c1", 2)
        x = conv_block(x, 32, "c2", 2)
        x = conv_block(x, 32, "c3", 2)
        feat = conv_block(x, 64, "c4", 2)

        rpn = conv_block(feat, 64, "rpn_conv")
        rpn_cls = mx.sym.Convolution(rpn, kernel=(1, 1), num_filter=2 * A,
                                     name="rpn_cls_score")
        rpn_bbox = mx.sym.Convolution(rpn, kernel=(1, 1), num_filter=4 * A,
                                      name="rpn_bbox_pred")

        rpn_cls_r = mx.sym.reshape(rpn_cls, shape=(0, 2, -1))
        rpn_cls_prob = mx.sym.SoftmaxOutput(
            rpn_cls_r, rpn_label, multi_output=True, use_ignore=True,
            ignore_label=-1, normalization="valid", name="rpn_cls_prob")
        rpn_bbox_loss = mx.sym.MakeLoss(
            mx.sym.smooth_l1(rpn_bbox_weight * (rpn_bbox - rpn_bbox_target),
                             scalar=3.0),
            grad_scale=1.0 / (FEAT * FEAT), name="rpn_bbox_loss")

        score_shape = mx.sym.reshape(rpn_cls, shape=(0, 2, A, FEAT, FEAT))
        probs = mx.sym.softmax(score_shape, axis=1)
        probs = mx.sym.reshape(probs, shape=(0, 2 * A, FEAT, FEAT))
        rois = mx.sym.contrib.Proposal(
            mx.sym.BlockGrad(probs), mx.sym.BlockGrad(rpn_bbox), im_info,
            feature_stride=STRIDE, scales=SCALES, ratios=RATIOS,
            rpn_pre_nms_top_n=64, rpn_post_nms_top_n=ROIS_PER_IMG,
            threshold=0.7, rpn_min_size=8, name="rois")
        target = mx.sym.Custom(rois=rois, gt_boxes=gt_boxes,
                               op_type="proposal_target", name="pt")
        rois_s, label, bbox_target, bbox_weight = (
            target[0], target[1], target[2], target[3])

        pooled = mx.sym.ROIPooling(feat, rois_s, pooled_size=(4, 4),
                                   spatial_scale=1.0 / STRIDE,
                                   name="roi_pool")
        h = mx.sym.Activation(
            mx.sym.FullyConnected(pooled, num_hidden=128, name="fc6"),
            act_type="relu")
        cls_prob = mx.sym.SoftmaxOutput(
            mx.sym.FullyConnected(h, num_hidden=NUM_CLASSES,
                                  name="cls_score"),
            mx.sym.BlockGrad(label), normalization="valid", name="cls_prob")
        bbox_loss = mx.sym.MakeLoss(
            mx.sym.smooth_l1(
                bbox_weight * (mx.sym.FullyConnected(
                    h, num_hidden=4 * NUM_CLASSES, name="bbox_pred")
                    - bbox_target), scalar=1.0),
            grad_scale=1.0 / ROIS_PER_IMG, name="bbox_loss")
        return mx.sym.Group([rpn_cls_prob, rpn_bbox_loss, cls_prob,
                             bbox_loss, mx.sym.BlockGrad(label)])

    class RCNNIter(mx.io.DataIter):
        def __init__(self, n=64, batch_size=2, seed=0):
            super().__init__(batch_size)
            rng = np.random.RandomState(seed)
            self.data, self.gt = [], []
            for _ in range(n):
                img = rng.rand(3, IMG, IMG).astype(np.float32) * 0.1
                cls = rng.randint(0, NUM_CLASSES - 1)
                size = rng.randint(36, 80)
                x1 = rng.randint(0, IMG - size)
                y1 = rng.randint(0, IMG - size)
                img[cls, y1:y1 + size, x1:x1 + size] += 0.8
                self.data.append(img)
                self.gt.append(np.array([x1, y1, x1 + size, y1 + size, cls],
                                        np.float32))
            self.n = n
            self.reset()

        @property
        def provide_data(self):
            return [("data", (self.batch_size, 3, IMG, IMG)),
                    ("im_info", (self.batch_size, 3)),
                    ("gt_boxes", (self.batch_size, 5))]

        @property
        def provide_label(self):
            return [("rpn_label", (self.batch_size, A * FEAT * FEAT)),
                    ("rpn_bbox_target", (self.batch_size, 4 * A, FEAT, FEAT)),
                    ("rpn_bbox_weight", (self.batch_size, 4 * A, FEAT, FEAT))]

        def reset(self):
            self.cursor = -self.batch_size

        def next(self):
            self.cursor += self.batch_size
            if self.cursor + self.batch_size > self.n:
                raise StopIteration
            sl = slice(self.cursor, self.cursor + self.batch_size)
            imgs = np.stack(self.data[sl])
            gts = np.stack(self.gt[sl])
            labs, tgts, wgts = zip(*(anchor_targets(g[:4])
                                     for g in self.gt[sl]))
            info = np.tile([IMG, IMG, 1.0], (self.batch_size, 1)) \
                .astype(np.float32)
            return mx.io.DataBatch(
                data=[mx.nd.array(imgs), mx.nd.array(info),
                      mx.nd.array(gts)],
                label=[mx.nd.array(np.stack(labs)),
                       mx.nd.array(np.stack(tgts)),
                       mx.nd.array(np.stack(wgts))], pad=0)

    class RCNNMetric(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("rcnn_loss")

        def update(self, labels, preds):
            rpn_prob = preds[0].asnumpy()
            rpn_lab = labels[0].asnumpy()
            m = rpn_lab >= 0
            idx = rpn_lab.clip(0).astype(int)
            p = np.take_along_axis(rpn_prob, idx[:, None, :], 1)[:, 0][m]
            rpn_nll = -np.log(np.maximum(p, 1e-9)).sum()
            cls_prob = preds[2].asnumpy()
            lab = preds[4].asnumpy().astype(int).ravel()
            pc = cls_prob[np.arange(len(lab)), lab]
            cls_nll = -np.log(np.maximum(pc, 1e-9)).sum()
            self.sum_metric += rpn_nll + cls_nll
            self.num_inst += m.sum() + len(lab)

    return SimpleNamespace(
        anchors=anchors, anchor_targets=anchor_targets,
        ProposalTargetProp=ProposalTargetProp,
        ProposalTarget=ProposalTarget, rcnn_symbol=rcnn_symbol,
        RCNNIter=RCNNIter, RCNNMetric=RCNNMetric)
