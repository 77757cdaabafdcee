"""The region proposal op (counterpart of a part of
``mxnet_tpu/ops/vision_ops.py``): ``_contrib_Proposal`` (alias
``Proposal``) with the anchors of :func:`_make_anchors`.

Per image: the anchors shifted over the feature grid, the deltas
decoded (the +1-width convention, or direct corner offsets under
``iou_loss``), clipped to the image, boxes under ``rpn_min_size *
im_info[2]`` scored -1, the ``rpn_pre_nms_top_n`` best kept (a stable
descending sort: ``lax.top_k`` takes the lower index among ties),
``box_nms`` over them, survivors compacted to the front and the rest of
the ``rpn_post_nms_top_n`` rows -1, as in the JAX op. The NMS walk runs
on the host (:mod:`.contrib_ops`), so the op is marked ``host``.

The rest of the JAX file (``Correlation``, ``Crop``,
``DeformableConvolution``, ``PSROIPooling``, ``DeformablePSROIPooling``
and the two small ops) is not ported yet (ROADMAP A9).
"""
from __future__ import annotations

import numpy as _np
import torch

from .contrib_ops import box_nms
from .registry import alias, register

__all__ = ["_make_anchors", "proposal"]


def _make_anchors(base_size, scales, ratios):
    """The reference's GenerateAnchors: base box (0, 0, bs-1, bs-1),
    ratios enumerated first, then scales -> (A, 4) float32."""
    bs = float(base_size)
    px, py = (bs - 1) * 0.5, (bs - 1) * 0.5
    size = bs * bs
    anchors = []
    for r in ratios:
        size_ratio = size / r
        ws = round(_np.sqrt(size_ratio))
        hs = round(ws * r)
        for s in scales:
            w2, h2 = ws * s, hs * s
            anchors.append([px - (w2 - 1) * 0.5, py - (h2 - 1) * 0.5,
                            px + (w2 - 1) * 0.5, py + (h2 - 1) * 0.5])
    return _np.asarray(anchors, _np.float32)


def _proposal_outputs(p):
    return 2 if p.get("output_score") else 1


@register("_contrib_Proposal", num_outputs=_proposal_outputs, host=True)
def proposal(cls_prob, bbox_pred, im_info, *, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
             feature_stride=16, output_score=False, iou_loss=False):
    """cls_prob (N, 2A, fh, fw), bbox_pred (N, 4A, fh, fw), im_info (N,
    3) [height, width, scale] -> rois (N * post, 5) [batch_idx, x1, y1,
    x2, y2] (and their scores (N * post, 1) with ``output_score``)."""
    n, _, fh, fw = cls_prob.shape
    post = int(rpn_post_nms_top_n)
    if cls_prob.is_meta or bbox_pred.is_meta or im_info.is_meta:
        rois = torch.empty((n * post, 5), device="meta")
        return (rois, torch.empty((n * post, 1), device="meta")) \
            if output_score else rois
    A = len(scales) * len(ratios)
    dev = cls_prob.device
    f32 = torch.float32
    base = torch.from_numpy(_make_anchors(feature_stride, scales,
                                          ratios)).to(dev)
    shift_x = torch.arange(fw, device=dev, dtype=torch.int32) \
        * int(feature_stride)
    shift_y = torch.arange(fh, device=dev, dtype=torch.int32) \
        * int(feature_stride)
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 4)
    anchors = (base[None] + shifts[:, None].to(f32)).reshape(-1, 4)
    packed = []
    for i in range(n):
        info = im_info[i]
        scores = cls_prob[i, A:].permute(1, 2, 0).reshape(-1)
        d = bbox_pred[i].reshape(A, 4, fh, fw).permute(2, 3, 0, 1) \
            .reshape(-1, 4)
        if iou_loss:
            x1 = anchors[:, 0] + d[:, 0]
            y1 = anchors[:, 1] + d[:, 1]
            x2 = anchors[:, 2] + d[:, 2]
            y2 = anchors[:, 3] + d[:, 3]
        else:
            widths = anchors[:, 2] - anchors[:, 0] + 1.0
            heights = anchors[:, 3] - anchors[:, 1] + 1.0
            ctr_x = anchors[:, 0] + 0.5 * (widths - 1)
            ctr_y = anchors[:, 1] + 0.5 * (heights - 1)
            pred_x = d[:, 0] * widths + ctr_x
            pred_y = d[:, 1] * heights + ctr_y
            pred_w = torch.exp(d[:, 2]) * widths
            pred_h = torch.exp(d[:, 3]) * heights
            x1 = pred_x - 0.5 * (pred_w - 1)
            y1 = pred_y - 0.5 * (pred_h - 1)
            x2 = pred_x + 0.5 * (pred_w - 1)
            y2 = pred_y + 0.5 * (pred_h - 1)
        zero = torch.zeros((), dtype=x1.dtype, device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), info[1] - 1.0)
        y1 = torch.minimum(torch.maximum(y1, zero), info[0] - 1.0)
        x2 = torch.minimum(torch.maximum(x2, zero), info[1] - 1.0)
        y2 = torch.minimum(torch.maximum(y2, zero), info[0] - 1.0)
        min_sz = rpn_min_size * info[2]
        keep = ((x2 - x1 + 1) >= min_sz) & ((y2 - y1 + 1) >= min_sz)
        scores = torch.where(keep, scores,
                             torch.full((), -1.0, dtype=scores.dtype,
                                        device=dev))
        pre_n = min(rpn_pre_nms_top_n, scores.shape[0]) \
            if rpn_pre_nms_top_n > 0 else scores.shape[0]
        order = torch.sort(scores.detach(), descending=True,
                           stable=True).indices[:pre_n]
        top_scores = scores[order]
        boxes = torch.stack([x1, y1, x2, y2], dim=1)[order]
        packed.append(torch.cat([torch.zeros((pre_n, 1), dtype=boxes.dtype,
                                             device=dev),
                                 top_scores[:, None], boxes], dim=1))
    # one NMS call for the batch: one copy to the host, one walk an image
    nms_all = box_nms(torch.stack(packed), overlap_thresh=threshold,
                      valid_thresh=0.0, topk=post, coord_start=2,
                      score_index=1, id_index=-1, force_suppress=True)
    rois_all, scores_all = [], []
    for nms in nms_all:
        kept = nms[:, 1].detach() >= 0
        idx = torch.sort((~kept).to(torch.int32), stable=True) \
            .indices[:post]
        rows = nms[idx]
        valid = kept[idx]
        minus = torch.full((), -1.0, dtype=rows.dtype, device=dev)
        rois = torch.where(valid[:, None], rows[:, 2:6], minus)
        rscores = torch.where(valid, rows[:, 1], minus)
        short = post - rois.shape[0]
        if short > 0:
            rois = torch.cat([rois, minus.expand(short, 4)], dim=0)
            rscores = torch.cat([rscores, minus.expand(short)], dim=0)
        rois_all.append(rois)
        scores_all.append(rscores)
    rois = torch.stack(rois_all)
    batch_idx = torch.arange(n, dtype=rois.dtype, device=dev)[:, None, None] \
        .expand(n, rois.shape[1], 1)
    out = torch.cat([batch_idx, rois], dim=2).reshape(-1, 5)
    if output_score:
        return out, torch.stack(scores_all).reshape(-1, 1)
    return out


alias("_contrib_Proposal", "Proposal")
