"""Detection and ROI operators (counterpart of a part of
``mxnet_tpu/ops/contrib_ops.py``): ``ROIPooling``, ``_contrib_ROIAlign``,
``_contrib_MultiBoxPrior``, ``_contrib_box_iou``, ``_contrib_box_nms``,
``_contrib_MultiBoxDetection``, ``_contrib_MultiBoxTarget`` and
``_contrib_bipartite_matching``, with the JAX ops' keyword names, output
layouts and static shapes (suppressed rows become -1 rows, matches -1).

Plain torch; torch autograd gives each op the gradient the JAX op's vjp
gives, but ROIPooling's, written out (``_ROIPoolFn``: ``jnp.max``'s,
equal maxima sharing the cotangent, summed into the images without a
scatter-add, so that it is the same from run to run). Where the JAX op
breaks ties by index (``jnp.argsort`` is stable, ``argmax`` takes the
first maximum), the port sorts stably and takes the first maximum
itself, on the CPU and on a card alike.

Two walks are sequential by nature and run on the host:
* box_nms's greedy pass. The IoU matrix is computed once where the data
  lies; its suppression bits (``iou > overlap_thresh`` above the
  diagonal, same class where classes count) are packed eight to a byte
  there and copied to the host in one transfer with the candidates; the
  walk visits the candidates in score order, each kept one OR-ing its
  row into the removed set. ``nms_passes`` and ``nms_copy_bytes`` count
  the walks and the bytes copied.
* bipartite_matching's walk over the sorted scores (one copy of the
  scores to the host).
Both mark their op ``host`` in the registry: a train step holding one
runs uncaptured (``module.fused``). MultiBoxTarget's bipartite pass
loops over the label's M slots with device ops only, as the JAX op's
``fori_loop`` does, so it reads nothing back.

The rest of the JAX file (the spatial transformer family,
``boolean_mask``, ``index_copy``, ``SVMOutput``, ``fft``/``ifft``,
``count_sketch``, ``getnnz``) is not ported yet (ROADMAP A9).
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .registry import alias, register

__all__ = ["nms_passes", "nms_copy_bytes", "reset_counts", "box_iou",
           "box_nms", "first_argmax"]

nms_passes = 0        # greedy walks run on the host (one per sample)
nms_copy_bytes = 0    # bytes copied to the host for them


def reset_counts():
    global nms_passes, nms_copy_bytes
    nms_passes = 0
    nms_copy_bytes = 0


def first_argmax(x, dim):
    """Index of the first maximum along ``dim`` (``jnp.argmax``'s tie
    rule, whatever the device)."""
    n = x.shape[dim]
    hit = x == x.amax(dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).reshape(shape)
    return torch.where(hit, idx, n).amin(dim=dim)


def _meta(*shapes, dtype=torch.float32):
    outs = tuple(torch.empty(s, dtype=dtype, device="meta") for s in shapes)
    return outs if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# ROI pooling / align
# ---------------------------------------------------------------------------

@register("ROIPooling")
def roi_pooling(data, rois, *, pooled_size, spatial_scale):
    """Max-pool regions of interest: data (N, C, H, W), rois (R, 5) rows
    [batch_idx, x1, y1, x2, y2] in image coordinates -> (R, C, ph, pw).
    Corners round half to even after scaling; bin edges are floor/ceil
    of ``py * (rh / ph)`` in f32, as in the JAX op; an empty bin is 0."""
    n, c, h, w = data.shape
    ph, pw = (int(v) for v in pooled_size)
    if data.is_meta or rois.is_meta:
        return _meta((rois.shape[0], c, ph, pw), dtype=data.dtype)
    dev = data.device
    bi = rois[:, 0].detach().to(torch.int32).long()
    corner = [torch.round(rois[:, k].detach() * spatial_scale)
              .to(torch.int32) for k in range(1, 5)]
    x1, y1, x2, y2 = corner
    rh = torch.clamp_min(y2 - y1 + 1, 1)
    rw = torch.clamp_min(x2 - x1 + 1, 1)
    hb = rh / ph
    wb = rw / pw

    def axis_mask(lo0, hi_end, bins, size, step):
        # (R, bins, size): the cells of each bin along one axis
        p = torch.arange(bins, device=dev)
        lo = lo0[:, None] + torch.floor(p[None, :] * step[:, None]) \
            .to(torch.int32)
        hi = lo0[:, None] + torch.ceil((p[None, :] + 1) * step[:, None]) \
            .to(torch.int32)
        pos = torch.arange(size, device=dev)[None, None, :]
        return (pos >= lo[..., None]) \
            & (pos < torch.maximum(hi, lo + 1)[..., None]) \
            & (pos <= hi_end[:, None, None])

    ymask = axis_mask(y1, y2, ph, h, hb)            # (R, ph, H)
    xmask = axis_mask(x1, x2, pw, w, wb)            # (R, pw, W)
    m = ymask[:, :, None, :, None] & xmask[:, None, :, None, :]
    return _ROIPoolFn.apply(data, m, bi)


class _ROIPoolFn(torch.autograd.Function):
    """ROIPooling over the bin masks ``m`` (R, ph, pw, H, W) of the ROIs'
    images ``bi``. The backward is ``jnp.max``'s: each bin's cotangent
    split equally among the cells that hold its maximum (0 for an empty
    bin), then summed into each image by a one-hot product over the ROIs:
    no scatter-add over repeated image indices, whose order (threads on
    the CPU, atomics on a card) would change the last bits from run to
    run."""

    @staticmethod
    def _cells(data, m, bi):
        img = data[bi]                              # (R, C, H, W)
        return torch.where(m[:, None], img[:, :, None, None],
                           torch.full((), -math.inf, dtype=data.dtype,
                                      device=data.device))

    @staticmethod
    def forward(ctx, data, m, bi):
        out = _ROIPoolFn._cells(data, m, bi).amax(dim=(-2, -1))
        ctx.save_for_backward(data, m, bi, out)
        return torch.where(torch.isfinite(out), out,
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device))

    @staticmethod
    def backward(ctx, g):
        data, m, bi, out = ctx.saved_tensors
        n, c, h, w = data.shape
        hit = (_ROIPoolFn._cells(data, m, bi) == out[..., None, None]) \
            & m[:, None]
        count = hit.sum(dim=(-2, -1))
        share = torch.where(count > 0, g / count.clamp_min(1),
                            torch.zeros((), dtype=g.dtype, device=g.device))
        per_roi = (hit * share[..., None, None]).sum(dim=(2, 3))
        onehot = (bi[None, :] == torch.arange(n, device=bi.device)[:, None]) \
            .to(g.dtype)                            # (N, R)
        grad = onehot @ per_roi.reshape(per_roi.shape[0], -1)
        return grad.reshape(n, c, h, w), None, None


@register("_contrib_ROIAlign")
def roi_align(data, rois, *, pooled_size, spatial_scale, sample_ratio=-1,
              position_sensitive=False):
    """Bilinear ROI align: each bin averages ``sample_ratio`` squared
    (2 when not positive) bilinear samples, the samples clipped into the
    image, as in the JAX op; differentiable in data and rois."""
    n, c, h, w = data.shape
    ph, pw = (int(v) for v in pooled_size)
    if data.is_meta or rois.is_meta:
        return _meta((rois.shape[0], c, ph, pw), dtype=data.dtype)
    sr = 2 if sample_ratio <= 0 else int(sample_ratio)
    dev = data.device
    R = rois.shape[0]
    bi = rois[:, 0].detach().to(torch.int32).long()
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    rh = torch.clamp_min(y2 - y1, 1.0)
    rw = torch.clamp_min(x2 - x1, 1.0)
    bin_h = rh / ph
    bin_w = rw / pw
    img = data[bi].reshape(R, c, h * w)

    def coords(start, step, bins, size, i):
        # (R, bins): the i-th sample of every bin, clipped, with its
        # low cell, high cell and the fraction past the low one
        f = torch.tensor([p + (i + 0.5) / sr for p in range(bins)],
                         dtype=data.dtype, device=dev)
        v = start[:, None] + f[None, :] * step[:, None]
        v = torch.clamp(v, 0.0, size - 1.0)
        lo = torch.floor(v).detach()
        hi = torch.clamp_max(lo + 1, size - 1)
        return lo.long(), hi.long(), v - lo

    def at(yi, xi):
        # img at (yi (R, ph) x xi (R, pw)) -> (R, C, ph, pw)
        lin = (yi[:, :, None] * w + xi[:, None, :]).reshape(R, 1, ph * pw)
        return img.gather(2, lin.expand(R, c, ph * pw)).reshape(
            R, c, ph, pw)

    acc = 0.0
    for iy in range(sr):
        y0, yh, ly = coords(y1, bin_h, ph, h, iy)
        ly = ly[:, None, :, None]
        for ix in range(sr):
            x0, xh, lx = coords(x1, bin_w, pw, w, ix)
            lx = lx[:, None, None, :]
            acc = acc + (at(y0, x0) * (1 - ly) * (1 - lx)
                         + at(yh, x0) * ly * (1 - lx)
                         + at(y0, xh) * (1 - ly) * lx
                         + at(yh, xh) * ly * lx)
    return acc / (sr * sr)


# ---------------------------------------------------------------------------
# Detection: multibox (SSD), box_nms
# ---------------------------------------------------------------------------

@register("_contrib_MultiBoxPrior")
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes for every cell of data's (H, W) grid -> (1, H*W*S, 4)
    corners in [0, 1] units, S = len(sizes) + len(ratios) - 1 per cell:
    (sizes[0], r) for every ratio, then (s, ratios[0]) for the other
    sizes, as the JAX op lays them out."""
    h, w = data.shape[2], data.shape[3]
    specs = [(sizes[0], r) for r in ratios] + \
            [(s, ratios[0]) for s in sizes[1:]]
    if data.is_meta:
        return _meta((1, h * w * len(specs), 4))
    dev = data.device
    f32 = torch.float32
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=f32, device=dev) + offsets[1]) * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    anchors = []
    for s, r in specs:
        # the half sizes in f32 as the JAX op rounds them, on the host
        # (no copy into a captured step)
        sr = _np.sqrt(_np.float32(r))
        bw = float(_np.float32(s) * sr / _np.float32(2))
        bh = float(_np.float32(s) / sr / _np.float32(2))
        anchors.append(torch.stack([cx - bw, cy - bh, cx + bw, cy + bh],
                                   dim=-1))
    out = torch.stack(anchors, dim=2).reshape(1, -1, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def _box_iou_corner(a, b):
    """IoU of corner boxes a (..., N, 4) and b (..., M, 4) -> (..., N, M);
    every step a separate elementwise op, so a card and the CPU give the
    same bits."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


@register("_contrib_box_iou")
def box_iou(lhs, rhs, *, format="corner"):
    return _box_iou_corner(lhs, rhs)


def _pack_rows(sup):
    """(b, n, n) bool -> (b, n, ceil(n / 8)) uint8, bit j % 8 of byte
    j // 8 set when column j is."""
    b, n, _ = sup.shape
    pad = (-n) % 8
    if pad:
        sup = torch.cat([sup, sup.new_zeros((b, n, pad))], dim=2)
    bits = sup.reshape(b, n, -1, 8).to(torch.uint8)
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8,
                           device=sup.device)
    return (bits * weights).sum(dim=-1, dtype=torch.uint8)


def _greedy_keep(iou, candidate, overlap_thresh, ids=None):
    """The JAX op's greedy pass: iou (b, n, n) over boxes in score order,
    candidate (b, n) bool; box i, if still kept, suppresses every later
    box j with ``iou[i, j] > overlap_thresh`` (of its class when ``ids``
    is given) -> keep (b, n) bool where the inputs lie."""
    global nms_passes, nms_copy_bytes
    b, n, _ = iou.shape
    sup = iou > overlap_thresh
    sup = sup & torch.ones((n, n), dtype=torch.bool,
                           device=iou.device).triu(1)
    if ids is not None:
        sup = sup & (ids[:, :, None] == ids[:, None, :])
    packed = _pack_rows(sup)
    nb = packed.shape[2]
    host = torch.cat([packed.reshape(b, n * nb),
                      candidate.to(torch.uint8)], dim=1).cpu().numpy()
    nms_copy_bytes += host.nbytes
    keep = _np.zeros((b, n), bool)
    for s in range(b):
        rows = host[s, :n * nb].reshape(n, nb)
        removed = _np.zeros(nb, _np.uint8)
        for i in _np.flatnonzero(host[s, n * nb:]):
            if not (int(removed[i >> 3]) >> (i & 7)) & 1:
                keep[s, i] = True
                removed |= rows[i]
        nms_passes += 1
    return torch.from_numpy(keep).to(iou.device)


@register("_contrib_box_nms", host=True)
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner", background_id=-1):
    """Greedy NMS with static shapes: rows sorted by score (stable), the
    suppressed and invalid ones (score not above ``valid_thresh``)
    become -1 rows, as in the JAX op."""
    single = data.dim() == 2
    if data.is_meta:
        return _meta(tuple(data.shape), dtype=data.dtype)
    if single:
        data = data[None]
    b, n, k = data.shape
    scores = data[..., score_index]
    class_aware = id_index >= 0 and not force_suppress
    order = torch.sort(-scores.detach(), dim=1, stable=True).indices
    sdata = data.gather(1, order[..., None].expand(b, n, k))
    sboxes = sdata[..., coord_start:coord_start + 4].detach()
    sscores = sdata[..., score_index].detach()
    ids = sdata[..., id_index].detach() if class_aware else None
    keep = _greedy_keep(_box_iou_corner(sboxes, sboxes),
                        sscores > valid_thresh, overlap_thresh, ids)
    if topk > 0:
        keep = keep & (torch.cumsum(keep.to(torch.int32), dim=1) <= topk)
    out = torch.where(keep[..., None], sdata,
                      torch.full((), -1.0, dtype=data.dtype,
                                 device=data.device))
    return out[0] if single else out


@register("_contrib_MultiBoxDetection", host=True)
def multibox_detection(cls_prob, loc_pred, anchor, *, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """SSD predictions to detections: cls_prob (B, classes, A), loc_pred
    (B, A*4), anchor (1, A, 4) -> (B, A, 6) rows [cls_id, score, x1,
    y1, x2, y2] after box_nms (class-aware unless ``force_suppress``)."""
    b, num_cls, a = cls_prob.shape
    if cls_prob.is_meta:
        return _meta((b, a, 6), dtype=cls_prob.dtype)
    loc = loc_pred.reshape(b, a, 4)
    anc = anchor.reshape(a, 4)
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    bw = torch.exp(loc[..., 2] * variances[2]) * aw / 2
    bh = torch.exp(loc[..., 3] * variances[3]) * ah / 2
    x1, y1, x2, y2 = cx - bw, cy - bh, cx + bw, cy + bh
    if clip:
        x1, y1 = torch.clamp(x1, 0, 1), torch.clamp(y1, 0, 1)
        x2, y2 = torch.clamp(x2, 0, 1), torch.clamp(y2, 0, 1)
    fg = cls_prob[:, 1:] if background_id == 0 else cls_prob
    cls_id = first_argmax(fg.detach(), dim=1).to(cls_prob.dtype)
    score = fg.amax(dim=1)
    cls_id = torch.where(score > threshold, cls_id,
                         torch.full((), -1.0, dtype=cls_id.dtype,
                                    device=cls_id.device))
    det = torch.stack([cls_id, score, x1, y1, x2, y2], dim=-1)
    return box_nms(det, overlap_thresh=nms_threshold, valid_thresh=threshold,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


@register("_contrib_MultiBoxTarget", num_outputs=3)
def multibox_target(anchor, label, cls_pred, *, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets, the JAX op's rules: each ground truth (label
    rows [cls, x1, y1, x2, y2], cls < 0 padding) claims its best anchor
    best-first, the other anchors match their best ground truth above
    ``overlap_threshold``; matched anchors get encoded offsets and class
    + 1, the rest background, with hard negatives mined by ascending
    background probability when ``negative_mining_ratio`` > 0 (the
    others take ``ignore_label``). -> (loc_target (B, N*4), loc_mask
    (B, N*4), cls_target (B, N)); no gradient reaches the inputs, as
    none does in the JAX op. Device ops only, no host read."""
    anchors = anchor.detach().reshape(-1, 4)
    n = anchors.shape[0]
    B, m = label.shape[0], label.shape[1]
    if anchor.is_meta or label.is_meta or cls_pred.is_meta:
        return _meta((B, n * 4), (B, n * 4), (B, n), dtype=anchor.dtype)
    label = label.detach()
    conf = cls_pred.detach()
    dev, dt = anchors.device, anchors.dtype
    v0, v1, v2, v3 = (float(v) for v in variances)
    a_w = anchors[:, 2] - anchors[:, 0]
    a_h = anchors[:, 3] - anchors[:, 1]
    a_cx = (anchors[:, 0] + anchors[:, 2]) / 2
    a_cy = (anchors[:, 1] + anchors[:, 3]) / 2

    def full(v):
        return torch.full((), v, dtype=dt, device=dev)

    valid = label[:, :, 0] >= 0                           # (B, M)
    gt = label[:, :, 1:5]
    iou = _box_iou_corner(anchors[None], gt)              # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, full(-1.0))
    ar_n = torch.arange(n, device=dev)[None, :]
    ar_m = torch.arange(m, device=dev)[None, :]
    match = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    taken = torch.zeros((B, n), dtype=torch.bool, device=dev)
    gt_done = torch.zeros((B, m), dtype=torch.bool, device=dev)
    for _ in range(m):
        masked = torch.where(taken[:, :, None] | gt_done[:, None, :],
                             full(-2.0), iou)
        best_per_gt = masked.amax(dim=1)                  # (B, M)
        g = first_argmax(torch.where(valid & ~gt_done & (best_per_gt > -2.0),
                                     best_per_gt, full(-3.0)), dim=1)
        col = masked.gather(2, g[:, None, None].expand(B, n, 1))[..., 0]
        a = first_argmax(col, dim=1)
        ok = valid.gather(1, g[:, None])[:, 0] \
            & ~gt_done.gather(1, g[:, None])[:, 0] \
            & (col.gather(1, a[:, None])[:, 0] > 1e-6)
        hit = ok[:, None] & (ar_n == a[:, None])
        match = torch.where(hit, g[:, None], match)
        taken = taken | hit
        gt_done = gt_done | (ok[:, None] & (ar_m == g[:, None]))
    best_gt = first_argmax(iou, dim=2)
    best_iou = iou.amax(dim=2)
    if overlap_threshold > 0:
        thr_ok = ~taken & (best_iou > overlap_threshold)
        match = torch.where(thr_ok, best_gt, match)
    matched = match >= 0
    midx = torch.clamp(match, 0, m - 1)
    g_box = gt.gather(1, midx[..., None].expand(B, n, 4))
    g_w = torch.clamp_min(g_box[..., 2] - g_box[..., 0], 1e-12)
    g_h = torch.clamp_min(g_box[..., 3] - g_box[..., 1], 1e-12)
    g_cx = (g_box[..., 0] + g_box[..., 2]) / 2
    g_cy = (g_box[..., 1] + g_box[..., 3]) / 2
    tx = (g_cx - a_cx) / torch.clamp_min(a_w, 1e-12) / v0
    ty = (g_cy - a_cy) / torch.clamp_min(a_h, 1e-12) / v1
    tw = torch.log(torch.clamp_min(g_w / torch.clamp_min(a_w, 1e-12),
                                   1e-12)) / v2
    th = torch.log(torch.clamp_min(g_h / torch.clamp_min(a_h, 1e-12),
                                   1e-12)) / v3
    loc = torch.stack([tx, ty, tw, th], dim=2)            # (B, N, 4)
    loc_t = torch.where(matched[..., None], loc, full(0.0)).reshape(B, -1)
    loc_m = matched[..., None].expand(B, n, 4).to(dt).reshape(B, -1)
    g_cls = label[:, :, 0].gather(1, midx)
    cls_t = torch.where(matched, g_cls + 1.0, full(0.0))
    if negative_mining_ratio > 0:
        # the background probability as jax.nn.softmax spells it
        e = torch.exp(conf - conf.amax(dim=1, keepdim=True))
        bg_prob = e[:, 0] / e.sum(dim=1)                  # (B, N)
        num_pos = matched.sum(dim=1)
        quota = torch.clamp_min(
            (negative_mining_ratio * num_pos).to(torch.int32).long(),
            int(minimum_negative_samples))
        quota = torch.minimum(quota, n - num_pos)
        is_cand = ~matched & (best_iou < negative_mining_thresh)
        quota = torch.minimum(quota, is_cand.sum(dim=1))
        order = torch.sort(torch.where(is_cand, bg_prob, full(math.inf)),
                           dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=dev).expand(B, n).contiguous())
        keep_neg = is_cand & (rank < quota[:, None])
        cls_t = torch.where(~matched,
                            torch.where(keep_neg, full(0.0),
                                        full(float(ignore_label))), cls_t)
    return loc_t, loc_m, cls_t


# ---------------------------------------------------------------------------
# bipartite matching
# ---------------------------------------------------------------------------

@register("_contrib_bipartite_matching", num_outputs=2, host=True)
def bipartite_matching(data, *, threshold, is_ascend=False, topk=-1):
    """Greedy bipartite matching on scores (..., N, M) -> (row_match
    (..., N), col_match (..., M)), -1 where unmatched, in data's dtype:
    the entries visited best first (a stable sort), a pair taken when
    its row and column are free and its score passes ``threshold``; the
    walk ends at the first score that fails, and after the assignment
    that makes the count exceed ``topk`` (the JAX op's rules)."""
    dshape = tuple(data.shape)
    nrow, ncol = dshape[-2], dshape[-1]
    if data.is_meta:
        return _meta(dshape[:-1], dshape[:-2] + (ncol,), dtype=data.dtype)
    flat = data.detach().reshape(-1, nrow * ncol).cpu().numpy()
    rm = _np.full((flat.shape[0], nrow), -1.0, flat.dtype)
    cm = _np.full((flat.shape[0], ncol), -1.0, flat.dtype)
    thr = flat.dtype.type(threshold)   # compared in data's dtype
    for s, scores in enumerate(flat):
        order = _np.argsort(scores if is_ascend else -scores, kind="stable")
        count = 0
        for ij in order:
            v = scores[ij]
            if not (v < thr if is_ascend else v > thr):
                break
            if topk > 0 and count > topk:
                break
            r, c = divmod(int(ij), ncol)
            if rm[s, r] == -1 and cm[s, c] == -1:
                rm[s, r] = c
                cm[s, c] = r
                count += 1
    dev = data.device
    return (torch.from_numpy(rm).to(dev).reshape(dshape[:-1]),
            torch.from_numpy(cm).to(dev).reshape(dshape[:-2] + (ncol,)))


alias("_contrib_bipartite_matching", "bipartite_matching")
