"""Vision and detection operators (`incubator_mxnet_tpu/ops/vision.py`):
box utilities and NMS, the MultiBox (SSD) family, ROI pooling and
align, the samplers and transformers, resizing, adaptive pooling,
deformable convolution, RPN proposals and the `_image_*` ops.

Suppressed or invalid detections are `-1` rows of a dense output, as in
the JAX package. Where the JAX formulation would not fit the card at a
detector's widths, the port computes the same values another way:

- NMS keeps the greedy keep set, which is the one solution of
  keep[j] = valid[j] and not any(keep[i] and same[i, j] and
  iou[i, j] > thr for i < j) in score order. JAX walks it with an
  n-step `fori_loop`; the port iterates the equation from keep = valid
  (each pass one masked reduction over the n x n matrix) until a pass
  changes nothing, which takes the longest suppression chain + 1 passes
  (`NMS_PASSES` records each call's count).
- Sort orders follow JAX's exactly through stable sorts: NMS's
  `argsort(...)[::-1]` puts the higher index first among equal scores,
  `lax.top_k` and the stable `argsort(-score)` the lower one.
- ROIPooling gathers each bin's bounded row window, then its column
  window, and reduces with `amax` (which splits the gradient evenly
  among tied maxima, as JAX's `max` does), chunked over ROIs; JAX masks
  a (C, ph, H, W) tensor per ROI. ROIAlign's four taps are gathered in
  chunks of ROIs.
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch
import torch.nn.functional as tF

from .registry import register

# passes of the fixed-point NMS per call, newest last
NMS_PASSES = collections.deque(maxlen=4096)
# when a list, each NMS call appends its sorted candidates' corner boxes,
# validity, class ids (None when every pair may suppress) and keep set,
# on the CPU
NMS_TRACE = None
# ROIs per chunk of ROIPooling / ROIAlign
ROI_CHUNK = 32


# ---------------------------------------------------------------------------
# box utilities
# ---------------------------------------------------------------------------


def _div(a, b):
    """a / b rounded as IEEE division on every device: a CUDA tensor
    divided by a Python number is multiplied by the number's reciprocal,
    which can move floor / ceil bin edges by one."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def _to_corner(b, fmt):
    """(..., 4) boxes to corner (x1, y1, x2, y2) format."""
    if fmt == "corner":
        return b
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _to_format(b, fmt):
    if fmt == "corner":
        return b
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def _pair_iou(a, b):
    """IoU matrix between corner boxes a (N, 4) and b (M, 4) -> (N, M)."""
    ax1, ay1, ax2, ay2 = a[:, 0:1], a[:, 1:2], a[:, 2:3], a[:, 3:4]
    bx1, by1, bx2, by2 = (b[None, :, 0], b[None, :, 1], b[None, :, 2],
                          b[None, :, 3])
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
    area_b = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


@register("_contrib_box_iou", aliases=("box_iou",))
def box_iou(lhs, rhs, *, format="corner"):
    """IoU of every lhs box against every rhs box; output shape
    lhs.shape[:-1] + rhs.shape[:-1]."""
    lshape, rshape = tuple(lhs.shape[:-1]), tuple(rhs.shape[:-1])
    a = _to_corner(lhs.reshape(-1, 4), format)
    b = _to_corner(rhs.reshape(-1, 4), format)
    return _pair_iou(a, b).reshape(lshape + rshape)


def greedy_keep(valid, sup):
    """The greedy keep set over candidates in score order: `valid` (n,)
    bool, `sup` (n, n) bool with sup[i, j] true when candidate i, kept,
    suppresses a later j. Iterated from keep = valid until a pass changes
    nothing; returns (keep, passes)."""
    keep, passes = valid, 0
    while True:
        passes += 1
        hit = (keep[:, None] & sup).any(0)
        new = valid & ~hit
        if torch.equal(new, keep):
            return keep, passes
        keep = new


def _desc_order(key):
    """JAX's `argsort(key)[::-1]`: descending, the higher index first
    among equal keys."""
    return torch.sort(key, stable=True).indices.flip(0)


def _nms_one(data, overlap_thresh, valid_thresh, topk, coord_start,
             score_index, id_index, force_suppress, in_format, out_format):
    """NMS over one (N, K) batch element; returns (N, K) with -1 rows."""
    n = data.shape[0]
    scores = data[:, score_index]
    valid = scores > valid_thresh
    neg_inf = torch.full_like(scores, -math.inf)
    order = _desc_order(torch.where(valid, scores, neg_inf))
    data = data[order]
    valid = valid[order]
    idx = torch.arange(n, device=data.device)
    if topk > 0:
        valid = valid & (idx < topk)

    boxes = _to_corner(data[:, coord_start:coord_start + 4], in_format)
    sup = (_pair_iou(boxes, boxes) > overlap_thresh) & (idx[:, None]
                                                        < idx[None, :])
    ids = None
    if id_index >= 0 and not force_suppress:
        ids = data[:, id_index]
        sup &= ids[:, None] == ids[None, :]
    keep, passes = greedy_keep(valid, sup)
    NMS_PASSES.append(passes)
    if NMS_TRACE is not None:
        NMS_TRACE.append(dict(
            boxes=boxes.detach().cpu(), valid=valid.cpu(), keep=keep.cpu(),
            ids=None if ids is None else ids.detach().cpu()))

    out = data
    if out_format != in_format:
        conv = _to_format(boxes, out_format) if out_format == "center" \
            else boxes
        out = torch.cat([out[:, :coord_start], conv,
                         out[:, coord_start + 4:]], 1)
    return torch.where(keep[:, None], out, -torch.ones_like(out))


@register("_contrib_box_nms", aliases=("box_nms",))
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Non-maximum suppression. Input (..., N, K): each row [.., id?,
    score, x1, y1, x2, y2, ..]; output of the same shape, score-sorted,
    suppressed rows set to -1."""
    shape = tuple(data.shape)
    flat = data.reshape((-1,) + shape[-2:])
    if background_id >= 0 and id_index >= 0:
        bg = flat[..., id_index] == background_id
        flat = torch.where(bg[..., None], -torch.ones_like(flat), flat)
    out = torch.stack([
        _nms_one(d, overlap_thresh, valid_thresh, topk, coord_start,
                 score_index, id_index, force_suppress, in_format,
                 out_format) for d in flat])
    return out.reshape(shape)


def _encode_offsets(anchors_center, gt_center, variances):
    """SSD box-regression encoding: (d_cx / w, d_cy / h, log dw, log dh)
    / var."""
    var = [float(v) for v in variances]
    a, g = anchors_center, gt_center
    tiny = 1e-12
    return torch.stack([
        _div((g[..., 0] - a[..., 0]) / a[..., 2], var[0]),
        _div((g[..., 1] - a[..., 1]) / a[..., 3], var[1]),
        _div(torch.log((g[..., 2] / a[..., 2].clamp_min(tiny))
                       .clamp_min(tiny)), var[2]),
        _div(torch.log((g[..., 3] / a[..., 3].clamp_min(tiny))
                       .clamp_min(tiny)), var[3]),
    ], -1)


def _decode_offsets(offsets, anchors_center, variances):
    """Inverse of _encode_offsets -> center-format boxes."""
    var = torch.tensor([float(v) for v in variances], dtype=torch.float32,
                       device=offsets.device)
    d = offsets * var
    a = anchors_center
    cx = d[..., 0] * a[..., 2] + a[..., 0]
    cy = d[..., 1] * a[..., 3] + a[..., 1]
    w = torch.exp(d[..., 2]) * a[..., 2]
    h = torch.exp(d[..., 3]) * a[..., 3]
    return torch.stack([cx, cy, w, h], -1)


@register("_contrib_box_encode", aliases=("box_encode",))
def box_encode(samples, matches, anchors, refs, *, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Matched gt boxes as regression targets against anchors: samples
    (B, N) in {+1 pos, -1 neg}, matches (B, N) gt indices, anchors
    (B, N, 4), refs (B, M, 4) corner boxes -> (targets, masks)."""
    m = matches.to(torch.int32).long()
    gt = torch.gather(refs, 1, m[..., None].expand(*m.shape, 4))
    a_c, g_c = _to_format(anchors, "center"), _to_format(gt, "center")
    t = _encode_offsets(a_c, g_c, stds)
    t = t - (torch.tensor(means, dtype=t.dtype, device=t.device)
             / torch.tensor(stds, dtype=t.dtype, device=t.device))
    mask = (samples > 0.5)[..., None].to(t.dtype)
    return t * mask, mask


@register("_contrib_box_decode", aliases=("box_decode",))
def box_decode(data, anchors, *, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):
    """Regression targets back to corner boxes (box_encode's inverse)."""
    a_c = _to_format(anchors, "center") if format == "corner" else anchors
    out = _to_corner(_decode_offsets(data, a_c, (std0, std1, std2, std3)),
                     "center")
    if clip > 0:
        out = out.clamp(0.0, clip)
    return out


# ---------------------------------------------------------------------------
# MultiBox (SSD) family
# ---------------------------------------------------------------------------


def _floats(v):
    return tuple(float(x) for x in (v if not np.isscalar(v) else (v,)))


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",))
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes: data (B, C, H, W) -> (1, H*W*(len(sizes) +
    len(ratios) - 1), 4) normalized corners; per pixel (sizes[i],
    ratios[0]) for every i, then (sizes[0], ratios[j]) for j >= 1."""
    h, w = data.shape[2], data.shape[3]
    sizes, ratios = _floats(sizes), _floats(ratios)
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    dev = data.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    wh = [(s * math.sqrt(ratios[0]) / 2, s / math.sqrt(ratios[0]) / 2)
          for s in sizes]
    wh += [(sizes[0] * math.sqrt(r) / 2, sizes[0] / math.sqrt(r) / 2)
           for r in ratios[1:]]
    half = torch.tensor(wh, dtype=torch.float32, device=dev)
    c = torch.stack([cxg, cyg], -1)[:, :, None, :]
    anchors = torch.cat([c - half[None, None], c + half[None, None]],
                        -1).reshape(1, -1, 4)
    if clip:
        anchors = anchors.clamp(0.0, 1.0)
    return anchors


def _match_one(iou, valid_gt, overlap_threshold):
    """Greedy bipartite then threshold matching for one image: iou
    (N anchors, M gt), valid_gt (M,) -> matches (N,) gt index or -1."""
    n, m = iou.shape
    iou = torch.where(valid_gt[None, :], iou, torch.full_like(iou, -1.0))
    matches = torch.full((n,), -1, dtype=torch.int32, device=iou.device)
    work = iou.clone()
    for _ in range(m):
        flat = torch.argmax(work)
        i, j = flat // m, flat % m
        do = work[i, j] > 1e-12
        matches = torch.where(do & (torch.arange(n, device=iou.device) == i),
                              j.to(torch.int32), matches)
        hit = ((torch.arange(n, device=iou.device) == i)[:, None]
               | (torch.arange(m, device=iou.device) == j)[None, :])
        work = torch.where(do & hit, torch.full_like(work, -1.0), work)
    best_j, best_v = torch.argmax(iou, 1), iou.amax(1)
    thr = (matches < 0) & (best_v > overlap_threshold)
    return torch.where(thr, best_j.to(torch.int32), matches)


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          num_outputs=3, no_grad_inputs=("anchor", "label", "cls_pred"))
def multibox_target(anchor, label, cls_pred, *, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets: anchor (1, N, 4) corners, label (B, M, 5)
    rows [cls, x1, y1, x2, y2] (cls -1 pads), cls_pred (B, classes + 1,
    N) -> (loc_target (B, 4N), loc_mask (B, 4N), cls_target (B, N)),
    cls_target the gt class + 1 (0 background, ignore_label ignored)."""
    a = anchor[0]
    n = a.shape[0]
    a_c = _to_format(a, "center")
    outs = []
    for lab, pred in zip(label, cls_pred):
        valid = lab[:, 0] >= 0
        iou = _pair_iou(a, lab[:, 1:5])
        matches = _match_one(iou, valid, overlap_threshold)
        pos = matches >= 0
        gt = lab[matches.clamp_min(0).long()]
        g_c = _to_format(gt[:, 1:5], "center")
        t = _encode_offsets(a_c, g_c, variances)
        zero = torch.zeros_like(t)
        loc_t = torch.where(pos[:, None], t, zero).reshape(-1)
        loc_m = torch.where(pos[:, None], torch.ones_like(t),
                            zero).reshape(-1)
        cls_t = torch.where(pos, gt[:, 0] + 1.0, torch.zeros_like(gt[:, 0]))
        if negative_mining_ratio > 0:
            num_pos = pos.sum()
            max_neg = torch.clamp_min(num_pos * negative_mining_ratio,
                                      float(minimum_negative_samples))
            conf = pred[1:, :].max(0).values
            max_iou = torch.where(valid[None, :], iou,
                                  torch.zeros_like(iou)).max(1).values
            neg = ~pos & (max_iou < negative_mining_thresh)
            neg_score = torch.where(neg, conf, torch.full_like(conf,
                                                               -math.inf))
            rank = torch.argsort(torch.argsort(-neg_score, stable=True),
                                 stable=True)
            keep_neg = neg & (rank < max_neg)
            cls_t = torch.where(~pos & ~keep_neg,
                                torch.full_like(cls_t, float(ignore_label)),
                                cls_t)
        outs.append((loc_t, loc_m, cls_t))
    return tuple(torch.stack(x) for x in zip(*outs))


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
          no_grad_inputs=("cls_prob", "loc_pred", "anchor"))
def multibox_detection(cls_prob, loc_pred, anchor, *, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """SSD decode and per-class NMS: cls_prob (B, classes + 1, N),
    loc_pred (B, 4N), anchor (1, N, 4) -> (B, N, 6) rows [class_id,
    score, x1, y1, x2, y2], invalid rows -1."""
    a_c = _to_format(anchor[0], "center")
    n = a_c.shape[0]
    outs = []
    for prob, loc in zip(cls_prob, loc_pred):
        fg = torch.cat([prob[:background_id], prob[background_id + 1:]], 0)
        score = fg.amax(0)
        cls = torch.argmax(fg, 0).to(torch.float32)
        boxes = _to_corner(_decode_offsets(loc.reshape(n, 4), a_c,
                                           variances), "center")
        if clip:
            boxes = boxes.clamp(0.0, 1.0)
        keep = score > threshold
        rows = torch.cat([cls[:, None], score[:, None], boxes], -1)
        rows = torch.where(keep[:, None], rows, torch.full_like(rows, -1.0))
        outs.append(_nms_one(rows, nms_threshold, 0.0, nms_topk, 2, 1, 0,
                             force_suppress, "corner", "corner"))
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# ROI pooling / align
# ---------------------------------------------------------------------------


def _pair(v):
    return tuple(v) if not np.isscalar(v) else (v, v)


def _round_half_away(x):
    """C round(): halves go away from zero (torch.round is to even)."""
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


def _windows(lo, hi, size):
    """Bounded windows [lo, hi) clipped to [0, size): (start index (..., K),
    in-window mask (..., K)) with K the longest window (one host read)."""
    lo = lo.clamp(0, size).long()
    n = (hi.clamp(0, size).long() - lo).clamp_min(0)
    k = max(int(n.max()) if n.numel() else 0, 1)
    ar = torch.arange(k, device=lo.device)
    return (lo[..., None] + ar).clamp_max(size - 1), ar < n[..., None]


@register("ROIPooling", no_grad_inputs=("rois",))
def roi_pooling(data, rois, *, pooled_size, spatial_scale):
    """Max pooling over regions: data (B, C, H, W), rois (R, 5) rows
    [batch_idx, x1, y1, x2, y2] in image coordinates -> (R, C, ph, pw).
    Bin i covers rows [floor(y1 + i*bin_h), ceil(y1 + (i+1)*bin_h)); an
    empty bin gives 0. Each bin's rows, then its columns, are gathered in
    bounded windows and reduced with amax, in chunks of ROIs."""
    ph, pw = _pair(pooled_size)
    b, c, h, w = data.shape
    dev = data.device
    outs = []
    for r0 in range(0, rois.shape[0], ROI_CHUNK):
        roi = rois[r0:r0 + ROI_CHUNK]
        rc = roi.shape[0]
        bidx = roi[:, 0].to(torch.int32).long()
        x1 = _round_half_away(roi[:, 1] * spatial_scale)
        y1 = _round_half_away(roi[:, 2] * spatial_scale)
        x2 = _round_half_away(roi[:, 3] * spatial_scale)
        y2 = _round_half_away(roi[:, 4] * spatial_scale)
        bin_h = _div((y2 - y1 + 1.0).clamp_min(1.0), ph)
        bin_w = _div((x2 - x1 + 1.0).clamp_min(1.0), pw)
        i = torch.arange(ph, dtype=torch.float32, device=dev)
        j = torch.arange(pw, dtype=torch.float32, device=dev)
        y_lo = torch.floor(y1[:, None] + i[None, :] * bin_h[:, None])
        y_hi = torch.ceil(y1[:, None] + (i[None, :] + 1) * bin_h[:, None])
        x_lo = torch.floor(x1[:, None] + j[None, :] * bin_w[:, None])
        x_hi = torch.ceil(x1[:, None] + (j[None, :] + 1) * bin_w[:, None])
        ys, ym = _windows(y_lo, y_hi, h)                    # (rc, ph, Ky)
        # (rc, ph, Ky, C, W): the rows of each bin's window
        rows = data[bidx[:, None, None], :, ys, :]
        neg = torch.tensor(-math.inf, dtype=data.dtype, device=dev)
        rowred = torch.where(ym[..., None, None], rows, neg).amax(2)
        xs, xm = _windows(x_lo, x_hi, w)                    # (rc, pw, Kx)
        # (rc, pw, Kx, ph, C): the columns of each bin's window
        cols = rowred.permute(0, 3, 1, 2)[
            torch.arange(rc, device=dev)[:, None, None], xs]
        out = torch.where(xm[..., None, None], cols, neg).amax(2)
        out = out.permute(0, 3, 2, 1)                       # (rc, C, ph, pw)
        outs.append(torch.where(torch.isfinite(out), out,
                                torch.zeros_like(out)))
    if not outs:
        return data.new_zeros((0, c, ph, pw))
    return torch.cat(outs)


@register("Crop", optional=("crop_like",), no_grad_inputs=("crop_like",))
def crop_op(data, crop_like=None, *, offset=(0, 0), h_w=(0, 0),
            center_crop=False, num_args=1):
    """Spatial crop of (N, C, H, W) to h_w or to crop_like's H, W, at a
    (y, x) offset or centred."""
    if crop_like is not None and num_args == 2:
        th, tw = int(crop_like.shape[2]), int(crop_like.shape[3])
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if th <= 0 or tw <= 0:
        raise ValueError("Crop: target size must be positive (set h_w or "
                         "pass crop_like with num_args=2)")
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    if not (0 <= oy and oy + th <= h and 0 <= ox and ox + tw <= w):
        raise ValueError(f"Crop: window {th}x{tw}@({oy},{ox}) outside "
                         f"{h}x{w}")
    return data[:, :, oy:oy + th, ox:ox + tw]


def _bin_masks(lo, hi, size, dev):
    """(..., size) membership masks of [lo, hi)."""
    pos = torch.arange(size, dtype=torch.float32, device=dev)
    return (pos >= lo[..., None]) & (pos < hi[..., None])


@register("_contrib_PSROIPooling", aliases=("PSROIPooling",),
          no_grad_inputs=("rois",))
def psroi_pooling(data, rois, *, spatial_scale, output_dim, pooled_size,
                  group_size=0):
    """Position-sensitive ROI pooling (the R-FCN head): data (B,
    output_dim * group^2, H, W), rois (R, 5); bin (i, j) of channel o
    averages the (o, gi, gj) channel page over the bin's region."""
    group = int(group_size) or int(pooled_size)
    p = int(pooled_size)
    b, c, h, w = data.shape
    o_dim = int(output_dim)
    dev = data.device
    bidx = rois[:, 0].to(torch.int32).long()
    x1 = _round_half_away(rois[:, 1]) * spatial_scale
    y1 = _round_half_away(rois[:, 2]) * spatial_scale
    x2 = (_round_half_away(rois[:, 3]) + 1.0) * spatial_scale
    y2 = (_round_half_away(rois[:, 4]) + 1.0) * spatial_scale
    bin_h = _div((y2 - y1).clamp_min(0.1), p)
    bin_w = _div((x2 - x1).clamp_min(0.1), p)
    i = torch.arange(p, dtype=torch.float32, device=dev)
    row_m = _bin_masks(torch.floor(y1[:, None] + i * bin_h[:, None]),
                       torch.ceil(y1[:, None] + (i + 1.0) * bin_h[:, None]),
                       h, dev)                               # (R, p, H)
    col_m = _bin_masks(torch.floor(x1[:, None] + i * bin_w[:, None]),
                       torch.ceil(x1[:, None] + (i + 1.0) * bin_w[:, None]),
                       w, dev)                               # (R, p, W)
    gi = ((torch.arange(p, device=dev) * group) // p).clamp(0, group - 1)
    img = data[bidx].reshape(-1, o_dim, group, group, h, w)
    pages = img[:, :, gi][:, :, :, gi]                       # (R, O, p, p, H, W)
    m2 = row_m[:, :, None, :, None] & col_m[:, None, :, None, :]
    num = torch.where(m2[:, None], pages,
                      torch.zeros_like(pages)).sum((-1, -2))
    cnt = m2.sum((-1, -2)).clamp_min(1).to(data.dtype)
    return num / cnt[:, None]


@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",), optional=("trans",),
          no_grad_inputs=("rois",), num_outputs=1)
def deformable_psroi_pooling(data, rois, trans=None, *, spatial_scale,
                             output_dim, pooled_size, group_size=0,
                             part_size=0, sample_per_part=4,
                             trans_std=0.0, no_trans=False):
    """Deformable position-sensitive ROI pooling (the Deformable R-FCN
    head): each bin averages sample_per_part^2 bilinear taps; `trans`
    holds per-(class, bin) offsets in ROI-size units, scaled by
    trans_std."""
    group = int(group_size) or int(pooled_size)
    p = int(pooled_size)
    part = int(part_size) or p
    s = int(sample_per_part)
    b, c, h, w = data.shape
    o_dim = int(output_dim)
    dev = data.device
    use_trans = (trans is not None) and not no_trans
    n_cls = (trans.shape[1] // 2) if use_trans else 1
    per_cls = max(o_dim // n_cls, 1)
    r = rois.shape[0]
    bidx = rois[:, 0].to(torch.int32).long()
    x1 = _round_half_away(rois[:, 1]) * spatial_scale - 0.5
    y1 = _round_half_away(rois[:, 2]) * spatial_scale - 0.5
    x2 = (_round_half_away(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (_round_half_away(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rh = (y2 - y1).clamp_min(0.1)
    rw = (x2 - x1).clamp_min(0.1)
    bin_h, bin_w = _div(rh, p), _div(rw, p)
    sub_h, sub_w = _div(bin_h, s), _div(bin_w, s)
    i = torch.arange(p, dtype=torch.float32, device=dev)
    u = torch.arange(s, dtype=torch.float32, device=dev)
    # base tap grid per bin (R, p, s), taps at u * sub_bin from the start
    ys0 = (y1[:, None, None] + i[None, :, None] * bin_h[:, None, None]
           + u[None, None, :] * sub_h[:, None, None])
    xs0 = (x1[:, None, None] + i[None, :, None] * bin_w[:, None, None]
           + u[None, None, :] * sub_w[:, None, None])
    if use_trans:
        pi = ((torch.arange(p, device=dev) * part) // p).clamp(0, part - 1)
        t = trans.reshape(r, n_cls, 2, part, part)
        off_y = t[:, :, 1][:, :, pi][:, :, :, pi] * trans_std  # (R, cls, p, p)
        off_x = t[:, :, 0][:, :, pi][:, :, :, pi] * trans_std
    else:
        off_y = torch.zeros((r, 1, p, p), dtype=torch.float32, device=dev)
        off_x = torch.zeros((r, 1, p, p), dtype=torch.float32, device=dev)
    # tap coordinates (R, cls, p_i, p_j, s_i, s_j)
    ty = (ys0[:, None, :, None, :, None]
          + (off_y * rh[:, None, None, None])[..., None, None])
    tx = (xs0[:, None, None, :, None, :]
          + (off_x * rw[:, None, None, None])[..., None, None])
    ty = ty.expand(r, n_cls, p, p, s, s)
    tx = tx.expand(r, n_cls, p, p, s, s)
    cls_ids = (torch.arange(o_dim, device=dev) // per_cls).clamp(0, n_cls - 1)
    yy, xx = ty[:, cls_ids], tx[:, cls_ids]                # (R, O, p, p, s, s)
    valid = ((yy >= -0.5) & (yy <= h - 0.5) & (xx >= -0.5)
             & (xx <= w - 0.5))
    yy = yy.clamp(0.0, h - 1.0)
    xx = xx.clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = yy - y0, xx - x0
    gi = ((torch.arange(p, device=dev) * group) // p).clamp(0, group - 1)
    # channel of bin (o, i, j): page (o, gi[i], gi[j])
    chan = (torch.arange(o_dim, device=dev)[:, None, None] * group * group
            + gi[None, :, None] * group + gi[None, None, :])   # (O, p, p)
    ridx = bidx[:, None, None, None, None, None]
    cidx = chan[None, :, :, :, None, None]

    def tap(yi, xi, wgt):
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        return data[ridx, cidx, yc, xc] * wgt

    out = (tap(y0, x0, (1 - wy1) * (1 - wx1))
           + tap(y0, x0 + 1, (1 - wy1) * wx1)
           + tap(y0 + 1, x0, wy1 * (1 - wx1))
           + tap(y0 + 1, x0 + 1, wy1 * wx1))
    cnt = valid.sum((-1, -2)).to(data.dtype)
    tot = (out * valid.to(data.dtype)).sum((-1, -2))
    return torch.where(cnt > 0, tot / cnt.clamp_min(1.0),
                       torch.zeros_like(tot))


def _batched_bilinear(data, bidx, ys, xs):
    """Bilinear samples of images data[bidx[r]] (of (B, C, H, W)) at float
    coordinates ys[r] / xs[r] (R, P), zero outside: (R, P, C)."""
    b, c, h, w = data.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    ridx = bidx[:, None]

    def tap(yi, xi, wgt):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        return data[ridx, :, yc, xc] * (wgt * inb.to(data.dtype))[..., None]

    return (tap(y0, x0, wy0 * wx0) + tap(y0, x0 + 1, wy0 * wx1)
            + tap(y0 + 1, x0, wy1 * wx0) + tap(y0 + 1, x0 + 1, wy1 * wx1))


def _bilinear_gather(img, ys, xs):
    """Bilinear samples of img (C, H, W) at float coordinates ys / xs
    (...,), zero outside: (C, ...)."""
    zero = torch.zeros(1, dtype=torch.long, device=img.device)
    out = _batched_bilinear(img[None], zero, ys.reshape(1, -1),
                            xs.reshape(1, -1))[0]
    return out.t().reshape((img.shape[0],) + tuple(ys.shape))


@register("_contrib_ROIAlign", aliases=("ROIAlign",),
          no_grad_inputs=("rois",))
def roi_align(data, rois, *, pooled_size, spatial_scale, sample_ratio=-1,
              position_sensitive=False, aligned=False):
    """ROIAlign: the average of bilinear samples on a fixed sub-grid per
    bin, 2 x 2 when sample_ratio <= 0 (the JAX package fixes it so shapes
    stay static). A sample beyond [-1, dim] is zero, one within that
    margin is clamped to the edge. position_sensitive=True gives the
    R-FCN layout: C = C_out * ph * pw, bin (i, j) reading channel group
    c_out * ph * pw + i * pw + j. Computed in chunks of ROIs."""
    ph, pw = _pair(pooled_size)
    s = int(sample_ratio) if sample_ratio > 0 else 2
    offset = 0.5 if aligned else 0.0
    b, c, h, w = data.shape
    dev = data.device
    outs = []
    for r0 in range(0, rois.shape[0], ROI_CHUNK):
        roi = rois[r0:r0 + ROI_CHUNK]
        rc = roi.shape[0]
        bidx = roi[:, 0].to(torch.int32).long()
        x1 = roi[:, 1] * spatial_scale - offset
        y1 = roi[:, 2] * spatial_scale - offset
        x2 = roi[:, 3] * spatial_scale - offset
        y2 = roi[:, 4] * spatial_scale - offset
        rw = x2 - x1 if aligned else (x2 - x1).clamp_min(1.0)
        rh = y2 - y1 if aligned else (y2 - y1).clamp_min(1.0)
        bin_h, bin_w = _div(rh, ph), _div(rw, pw)
        k = _div(torch.arange(s, dtype=torch.float32, device=dev) + 0.5, s)
        i = torch.arange(ph, dtype=torch.float32, device=dev)[:, None]
        ys = (y1[:, None, None] + (i + k[None, :])[None]
              * bin_h[:, None, None]).reshape(rc, -1)       # (rc, ph*s)
        j = torch.arange(pw, dtype=torch.float32, device=dev)[:, None]
        xs = (x1[:, None, None] + (j + k[None, :])[None]
              * bin_w[:, None, None]).reshape(rc, -1)       # (rc, pw*s)
        yg = ys.repeat_interleave(pw * s, 1)
        xg = xs.repeat(1, ph * s)
        valid = (yg >= -1.0) & (yg <= h) & (xg >= -1.0) & (xg <= w)
        v = _batched_bilinear(data, bidx, yg.clamp(0.0, h - 1.0),
                              xg.clamp(0.0, w - 1.0))       # (rc, P, C)
        v = v * valid.to(v.dtype)[..., None]
        v = v.reshape(rc, ph, s, pw, s, c)
        full = v.mean((2, 4)).permute(0, 3, 1, 2)          # (rc, C, ph, pw)
        if position_sensitive:
            c_out = c // (ph * pw)
            g = full.reshape(rc, c_out, ph, pw, ph, pw)
            ii = torch.arange(ph, device=dev)[:, None]
            jj = torch.arange(pw, device=dev)[None, :]
            full = g[:, :, ii, jj, ii, jj]
        outs.append(full)
    if not outs:
        c_o = c // (ph * pw) if position_sensitive else c
        return data.new_zeros((0, c_o, ph, pw))
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# samplers / transformers
# ---------------------------------------------------------------------------


@register("BilinearSampler")
def bilinear_sampler(data, grid, *, cudnn_off=False):
    """Sample data (B, C, H, W) at a normalized grid (B, 2, H', W')
    (grid[:, 0] x, grid[:, 1] y in [-1, 1]); reads outside are zero."""
    b, c, h, w = data.shape
    xs = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    ys = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    return torch.stack([_bilinear_gather(data[k], ys[k], xs[k])
                        for k in range(b)])


@register("GridGenerator")
def grid_generator(data, *, transform_type="affine", target_shape=(0, 0)):
    """Sampling grids: affine, data (B, 6) -> grid (B, 2, H, W) over
    target_shape; warp, data (B, 2, H, W) optical flow added to the
    identity grid."""
    if transform_type == "affine":
        h, w = int(target_shape[0]), int(target_shape[1])
        theta = data.reshape(-1, 2, 3)
        yt, xt = torch.meshgrid(
            torch.linspace(-1.0, 1.0, h, device=data.device),
            torch.linspace(-1.0, 1.0, w, device=data.device), indexing="ij")
        src = torch.stack([xt, yt, torch.ones_like(xt)], 0).reshape(3, -1)
        out = torch.einsum("bij,jk->bik", theta, src)
        return out.reshape(-1, 2, h, w)
    if transform_type == "warp":
        b, _, h, w = data.shape
        yg, xg = torch.meshgrid(
            torch.arange(h, dtype=data.dtype, device=data.device),
            torch.arange(w, dtype=data.dtype, device=data.device),
            indexing="ij")
        x = _div((xg[None] + data[:, 0]) * 2.0, max(w - 1, 1)) - 1.0
        y = _div((yg[None] + data[:, 1]) * 2.0, max(h - 1, 1)) - 1.0
        return torch.stack([x, y], 1)
    raise ValueError(f"unknown transform_type {transform_type}")


@register("SpatialTransformer")
def spatial_transformer(data, loc, *, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    """Affine spatial transformer: loc (B, 6) -> grid -> bilinear samples
    of data."""
    if sampler_type != "bilinear":
        raise ValueError(f"sampler_type must be 'bilinear', got "
                         f"{sampler_type}")
    grid = grid_generator(loc, transform_type=transform_type,
                          target_shape=target_shape)
    return bilinear_sampler(data, grid)


@register("Correlation", num_outputs=1)
def correlation(data1, data2, *, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """FlowNet correlation: one elementwise product (or |difference|),
    k x k window mean and channel mean per displacement."""
    b, c, h, w = data1.shape
    pad = int(pad_size)
    d1 = tF.pad(data1, (pad, pad, pad, pad))
    d2 = tF.pad(data2, (pad, pad, pad, pad))
    hp, wp = h + 2 * pad, w + 2 * pad
    k = int(kernel_size)
    rad = k // 2
    nbh = int(max_displacement) // int(stride2)
    border = rad + int(max_displacement)
    out_h = int(math.ceil((hp - border * 2) / float(stride1)))
    out_w = int(math.ceil((wp - border * 2) / float(stride1)))
    ys = border + torch.arange(out_h, device=data1.device) * stride1
    xs = border + torch.arange(out_w, device=data1.device) * stride1
    maps = []
    for dy in range(-nbh, nbh + 1):
        for dx in range(-nbh, nbh + 1):
            oy, ox = dy * stride2, dx * stride2
            shifted = torch.roll(d2, shifts=(-oy, -ox), dims=(2, 3))
            prod = d1 * shifted if is_multiply else (d1 - shifted).abs()
            if k > 1:
                # XLA's "SAME" window sum: (k - 1) // 2 zeros before, the
                # rest after
                lo, hi = (k - 1) // 2, k - 1 - (k - 1) // 2
                prod = tF.avg_pool2d(tF.pad(prod, (lo, hi, lo, hi)), k,
                                     stride=1)
            m = prod.mean(1)
            maps.append(m[:, ys][:, :, xs])
    return torch.stack(maps, 1)


# ---------------------------------------------------------------------------
# resize / adaptive pooling
# ---------------------------------------------------------------------------


@register("_contrib_BilinearResize2D", aliases=("BilinearResize2D",))
def bilinear_resize_2d(data, *, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size"):
    """Bilinear resize with the reference's align_corners convention
    (source coordinate i * (H - 1) / (oH - 1))."""
    if mode != "size":
        raise NotImplementedError(
            f"BilinearResize2D mode='{mode}': only explicit size/scale "
            f"resizing is implemented (the like/odd_scale/to_even_* size "
            f"derivations are not)")
    b, c, h, w = data.shape
    oh = int(height) if height else int(round(h * (scale_height or 1.0)))
    ow = int(width) if width else int(round(w * (scale_width or 1.0)))
    ys = torch.linspace(0.0, h - 1.0, oh, device=data.device)
    xs = torch.linspace(0.0, w - 1.0, ow, device=data.device)
    yg = ys.repeat_interleave(ow)
    xg = xs.repeat(oh)
    out = torch.stack([_bilinear_gather(img, yg, xg) for img in data])
    return out.reshape(b, c, oh, ow)


@register("_contrib_AdaptiveAvgPooling2D", aliases=("AdaptiveAvgPooling2D",))
def adaptive_avg_pooling_2d(data, *, output_size=(1, 1)):
    """Adaptive average pooling with the reference's integer bin edges
    floor(i * H / oH), ceil((i + 1) * H / oH)."""
    if np.isscalar(output_size):
        output_size = (int(output_size), int(output_size))
    oh, ow = int(output_size[0]), int(output_size[1])
    b, c, h, w = data.shape
    ys = [(int(math.floor(i * h / oh)), int(math.ceil((i + 1) * h / oh)))
          for i in range(oh)]
    xs = [(int(math.floor(j * w / ow)), int(math.ceil((j + 1) * w / ow)))
          for j in range(ow)]
    rows = torch.cat([data[:, :, y0:y1, :].mean(2, keepdim=True)
                      for y0, y1 in ys], 2)
    return torch.cat([rows[:, :, :, x0:x1].mean(3, keepdim=True)
                      for x0, x1 in xs], 3)


# ---------------------------------------------------------------------------
# deformable convolution: a bilinear gather builds (B, C*kh*kw, H', W'),
# then one matmul per group
# ---------------------------------------------------------------------------


@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",), optional=("bias",))
def deformable_convolution(data, offset, weight, bias=None, *, kernel,
                           num_filter, stride=(1, 1), pad=(0, 0),
                           dilate=(1, 1), num_deformable_group=1,
                           num_group=1, no_bias=False, workspace=1024,
                           layout="NCHW"):
    """data (B, C, H, W); offset (B, 2*kh*kw*num_deformable_group, H', W')
    as (dy, dx) per kernel tap and deformable group; weight (num_filter,
    C / num_group, kh, kw) -> (B, num_filter, H', W')."""
    if layout != "NCHW":
        raise ValueError("DeformableConvolution supports layout='NCHW' only "
                         "(matches the reference op)")
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    ph, pw = int(pad[0]), int(pad[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    b, c, h, w = data.shape
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    ndg = int(num_deformable_group)
    cg = c // ndg
    dev = data.device
    oy = torch.arange(oh, dtype=torch.float32, device=dev) * sh - ph
    ox = torch.arange(ow, dtype=torch.float32, device=dev) * sw - pw
    ky = torch.arange(kh, dtype=torch.float32, device=dev) * dh
    kx = torch.arange(kw, dtype=torch.float32, device=dev) * dw
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        oh, ow, kh, kw)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        oh, ow, kh, kw)
    off = offset.reshape(b, ndg, kh, kw, 2, oh, ow)
    cols = []
    for n in range(b):
        per_group = []
        for g in range(ndg):
            dy = off[n, g, :, :, 0].permute(2, 3, 0, 1)
            dx = off[n, g, :, :, 1].permute(2, 3, 0, 1)
            v = _bilinear_gather(data[n, g * cg:(g + 1) * cg],
                                 (base_y + dy).reshape(-1),
                                 (base_x + dx).reshape(-1))
            per_group.append(v.reshape(cg, oh, ow, kh, kw))
        cols.append(torch.cat(per_group, 0).permute(0, 3, 4, 1, 2))
    col = torch.stack(cols)                                # (B, C, kh, kw, oh, ow)
    cpg = c // num_group
    fpg = num_filter // num_group
    col = col.reshape(b, num_group, cpg * kh * kw, oh * ow)
    wmat = weight.reshape(num_group, fpg, cpg * kh * kw)
    out = torch.einsum("bgkp,gfk->bgfp", col, wmat).reshape(
        b, num_filter, oh, ow)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# ---------------------------------------------------------------------------
# RPN proposals (Faster R-CNN)
# ---------------------------------------------------------------------------


def _make_anchors(h, w, stride, scales, ratios, device="cpu"):
    """The anchor grid (A*h*w, 4) of corners and A: a base box of
    `stride` size at each cell, per ratio then per scale (the reference's
    GenerateAnchors)."""
    base = stride - 1.0
    ctr = base / 2.0
    size = stride * stride
    anchors = []
    for r in ratios:
        size_r = size / r
        ws = np.round(np.sqrt(size_r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([ctr - 0.5 * (wss - 1), ctr - 0.5 * (hss - 1),
                            ctr + 0.5 * (wss - 1), ctr + 0.5 * (hss - 1)])
    a = len(anchors)
    anchors = torch.tensor(np.asarray(anchors, np.float32), device=device)
    sx = torch.arange(w, dtype=torch.float32, device=device) * stride
    sy = torch.arange(h, dtype=torch.float32, device=device) * stride
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shift = torch.stack([gx, gy], -1)
    shift = torch.cat([shift, shift], -1)                  # (h, w, 4)
    all_a = anchors[None, None] + shift[:, :, None]        # (h, w, A, 4)
    return all_a.reshape(-1, 4), a


def _proposal_one(score, bbox, im_info, anchors, *, pre_top, post_top,
                  nms_thresh, min_size, stride):
    """One image's RPN proposals: score (A*h*w,), bbox deltas (A*h*w, 4),
    anchors (A*h*w, 4) -> (boxes (post_top, 4), scores (post_top,))."""
    height, width, im_scale = im_info[0], im_info[1], im_info[2]
    zero = torch.zeros((), dtype=score.dtype, device=score.device)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + 0.5 * (aw - 1.0)
    ay = anchors[:, 1] + 0.5 * (ah - 1.0)
    cx = bbox[:, 0] * aw + ax
    cy = bbox[:, 1] * ah + ay
    pw = torch.exp(bbox[:, 2].clamp(-10, 10)) * aw
    ph = torch.exp(bbox[:, 3].clamp(-10, 10)) * ah

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    x1 = clip(cx - 0.5 * (pw - 1.0), width - 1.0)
    y1 = clip(cy - 0.5 * (ph - 1.0), height - 1.0)
    x2 = clip(cx + 0.5 * (pw - 1.0), width - 1.0)
    y2 = clip(cy + 0.5 * (ph - 1.0), height - 1.0)
    ms = min_size * im_scale
    keep = ((x2 - x1 + 1.0) >= ms) & ((y2 - y1 + 1.0) >= ms)
    score = torch.where(keep, score, torch.full_like(score, -1.0))
    # lax.top_k: descending, the lower index first among equal scores
    k = min(pre_top, score.shape[0]) if pre_top > 0 else score.shape[0]
    top_scores, top_idx = torch.sort(score, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    rows = torch.stack([torch.zeros_like(top_scores), top_scores,
                        x1[top_idx], y1[top_idx], x2[top_idx], y2[top_idx]],
                       1)
    rows = torch.where(top_scores[:, None] > -1.0, rows,
                       torch.full_like(rows, -1.0))
    kept = _nms_one(rows, nms_thresh, -1.0, -1, 2, 1, -1, True,
                    "corner", "corner")
    # survivors first (a stable sort of -score), then the post-NMS top;
    # a short list pads with the best proposal, as the reference does
    kept = kept[torch.sort(-kept[:, 1], stable=True).indices]
    if kept.shape[0] < post_top:
        kept = torch.cat([kept, kept[:1].expand(post_top - kept.shape[0],
                                                -1)], 0)
    post = kept[:post_top]
    invalid = post[:, 1] < 0
    post = torch.where(invalid[:, None], kept[:1], post)
    return post[:, 2:6], post[:, 1]


@register("_contrib_Proposal", aliases=("_contrib_MultiProposal", "Proposal"),
          num_outputs=lambda attrs: 2 if attrs.get("output_score") else 1,
          no_grad_inputs=("cls_prob", "bbox_pred", "im_info"))
def proposal(cls_prob, bbox_pred, im_info, *, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
             feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals: cls_prob (B, 2A, H, W) (foreground scores in the
    second half), bbox_pred (B, 4A, H, W), im_info (B, 3) rows (height,
    width, scale) -> rois (B * rpn_post_nms_top_n, 5) [batch_idx, x1, y1,
    x2, y2] (and scores (B * rpn_post_nms_top_n, 1) with
    output_score)."""
    if iou_loss:
        raise NotImplementedError(
            "iou_loss=True decoding (x1,y1,x2,y2 deltas) is not implemented; "
            "retrain the RPN with the standard transform or decode manually")
    b, a2, h, w = cls_prob.shape
    a = a2 // 2
    anchors, a_made = _make_anchors(h, w, feature_stride, scales, ratios,
                                    device=cls_prob.device)
    assert a_made == a, f"anchor count {a_made} != cls_prob channels//2 {a}"
    fg = cls_prob[:, a:].permute(0, 2, 3, 1).reshape(b, -1)
    deltas = (bbox_pred.reshape(b, a, 4, h, w).permute(0, 3, 4, 1, 2)
              .reshape(b, -1, 4))
    per = [_proposal_one(fg[k], deltas[k], im_info[k], anchors,
                         pre_top=int(rpn_pre_nms_top_n),
                         post_top=int(rpn_post_nms_top_n),
                         nms_thresh=float(threshold),
                         min_size=float(rpn_min_size), stride=feature_stride)
           for k in range(b)]
    boxes = torch.stack([p[0] for p in per])
    scores = torch.stack([p[1] for p in per])
    batch_idx = torch.arange(b, dtype=torch.float32,
                             device=cls_prob.device).repeat_interleave(
                                 int(rpn_post_nms_top_n))
    rois = torch.cat([batch_idx[:, None], boxes.reshape(-1, 4)], 1)
    if output_score:
        return rois, scores.reshape(-1, 1)
    return rois


# ---------------------------------------------------------------------------
# nd.image.* ops
# ---------------------------------------------------------------------------


@register("_image_to_tensor")
def _image_to_tensor(data):
    """HWC (or NHWC) [0, 255] -> CHW (NCHW) float32 [0, 1]."""
    x = _div(data.to(torch.float32), 255.0)
    if x.dim() == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register("_image_normalize")
def _image_normalize(data, *, mean=(0.0,), std=(1.0,)):
    """Channel-wise (x - mean) / std on CHW / NCHW floats."""
    shape = [1] * data.dim()
    shape[0 if data.dim() == 3 else 1] = -1
    m = torch.tensor(mean, dtype=data.dtype, device=data.device).reshape(shape)
    s = torch.tensor(std, dtype=data.dtype, device=data.device).reshape(shape)
    return (data - m) / s


@register("_image_resize")
def _image_resize(data, *, size, keep_ratio=False, interp=1):
    """Bilinear (half-pixel centres, antialiased when shrinking) or
    nearest resize of HWC or NHWC images, as `jax.image.resize`."""
    ih, iw = ((data.shape[0], data.shape[1]) if data.dim() == 3
              else (data.shape[1], data.shape[2]))
    if isinstance(size, int):
        if keep_ratio:
            # an int size with keep_ratio fits the short edge to `size`
            if ih > iw:
                w, h = size, int(ih * size / iw)
            else:
                w, h = int(iw * size / ih), size
        else:
            w = h = size
    else:
        w, h = int(size[0]), int(size[1])
    x = data if data.dim() == 4 else data[None]
    x = x.permute(0, 3, 1, 2).to(torch.float32)
    if interp == 0:
        y = tF.interpolate(x, size=(h, w), mode="nearest-exact")
    else:
        y = tF.interpolate(x, size=(h, w), mode="bilinear",
                           align_corners=False,
                           antialias=(h < ih or w < iw))
    y = y.permute(0, 2, 3, 1).to(data.dtype)
    return y if data.dim() == 4 else y[0]
