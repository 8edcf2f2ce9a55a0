"""The stage-1 loss in plain PyTorch: the M3D-RPN-style loss of the
``kitti_3d_warmup`` config (no acceptance branch, no NMS in the loss).

For each anchor: the 2D IoU with each ground truth; foreground where it is
at least ``fg_thresh`` or the anchor is a GT's best one (at least
``best_thresh``), background below ``bg_thresh_hi``; the regression targets
of the GT of largest IoU.  Of ``box_samples`` of the anchors, a
``fg_fraction`` share of foregrounds and the rest background are kept, the
lowest-scored of each first (hard negatives).  The loss is the weighted
softmax cross-entropy, the smooth-L1 3D terms with the sin/cos branch and
the axis and heading classifiers, and -log(IoU) of the decoded 2D boxes,
each a mean over its rows.  Imports torch and numpy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_LOG_SCALE = math.log(1e6)


def _iou(a, b):
    """Pairwise IoU of corner boxes a [..., M, 4] and b [..., N, 4], widths
    x2 - x1."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def _center(box):
    w = box[..., 2] - box[..., 0] + 1.0
    h = box[..., 3] - box[..., 1] + 1.0
    return box[..., 0] + 0.5 * w, box[..., 1] + 0.5 * h, w, h


def _decode(anchors, d, means, stds):
    cx, cy, w, h = _center(anchors)
    dx, dy = d[..., 0] * stds[0] + means[0], d[..., 1] * stds[1] + means[1]
    dw = (d[..., 2] * stds[2] + means[2]).clamp(max=MAX_LOG_SCALE)
    dh = (d[..., 3] * stds[3] + means[3]).clamp(max=MAX_LOG_SCALE)
    px, py = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw - 1,
                        py + 0.5 * ph - 1], dim=-1)


def _smooth_l1(x, t):
    d = (x - t).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _bce(p, t):
    p = p.clamp(1e-7, 1.0 - 1e-7)
    return -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))


def _mean(x, mask):
    ok = mask & torch.isfinite(x)
    return torch.where(ok, x, 0.0).sum() / ok.sum().clamp_min(1)


def _lowest(mask, score, num):
    """mask & the ``num`` [B] lowest scores of mask (stable order)."""
    key = torch.where(mask, score, float("inf"))
    rank = torch.argsort(torch.argsort(key, dim=-1, stable=True), dim=-1)
    return mask & (rank < num[:, None])


def assign(rois, rois_3d, gt, cfg):
    """Each anchor's ground truth: (fg, bg, label, the matched GT's 3D row,
    the 2D targets [B, R, 4], the 3D targets [B, R, 9]), unnormalised."""
    boxes = rois[:, :4]
    valid = gt["gt_valid"]
    b, r = valid.shape[0], boxes.shape[0]
    ols = torch.where(valid[:, None, :], _iou(boxes, gt["gts_2d"]), -1.0)
    any_gt = valid.any(1, keepdim=True)
    ols_max = torch.where(any_gt, ols.amax(2), 0.0)
    gt_index = ols.argmax(2)
    matched = valid & (ols.amax(1) >= cfg["best_thresh"])
    is_best = torch.zeros((b, r), device=boxes.device).scatter_reduce(
        1, ols.argmax(1), matched.float(), "amax") > 0
    fg = any_gt & ((ols_max >= cfg["fg_thresh"]) | is_best)
    bg = (ols_max >= cfg["bg_thresh_lo"]) & (ols_max < cfg["bg_thresh_hi"])
    bg = torch.where(any_gt, bg & ~fg & ~is_best, True)
    take = lambda t: torch.gather(  # noqa: E731
        t, 1, gt_index[..., None].expand(-1, -1, t.shape[-1]))
    tgt2, tgt3 = take(gt["gts_2d"]), take(gt["gts_3d"])
    label = torch.where(fg, torch.gather(gt["gt_labels"], 1, gt_index).long(),
                        0)
    ecx, ecy, ew, eh = _center(boxes)
    gcx, gcy, gw, gh = _center(tgt2)
    t2 = torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                      torch.log(gw / ew), torch.log(gh / eh)], -1)
    t3 = torch.stack([(tgt3[..., 0] - ecx) / ew, (tgt3[..., 1] - ecy) / eh,
                      tgt3[..., 2] - rois_3d[:, 0],
                      torch.log(tgt3[..., 3] / rois_3d[:, 1]),
                      torch.log(tgt3[..., 4] / rois_3d[:, 2]),
                      torch.log(tgt3[..., 5] / rois_3d[:, 3]),
                      tgt3[..., 6] - rois_3d[:, 4],
                      tgt3[..., 12] - rois_3d[:, 5],
                      tgt3[..., 13] - rois_3d[:, 6]], -1)
    return fg, bg, label, tgt3, t2, t3


def target_stats(rois, rois_3d, gts, cfg):
    """The regression targets' mean and standard deviation [13] over the
    foreground anchors of the ground-truth batches ``gts`` (f64 numpy), as
    a training run learns them from its data set before it starts."""
    rows = []
    for gt in gts:
        fg, _, _, _, t2, t3 = assign(rois, rois_3d, gt, cfg)
        rows.append(torch.cat([t2, t3], -1)[fg].double())
    rows = torch.cat(rows)
    if not len(rows):
        return np.zeros(13), np.ones(13)
    var = rows.var(0, unbiased=False).clamp_min(1e-12)
    return rows.mean(0).cpu().numpy(), var.sqrt().cpu().numpy()


def stage1_loss(head, rois, rois_3d, gt, means, stds, cfg):
    """(loss, {term: value}) of one batch: ``head`` [B, R, per] f32 (class
    logits, 2D deltas, 3D deltas), anchors ``rois`` [R, 5] and priors ``rois_3d``
    [R, 7], ``gt`` a dict of the padded ground truth (``gts_2d``, ``gts_3d``,
    ``gt_labels``, ``gt_valid``; no ignore region is valid), ``means`` and
    ``stds`` [13], ``cfg`` the experiment dict."""
    c = len(cfg["lbls"]) + 1
    cls = head[..., :c]
    b2 = head[..., c:c + 4]
    raw3 = head[..., c + 4:c + 14]
    b3 = torch.cat([raw3[..., :8], torch.sigmoid(raw3[..., 8:10])], -1)
    prob = torch.softmax(cls, dim=-1)
    b, r, _ = cls.shape
    boxes = rois[:, :4]
    fg, bg, label, tgt3, t2, t3 = assign(rois, rois_3d, gt, cfg)

    fgc = fg[..., None]
    t2n = (torch.where(fgc, t2, 0.0) - means[:4]) / stds[:4]
    t3n = (torch.where(fgc, t3, 0.0) - means[4:13]) / stds[4:13]
    axis_t = torch.where(fg, tgt3[..., 14], 0.0)
    head_t = torch.where(fg, tgt3[..., 15], 0.0)

    # -- sampling: hard negatives first ------------------------------------
    onehot = (label[..., None] == torch.arange(c, device=head.device)).float()
    s_label = (prob.detach() * onehot).sum(-1)
    n_fg, n_bg = fg.sum(1), bg.sum(1)
    frac, samples = cfg["fg_fraction"], cfg["box_samples"]
    want_fg = n_fg.clamp_max(round(r * samples * frac))
    want_bg = torch.minimum(round(r * samples) - want_fg, n_bg)
    fg_sel = _lowest(fg, s_label, want_fg)
    bg_sel = _lowest(bg, s_label, want_bg)
    fg_num, bg_num = fg_sel.sum(), bg_sel.sum()
    fg_w = torch.where(fg_num > 0, frac / (1 - frac) * bg_num /
                       fg_num.clamp_min(1), 0.0)
    weight = torch.where(fg_sel, fg_w, 0.0) + torch.where(bg_sel, 1.0, 0.0)

    # -- terms ---------------------------------------------------------------
    logp = torch.log_softmax(cls, dim=-1)
    ce = -torch.where(onehot > 0, logp, 0.0).sum(-1)
    loss_cls = _mean((ce * weight).clamp(0.0, 2000.0), fg_sel | bg_sel) \
        * cfg["cls_2d_lambda"]
    terms = [_smooth_l1(b3[..., i], t3n[..., i]) for i in range(6)]
    terms.append(torch.where(axis_t == 1, _smooth_l1(b3[..., 6], t3n[..., 7]),
                             _smooth_l1(b3[..., 7], t3n[..., 8])))
    l3 = sum(_mean(t, fg_sel) for t in terms)
    l3 = l3 + (_mean(_bce(b3[..., 8], axis_t), fg_sel) +
               _mean(_bce(b3[..., 9], head_t), fg_sel)) \
        * cfg["bbox_axis_head_lambda"]
    any_fg = fg_num > 0
    loss_3d = torch.where(any_fg, l3 * cfg["bbox_3d_lambda"], 0.0)
    pred = _decode(boxes, b2, means, stds)
    tgt = _decode(boxes, t2n, means, stds)
    lt = torch.maximum(pred[..., :2], tgt[..., :2])
    rb = torch.minimum(pred[..., 2:], tgt[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])  # noqa
    iou = inter / (area(pred) + area(tgt) - inter)
    l_iou = _mean(-torch.log(iou.clamp(1e-12, 1.0)), fg_sel & (iou > 0))
    loss_iou = torch.where(any_fg, l_iou * cfg["iou_2d_lambda"], 0.0)
    return loss_cls + loss_3d + loss_iou, {
        "cls": loss_cls, "bbox_3d": loss_3d, "iou_2d_loss": loss_iou}
