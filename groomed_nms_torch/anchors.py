"""Anchors: templates, learned priors and their placement on the feature grid
(numpy on the host), the dataset's target statistics, and the anchor <->
ground-truth assignment of the loss (torch).

Counterpart of ``groomed_nms_tpu/anchors.py``.  ``learn_anchor_priors``
matches each GT to its best template with the port's ``pairwise_iou`` (f32
on the CPU) and averages the matched GTs' 3D columns; ``compute_bbox_stats``
is the one-pass mean/std of per-image target rows.  The k-means refinement
``cluster_anchors`` (numpy) is off in every shipped config
(``cluster_anchors=0``).  The grid is ordered
**(h, w, a)**, the natural unroll of an NHWC head output, which is the order
``models/rpn_3d.py`` gives its per-anchor rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops.boxes import bbox_transform, bbox_transform_3d
from .ops.iou import pairwise_iou, pairwise_iou_ign


def anchor_center(w, h, stride):
    """Anchor box of size (w, h) centered at ((stride-1)/2, (stride-1)/2)."""
    c = (stride - 1) / 2.0
    return np.array([c - w / 2.0, c - h / 2.0, c + w / 2.0, c + h / 2.0],
                    dtype=np.float32)


def generate_anchor_templates(anchor_scales, anchor_ratios, stride):
    """[len(scales) * len(ratios), 4] template boxes; h = scale, w = scale*ratio."""
    out = np.zeros([len(anchor_scales) * len(anchor_ratios), 4], np.float32)
    i = 0
    for scale in anchor_scales:
        for ratio in anchor_ratios:
            out[i] = anchor_center(scale * ratio, scale, stride)
            i += 1
    return out


def locate_anchors(anchors, feat_size, stride):
    """Tile anchors over the feature grid in (h, w, a) order.

    anchors [A, >=4] -> rois [H*W*A, 5] of [x1, y1, x2, y2, anchor_index].
    """
    anchors = np.asarray(anchors, np.float32)
    h, w = int(feat_size[0]), int(feat_size[1])
    a = anchors.shape[0]
    shift_x = (np.arange(w, dtype=np.float32) * stride)[None, :, None]
    shift_y = (np.arange(h, dtype=np.float32) * stride)[:, None, None]
    sx = np.broadcast_to(shift_x, (h, w, a))
    sy = np.broadcast_to(shift_y, (h, w, a))
    boxes = anchors[None, None, :, :4] + np.stack([sx, sy, sx, sy], axis=-1)
    tracker = np.broadcast_to(
        np.arange(a, dtype=np.float32)[None, None, :], (h, w, a))
    rois = np.concatenate([boxes, tracker[..., None]], axis=-1)
    return rois.reshape(h * w * a, 5)


class Targets(NamedTuple):
    """Per-anchor assignment, all [B, R, ...] in roi order."""

    labels: torch.Tensor         # [B, R] float: -1 bg, 0 ignored, >=1 class
    transforms_2d: torch.Tensor  # [B, R, 4] dx dy dw dh (0 for non-fg)
    transforms_3d: torch.Tensor  # [B, R, T3] 3D deltas + raw GT tail (0 non-fg)
    gt_index: torch.Tensor       # [B, R] int64 assigned GT (meaningful on fg)
    fg_mask: torch.Tensor        # [B, R] bool
    bg_mask: torch.Tensor        # [B, R] bool
    ols_max: torch.Tensor        # [B, R] max IoU against the valid GTs
    raw_gt_2d: torch.Tensor      # [B, R, 4] assigned GT box (0 for non-fg)
    raw_gt_3d: torch.Tensor      # [B, R, K] assigned GT bbox_3d row (0 non-fg)


def _take_gt(table, gt_index):
    """table [B, G, K], gt_index [B, R] -> [B, R, K] (a gather where JAX
    contracts with a one-hot matrix; both copy the rows exactly)."""
    idx = gt_index[..., None].expand(-1, -1, table.shape[-1])
    return torch.gather(table, 1, idx)


def compute_targets(rois, rois_3d, gts_2d, gts_3d, gt_labels, gt_valid,
                    ign_2d, ign_valid, *, fg_thresh, ign_thresh, bg_thresh_lo,
                    bg_thresh_hi, best_thresh, decomp_alpha=True,
                    has_vel=False):
    """Batched anchor <-> GT assignment.

    ``rois`` [R, 5] and ``rois_3d`` [R, P] are shared by the batch;
    ``gts_2d`` [B, G, 4], ``gts_3d`` [B, G, K], ``gt_labels`` [B, G],
    ``gt_valid`` [B, G] bool and ``ign_2d`` [B, I, 4], ``ign_valid`` [B, I]
    are padded.  fg = IoU >= fg_thresh or the best anchor of a GT (at >=
    best_thresh); each fg anchor regresses to its argmax GT; bg = IoU in
    [bg_lo, bg_hi) minus ignores and fg.  An image with no valid GT and no
    ignore region is all background.
    """
    boxes = rois[:, :4]
    b, r = gts_2d.shape[0], boxes.shape[0]
    ols = torch.where(gt_valid[:, None, :], pairwise_iou(boxes, gts_2d), -1.0)
    any_gt = gt_valid.any(1, keepdim=True)                     # [B, 1]
    ols_max = torch.where(any_gt, ols.amax(2), 0.0)
    gt_index = ols.argmax(2)                                   # [B, R]

    best_roi = ols.argmax(1)                                   # [B, G]
    matched = gt_valid & (ols.amax(1) >= best_thresh)
    is_best = torch.zeros((b, r), device=boxes.device).scatter_reduce(
        1, best_roi, matched.float(), "amax") > 0
    fg = any_gt & ((ols_max >= fg_thresh) | is_best)

    if ign_2d.shape[1]:
        ols_ign = torch.where(ign_valid[:, None, :],
                              pairwise_iou_ign(boxes, ign_2d), 0.0)
        ign = ols_ign.amax(2) >= ign_thresh
        any_ign = ign_valid.any(1, keepdim=True)
    else:
        ign = torch.zeros_like(fg)
        any_ign = torch.zeros_like(any_gt)
    bg = (ols_max >= bg_thresh_lo) & (ols_max < bg_thresh_hi)
    bg = torch.where(any_gt | any_ign, bg & ~ign & ~fg & ~is_best, True)

    labels = torch.where(bg, -1.0, 0.0)
    labels = torch.where(
        fg, torch.gather(gt_labels.float(), 1, gt_index), labels)
    tgt_2d = _take_gt(gts_2d, gt_index)
    tgt_3d = _take_gt(gts_3d, gt_index)
    # a non-finite GT entry (the -inf "no velocity" sentinel) comes out as
    # -inf, as the JAX one-hot selection restores it
    tgt_3d = torch.where(torch.isfinite(tgt_3d), tgt_3d, float("-inf"))
    t2d = bbox_transform(boxes, tgt_2d)
    t3d = bbox_transform_3d(boxes, rois_3d, tgt_3d,
                            decomp_alpha=decomp_alpha, has_vel=has_vel)
    # zero non-fg rows with `where`, never a product: t3d holds -inf (log 0
    # of the zero-padded GT every anchor of a GT-less image selects, and the
    # no-velocity sentinel), and 0 * -inf = NaN poisons every gradient
    fg_col = fg[..., None]
    return Targets(
        labels=labels,
        transforms_2d=torch.where(fg_col, t2d, 0.0),
        transforms_3d=torch.where(fg_col, t3d, 0.0),
        gt_index=gt_index, fg_mask=fg, bg_mask=bg, ols_max=ols_max,
        raw_gt_2d=torch.where(fg_col, tgt_2d, 0.0),
        raw_gt_3d=torch.where(fg_col, tgt_3d, 0.0))


def learn_anchor_priors(templates, gts_2d, gts_3d, min_overlap=0.2,
                        decomp_alpha=True, has_vel=False):
    """Attach learned 3D priors to the 2D anchor templates.

    ``templates`` [A, 4]; ``gts_2d`` [G, 4] valid GT boxes re-centred at
    the anchor origin; ``gts_3d`` [G, >=16] their ``bbox_3d`` rows.  Each
    GT goes to the template of largest IoU (when above ``min_overlap``);
    a template's priors are the means of its GTs' projected depth (column
    2), w3d, h3d, l3d, alpha (column 6), alpha_sin / alpha_cos
    (``decomp_alpha``) and the non-negative velocities (``has_vel``).

    Returns [A', 9 (+2 decomp) (+1 vel)] anchors
    [x1, y1, x2, y2, z, w3d, h3d, l3d, rot, (sin, cos), (vel)], the
    templates no GT chose dropped (all A when there is no GT).
    """
    a = templates.shape[0]
    extra = 5 + (2 if decomp_alpha else 0) + (1 if has_vel else 0)
    anchors = np.concatenate([templates, np.zeros((a, extra), np.float32)],
                             axis=1)
    if gts_2d.shape[0] == 0:
        return anchors

    ols = pairwise_iou(torch.from_numpy(np.asarray(templates, np.float32)),
                       torch.from_numpy(np.asarray(gts_2d, np.float32))
                       ).numpy()                                  # [A, G]
    best_anchor = np.argmax(ols, axis=0)
    best_ol = np.max(ols, axis=0)

    used = np.zeros(a, bool)
    for aind in range(a):
        sel = (best_anchor == aind) & (best_ol > min_overlap)
        if not sel.any():
            continue
        used[aind] = True
        g = gts_3d[sel]
        anchors[aind, 4] = g[:, 2].mean()    # cz3d_2d, the projected depth
        anchors[aind, 5] = g[:, 3].mean()    # w3d
        anchors[aind, 6] = g[:, 4].mean()    # h3d
        anchors[aind, 7] = g[:, 5].mean()    # l3d
        anchors[aind, 8] = g[:, 6].mean()    # alpha: the rotation target
        if decomp_alpha:
            anchors[aind, 9] = g[:, 12].mean()   # alpha_sin
            anchors[aind, 10] = g[:, 13].mean()  # alpha_cos
        if has_vel:
            vel = g[:, 16]
            vel = vel[vel >= 0]
            if vel.size:
                anchors[aind, 9 + 2 * decomp_alpha] = vel.mean()
    return anchors[used]


def compute_bbox_stats(per_image_rows, n_targets):
    """Mean and std of foreground target rows over a dataset.

    ``per_image_rows`` yields [F_i, T] rows (2D deltas then 3D deltas).
    Accumulates in f64, each column over its finite entries only (the
    velocity target is -inf where a track has no velocity).  Returns
    (means [1, T], stds [1, T]); zeros and ones when no row is finite, and
    a std of 1 for a column with fewer than two entries.
    """
    total = np.zeros(n_targets, np.float64)
    s = np.zeros(n_targets, np.float64)
    sq = np.zeros(n_targets, np.float64)
    for rows in per_image_rows:
        if rows.shape[0] == 0:
            continue
        rows = np.asarray(rows, np.float64)
        ok = np.isfinite(rows)
        rows = np.where(ok, rows, 0.0)
        total += ok.sum(axis=0)
        s += rows.sum(axis=0)
        sq += (rows ** 2).sum(axis=0)
    if not total.any():
        return np.zeros((1, n_targets)), np.ones((1, n_targets))
    cnt = np.maximum(total, 1.0)
    means = s / cnt
    var = np.maximum(sq / cnt - means ** 2, 1e-12)
    stds = np.where(total > 1, np.sqrt(var), 1.0)
    return means[None, :], stds[None, :]


def _np_iou_corners(a, b):
    """Pairwise IoU [A, G] of corner boxes, numpy, with +1 pixel widths."""
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def normalized_gts_for_clustering(imdb, feat_stride, test_scale, lbls,
                                  ilbls, min_gt_vis=0.99, min_gt_h=0):
    """The valid GTs of ``imdb`` for ``cluster_anchors``: per record, the 2D
    boxes scaled by ``scale * test_scale / im_h``, the removed and ignored
    GTs dropped (``determine_ignores`` with ``use_trunc``), each box
    re-centred at ``anchor_center(w, h, feat_stride)``, then the record's
    unscaled 16-column ``bbox_3d`` row.  Returns [G, 20] f64 sorted by 2D
    height, ascending."""
    from .data.imdb import determine_ignores

    rows = []
    for rec in imdb:
        gts = rec.gts
        if not gts or len(gts.get("cls", [])) == 0:
            continue
        scale = rec.scale * test_scale / rec.im_h
        igns, rmvs = determine_ignores(gts, lbls, ilbls, min_gt_vis,
                                       min_gt_h, np.inf, scale,
                                       use_trunc=True)
        keep = (~igns) & (~rmvs)
        if not keep.any():
            continue
        bf = gts["bbox_full"][keep] * scale
        corners = np.stack([bf[:, 0], bf[:, 1],
                            bf[:, 0] + bf[:, 2] - 1,
                            bf[:, 1] + bf[:, 3] - 1], axis=1)
        w = corners[:, 2] - corners[:, 0] + 1
        h = corners[:, 3] - corners[:, 1] + 1
        centered = np.stack([anchor_center(wi, hi, feat_stride)
                             for wi, hi in zip(w, h)])
        rows.append(np.concatenate(
            [centered.astype(np.float64), gts["bbox_3d"][keep, :16]],
            axis=1))
    if not rows:
        return np.zeros((0, 20))
    out = np.concatenate(rows, axis=0)
    return out[np.argsort(out[:, 3] - out[:, 1] + 1)]


def cluster_anchors(anchors, normalized_gts, feat_stride, rounds=50):
    """Refine anchors by k-means with 2D-IoU argmax assignment, with the
    reference's quirks: exactly ``rounds`` (50) rounds, the final anchors
    returned; the 3D prior columns 4..8 refilled from the GT rows' columns
    6..10 (cz2d, w3d, h3d, l3d and alpha, not rotY); the decomp-alpha and
    velocity columns (9+) left as they are; an anchor that attracts no GT
    raises ``ValueError``.

    ``anchors`` [A, >=9]; ``normalized_gts`` [G, 20] from
    ``normalized_gts_for_clustering``.  Returns a refined f64 copy.
    """
    anch = np.array(anchors, np.float64, copy=True)
    gts = np.asarray(normalized_gts, np.float64)
    if gts.shape[0] == 0:
        return anch
    gw = gts[:, 2] - gts[:, 0] + 1
    gh = gts[:, 3] - gts[:, 1] + 1
    for _ in range(rounds):
        assign = _np_iou_corners(anch[:, :4], gts[:, :4]).argmax(axis=0)
        for a in range(anch.shape[0]):
            m = assign == a
            if not m.any():
                raise ValueError(f"Non-used anchor #{a} found")
            anch[a, :4] = anchor_center(gw[m].mean(), gh[m].mean(),
                                        feat_stride)
            anch[a, 4:9] = gts[m, 6:11].mean(axis=0)
    return anch
