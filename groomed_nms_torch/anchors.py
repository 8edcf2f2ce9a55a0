"""Anchors: templates and their placement on the feature grid (numpy), and
the anchor <-> ground-truth assignment of the loss (torch).

Counterpart of ``groomed_nms_tpu/anchors.py``.  The grid is ordered
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
