"""2D and 3D box deltas (counterpart of ``groomed_nms_tpu/ops/boxes.py``).

Box convention: ``[x1, y1, x2, y2]`` inclusive pixel corners, widths are
``x2 - x1 + 1`` (the legacy R-CNN convention the anchors and the KITTI
evaluator rely on).  Shape-polymorphic over leading axes.
"""

from __future__ import annotations

import torch


def xywh_to_corners(box):
    """[..., 4] [x, y, w, h] -> [x1, y1, x2, y2], inclusive pixels:
    ``x2 = x + w - 1``."""
    return torch.stack([box[..., 0], box[..., 1],
                        box[..., 0] + box[..., 2] - 1,
                        box[..., 1] + box[..., 3] - 1], dim=-1)


def corners_to_xywh(box):
    """[..., 4] [x1, y1, x2, y2] -> [x, y, w, h], inclusive pixels:
    ``w = x2 - x1 + 1``."""
    return torch.stack([box[..., 0], box[..., 1],
                        box[..., 2] - box[..., 0] + 1,
                        box[..., 3] - box[..., 1] + 1], dim=-1)


def center_size(box):
    """(ctr_x, ctr_y, w, h) of corner boxes (inclusive convention)."""
    w = box[..., 2] - box[..., 0] + 1.0
    h = box[..., 3] - box[..., 1] + 1.0
    cx = box[..., 0] + 0.5 * w
    cy = box[..., 1] + 0.5 * h
    return cx, cy, w, h


def bbox_transform(ex_rois, gt_rois):
    """2D deltas [dx, dy, dw, dh] from anchors ``ex_rois`` to ``gt_rois``:
    center offsets over the anchor size, log size ratios."""
    ex_cx, ex_cy, ex_w, ex_h = center_size(ex_rois)
    gt_cx, gt_cy, gt_w, gt_h = center_size(gt_rois)
    return torch.stack([(gt_cx - ex_cx) / ex_w, (gt_cy - ex_cy) / ex_h,
                        torch.log(gt_w / ex_w), torch.log(gt_h / ex_h)],
                       dim=-1)


def bbox_transform_3d(ex_rois_2d, ex_rois_3d, gt_rois, decomp_alpha=False,
                      has_vel=False):
    """3D regression targets relative to an anchor's 3D prior.

    ``gt_rois`` columns are the imdb ``bbox_3d`` layout ``[cx, cy, cz2d, w3d,
    h3d, l3d, alpha, cx3d, cy3d, cz3d, rotY, elev, alpha_sin, alpha_cos,
    axis_lbl, head_lbl, (vel)]``; ``ex_rois_3d`` the prior ``[z, w3d, h3d,
    l3d, rotY, (sin, cos, (vel))]``.  Returns ``[dx, dy, dz, dlog_w,
    dlog_h, dlog_l, drotY, (dsin, dcos, (dvel)), gt_rois[7:]]``: the raw GT
    tail is appended so the loss can read raw camera coordinates.  Without a
    velocity column in ``gt_rois`` the dvel target is -inf.
    """
    _, _, ex_w, ex_h = center_size(ex_rois_2d)
    ex_cx = ex_rois_2d[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois_2d[..., 1] + 0.5 * ex_h
    dx = (gt_rois[..., 0] - ex_cx) / ex_w
    cols = [dx, (gt_rois[..., 1] - ex_cy) / ex_h,
            gt_rois[..., 2] - ex_rois_3d[..., 0],
            torch.log(gt_rois[..., 3] / ex_rois_3d[..., 1]),
            torch.log(gt_rois[..., 4] / ex_rois_3d[..., 2]),
            torch.log(gt_rois[..., 5] / ex_rois_3d[..., 3]),
            gt_rois[..., 6] - ex_rois_3d[..., 4]]
    if decomp_alpha:
        cols.append(gt_rois[..., 12] - ex_rois_3d[..., 5])
        cols.append(gt_rois[..., 13] - ex_rois_3d[..., 6])
        if has_vel:
            if ex_rois_3d.shape[-1] < 8:
                raise ValueError(
                    "has_vel targets need an 8-column anchor prior [z w3d "
                    "h3d l3d rotY sin cos vel]; got "
                    f"{ex_rois_3d.shape[-1]} columns")
            if gt_rois.shape[-1] == 17:
                cols.append(gt_rois[..., 16] - ex_rois_3d[..., 7])
            else:
                cols.append(torch.full_like(dx, float("-inf")))
    targets = torch.stack(torch.broadcast_tensors(*cols), dim=-1)
    tail = gt_rois[..., 7:].expand(targets.shape[:-1] + (-1,))
    return torch.cat([targets, tail], dim=-1)


def bbox_transform_inv(boxes, deltas, means=None, stds=None,
                       max_log_scale=None):
    """Decode [dx, dy, dw, dh] deltas against corner anchors ``boxes``,
    de-normalising with ``stds`` then ``means`` when given.
    ``max_log_scale`` caps the de-normalised dw and dh before ``exp`` (no
    cap by default, as JAX's decode)."""
    cx, cy, w, h = center_size(boxes)
    dx, dy, dw, dh = deltas.unbind(-1)
    if stds is not None:
        dx, dy, dw, dh = dx * stds[0], dy * stds[1], dw * stds[2], dh * stds[3]
    if means is not None:
        dx, dy = dx + means[0], dy + means[1]
        dw, dh = dw + means[2], dh + means[3]
    if max_log_scale is not None:
        dw, dh = dw.clamp(max=max_log_scale), dh.clamp(max=max_log_scale)
    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h
    return torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                        pred_cx + 0.5 * pred_w - 1,
                        pred_cy + 0.5 * pred_h - 1], dim=-1)
