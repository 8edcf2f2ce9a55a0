"""2D box delta decoding (counterpart of ``groomed_nms_tpu/ops/boxes.py``).

Box convention: ``[x1, y1, x2, y2]`` inclusive pixel corners, widths are
``x2 - x1 + 1`` (the legacy R-CNN convention the anchors and the KITTI
evaluator rely on).  Shape-polymorphic over leading axes.
"""

from __future__ import annotations

import torch


def center_size(box):
    """(ctr_x, ctr_y, w, h) of corner boxes (inclusive convention)."""
    w = box[..., 2] - box[..., 0] + 1.0
    h = box[..., 3] - box[..., 1] + 1.0
    cx = box[..., 0] + 0.5 * w
    cy = box[..., 1] + 0.5 * h
    return cx, cy, w, h


def bbox_transform_inv(boxes, deltas, means=None, stds=None):
    """Decode [dx, dy, dw, dh] deltas against corner anchors ``boxes``,
    de-normalising with ``stds`` then ``means`` when given."""
    cx, cy, w, h = center_size(boxes)
    dx, dy, dw, dh = deltas.unbind(-1)
    if stds is not None:
        dx, dy, dw, dh = dx * stds[0], dy * stds[1], dw * stds[2], dh * stds[3]
    if means is not None:
        dx, dy = dx + means[0], dy + means[1]
        dw, dh = dw + means[2], dh + means[3]
    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h
    return torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                        pred_cx + 0.5 * pred_w - 1,
                        pred_cy + 0.5 * pred_h - 1], dim=-1)
