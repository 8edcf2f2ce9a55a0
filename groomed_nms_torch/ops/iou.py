"""Pairwise 2D IoU (counterpart of ``groomed_nms_tpu/ops/iou.py``).

``shift`` selects the box-width convention: 0 (``w = x2 - x1``, the
GrooMeD-NMS and loss convention, the default) or 1 (the +1-pixel convention
of classical greedy NMS).
"""

from __future__ import annotations


def _area(box, shift=0.0):
    return (box[..., 2] - box[..., 0] + shift) * (box[..., 3] - box[..., 1] + shift)


def pairwise_intersect(box_a, box_b, shift=0.0):
    """Pairwise intersection area. box_a [M, 4], box_b [N, 4] -> [M, N]."""
    max_xy = box_a[:, None, 2:4].minimum(box_b[None, :, 2:4])
    min_xy = box_a[:, None, 0:2].maximum(box_b[None, :, 0:2])
    wh = (max_xy - min_xy + shift).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(box_a, box_b, shift=0.0):
    """Pairwise IoU. box_a [M, 4], box_b [N, 4] -> [M, N]."""
    inter = pairwise_intersect(box_a, box_b, shift)
    union = _area(box_a, shift)[:, None] + _area(box_b, shift)[None, :] - inter
    return inter / union
