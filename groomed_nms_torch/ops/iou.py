"""Box overlaps: 2D IoU, ignore overlap and approximate 3D IoU
(counterpart of ``groomed_nms_tpu/ops/iou.py``).

``shift`` selects the box-width convention: 0 (``w = x2 - x1``, the
GrooMeD-NMS and loss convention, the default) or 1 (the +1-pixel convention
of classical greedy NMS).  The ``pairwise_*`` functions broadcast over
leading batch axes: ``[..., M, 4]`` and ``[..., N, 4]`` give ``[..., M, N]``;
the ``elementwise_*`` ones give one value per row.
"""

from __future__ import annotations

import torch


def _area(box, shift=0.0):
    return (box[..., 2] - box[..., 0] + shift) * (box[..., 3] - box[..., 1] + shift)


def pairwise_intersect(box_a, box_b, shift=0.0):
    """Pairwise intersection area. [..., M, 4], [..., N, 4] -> [..., M, N]."""
    max_xy = box_a[..., :, None, 2:4].minimum(box_b[..., None, :, 2:4])
    min_xy = box_a[..., :, None, 0:2].maximum(box_b[..., None, :, 0:2])
    wh = (max_xy - min_xy + shift).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(box_a, box_b, shift=0.0):
    """Pairwise IoU. [..., M, 4], [..., N, 4] -> [..., M, N]."""
    inter = pairwise_intersect(box_a, box_b, shift)
    union = (_area(box_a, shift)[..., :, None]
             + _area(box_b, shift)[..., None, :] - inter)
    return inter / union


def pairwise_iou_ign(box_a, box_b):
    """Overlap of box_a inside the ignore regions box_b, normalised by
    box_a's area only. [..., M, 4], [..., N, 4] -> [..., M, N]."""
    return pairwise_intersect(box_a, box_b) / _area(box_a)[..., :, None]


def elementwise_intersect(box_a, box_b, shift=0.0):
    """Row-wise intersection area. [..., 4], [..., 4] -> [...]."""
    max_xy = box_a[..., 2:4].minimum(box_b[..., 2:4])
    min_xy = box_a[..., 0:2].maximum(box_b[..., 0:2])
    wh = (max_xy - min_xy + shift).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def elementwise_iou(box_a, box_b, shift=0.0):
    """Row-wise IoU. [..., 4], [..., 4] -> [...]."""
    inter = elementwise_intersect(box_a, box_b, shift)
    return inter / (_area(box_a, shift) + _area(box_b, shift) - inter)


def aabb_volume(corners):
    """Axis-aligned bounding volume of corner sets [..., 3, 8] -> [...]."""
    diff = corners.amax(-1) - corners.amin(-1)
    return diff[..., 0] * diff[..., 1] * diff[..., 2]


def bev_boxes_from_corners(corners):
    """[..., 3, 8] cuboid corners -> [..., 4] axis-aligned BEV footprints
    [x1, z1, x2, z2] over the bottom-face corners 2, 3, 6, 7."""
    bottom = torch.cat([corners[..., 2:4], corners[..., 6:8]], dim=-1)
    x, z = bottom[..., 0, :], bottom[..., 2, :]
    return torch.stack([x.amin(-1), z.amin(-1), x.amax(-1), z.amax(-1)],
                       dim=-1)


def _span_overlap(lo_a, hi_a, lo_b, hi_b, pairwise):
    if pairwise:
        lo = lo_a[..., :, None].maximum(lo_b[..., None, :])
        hi = hi_a[..., :, None].minimum(hi_b[..., None, :])
    else:
        lo, hi = lo_a.maximum(lo_b), hi_a.minimum(hi_b)
    return (hi - lo).clamp_min(0.0)


def _span_hull(lo_a, hi_a, lo_b, hi_b, pairwise):
    if pairwise:
        lo = lo_a[..., :, None].minimum(lo_b[..., None, :])
        hi = hi_a[..., :, None].maximum(hi_b[..., None, :])
    else:
        lo, hi = lo_a.minimum(lo_b), hi_a.maximum(hi_b)
    return (hi - lo).clamp_min(0.0)


def iou3d_approximate(corners_a, corners_b, pairwise=True, generalized=False):
    """Approximate 3D IoU of cuboid corner sets: the axis-aligned BEV
    footprints' overlap times the vertical overlap over the AABB volumes;
    ``generalized=True`` subtracts the GIoU-3D hull penalty.

    corners_a [..., M, 3, 8], corners_b [..., N, 3, 8] (M == N and one
    value per row when not ``pairwise``).  Returns (iou_bev, iou_3d),
    [..., M, N] when ``pairwise`` else [..., M].
    """
    vol_a, vol_b = aabb_volume(corners_a), aabb_volume(corners_b)
    y_lo_a, y_hi_a = corners_a[..., 1, :].amin(-1), corners_a[..., 1, :].amax(-1)
    y_lo_b, y_hi_b = corners_b[..., 1, :].amin(-1), corners_b[..., 1, :].amax(-1)
    bev_a = bev_boxes_from_corners(corners_a)
    bev_b = bev_boxes_from_corners(corners_b)

    y_inter = _span_overlap(y_lo_a, y_hi_a, y_lo_b, y_hi_b, pairwise)
    if pairwise:
        vol = vol_a[..., :, None] + vol_b[..., None, :]
        iou_bev = pairwise_iou(bev_a, bev_b)
        inter_bev = pairwise_intersect(bev_a, bev_b)
    else:
        vol = vol_a + vol_b
        iou_bev = elementwise_iou(bev_a, bev_b)
        inter_bev = elementwise_intersect(bev_a, bev_b)

    inter_3d = inter_bev * y_inter
    union_3d = vol - inter_3d
    iou_3d = inter_3d / union_3d
    if generalized:
        x_hull = _span_hull(bev_a[..., 0], bev_a[..., 2], bev_b[..., 0],
                            bev_b[..., 2], pairwise)
        z_hull = _span_hull(bev_a[..., 1], bev_a[..., 3], bev_b[..., 1],
                            bev_b[..., 3], pairwise)
        y_hull = _span_hull(y_lo_a, y_hi_a, y_lo_b, y_hi_b, pairwise)
        vol_hull = x_hull * y_hull * z_hull
        iou_3d = iou_3d - (vol_hull - union_3d) / vol_hull
    return iou_bev, iou_3d
