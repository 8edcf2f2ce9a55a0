"""Anchor templates and their placement on the feature grid (numpy).

Counterpart of ``groomed_nms_tpu/anchors.py``: the same host-side functions,
copied because that module imports JAX.  The grid is ordered **(h, w, a)**,
the natural unroll of an NHWC head output, which is the order
``models/rpn_3d.py`` gives its per-anchor rows.
"""

from __future__ import annotations

import numpy as np


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
