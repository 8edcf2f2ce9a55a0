"""RoIAlign by bilinear interpolation (counterpart of
``groomed_nms_tpu/ops/roi_align.py``), written out in PyTorch ops so that
autograd differentiates it with respect to the features and the boxes.

Each output cell averages (or takes the max of) ``sampling_ratio`` x
``sampling_ratio`` bilinear samples of the feature map at regularly spaced
points inside the cell of the box scaled by ``spatial_scale``; a box
narrower than one feature pixel is widened to one.  Sample coordinates are
clamped into the map.
"""

from __future__ import annotations

import torch


def roi_align(features, rois, *, output_size=(7, 7), spatial_scale=1.0,
              sampling_ratio=2, reduction="avg"):
    """features [H, W, C] (one image), rois [N, 4] as [x1, y1, x2, y2] in
    input coordinates -> [N, oh, ow, C]; ``reduction`` 'avg' or 'max' over
    a cell's samples."""
    if reduction not in ("avg", "max"):
        raise ValueError(f"unknown RoIAlign reduction {reduction!r}")
    h, w, c = features.shape
    oh, ow = output_size
    s = sampling_ratio
    boxes = rois * spatial_scale
    x1, y1, x2, y2 = boxes.unbind(-1)
    dev, dt = features.device, boxes.dtype
    zero, one = torch.zeros((), device=dev, dtype=dt), \
        torch.ones((), device=dev, dtype=dt)
    # maximum / minimum, not clamp: at a tie with the bound they split the
    # gradient in halves, as JAX's maximum and clip do
    cell_w = torch.maximum(x2 - x1, one) / ow
    cell_h = torch.maximum(y2 - y1, one) / oh
    ix = (torch.arange(ow * s, device=dev, dtype=dt) + 0.5) / s
    iy = (torch.arange(oh * s, device=dev, dtype=dt) + 0.5) / s
    sample_x = x1[:, None] + ix[None, :] * cell_w[:, None]    # [N, ow*s]
    sample_y = y1[:, None] + iy[None, :] * cell_h[:, None]

    x0 = sample_x.floor().clamp(0, w - 1)
    y0 = sample_y.floor().clamp(0, h - 1)
    x0i, y0i = x0.long(), y0.long()
    x1i = (x0 + 1).clamp(0, w - 1).long()
    y1i = (y0 + 1).clamp(0, h - 1).long()
    wx = torch.minimum(torch.maximum(sample_x - x0, zero), one)
    wy = torch.minimum(torch.maximum(sample_y - y0, zero), one)
    wx, wy = wx[:, None, :, None], wy[:, :, None, None]

    def gather(yi, xi):                              # [N, oh*s, ow*s, C]
        return features[yi[:, :, None], xi[:, None, :]]

    out = (gather(y0i, x0i) * (1 - wy) * (1 - wx)
           + gather(y0i, x1i) * (1 - wy) * wx
           + gather(y1i, x0i) * wy * (1 - wx)
           + gather(y1i, x1i) * wy * wx)
    out = out.reshape(rois.shape[0], oh, s, ow, s, c)
    if reduction == "max":
        return out.amax((2, 4))
    return out.mean((2, 4))
