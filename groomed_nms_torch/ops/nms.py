"""Classical greedy NMS and soft-NMS (counterpart of
``groomed_nms_tpu/ops/nms.py``).

* ``greedy_nms``: JAX's per-image contract (boxes [N, 4] in any order, an
  optional valid mask, keep in input order) on K2, the hand-written kernel
  of ``ops/kernels.py::greedy_nms``: a stable sort by score, K2 on the
  sorted rows, the keep mask scattered back.  JAX's ``greedy_nms_blocked``
  is a layout of the same function for the TPU's vector unit; K2 is this
  port's layout of it, so it has no counterpart of its own.
* ``soft_nms``: Bodla et al.'s decay in N fixed rounds over the pairwise
  IoU matrix, with JAX's removal rule.
* ``greedy_nms_numpy`` and ``greedy_nms_cpp``: the host oracles (numpy, and
  the repository's C++ ``eval/cpu_nms.cpp`` through ctypes), kept indices
  in score order; ``top_k_after_nms``, the host-side top-k of kept rows.

The NMS oracles use the +1-pixel (``shift=1``) area convention.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, kernels
from .iou import pairwise_iou


def greedy_nms(boxes, scores, valid_mask=None, *, nms_threshold=0.4,
               shift=1.0):
    """Greedy hard NMS. boxes [N, 4] f32, scores [N] -> keep [N] bool in
    input order.

    Boxes are visited in score order (a stable sort, invalid rows last); a
    visited valid box is kept when no kept box before it overlaps it above
    ``nms_threshold``.  K2 runs on the sorted rows with the valid mask as
    its scores (K2 reads a score only as > 0: padding or not).
    """
    n = scores.shape[0]
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=scores.device)
    order = torch.sort(torch.where(valid_mask, scores, -torch.inf),
                       descending=True, stable=True).indices
    keep_sorted = kernels.greedy_nms(
        boxes[order][None].contiguous(),
        valid_mask[order].to(torch.float32)[None],
        nms_threshold=nms_threshold, shift=shift)[0]
    return torch.zeros_like(keep_sorted).scatter(0, order, keep_sorted)


def soft_nms(boxes, scores, valid_mask=None, *, nms_threshold=0.4, sigma=0.5,
             method="hard", score_threshold=0.001, shift=1.0):
    """Soft-NMS: decay instead of suppress.  boxes [N, 4], scores [N] ->
    (new scores [N], keep [N]) in input order.

    ``method``: 'linear' (w = 1 - iou where iou > t), 'gaussian'
    (w = exp(-iou^2 / sigma)) or 'hard' (w = 0 where iou > t).  Each of N
    rounds selects the highest-scoring remaining box and decays the boxes it
    overlaps.  A box is removed (from later rounds and from ``keep``) only
    when a decay with positive overlap leaves its score below
    ``score_threshold``: selected boxes stay kept, boxes that overlap
    nothing are never removed.  The rounds read no value on the host.
    """
    if method not in ("linear", "gaussian", "hard"):
        raise ValueError(f"unknown soft-NMS method {method!r}")
    n = scores.shape[0]
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=scores.device)
    iou = pairwise_iou(boxes, boxes, shift=shift)
    idx = torch.arange(n, device=scores.device)
    cur = torch.where(valid_mask, scores, 0.0)
    processed = torch.zeros_like(valid_mask)
    active = valid_mask.clone()
    for _ in range(n):
        cand = torch.where(processed | ~active, -torch.inf, cur)
        top = cand.argmax().view(1)
        has_cand = torch.isfinite(cand.index_select(0, top))
        ov = iou.index_select(0, top)[0]
        if method == "linear":
            w = torch.where(ov > nms_threshold, 1.0 - ov, 1.0)
        elif method == "gaussian":
            w = torch.exp(-ov.square() / sigma)
        else:
            w = torch.where(ov > nms_threshold, 0.0, 1.0)
        is_top = idx == top
        # the IoU is clamped at 0, so ov > 0 exactly where the reference's
        # positive-intersection branch runs
        touched = active & ~processed & ~is_top & has_cand & (ov > 0)
        cur = torch.where(touched, cur * w, cur)
        processed = processed | (is_top & has_cand)
        active = active & ~(touched & (cur < score_threshold))
    return cur, active


def greedy_nms_numpy(dets, nms_threshold, shift=1.0):
    """Numpy greedy NMS oracle.  dets [N, 5] = [x1, y1, x2, y2, score] ->
    kept indices in score order (int64)."""
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3],
                              dets[:, 4])
    areas = (x2 - x1 + shift) * (y2 - y1 + shift)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + shift)
        h = np.maximum(0.0, yy2 - yy1 + shift)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= nms_threshold]
    return np.array(keep, dtype=np.int64)


def top_k_after_nms(boxes_scores, keep, top_n, score_threshold=None):
    """Up to ``top_n`` kept rows of ``boxes_scores`` [N, 5] by descending
    score (stable), then those at or above ``score_threshold`` when given
    (host side, numpy)."""
    boxes_scores = np.asarray(boxes_scores)
    kept = boxes_scores[np.asarray(keep)]
    kept = kept[np.argsort(-kept[:, 4], kind="stable")][:top_n]
    if score_threshold is not None:
        kept = kept[kept[:, 4] >= score_threshold]
    return kept


def greedy_nms_cpp(dets, nms_threshold, shift=1.0):
    """The C++ greedy-NMS oracle (``eval/cpu_nms.cpp``, built with the host
    compiler at first use): ``greedy_nms_numpy``'s contract."""
    lib = _build.cpu_nms_lib()
    dets = np.ascontiguousarray(dets, np.float32)
    n = dets.shape[0]
    keep = np.zeros(n, np.int32)
    n_keep = lib.greedy_nms(
        dets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        ctypes.c_float(nms_threshold), ctypes.c_float(shift),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return keep[:n_keep].astype(np.int64)
