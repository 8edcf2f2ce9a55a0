"""Batched 3D detection inference: score -> top-k -> decode -> NMS -> top-k.

Counterpart of ``groomed_nms_tpu/inference.py`` for still images.  The
per-anchor passes are the hand-written kernels of ``ops/kernels.py``: K1
scores every anchor straight from the head's ``fused_raw`` tensor; the NMS
is classical greedy NMS by K2 (the test-time default) or, with
``use_differentiable_nms``, GrooMeD-NMS over the top ``diff_nms_boxes`` rows
with K3 computing their overlap and prune matrices.  Everything else is
plain PyTorch on the same device.

Detection row layout (17 columns, original image scale):
  [x1, y1, x2, y2, score, cls,
   x2d, y2d, z2d,              (projected 3D center, original pixels)
   w3d, h3d, l3d, alpha,
   x3d, y3d, z3d, ry3d]        (camera frame; y3d at cuboid *center*)
The KITTI writer re-grounds y3d += h3d/2.  ``write_kitti_tracks`` writes the
video model's tracks (``models/video.py``).  ``refine_detections`` is the
``--refine`` hill-climb of final rows (``ops/refine.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .models.rpn_3d import N_BOX2D
from .ops.boxes import bbox_transform_inv, corners_to_xywh
from .ops.geometry import (alpha_to_rot_y, backproject_2d_points,
                           get_corners_of_cuboid, rot_y_to_alpha, snap_to_pi)
from .ops.groomed_nms import _rows, groomed_nms_boxes
from .ops.kernels import fused_head_scores, greedy_nms
from .ops.refine import hill_climb


@dataclass(frozen=True)
class DetectConfig:
    num_classes: int = 4
    nms_topN_pre: int = 3000
    nms_topN_post: int = 40
    nms_thres: float = 0.4
    score_thres: float = 0.6
    clip_boxes: bool = False
    # NMS flavour: classical greedy (False) or GrooMeD (True)
    use_differentiable_nms: bool = False
    diff_nms_boxes: int = 512           # the reference caps at 500
    diff_nms_pruning_method: str = "linear"
    diff_nms_temperature: float = 0.1
    diff_nms_valid_box_prob_threshold: float = 0.3
    diff_nms_group_boxes: bool = True
    diff_nms_mask_group_boxes: bool = True
    diff_nms_group_size: int = 100
    overlap_in_nms: str = "2d"
    # use_acceptance_prob_for_nms folds accept/un into the RANKING score
    # (pre-NMS top-k + NMS); use_un_for_score folds it into the WRITTEN
    # score column
    use_acceptance_prob_for_nms: bool = True
    use_un_for_score: bool = True
    decomp_alpha: bool = True


NUM_DET_COLS = 17


def top_k_indices(scores, k):
    """Indices of the ``k`` largest scores along the last axis, in
    ``lax.top_k``'s order: descending, and among equal scores the lower
    index first.  A stable descending sort gives that order on every device;
    ``torch.topk`` promises no order among ties."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def select_top_pre_nms(outputs, rois, rois_3d, cfg: DetectConfig):
    """Gather the top ``nms_topN_pre`` anchors per image BEFORE decoding.

    Scores come from K1 on the head's [B, R, per] ``fused_raw`` tensor; only
    the gathered rows are cast to f32 and split, so no full-size softmax or
    f32 head tensor is made.  The decode is per-row, so gather-then-decode
    equals decode-then-gather.

    Returns (gathered outputs dict, rois [B, K, 5], rois_3d [B, K, P]), rows
    in descending score order.
    """
    fused = outputs["fused_raw"]
    accept_full = outputs.get("accept_prob")
    unc_full = outputs.get("uncertainty")
    c = cfg.num_classes
    has_unc = unc_full is not None
    n3d = fused.shape[-1] - c - N_BOX2D - (1 if has_unc else 0)
    accept = accept_full if accept_full is not None else unc_full
    if not cfg.use_acceptance_prob_for_nms:
        accept = None
    scores = fused_head_scores(fused, accept, num_classes=c)
    idx = top_k_indices(scores, min(cfg.nms_topN_pre, scores.shape[-1]))
    sel_f = _rows(fused, idx).float()
    b3 = sel_f[..., c + N_BOX2D:c + N_BOX2D + n3d]
    b3 = torch.cat([b3[..., :8], torch.sigmoid(b3[..., 8:10]), b3[..., 10:]],
                   dim=-1)
    sel = {"prob": torch.softmax(sel_f[..., :c], dim=-1),
           "bbox_2d": sel_f[..., c:c + N_BOX2D], "bbox_3d": b3}
    if has_unc:
        sel["uncertainty"] = torch.sigmoid(sel_f[..., c + N_BOX2D + n3d])
    if accept_full is not None:
        sel["accept_prob"] = torch.gather(accept_full, 1, idx)
    return sel, rois[idx], rois_3d[idx]


def decode_detections(outputs, rois, rois_3d, p2, p2_inv, scale_factor,
                      bbox_means, bbox_stds, cfg: DetectConfig):
    """Decode head outputs into detection rows.

    ``outputs``: 'prob' [B, R, C], 'bbox_2d', 'bbox_3d', optional
    'accept_prob' / 'uncertainty'.  ``rois`` / ``rois_3d``: [R, *] shared or
    [B, R, *] per image.  ``p2`` / ``p2_inv`` [B, 4, 4], ``scale_factor`` [B].
    Returns (dets [B, R, 17], ranking scores [B, R]).
    """
    prob, bbox_2d, bbox_3d = (outputs["prob"], outputs["bbox_2d"],
                              outputs["bbox_3d"])
    means = bbox_means.float()
    stds = bbox_stds.float()
    if rois.dim() == 2:
        rois = rois[None]
    if rois_3d.dim() == 2:
        rois_3d = rois_3d[None]

    coords_2d = bbox_transform_inv(rois[..., :4], bbox_2d, means=means[:4],
                                   stds=stds[:4])
    coords_2d = coords_2d / scale_factor[:, None, None]

    widths = rois[..., 2] - rois[..., 0] + 1.0
    heights = rois[..., 3] - rois[..., 1] + 1.0
    ctr_x = rois[..., 0] + 0.5 * widths
    ctr_y = rois[..., 1] + 0.5 * heights

    stat_idx = [4, 5, 6, 7, 8, 9, 11, 12] if cfg.decomp_alpha else \
        [4, 5, 6, 7, 8, 9, 10]
    dn = bbox_3d[..., :len(stat_idx)] * stds[stat_idx] + means[stat_idx]

    x2d = (dn[..., 0] * widths + ctr_x) / scale_factor[:, None]
    y2d = (dn[..., 1] * heights + ctr_y) / scale_factor[:, None]
    z2d = rois_3d[..., 0] + dn[..., 2]
    w3d = torch.exp(dn[..., 3]) * rois_3d[..., 1]
    h3d = torch.exp(dn[..., 4]) * rois_3d[..., 2]
    l3d = torch.exp(dn[..., 5]) * rois_3d[..., 3]

    if cfg.decomp_alpha:
        rsin = rois_3d[..., 5] + dn[..., 6]
        rcos = rois_3d[..., 6] + dn[..., 7]
        alpha = torch.where(bbox_3d[..., 8] >= 0.5, rsin, rcos)
        alpha = torch.where(bbox_3d[..., 9] >= 0.5, alpha + torch.pi, alpha)
    else:
        alpha = rois_3d[..., 4] + dn[..., 6]

    # backproject the projected center through P2^-1 as four f32
    # multiply-adds per coordinate: no matmul, so no TF32 can enter
    pts = (x2d * z2d, y2d * z2d, z2d)

    def cam(i):
        p = p2_inv[:, i, :, None]                     # [B, 4, 1]
        return p[:, 0] * pts[0] + p[:, 1] * pts[1] + p[:, 2] * pts[2] + p[:, 3]

    x3d, y3d, z3d = cam(0), cam(1), cam(2)
    ry3d = alpha_to_rot_y(snap_to_pi(alpha), z3d, x3d)
    alpha_out = rot_y_to_alpha(ry3d, z3d, x3d)

    fg = prob[..., 1:]
    cls_pred = (fg.argmax(-1) + 1).float()
    raw_scores = fg.amax(-1)
    accept = outputs.get("accept_prob")
    if accept is None:
        accept = outputs.get("uncertainty")
    scores = raw_scores
    if cfg.use_acceptance_prob_for_nms and accept is not None:
        scores = raw_scores * accept
    written = raw_scores * accept \
        if (cfg.use_un_for_score and accept is not None) else raw_scores

    dets = torch.stack([
        coords_2d[..., 0], coords_2d[..., 1], coords_2d[..., 2],
        coords_2d[..., 3], written, cls_pred,
        x2d, y2d, z2d, w3d, h3d, l3d, alpha_out,
        x3d, y3d, z3d, ry3d,
    ], dim=-1)
    return dets, scores


def _groomed_keep_score(d, vals, cfg: DetectConfig):
    """GrooMeD-NMS at test time on the first ``diff_nms_boxes`` rows:
    returns those rows and their ranking score, the rescored value where
    kept and -1 elsewhere (the reference orders its survivors by the
    rescored value; the written score column stays the original)."""
    k = min(cfg.diff_nms_boxes, d.shape[1])
    d, vals = d[:, :k], vals[:, :k]
    corners = None
    if cfg.overlap_in_nms != "2d":
        corners = get_corners_of_cuboid(d[..., 13], d[..., 14], d[..., 15],
                                        d[..., 9], d[..., 10], d[..., 11],
                                        d[..., 16])
    res = groomed_nms_boxes(
        vals, d[..., :4], corners=corners, overlap_in_nms=cfg.overlap_in_nms,
        nms_threshold=cfg.nms_thres,
        pruning_method=cfg.diff_nms_pruning_method,
        temperature=cfg.diff_nms_temperature,
        valid_box_prob_threshold=cfg.diff_nms_valid_box_prob_threshold,
        group_boxes=cfg.diff_nms_group_boxes,
        mask_group_boxes=cfg.diff_nms_mask_group_boxes,
        group_size=cfg.diff_nms_group_size)
    return d, torch.where(res.keep, res.rescored, -1.0)


def nms_and_topk(dets, scores, cfg: DetectConfig, presorted: bool = False):
    """Top-k pre-NMS -> NMS -> top-k post.

    [B, R, 17] -> ([B, topN_post, 17], valid [B, topN_post]).  The NMS is
    greedy (K2) or, with ``cfg.use_differentiable_nms``, GrooMeD (K3).
    ``presorted=True`` skips the first top-k when rows already come in
    descending score order (the ``im_detect_3d`` path).
    """
    k_pre = min(cfg.nms_topN_pre, scores.shape[1])
    if presorted:
        d, vals = dets[:, :k_pre], scores[:, :k_pre]
    else:
        idx = top_k_indices(scores, k_pre)
        d, vals = _rows(dets, idx), torch.gather(scores, 1, idx)
    if cfg.use_differentiable_nms:
        d, keep_score = _groomed_keep_score(d, vals, cfg)
    else:
        keep = greedy_nms(d[..., :4].contiguous(), vals.contiguous(),
                          nms_threshold=cfg.nms_thres, shift=1.0)
        keep_score = torch.where(keep, vals, -1.0)
    post_idx = top_k_indices(keep_score,
                             min(cfg.nms_topN_post, keep_score.shape[1]))
    post_vals = torch.gather(keep_score, 1, post_idx)
    return _rows(d, post_idx), post_vals > 0


def im_detect_3d(outputs, rois, rois_3d, p2, p2_inv, scale_factor,
                 bbox_means, bbox_stds, cfg: DetectConfig):
    """Batched detection: top-k gather -> decode -> NMS -> top-k.

    The same rows as decode_detections + nms_and_topk over every anchor,
    with the decode done on the pre-NMS top-k only.
    """
    sel, sel_rois, sel_rois_3d = select_top_pre_nms(outputs, rois, rois_3d,
                                                    cfg)
    dets, scores = decode_detections(sel, sel_rois, sel_rois_3d, p2, p2_inv,
                                     scale_factor, bbox_means, bbox_stds, cfg)
    return nms_and_topk(dets, scores, cfg, presorted=True)


def rpn_outputs_dict(out):
    """RPNOutputs -> the outputs dict ``im_detect_3d`` reads."""
    return {"fused_raw": out.fused_raw, "accept_prob": out.accept_prob,
            "uncertainty": out.uncertainty}


def detect_batch(model, images, rois, rois_3d, p2, p2_inv, scale_factor,
                 bbox_means, bbox_stds, cfg: DetectConfig):
    """Inference for one preprocessed image batch: the model's forward in
    eval mode, without gradients, then ``im_detect_3d``.  ``images`` [B, 3,
    H, W] on the model's device; the model is put in eval mode."""
    model.eval()
    with torch.no_grad():
        out = model(images)
        return im_detect_3d(rpn_outputs_dict(out), rois, rois_3d, p2, p2_inv,
                            scale_factor, bbox_means, bbox_stds, cfg)


def refine_detections(dets, valid, p2, p2_inv):
    """Post-hoc z / ry hill-climb of final detections (``ops.refine``).

    ``dets`` [B, K, 17] (``decode_detections``' layout), ``valid`` [B, K]
    bool, ``p2`` / ``p2_inv`` [B, 4, 4] of the original image frame (the
    rows' x2d, y2d and boxes are original-frame).  Returns new rows with
    z2d, alpha, x3d, y3d, z3d and ry3d refined: the camera centre is
    re-derived from the refined depth and the projected centre, alpha from
    the refined yaw.  Only improving steps are taken; rows masked out by
    ``valid``, and rows whose starting projection is invalid, keep their
    inputs.  No host synchronisation.
    """
    x2d, y2d, z2d = dets[..., 6], dets[..., 7], dets[..., 8]
    ry3d = dets[..., 16]
    z_new, r_new, _ = hill_climb(p2, p2_inv, corners_to_xywh(dets[..., :4]),
                                 x2d, y2d, z2d, dets[..., 9], dets[..., 10],
                                 dets[..., 11], ry3d)
    z_new = torch.where(valid, z_new, z2d)
    r_new = torch.where(valid, r_new, ry3d)
    x3d, y3d, z3d = backproject_2d_points(p2_inv, x2d, y2d, z_new)
    alpha = rot_y_to_alpha(r_new, z3d, x3d)
    cols = torch.stack([z_new, alpha, x3d, y3d, z3d, r_new], dim=-1)
    return torch.cat([dets[..., :8], cols[..., :1], dets[..., 9:12],
                      cols[..., 1:]], dim=-1)


def clip_detections(dets, im_w, im_h):
    """Clip final 2D boxes to the original image (numpy, host side)."""
    dets = np.array(dets, copy=True)
    dets[:, 0] = np.clip(dets[:, 0], 0, im_w - 1)
    dets[:, 1] = np.clip(dets[:, 1], 0, im_h - 1)
    dets[:, 2] = np.clip(dets[:, 2], 0, im_w - 1)
    dets[:, 3] = np.clip(dets[:, 3], 0, im_h - 1)
    return dets


def write_kitti_detections(path, dets, valid, class_names,
                           score_thres=0.6, classes_to_write=None):
    """Write one image's detections in KITTI result format (host side).

    ``dets`` [K, 17] / ``valid`` [K] as numpy arrays or CPU tensors.  Six
    decimals, and y3d re-grounded by h3d/2, as the reference writer does.
    """
    dets = np.asarray(dets)
    valid = np.asarray(valid)
    lines = []
    for i in range(dets.shape[0]):
        if not valid[i]:
            continue
        row = dets[i]
        score = row[4]
        cls_idx = int(row[5]) - 1
        if cls_idx < 0 or cls_idx >= len(class_names):
            continue
        cls = class_names[cls_idx]
        if score <= score_thres:
            continue
        if classes_to_write is not None and cls not in classes_to_write:
            continue
        x1, y1, x2, y2 = row[0], row[1], row[2], row[3]
        w3d, h3d, l3d = row[9], row[10], row[11]
        alpha, x3d, y3d, z3d, ry3d = row[12], row[13], row[14], row[15], row[16]
        y3d = y3d + h3d / 2.0
        lines.append(
            f"{cls} -1 -1 {alpha:.6f} {x1:.6f} {y1:.6f} {x2:.6f} {y2:.6f} "
            f"{h3d:.6f} {w3d:.6f} {l3d:.6f} {x3d:.6f} {y3d:.6f} {z3d:.6f} "
            f"{ry3d:.6f} {score:.6f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def write_kitti_tracks(path, tracks, score_thres=0.6, class_name="Car"):
    """Write one clip's final tracks in KITTI result format (host side).

    ``tracks`` is a ``models.kalman.Tracks`` (any device).  Its ``box2d``
    is already in original-image pixels and its ``un`` already folds the 2D
    score in, so both are written as they are: the score is ``un``, gated
    at ``> score_thres``.  ry is theta plus the heading flip, wrapped; y is
    re-grounded by h3d/2.  The state is read in f32, and alpha computed in
    f32, as the JAX writer does.  Returns the number of rows written.
    """
    valid = tracks.valid.cpu().numpy()
    xs = tracks.X.float().cpu().numpy()
    box2d = tracks.box2d.float().cpu().numpy()
    un = tracks.un.float().cpu().numpy()
    lines = []
    for ti in np.flatnonzero(valid):
        x, y, z, w3, h3, l3, theta, head, _ = xs[ti]
        ry = theta + (np.pi if head >= 0.5 else 0.0)
        ry = np.arctan2(np.sin(ry), np.cos(ry))
        alpha = float(rot_y_to_alpha(*(torch.tensor(v, dtype=torch.float32)
                                       for v in (ry, z, x))))
        score = un[ti]
        if score <= score_thres:
            continue
        x1, y1, x2, y2 = box2d[ti, :4]
        lines.append(
            f"{class_name} -1 -1 {alpha:.6f} {x1:.6f} {y1:.6f} {x2:.6f} "
            f"{y2:.6f} {h3:.6f} {w3:.6f} {l3:.6f} {x:.6f} "
            f"{y + h3 / 2:.6f} {z:.6f} {ry:.6f} {score:.6f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return len(lines)
