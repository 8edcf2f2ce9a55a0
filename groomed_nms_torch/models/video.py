"""The video 3D detection model's test path (counterpart of
``groomed_nms_tpu/models/video.py``): one RPN over the frames of a clip,
the ego-pose network on consecutive trunk features, per-frame measurements
(K1 scores, top ``max_measurements``, decode, K2 NMS) and the Kalman
tracker over the clip.

Frames fold into the batch for the trunk.  ``extract_measurements`` scores
every anchor with K1 (``ops/kernels.py::fused_head_scores``, the function
JAX computes as ``max(prob[..., 1:])``) and decodes only the top
``max_measurements`` rows, where JAX decodes every anchor and gathers
after: the decode is per row, so the rows are the same.  K2
(``kernels.greedy_nms``) suppresses them; the rows already come in
descending score order, and the slots below ``score_thres`` go to K2 as
padding (score 0, a zero box).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch import nn

from ..inference import top_k_indices
from ..ops.boxes import bbox_transform_inv, center_size
from ..ops.geometry import alpha_to_rot_y, snap_to_pi
from ..ops.groomed_nms import _rows
from ..ops.kernels import fused_head_scores, greedy_nms
from .kalman import PoseNet, Tracks, track_step
from .rpn_3d import N_BOX2D, RPN3D, RPNConfig, RPNOutputs


@dataclass(frozen=True)
class VideoConfig:
    rpn: RPNConfig = field(default_factory=lambda: RPNConfig(
        predict_uncertainty=True))
    max_measurements: int = 64
    max_tracks: int = 128
    score_thres: float = 0.6
    nms_thres: float = 0.4
    best_thresh: float = 0.35
    # phase-1 association distance (m); 0.35 reproduces the reference's
    # batched eval, which leaks best_thresh into it after the first record
    match_dist: float = 0.5


class VideoOutputs(NamedTuple):
    frame_outputs: RPNOutputs     # leading [B*F]
    trunk_feats: torch.Tensor     # [B, F, C, fh, fw]
    poses: torch.Tensor           # [B, F-1, 6] relative ego poses, f32


class VideoRPN3D(nn.Module):
    """The RPN shared by every frame, and the pairwise pose head.

    Submodules ``rpn`` and ``pose_net`` carry the flax names, so
    ``utils/weights.py::from_flax`` maps a flax ``VideoRPN3D`` tree as it
    is."""

    def __init__(self, cfg: VideoConfig = VideoConfig()):
        super().__init__()
        self.config = cfg
        self.rpn = RPN3D(cfg.rpn)
        self.pose_net = PoseNet(2 * cfg.rpn.backbone.out_features)

    def forward(self, images):
        """images [B, F, 3, H, W] (frame 0 the oldest) -> VideoOutputs."""
        b, f = images.shape[:2]
        outputs, feats = self.rpn(images.flatten(0, 1), return_base=True)
        feats = feats.unflatten(0, (b, f))
        if f > 1:
            pairs = torch.cat([feats[:, :-1], feats[:, 1:]], dim=2)
            poses = self.pose_net(pairs.flatten(0, 1).contiguous(
                memory_format=torch.channels_last)).unflatten(0, (b, f - 1))
        else:
            poses = feats.new_zeros((b, 0, 6), dtype=torch.float32)
        return VideoOutputs(frame_outputs=outputs, trunk_feats=feats,
                            poses=poses)


def extract_measurements(outputs: RPNOutputs, rois, rois_3d, p2, scale,
                         bbox_means, bbox_stds, cfg: VideoConfig):
    """Per-frame measurements for the tracker: K1 scores, the top
    ``max_measurements`` rows at or above ``score_thres``, their decode, K2.

    ``rois`` [R, 5], ``rois_3d`` [R, P], ``p2`` [F, 4, 4], ``scale`` [F],
    ``bbox_means`` / ``bbox_stds`` [13] (or [14] with the velocity column).
    Returns (meas [F, M, 16], alive [F, M] bool): the kept rows, the
    measurement layout of ``models/kalman.py``.
    """
    fused = outputs.fused_raw
    c = outputs.num_classes
    n3d = outputs.n_box3d
    means, stds = bbox_means.float(), bbox_stds.float()

    # K1 ranks the anchors (an f64 head, a checking mode, rounded to f32
    # for it); the kept rows are decoded in the head's dtype, f32 at least
    head = fused.float() if fused.dtype == torch.float64 else fused
    scores = fused_head_scores(head, None, num_classes=c)        # [F, R]
    key = torch.where(scores >= cfg.score_thres, scores, float("-inf"))
    idx = top_k_indices(key, cfg.max_measurements)               # [F, M]
    vals = torch.gather(key, 1, idx)
    valid = vals > float("-inf")

    sel = _rows(fused, idx)                                      # [F, M, per]
    sel = sel.to(torch.promote_types(sel.dtype, torch.float32))
    r2, r3 = rois[idx], rois_3d[idx]
    prob = torch.softmax(sel[..., :c], dim=-1)
    sc = prob[..., 1:].amax(-1)
    cls_pred = (prob[..., 1:].argmax(-1) + 1).to(sc.dtype)
    b3 = sel[..., c + N_BOX2D:c + N_BOX2D + n3d]
    axis_p, head = torch.sigmoid(b3[..., 8]), torch.sigmoid(b3[..., 9])
    un = torch.sigmoid(sel[..., c + N_BOX2D + n3d]) \
        if fused.shape[-1] > c + N_BOX2D + n3d else torch.ones_like(sc)

    sf = scale[:, None]
    coords = bbox_transform_inv(r2[..., :4], sel[..., c:c + N_BOX2D],
                                means=means[:4], stds=stds[:4])
    # the reference's video decode has no -1 end correction
    coords = torch.cat([coords[..., :2], coords[..., 2:4] + 1.0], dim=-1) \
        / sf[..., None]
    ctr_x, ctr_y, widths, heights = center_size(r2[..., :4])
    # de-normalisation columns 4-9, 11-12 (sin, cos) of the stats
    stat = lambda v: torch.cat([v[4:10], v[11:13]])
    dn = b3[..., :8] * stat(stds) + stat(means)
    if n3d >= 11 and rois_3d.shape[-1] >= 8 and stds.shape[0] >= 14:
        vel = (r3[..., 7] + b3[..., 10] * stds[13] + means[13]).clamp_min(0.0)
    else:
        vel = torch.zeros_like(sc)
    x2d = (dn[..., 0] * widths + ctr_x) / sf
    y2d = (dn[..., 1] * heights + ctr_y) / sf
    z2d = r3[..., 0] + dn[..., 2]
    w3d = torch.exp(dn[..., 3]) * r3[..., 1]
    h3d = torch.exp(dn[..., 4]) * r3[..., 2]
    l3d = torch.exp(dn[..., 5]) * r3[..., 3]
    alpha = torch.where(axis_p >= 0.5, r3[..., 5] + dn[..., 6],
                        r3[..., 6] + dn[..., 7])

    # closed-form backprojection through P2
    p2a, p2b, p2c = p2[:, 0, 0, None], p2[:, 0, 2, None], p2[:, 0, 3, None]
    p2d, p2e, p2f = p2[:, 1, 1, None], p2[:, 1, 2, None], p2[:, 1, 3, None]
    p2h = p2[:, 2, 3, None]
    z3d = z2d - p2h
    x3d = ((z3d + p2h) * x2d - p2b * z3d - p2c) / p2a
    y3d = ((z3d + p2h) * y2d - p2e * z3d - p2f) / p2d
    ry3d = alpha_to_rot_y(snap_to_pi(alpha), z3d, x3d)

    keep = greedy_nms(
        torch.where(valid[..., None], coords, 0.0).float().contiguous(),
        torch.where(valid, vals, 0.0).contiguous(),
        nms_threshold=cfg.nms_thres, shift=1.0)
    meas = torch.stack([
        coords[..., 0], coords[..., 1], coords[..., 2], coords[..., 3],
        sc, cls_pred, x3d, y3d, z3d, w3d, h3d, l3d, snap_to_pi(ry3d), head,
        un, vel], dim=-1)
    return meas, keep & valid


def video_track(meas_frames, valid_frames, poses_dn, p2, cfg: VideoConfig,
                best_thresh=None):
    """The tracker over one clip: ``meas_frames`` [F, M, 16],
    ``valid_frames`` [F, M], ``poses_dn`` [F, 6] denormalised relative
    poses (row 0 unused), ``p2`` [4, 4].  Returns (final Tracks, the Tracks
    after each frame)."""
    bt = best_thresh if best_thresh is not None else cfg.best_thresh
    tracks = Tracks.empty(cfg.max_tracks, device=meas_frames.device,
                          dtype=meas_frames.dtype)
    snapshots = []
    for f in range(meas_frames.shape[0]):
        # frame 0 has no previous frame: a zero ego motion
        pose = poses_dn[f] if f > 0 else torch.zeros_like(poses_dn[f])
        tracks = track_step(tracks, meas_frames[f], valid_frames[f], pose, p2,
                            best_thresh=bt, apply_pose=True,
                            match_dist=cfg.match_dist)
        snapshots.append(tracks)
    return tracks, snapshots
