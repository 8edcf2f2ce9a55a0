"""The fused-track alignment loss (counterpart of
``groomed_nms_tpu/losses/fused_track.py``): the pose branch trained through
the Kalman tracker.

The tracker (``models/kalman.py``) rolls over a clip with the ego poses
applied by ``project_ego``, so the fused track states depend on the poses;
the loss pulls each current-frame GT centre's nearest track towards it, and
its gradient reaches the poses through the ego projections, the forecasts
and the Kalman updates.  Like the tracker it reads nothing back to the host,
forward or backward.
"""

from __future__ import annotations

import torch

from ..models.kalman import Tracks, track_step


def fused_track_loss(poses_dn, meas_frames, valid_frames, gt_centers,
                     gt_valid, p2, cfg, best_thresh=None):
    """Alignment of the fused tracks with the current frame's GT centres.

    ``poses_dn`` [F, 6] denormalised relative ego poses (row 0 unused: the
    first frame gets a zero pose, and a zero gradient); ``meas_frames`` /
    ``valid_frames`` [F, M, 16] / [F, M] measurements
    (``models/video.py::extract_measurements``, or oracle boxes);
    ``gt_centers`` [G, 3] camera-frame centres, ``gt_valid`` [G] bool;
    ``p2`` [4, 4]; ``cfg`` a ``VideoConfig`` (``max_tracks``,
    ``best_thresh``).  The tracker runs with ``track_step``'s own
    ``match_dist``, as the JAX function's does, not ``cfg.match_dist``.

    Each valid GT takes its nearest valid track; the loss is the smooth L1
    of their centre residuals summed over x, y, z and averaged over the
    matched GTs.  Returns ``(loss, n_matched)``, 0-dim tensors.
    """
    bt = best_thresh if best_thresh is not None else cfg.best_thresh
    tracks = Tracks.empty(cfg.max_tracks, device=meas_frames.device,
                          dtype=meas_frames.dtype)
    for f in range(meas_frames.shape[0]):
        pose = poses_dn[f] if f > 0 else torch.zeros_like(poses_dn[f])
        tracks = track_step(tracks, meas_frames[f], valid_frames[f], pose,
                            p2, best_thresh=bt, apply_pose=True)

    centers = tracks.X[:, :3]                                   # [T, 3]
    with torch.no_grad():
        d = (centers[:, None, :] - gt_centers[None, :, :]).norm(dim=-1)
        d = torch.where(tracks.valid[:, None] & gt_valid[None, :], d,
                        float("inf"))
        best_d, best_t = d.min(0)                               # [G]
        matched = gt_valid & torch.isfinite(best_d)
    res = centers.index_select(0, best_t) - gt_centers
    l1 = res.abs()
    huber = torch.where(l1 < 1.0, 0.5 * l1 * l1, l1 - 0.5).sum(-1)
    n_matched = matched.sum()
    loss = torch.where(matched, huber, 0.0).sum() / n_matched.clamp_min(1)
    return loss, n_matched
