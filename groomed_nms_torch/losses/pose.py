"""The ego-pose loss (counterpart of ``groomed_nms_tpu/losses/pose.py``):
an L1 on the denormalised 6-DoF relative pose, translation and rotation
weighted apart."""

from __future__ import annotations

import torch


def pose_loss(pose_pred, pose_tar, pose_means, pose_stds, pose_lambda_t=1.0,
              pose_lambda_r=1.0):
    """``mean |t_err| * pose_lambda_t + mean |r_err| * pose_lambda_r`` over
    the denormalised poses (the shipped config weighs 1 and 40).

    ``pose_pred`` / ``pose_tar`` [B, 6] normalised (tx, ty, tz, rx, ry, rz);
    ``pose_means`` / ``pose_stds`` [6] tensors on their device.  Returns
    ``(loss, {"pose", "t_err", "r_err"})``, 0-dim tensors.
    """
    means = pose_means.reshape(-1)[:6]
    stds = pose_stds.reshape(-1)[:6]
    err = (pose_pred * stds + means - (pose_tar * stds + means)).abs()
    t_err = err[:, :3].mean()
    r_err = err[:, 3:].mean()
    loss = t_err * pose_lambda_t + r_err * pose_lambda_r
    return loss, {"pose": loss, "t_err": t_err, "r_err": r_err}
