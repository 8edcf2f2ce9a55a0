"""Weights for the video model (``models/video.py::VideoRPN3D``).

The port's twins of ``groomed_nms_tpu/utils/torch_weights.py``'s
``assemble_video_variables``, ``load_video_variables`` and
``widen_fused_head_for_velocity``, over the port's checkpoint format
(``training/checkpoint.py``), and ``pose_npz_arrays``, the pose branch in
the npz layout ``scripts/train_pose.py`` writes.  ``load_video_variables``'
rule:

* a ``kalman``-stage checkpoint under the run's directory restores the
  whole model;
* otherwise the single-frame (``_un``) checkpoint fills ``rpn`` -- the
  run's own, else ``cfg.pretrained``'s, widened by a zero velocity channel
  when the video head has one -- and the pose branch comes from
  ``<out_dir>_pose/pose_net_params.npz``, the npz of flax paths that
  ``scripts/train_pose.py`` writes (so a pose branch trained by the JAX
  package serves here); the pose statistics from ``pose_stats.npz``, the
  identity when absent;
* random weights (no checkpoint at all) are logged as a warning.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from ..models.rpn_3d import N_BOX2D, N_BOX3D, RPN3D
from ..training.checkpoint import (latest_checkpoint, load_weights,
                                   read_checkpoint, restore_checkpoint)
from .weights import flax_names, from_flax


def widen_fused_head_for_velocity(state_dict, num_anchors, num_classes):
    """A copy of an RPN ``state_dict`` whose fused head has a zero velocity
    channel inserted in every anchor's block, after the 10 bbox_3d channels
    (so the decoded velocity is the anchor's prior): ``C+4+10(+un)`` ->
    ``C+4+11(+un)`` channels an anchor."""
    out = dict(state_dict)
    vel_pos = num_classes + N_BOX2D + N_BOX3D
    for name in ("head.weight", "head.bias"):
        t = state_dict[name]
        blocks = t.reshape(num_anchors, -1, *t.shape[1:])        # [A, per, ...]
        zero = torch.zeros_like(blocks[:, :1])
        out[name] = torch.cat([blocks[:, :vel_pos], zero,
                               blocks[:, vel_pos:]], dim=1).reshape(
            -1, *t.shape[1:])
    return out


def load_pose_npz(pose_net, path):
    """Fill ``pose_net`` from an npz of flax paths relative to the pose
    branch (``pose_feats/kernel``, ...); parameters the file lacks keep
    their values.  Returns the state_dict keys loaded."""
    with np.load(path) as z:
        tree = {}
        for key in z.files:
            mod, leaf = key.split("/")
            tree.setdefault(mod, {})[leaf] = z[key]
    sd = {k: v for k, v in from_flax(tree).items()
          if k in pose_net.state_dict()}
    pose_net.load_state_dict(sd, strict=False)
    return sorted(sd)


def pose_npz_arrays(pose_net):
    """``pose_net``'s parameters as ``{flax path: numpy array}``
    (``pose_feats/kernel`` HWIO, ``pose_feats/bias``, ...): the npz layout
    of ``pose_net_params.npz``, which ``load_pose_npz`` and the JAX
    package's ``assemble_video_variables`` read."""
    sd = pose_net.state_dict()
    out = {}
    for key, (_, path) in flax_names(pose_net).items():
        v = sd[key].detach().cpu()
        out[path] = (v.permute(2, 3, 1, 0) if v.dim() == 4 else v).numpy()
    return out


def single_frame_state_dict(rpn_cfg, pretrained):
    """The ``rpn`` state_dict of a video model with ``rpn_cfg`` from the
    latest single-frame (``_un``) checkpoint under ``pretrained``, which
    has no velocity channel: restored into a velocity-free ``RPN3D`` and,
    when ``rpn_cfg.predict_velocity``, widened by a zero one.  Returns
    ``(state_dict, step, report)``, ``report`` ``load_weights``' (empty
    lists when the checkpoint fitted that ``RPN3D`` exactly)."""
    pre = RPN3D(dataclasses.replace(rpn_cfg, predict_velocity=False))
    payload = read_checkpoint(pretrained)
    report = load_weights(pre, payload["model"])
    sd = pre.state_dict()
    if rpn_cfg.predict_velocity:
        sd = widen_fused_head_for_velocity(sd, rpn_cfg.num_anchors,
                                           rpn_cfg.num_classes)
    return sd, payload["step"], report


def assemble_video_variables(model, rpn_state_dict=None, pose_npz=None):
    """Fill ``model`` (a ``VideoRPN3D``) from a single-frame RPN
    ``state_dict`` and the pose branch's npz, each when given; what is not
    given keeps its values.  Returns ``model``."""
    if rpn_state_dict is not None:
        model.rpn.load_state_dict(rpn_state_dict)
    if pose_npz is not None:
        load_pose_npz(model.pose_net, pose_npz)
    return model


def load_video_variables(model, cfg, out_dir, restore=None, log=None):
    """Restore serving weights into ``model`` (a ``VideoRPN3D``) by the rule
    of the module docstring.  Returns ``(pose_means, pose_stds, step)``."""
    log = log or logging.getLogger(__name__)
    ckpt = latest_checkpoint(out_dir)
    rpn_cfg = model.config.rpn
    if ckpt is not None and cfg.model == "kalman":
        step = restore_checkpoint(out_dir, model, step=restore,
                                  restore_optimizer=False)
        log.info("video-model weights restored from %s (iter %d)", out_dir,
                 step)
    else:
        sd, step = None, 0
        if ckpt is not None:
            step = restore_checkpoint(out_dir, model.rpn, step=restore,
                                      restore_optimizer=False)
            log.info("single-frame weights restored from %s (iter %d)",
                     out_dir, step)
        elif getattr(cfg, "pretrained", None) and \
                latest_checkpoint(cfg.pretrained) is not None:
            sd, step, _ = single_frame_state_dict(rpn_cfg, cfg.pretrained)
            log.info("single-frame weights warm-started from %s (iter %d)",
                     cfg.pretrained, step)
        else:
            log.warning("no checkpoint under %s; using random weights",
                        out_dir)
        pose_npz = os.path.join(out_dir + "_pose", "pose_net_params.npz")
        assemble_video_variables(
            model, sd, pose_npz if os.path.exists(pose_npz) else None)

    pose_stats = os.path.join(out_dir + "_pose", "pose_stats.npz")
    if os.path.exists(pose_stats):
        with np.load(pose_stats) as z:
            pose_means, pose_stds = z["means"], z["stds"]
    else:
        pose_means, pose_stds = np.zeros(6), np.ones(6)
    return pose_means, pose_stds, step
