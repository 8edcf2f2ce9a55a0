"""The flagship workloads: KITTI-resolution still images, served and trained.

``build_flagship`` is the counterpart of ``__graft_entry__.py::_flagship``
and ``build_flagship_train`` of ``_flagship_train``, on the ``groomed_nms``
config: DenseNet-121 dilated to stride 16, 36 anchors, 4 classes, the
acceptance branch on, 512x1760 crops, seeded random weights and the same
synthetic anchor/prior recipe (numpy ``default_rng(0)``).  Both are driven
from uint8 frames at KITTI's source size (375x1242): serving through
``eval.tester.make_infer``, training through ``training.fuse_preprocess``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .anchors import generate_anchor_templates, locate_anchors
from .config import load_config, with_remat
from .eval.tester import make_infer
from .losses.rpn_3d import UncertaintyState
from .models.fast_eval import (KERNEL_BLOCKS, FastEvalRPN3D,
                                 check_kernel_dtype)
from .models.rpn_3d import RPN3D
from .training.schedules import build_lr_schedule
from .training.trainer import (TrainState, build_optimizer, fuse_preprocess,
                               make_train_step)
from .utils.weights import init_weights

NUM_ANCHORS = 36
SRC_HW = (375, 1242)                  # a KITTI frame


def flagship_priors(num_anchors=NUM_ANCHORS, seed=0, rs=None):
    """[A, 11] synthetic anchors: production 2D templates + plausible 3D
    priors (depth 30), the recipe of ``_flagship``; drawn from ``rs`` when
    given (the train workload goes on drawing from it), else from numpy
    ``default_rng(seed)``."""
    if rs is None:
        rs = np.random.default_rng(seed)
    scales = np.exp(np.linspace(np.log(32), np.log(384), 12))
    templates = generate_anchor_templates(scales, (0.5, 1.0, 1.5), 16)
    assert templates.shape[0] == num_anchors
    priors = np.concatenate(
        [templates,
         np.abs(rs.normal(size=(num_anchors, 7))).astype(np.float32) + 1.0],
        axis=1)
    priors[:, 4] = 30.0
    return priors


def _camera(batch):
    """[B, 4, 4] synthetic KITTI-like P2."""
    p2 = np.tile(np.eye(4, dtype=np.float32)[None], (batch, 1, 1))
    p2[:, 0, 0] = 707.0
    p2[:, 1, 1] = 707.0
    p2[:, 0, 2] = 604.0
    p2[:, 1, 2] = 180.0
    return p2


def build_flagship(batch=8, height=512, width=1760, device="cuda",
                   compute_dtype=torch.bfloat16, seed=0, src_hw=SRC_HW,
                   engine="rpn3d", differentiable_nms=False):
    """Model + inputs of the flagship workload on ``device``.

    Returns ``(infer, args, model)``: ``infer(*args)`` runs one batch of
    ``batch`` uint8 frames of ``src_hw`` and returns ``(dets [B, 40, 17],
    valid [B, 40])``.  The weights come from ``torch.Generator`` seeded with
    ``seed``, the frames from numpy ``default_rng(seed)``.  ``engine``
    "rpn3d" serves the ``RPN3D`` module under autocast; "fast_eval" serves
    the weight-folded ``FastEvalRPN3D`` built from it once, in
    ``compute_dtype`` (f32 when None), with K4 running dense blocks 1-2;
    on a CUDA device it takes bf16 or f32 (K4's dtypes) and raises
    ``ValueError`` at once for any other.
    ``differentiable_nms`` sets the config's
    ``use_differentiable_nms_at_test``: GrooMeD-NMS (K3) replaces greedy
    NMS (K2).
    """
    if engine not in ("rpn3d", "fast_eval"):
        raise ValueError(f"engine must be 'rpn3d' or 'fast_eval', got "
                         f"{engine!r}")
    device = torch.device(device)
    if engine == "fast_eval":
        check_kernel_dtype(device, compute_dtype or torch.float32,
                           KERNEL_BLOCKS)
    ecfg = dataclasses.replace(load_config("groomed_nms"),
                               use_differentiable_nms_at_test=differentiable_nms)
    model = RPN3D(ecfg.rpn_config(NUM_ANCHORS))
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last)
    if engine == "fast_eval":
        model = FastEvalRPN3D(model, compute_dtype or torch.float32)

    priors = flagship_priors()
    fh, fw = height // ecfg.feat_stride, width // ecfg.feat_stride
    rois = locate_anchors(priors, (fh, fw), ecfg.feat_stride)
    rois_3d = priors[rois[:, 4].astype(np.int64), 4:]

    p2 = _camera(batch)
    rs = np.random.default_rng(seed)
    frames = rs.integers(0, 256, (batch, *src_hw, 3), dtype=np.uint8)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    infer = make_infer(model, ecfg.detect_config(), height, width,
                       compute_dtype)
    args = (dev(frames, torch.uint8), dev(ecfg.image_means),
            dev(ecfg.image_stds), dev(rois), dev(rois_3d), dev(p2),
            dev(np.linalg.inv(p2)),
            dev(np.full((batch,), height / src_hw[0], np.float32)),
            dev(np.zeros(13, np.float32)), dev(np.ones(13, np.float32)))
    return infer, args, model


def build_flagship_train(batch=8, height=512, width=1760, device="cuda",
                         compute_dtype=torch.bfloat16, seed=0, src_hw=SRC_HW,
                         on_stage=None, backbone=None, batch_skip=None,
                         backbone_remat=False):
    """One GrooMeD-NMS training step of the flagship on ``device``.

    The ``groomed_nms`` config: the loss with GrooMeD-NMS on the top 512
    sampled foregrounds (K3 computes their overlaps), the after-NMS AP loss,
    SGD (momentum 0.9, weight decay 5e-4, element-wise clip 1.0, poly LR
    from 0.004 over 50000 iterations), bbox means 0 and stds 1; the model
    under autocast in ``compute_dtype`` (None: f32) with f32 parameters and
    an f32 loss.  The weights come from ``torch.Generator`` seeded with
    ``seed``; anchors, priors, six synthetic GTs per image and the
    uint8 frames from one numpy ``default_rng(0)`` stream, the recipe of
    ``_flagship_train`` (GT positions scaled to a crop smaller than
    512x1760).  The config's ``distort_prob`` is -1: no photometric jitter.
    ``on_stage`` is ``make_train_step``'s timer hook; ``backbone``, a
    ``DenseNetConfig``, replaces DenseNet-121 (the card-against-CPU checks
    take ``tiny_densenet_config()``: a randomly initialised DenseNet-121 in
    train mode turns a 1e-7 relative change of its weights into a ~0.4%
    change of the whole update, so two devices cannot agree closely on one
    step).  ``batch_skip`` (None: the config's, 1) accumulates that many
    steps' clipped gradients before each optimizer update.
    ``backbone_remat`` is the config's (False/"none", "layer" or
    "epilogue"), the counterpart of ``_flagship_train(remat=...)``: it
    recomputes dense layers, or their tails, in the backward pass.

    Returns ``(step, state, batch)``: ``step(state, batch)`` preprocesses
    the frames (odd images mirrored), takes one step, updates ``state`` in
    place and returns the stats dict.
    """
    device = torch.device(device)
    ecfg = dataclasses.replace(load_config("groomed_nms"),
                               backbone_remat=backbone_remat)
    rpn_cfg = ecfg.rpn_config(NUM_ANCHORS)
    if backbone is not None:
        rpn_cfg = dataclasses.replace(
            rpn_cfg, backbone=with_remat(backbone, backbone_remat))
    model = RPN3D(rpn_cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last)

    rs = np.random.default_rng(0)
    priors = flagship_priors(rs=rs)
    fh, fw = height // ecfg.feat_stride, width // ecfg.feat_stride
    rois = locate_anchors(priors, (fh, fw), ecfg.feat_stride)
    rois_3d = priors[rois[:, 4].astype(np.int64), 4:]

    b, g, ign = batch, ecfg.max_gts, ecfg.max_igns
    sy, sx = height / 512, width / 1760
    gts_2d = np.zeros((b, g, 4), np.float32)
    gts_3d = np.zeros((b, g, 16), np.float32)
    gt_valid = np.zeros((b, g), bool)
    for bi in range(b):
        for gi in range(6):              # ~KITTI's mean objects per image
            z = rs.uniform(8, 45)
            x1 = rs.uniform(0, width - 200 * sx)
            y1 = rs.uniform(120 * sy, 300 * sy)
            bw, bh = 707.0 * 1.8 / z, 707.0 * 1.6 / z
            gts_2d[bi, gi] = [x1, y1, x1 + bw, y1 + bh]
            gts_3d[bi, gi] = [x1 + bw / 2, y1 + bh / 2, z, 1.6, 1.5, 3.9,
                              0.2, (x1 - width / 2) * z / 707.0, 1.0, z,
                              0.3, 0.1, 0.2, -0.9, 1, 0]
            gt_valid[bi, gi] = True
    frames = rs.integers(0, 255, (b, *src_hw, 3)).astype(np.uint8)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    raw = {
        "images_u8": dev(frames, torch.uint8),
        "mirror": dev(np.arange(b) % 2, torch.bool),
        "gts_2d": dev(gts_2d), "gts_3d": dev(gts_3d),
        "gt_labels": dev(np.ones((b, g))), "gt_valid": dev(gt_valid, torch.bool),
        "ign_2d": dev(np.zeros((b, ign, 4))),
        "ign_valid": dev(np.zeros((b, ign)), torch.bool),
        "p2": dev(_camera(b)),
        "scale": dev(np.full((b,), height / src_hw[0])),
    }
    optimizer = build_optimizer(
        model.parameters(), ecfg.solver_type,
        build_lr_schedule(ecfg.lr, ecfg.max_iter, ecfg.lr_policy),
        momentum=ecfg.momentum, weight_decay=ecfg.weight_decay,
        clip_value=ecfg.grad_clip_value,
        batch_skip=ecfg.batch_skip if batch_skip is None else batch_skip)
    step = make_train_step(ecfg.loss_config(), dev(rois), dev(rois_3d),
                           dev(np.zeros(13)), dev(np.ones(13)), compute_dtype,
                           on_stage)
    fused = fuse_preprocess(step, dev(ecfg.image_means), dev(ecfg.image_stds),
                            target_h=height, crop_w=width,
                            distort_prob=ecfg.distort_prob)
    return fused, TrainState(model, optimizer, UncertaintyState.init(device)), \
        raw
