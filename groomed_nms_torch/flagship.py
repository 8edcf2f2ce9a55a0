"""The flagship inference workload: KITTI-resolution still images.

Counterpart of ``__graft_entry__.py::_flagship`` on the ``groomed_nms``
config: DenseNet-121 dilated to stride 16, 36 anchors, 4 classes, the
acceptance branch on, 512x1760 crops, seeded random weights and the same
synthetic anchor/prior recipe (numpy ``default_rng(0)``).  Unlike the JAX
twin it is driven from uint8 frames at KITTI's source size (375x1242)
through the serving entry point, ``eval.tester.make_infer``.
"""

from __future__ import annotations

import numpy as np
import torch

from .anchors import generate_anchor_templates, locate_anchors
from .config import load_config
from .eval.tester import make_infer
from .models.fast_eval import FastEvalRPN3D
from .models.rpn_3d import RPN3D
from .utils.weights import init_weights

NUM_ANCHORS = 36
SRC_HW = (375, 1242)                  # a KITTI frame


def flagship_priors(num_anchors=NUM_ANCHORS, seed=0):
    """[A, 11] synthetic anchors: production 2D templates + plausible 3D
    priors (depth 30), the recipe of ``_flagship``."""
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


def build_flagship(batch=8, height=512, width=1760, device="cuda",
                   compute_dtype=torch.bfloat16, seed=0, src_hw=SRC_HW,
                   engine="rpn3d"):
    """Model + inputs of the flagship workload on ``device``.

    Returns ``(infer, args, model)``: ``infer(*args)`` runs one batch of
    ``batch`` uint8 frames of ``src_hw`` and returns ``(dets [B, 40, 17],
    valid [B, 40])``.  The weights come from ``torch.Generator`` seeded with
    ``seed``, the frames from numpy ``default_rng(seed)``.  ``engine``
    "rpn3d" serves the ``RPN3D`` module under autocast; "fast_eval" serves
    the weight-folded ``FastEvalRPN3D`` built from it once, in
    ``compute_dtype`` (f32 when None), with K4 running dense blocks 1-2.
    """
    if engine not in ("rpn3d", "fast_eval"):
        raise ValueError(f"engine must be 'rpn3d' or 'fast_eval', got "
                         f"{engine!r}")
    device = torch.device(device)
    ecfg = load_config("groomed_nms")
    model = RPN3D(ecfg.rpn_config(NUM_ANCHORS))
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last)
    if engine == "fast_eval":
        model = FastEvalRPN3D(model, compute_dtype or torch.float32)

    priors = flagship_priors()
    fh, fw = height // ecfg.feat_stride, width // ecfg.feat_stride
    rois = locate_anchors(priors, (fh, fw), ecfg.feat_stride)
    rois_3d = priors[rois[:, 4].astype(np.int64), 4:]

    p2 = np.tile(np.eye(4, dtype=np.float32)[None], (batch, 1, 1))
    p2[:, 0, 0] = 707.0
    p2[:, 1, 1] = 707.0
    p2[:, 0, 2] = 604.0
    p2[:, 1, 2] = 180.0
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
