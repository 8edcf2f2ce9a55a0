"""The serving entry point: uint8 frames in, detections out.

Counterpart of ``groomed_nms_tpu/eval/tester.py::_make_infer``: preprocess
-> model -> ``im_detect_3d`` on one batch of same-sized frames, all on the
frames' device.  The imdb/PIL evaluation loop around it is not ported yet.
"""

from __future__ import annotations

import contextlib

import torch

from ..data.augment import preprocess_images
from ..inference import im_detect_3d, rpn_outputs_dict


def make_infer(model, dcfg, target_h, crop_w, compute_dtype=None):
    """Build ``infer(images_u8, means_img, stds_img, rois, rois_3d, p2,
    p2_inv, scale, bbox_means, bbox_stds) -> (dets [B, K, 17], valid [B, K])``.

    ``images_u8`` [B, H0, W0, 3] uint8 on the model's device; the other
    arguments are tensors on the same device (see ``im_detect_3d``).
    ``compute_dtype`` torch.bfloat16 runs the preprocess output and the
    model under bf16 autocast (BatchNorm statistics and the head's f32
    splits stay f32); None runs in f32.  The model is put in eval mode.
    """
    model.eval()

    @torch.inference_mode()
    def infer(images_u8, means_img, stds_img, rois, rois_3d, p2, p2_inv,
              scale, bbox_means, bbox_stds):
        images = preprocess_images(images_u8, None, means_img, stds_img,
                                   target_h=target_h, crop_w=crop_w,
                                   out_dtype=compute_dtype)
        amp = (torch.autocast(images.device.type, dtype=compute_dtype)
               if compute_dtype is not None else contextlib.nullcontext())
        with amp:
            out = model(images)
        return im_detect_3d(rpn_outputs_dict(out), rois, rois_3d, p2, p2_inv,
                            scale, bbox_means, bbox_stds, dcfg)

    return infer
