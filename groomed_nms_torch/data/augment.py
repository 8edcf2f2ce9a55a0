"""Image preprocessing on the device (counterpart of the image path of
``groomed_nms_tpu/data/augment.py``).

uint8 frames -> optional horizontal flip -> bilinear resize to the target
height (width scaled by the same factor, rounded) -> crop or zero-pad the
width to the fixed crop -> /255 -> per-channel mean/std.  The reference's
Resize semantics: padding is added before normalisation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def preprocess_images(images, mirror, means, stds, *, target_h, crop_w,
                      out_dtype=None):
    """uint8 [B, H0, W0, 3] -> normalised [B, 3, target_h, crop_w].

    ``images`` is NHWC, as frames are decoded; the result is NCHW in
    ``channels_last`` memory, the layout the model takes.  ``mirror`` is a
    [B] bool tensor of images to flip, or None.  ``means`` / ``stds`` are
    the 3 channel statistics on the 0-1 scale.  ``out_dtype`` None = f32.

    The resize antialiases only when it shrinks, as ``jax.image.resize``'s
    bilinear method does (its triangle kernel widens with the scale only
    when downsampling); upsampling is plain half-pixel bilinear.
    """
    b, h0, w0, _ = images.shape
    scale = target_h / h0
    new_w = int(round(w0 * scale))
    x = images.permute(0, 3, 1, 2).float()        # NCHW view, NHWC memory
    if mirror is not None:
        x = torch.where(mirror[:, None, None, None], x.flip(-1), x)
    x = F.interpolate(x, size=(target_h, new_w), mode="bilinear",
                      align_corners=False,
                      antialias=target_h < h0 or new_w < w0)
    if new_w > crop_w:
        x = x[..., :crop_w]
    elif new_w < crop_w:
        x = F.pad(x, (0, crop_w - new_w))
    means = torch.as_tensor(means, dtype=torch.float32, device=x.device)
    stds = torch.as_tensor(stds, dtype=torch.float32, device=x.device)
    x = (x / 255.0 - means[:, None, None]) / stds[:, None, None]
    x = x.contiguous(memory_format=torch.channels_last)
    return x.to(out_dtype) if out_dtype is not None else x
