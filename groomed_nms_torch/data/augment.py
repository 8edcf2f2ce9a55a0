"""Image preprocessing on the device (counterpart of the image path of
``groomed_nms_tpu/data/augment.py``).

uint8 frames -> optional horizontal flip -> bilinear resize to the target
height (width scaled by the same factor, rounded) -> crop or zero-pad the
width to the fixed crop -> /255 -> per-channel mean/std.  The reference's
Resize semantics: padding is added before normalisation.

``preprocess_images`` takes a batch of one size; ``preprocess_images_dynamic``
takes frames of several sizes, edge-padded into one buffer
(``pad_image_edge``), and resamples each by its own scale.
``preprocess_images_train`` adds the photometric jitter of training
(brightness, contrast, saturation) after the flip; its randomness is drawn
apart from it (``photometric_draws``), so that any stream of draws can feed
it.

The label path of the train loader runs on the host in numpy, copied from
the JAX module: ``scale_labels`` scales the 2D boxes and projected centres
by the resize factor, ``mirror_labels`` rewrites a record's ground truth
for a horizontal flip.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .kitti import decompose_alpha, rot_y_to_alpha


def _flipped(images, mirror):
    """uint8 NHWC frames -> an f32 NCHW view (NHWC memory), the images of
    ``mirror`` flipped horizontally."""
    x = images.permute(0, 3, 1, 2).float()
    if mirror is not None:
        x = torch.where(mirror[:, None, None, None], x.flip(-1), x)
    return x


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
    return _resize_normalize(_flipped(images, mirror), means, stds,
                             target_h, crop_w, out_dtype)


class PhotometricDraws(NamedTuple):
    """The randomness of one batch's photometric jitter: which images are
    jittered ([B] bool) and each image's brightness, contrast and
    saturation factor ([B] each)."""
    apply: torch.Tensor
    f_b: torch.Tensor
    f_c: torch.Tensor
    f_s: torch.Tensor

    def to(self, device, non_blocking=False):
        return PhotometricDraws(*(t.to(device, non_blocking=non_blocking)
                                  for t in self))


def photometric_draws(generator, b, distort_prob, brightness=0.2,
                      contrast=0.2, saturation=0.2):
    """Draw one batch's jitter on the CPU from ``generator``: 4 * ``b``
    uniforms, an image jittered when its first is <= ``distort_prob``, its
    factors uniform in [1 - m, 1 + m] for each magnitude m."""
    u = torch.rand((4, b), generator=generator, dtype=torch.float32)
    lo = torch.tensor([1 - brightness, 1 - contrast, 1 - saturation])
    hi = torch.tensor([1 + brightness, 1 + contrast, 1 + saturation])
    f = lo[:, None] + u[1:] * (hi - lo)[:, None]
    return PhotometricDraws(u[0] <= distort_prob, *f)


def photometric_distort(images, f_b, f_c, f_s):
    """Brightness, contrast and saturation jitter of float images [B, 3,
    H, W] on the 0-255 scale, one factor of each per image ([B]), in JAX's
    order: brightness; contrast about the image's mean over (C, H, W);
    saturation about each pixel's channel mean; clipped to [0, 255]."""
    x = images * f_b[:, None, None, None]
    mean = x.mean((1, 2, 3), keepdim=True)
    x = (x - mean) * f_c[:, None, None, None] + mean
    gray = x.mean(1, keepdim=True)
    x = (x - gray) * f_s[:, None, None, None] + gray
    return x.clamp(0.0, 255.0)


def preprocess_images_train(images, mirror, means, stds, draws, *, target_h,
                            crop_w, distort_prob, out_dtype=None):
    """``preprocess_images`` with photometric jitter after the flip and
    before the resize: the images of ``draws.apply`` are jittered by
    ``photometric_distort`` with ``draws``' factors (on the images'
    device).  ``distort_prob <= 0`` is ``preprocess_images`` itself and
    reads no draws."""
    if distort_prob <= 0:
        return preprocess_images(images, mirror, means, stds,
                                 target_h=target_h, crop_w=crop_w,
                                 out_dtype=out_dtype)
    x = _flipped(images, mirror)
    x = torch.where(draws.apply[:, None, None, None],
                    photometric_distort(x, draws.f_b, draws.f_c, draws.f_s),
                    x)
    return _resize_normalize(x, means, stds, target_h, crop_w, out_dtype)


def _resize_normalize(x, means, stds, target_h, crop_w, out_dtype):
    """Float NCHW frames on the 0-255 scale -> the resize to ``target_h``
    (width by the same factor), the crop or zero-pad to ``crop_w``, /255 and
    the channel statistics, ``channels_last``."""
    h0, w0 = x.shape[-2:]
    scale = target_h / h0
    new_w = int(round(w0 * scale))
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


def _resample_weights(m_buf, n_out, m_true, n_true):
    """[B, m_buf, n_out] linear-resample weights for images occupying the
    first ``m_true[b]`` samples of an ``m_buf`` buffer, resized to
    ``n_true[b]`` of ``n_out`` output samples (the rest zeroed).

    ``m_true`` and ``n_true`` are [B] f32 tensors.  The weights are
    ``jax.image.resize``'s antialiased triangle kernel over the in-range
    taps, renormalised, with out-of-range output samples zeroed: the
    formula of ``groomed_nms_tpu/data/augment.py::_resample_weights``
    with a batch dimension.
    """
    dev = m_true.device
    m_true = m_true.float()[:, None, None]
    n_true = n_true.float()[:, None, None]
    inv_scale = m_true / n_true
    kernel_scale = torch.clamp(inv_scale, min=1.0)  # low-pass when shrinking
    out_i = torch.arange(n_out, dtype=torch.float32, device=dev)[None, None]
    sample_f = (out_i + 0.5) * inv_scale - 0.5              # [B, 1, n_out]
    j = torch.arange(m_buf, dtype=torch.float32, device=dev)[None, :, None]
    w = torch.clamp(1.0 - (sample_f - j).abs() / kernel_scale, min=0.0)
    w = w * (j < m_true)               # buffer padding contributes nothing
    tot = w.sum(1, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(tot != 0.0, tot, 1.0), 0.0)
    valid = ((sample_f >= -0.5) & (sample_f <= m_true - 0.5)
             & (out_i < n_true))
    return w * valid


def preprocess_images_dynamic(images, src_hw, means, stds, *, target_h,
                              crop_w, out_dtype=None):
    """Mixed-size preprocess: uint8 [B, H0max, W0max, 3] buffers, each
    holding an image of true size ``src_hw[b] = (h, w)`` in its top-left
    corner -> normalised [B, 3, target_h, crop_w] (``channels_last``), as
    ``preprocess_images`` gives it for each size alone.

    Each image is resampled by its own ``target_h / h`` factor through
    ``_resample_weights`` matrices, its width to ``round(w * scale)``
    columns and then zero-padded or cropped to ``crop_w``; the buffer's
    padding is ignored.  The two products run in f64 and are rounded to
    f32: at least as precise as JAX's f32 products at
    ``Precision.HIGHEST``, and out of reach of the global TF32 settings
    (which no f64 product uses), so nothing here reads or sets them.
    """
    b, h0, w0, _ = images.shape
    x = images.double()
    hw = src_hw.float()
    h, w = hw[:, 0], hw[:, 1]
    new_w = torch.round(w * (target_h / h))
    wh = _resample_weights(h0, target_h, h, torch.full_like(h, target_h))
    ww = _resample_weights(w0, crop_w, w, new_w)
    x = torch.einsum("bhwc,bwj->bhjc", x, ww.double())
    x = torch.einsum("bhjc,bhi->bijc", x, wh.double()).float()
    means = torch.as_tensor(means, dtype=torch.float32, device=x.device)
    stds = torch.as_tensor(stds, dtype=torch.float32, device=x.device)
    x = ((x / 255.0 - means) / stds).permute(0, 3, 1, 2)  # channels_last
    return x.to(out_dtype) if out_dtype is not None else x


def pad_image_edge(img, h0, w0):
    """Place ``img`` into an [h0, w0, 3] numpy buffer, edge-replicating into
    the padding (``preprocess_images_dynamic`` ignores it; replication
    keeps the buffer safe for any other reader).  Raises ``ValueError``
    when ``img`` does not fit."""
    h, w = img.shape[:2]
    if h > h0 or w > w0:
        raise ValueError(
            f"image ({h}, {w}) exceeds the target plane ({h0}, {w0})")
    out = np.empty((h0, w0, 3), img.dtype)
    out[:h, :w] = img
    if h < h0:
        out[h:, :w] = img[-1:]
    if w < w0:
        out[:, w:] = out[:, w - 1:w]
    return out


_PIL_PRECISION_BITS = 22          # Pillow's 8-bit resample: 32 - 8 - 2


def _pil_bilinear_taps(in_size, out_size):
    """Pillow's bilinear resample taps along one axis: (first input index
    [out], fixed-point weights [out, ksize] with zeros past each output's
    taps).  The arithmetic of Pillow's ``precompute_coeffs`` (a triangle
    filter whose support widens by the downscale factor, the weights
    normalised in f64, summed in tap order) and ``normalize_coeffs_8bpc``
    (rounded to 22 fractional bits)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale                        # the triangle's support 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = 1.0 - np.abs(((taps[None, :] + xmin[:, None]) - center[:, None]
                      + 0.5) * (1.0 / filterscale))
    w = np.where((w > 0.0) & (taps[None, :] < xmax[:, None]), w, 0.0)
    total = np.zeros(out_size)
    for t in taps:                               # Pillow's summation order
        total = total + w[:, t]
    w = w / np.where(total != 0.0, total, 1.0)[:, None]
    return xmin, np.trunc(0.5 + w * (1 << _PIL_PRECISION_BITS)).astype(
        np.int64)


def _pil_resample_axis(img, out_size, axis):
    """One pass of Pillow's 8-bit bilinear resample along ``axis`` of a
    uint8 [H, W, 3] image: a fixed-point sum from a rounding half, shifted
    down and clipped to uint8."""
    start, k = _pil_bilinear_taps(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PIL_PRECISION_BITS - 1),
                  np.int64)
    for t in range(k.shape[1]):
        idx = np.minimum(start + t, src.shape[0] - 1)
        acc += src[idx] * k[:, t, None, None]
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear_resize(img, out_h, out_w):
    """uint8 [H, W, 3] -> [out_h, out_w, 3], as Pillow's
    ``Image.resize((out_w, out_h), Image.BILINEAR)`` gives it: the
    horizontal pass, rounded to uint8, then the vertical one."""
    if img.shape[1] != out_w:
        img = _pil_resample_axis(img, out_w, 1)
    if img.shape[0] != out_h:
        img = _pil_resample_axis(img, out_h, 0)
    return img


def fit_image_to_plane(img, h0, w0):
    """Fit an arbitrary-size uint8 image into an [h0, w0, 3] plane
    (``groomed_nms_tpu/data/augment.py::fit_image_to_plane``).

    Oversized images are bilinearly downscaled (aspect kept, Pillow's
    arithmetic through ``pil_bilinear_resize``) until they fit, then
    edge-padded; smaller images are edge-padded directly.  Returns
    ``(fitted, r)`` where ``r`` <= 1 is the ratio applied, recomputed from
    the rounded height: a consumer mapping plane coordinates back to the
    original pixels folds ``r`` into its scale (original = plane / r).
    """
    h, w = img.shape[:2]
    r = min(h0 / h, w0 / w, 1.0)
    if r < 1.0:
        nh, nw = min(int(round(h * r)), h0), min(int(round(w * r)), w0)
        img = pil_bilinear_resize(img, nh, nw)
        r = nh / h
    if img.shape[:2] == (h0, w0):
        return img, r
    return pad_image_edge(img, h0, w0), r


def scale_labels(gts, scale_factor):
    """Scale the 2D boxes and the projected 3D centres (columns 0-1 of
    ``bbox_3d``) by ``scale_factor``; a record without GTs comes back as
    it is."""
    if not gts or len(gts.get("cls", [])) == 0:
        return gts
    out = dict(gts)
    out["bbox_full"] = gts["bbox_full"] * scale_factor
    b3 = gts["bbox_3d"].copy()
    b3[:, 0] *= scale_factor
    b3[:, 1] *= scale_factor
    out["bbox_3d"] = b3
    return out


def mirror_labels(gts, p2_inv, image_width):
    """Rewrite ground truth for a horizontal flip at the source resolution:
    reflect the 2D box and the projected centre's x, negate rotY and snap
    it to [-pi, pi], back-project the new projected centre through P2^-1
    for the 3D centre, and recompute alpha and its decomposition.  The
    elevation (column 11) is left as it was, as the reference leaves it.
    """
    if not gts or len(gts.get("cls", [])) == 0:
        return gts
    out = dict(gts)
    bf = gts["bbox_full"].copy()
    bf[:, 0] = image_width - bf[:, 0] - bf[:, 2]
    out["bbox_full"] = bf

    b3 = gts["bbox_3d"].copy()
    for i in range(b3.shape[0]):
        b3[i, 0] = image_width - b3[i, 0] - 1
        rot_y = b3[i, 10]
        rot_y = (-math.pi - rot_y) if rot_y < 0 else (math.pi - rot_y)
        while rot_y > math.pi:
            rot_y -= 2 * math.pi
        while rot_y < -math.pi:
            rot_y += 2 * math.pi

        cx2d, cy2d, cz2d = b3[i, 0], b3[i, 1], b3[i, 2]
        coord3d = p2_inv @ np.array([cx2d * cz2d, cy2d * cz2d, cz2d, 1.0])
        alpha = rot_y_to_alpha(rot_y, coord3d[2], coord3d[0])
        a_sin, a_cos, axis_lbl, head_lbl = decompose_alpha(alpha)

        b3[i, 6] = alpha
        b3[i, 7:10] = coord3d[:3]
        b3[i, 10] = rot_y
        b3[i, 12] = a_sin
        b3[i, 13] = a_cos
        b3[i, 14] = axis_lbl
        b3[i, 15] = head_lbl
    out["bbox_3d"] = b3
    if "rotY" in gts:
        out["rotY"] = b3[:, 10].copy()
        out["alpha"] = b3[:, 6].copy()
    if "center_3d" in gts:
        out["center_3d"] = b3[:, 7:10].copy()
    return out
