"""The inputs the benchmark makes from ``--seed`` and hands to both the
program and the reference: anchors and their 3D priors, the camera, the
target statistics, uint8 frames and ground truth.  numpy and torch only;
the program's own anchor code is not used, so the reference takes no table
the program has made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# KITTI's P2 of the training split's first sequence
KITTI_P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                     [0.0, 721.5377, 172.854, 0.2163791],
                     [0.0, 0.0, 1.0, 0.002745884],
                     [0.0, 0.0, 0.0, 1.0]])


def rng(seed, stream):
    """A numpy generator for one use of the seed; ``stream`` keeps the
    draws of different uses apart."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def anchors(exp, num_anchors, seed):
    """[A, 11] anchors: the config's 2D templates (heights geometric from
    test_scale * percent_anc_h[0] to [1], ``anchor_ratios`` widths over
    heights, centred at ((stride - 1) / 2, ...)) and 3D priors drawn from
    the seed around a car: z from the template height, w, h, l, the yaw and
    its sin/cos branches."""
    lo = exp["test_scale"] * exp["percent_anc_h"][0]
    hi = exp["test_scale"] * exp["percent_anc_h"][1]
    n = exp["anchor_scales_count"]
    scales = [lo * (hi / lo) ** (i / (n - 1)) for i in range(n)]
    c = (exp["feat_stride"] - 1) / 2.0
    t = np.array([[c - s * r / 2, c - s / 2, c + s * r / 2, c + s / 2]
                  for s in scales for r in exp["anchor_ratios"]], np.float64)
    if t.shape[0] != num_anchors:
        raise ValueError(f"{t.shape[0]} templates, config says {num_anchors}")
    r = rng(seed, 1)
    a = num_anchors
    h3d = 1.5 + 0.1 * r.standard_normal(a)
    z = KITTI_P2[0, 0] * h3d / (t[:, 3] - t[:, 1])
    rot = r.uniform(-math.pi, math.pi, a)
    sin_b, cos_b, _, _ = decompose_alpha(rot)
    pri = np.stack([z, 1.6 + 0.1 * r.standard_normal(a), h3d,
                    3.9 + 0.3 * r.standard_normal(a), rot, sin_b, cos_b], 1)
    return np.concatenate([t, pri], 1).astype(np.float32)


def grid_rois(anch, feat_hw, stride):
    """rois [H*W*A, 5] (corner box, anchor index) in (h, w, a) order and
    their priors [H*W*A, 7]."""
    h, w = feat_hw
    a = anch.shape[0]
    sx = np.arange(w, dtype=np.float32) * stride
    sy = np.arange(h, dtype=np.float32) * stride
    shift = np.stack(np.broadcast_arrays(sx[None, :, None], sy[:, None, None],
                                         sx[None, :, None],
                                         sy[:, None, None]), -1)
    boxes = anch[None, None, :, :4] + shift                  # [h, w, a, 4]
    idx = np.broadcast_to(np.arange(a, dtype=np.float32), (h, w, a))
    rois = np.concatenate([boxes, idx[..., None]], -1).reshape(-1, 5)
    return rois, anch[rois[:, 4].astype(np.int64), 4:]


def decompose_alpha(alpha):
    """(sin branch, cos branch, axis label, heading label) of angles: the
    sin branch wrapped into (-pi/2, pi/2], the cos branch into (-pi, 0];
    axis 1 where |sin| < |cos|; heading 1 where the chosen branch needs a
    flip by pi."""
    alpha = np.asarray(alpha, np.float64)

    def snap(x, lo, hi):
        return np.where(x > hi, x - math.pi, np.where(x <= lo, x + math.pi, x))

    s_b = snap(alpha, -math.pi / 2, math.pi / 2)
    c_b = snap(alpha, -math.pi, 0.0)
    axis = (np.abs(np.sin(alpha)) < np.abs(np.cos(alpha))).astype(np.float64)
    branch = np.where(axis == 1, s_b, c_b)
    flipped = np.mod(branch + 2 * math.pi, 2 * math.pi) - math.pi
    head = (np.abs(flipped - alpha) < np.abs(branch - alpha)).astype(
        np.float64)
    return s_b, c_b, axis, head


def frames(seed, stream, n, src_hw):
    """[n, H0, W0, 3] uint8 frames of noise, pinned when a card is there."""
    g = torch.Generator().manual_seed(int(rng(seed, stream).integers(2**62)))
    x = torch.randint(0, 256, (n, *src_hw, 3), dtype=torch.uint8, generator=g)
    return x.pin_memory() if torch.cuda.is_available() else x


def ground_truth(seed, stream, batch, exp, crop_hw, src_hw, per_image):
    """Padded ground truth of one batch, ``per_image`` cars an image at
    KITTI's depths, in the preprocessed image's pixels: gts_2d [B, G, 4],
    gts_3d [B, G, 16] (the imdb layout), gt_labels, gt_valid, ign_2d,
    ign_valid, p2, scale.  numpy."""
    r = rng(seed, stream)
    g, ni = exp["max_gts"], exp["max_igns"]
    scale = crop_hw[0] / src_hw[0]
    p2 = KITTI_P2
    gts_2d = np.zeros((batch, g, 4))
    gts_3d = np.zeros((batch, g, 16))
    valid = np.zeros((batch, g), bool)
    labels = np.ones((batch, g))
    for bi in range(batch):
        for gi in range(per_image):
            z = r.uniform(8.0, 45.0)
            w3, h3, l3 = r.uniform(1.5, 1.9), r.uniform(1.4, 1.8), \
                r.uniform(3.4, 4.6)
            u = r.uniform(0.1, 0.9) * src_hw[1]
            x3 = (u - p2[0, 2]) * z / p2[0, 0]
            y3 = 1.65 - h3 / 2
            ry = r.uniform(-math.pi, math.pi)
            alpha = ry - math.atan2(-z, x3) - math.pi / 2
            alpha = (alpha + math.pi) % (2 * math.pi) - math.pi
            cu = (p2[0, 0] * x3 + p2[0, 2] * z + p2[0, 3]) / (z + p2[2, 3])
            cv = (p2[1, 1] * y3 + p2[1, 2] * z + p2[1, 3]) / (z + p2[2, 3])
            bw = p2[0, 0] * (abs(math.cos(ry)) * l3 + abs(math.sin(ry)) * w3) / z
            bh = p2[1, 1] * h3 / z
            box = np.array([cu - bw / 2, cv - bh / 2, cu + bw / 2, cv + bh / 2])
            s_b, c_b, axis, head = decompose_alpha(alpha)
            gts_2d[bi, gi] = box * scale
            gts_3d[bi, gi] = [cu * scale, cv * scale, z, w3, h3, l3, alpha,
                              x3, y3, z, ry, 0.0, s_b, c_b, axis, head]
            labels[bi, gi] = r.integers(1, len(exp["lbls"]) + 1)
            valid[bi, gi] = True
    return {"gts_2d": gts_2d.astype(np.float32),
            "gts_3d": gts_3d.astype(np.float32),
            "gt_labels": labels.astype(np.float32), "gt_valid": valid,
            "ign_2d": np.zeros((batch, ni, 4), np.float32),
            "ign_valid": np.zeros((batch, ni), bool),
            "p2": np.broadcast_to(p2, (batch, 4, 4)).astype(np.float32),
            "scale": np.full((batch,), scale, np.float32)}


def mirror_flags(seed, stream, batch, prob):
    return rng(seed, stream).uniform(size=batch) < prob


def target_stats(torch, ref, cfg, seed, rois, rois_3d, device):
    """The regression targets' means and stds [13] (f64 numpy) over the
    ground truth of the configuration's ``bbox_stats`` sample: batches
    ``ground_truth(seed, 100 + i, ...)``, the streams a training cell's
    pool draws, so that a training run normalises by its own data's
    statistics and a serving run by those of the same seed's data.  Worked
    out in f64 and rounded to f32, so that a last-bit difference between
    two calls' elementwise math (the CPU's vector and scalar paths) cannot
    change them."""
    st, exp = cfg["bbox_stats"], cfg["experiment"]
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa: E731
    gts = []
    for i in range(st["batches"]):
        g = ground_truth(seed, 100 + i, st["batch"], exp, exp["crop_size"],
                         st["src_hw"], st["gts_per_image"])
        gts.append({k: t(g[k]) if k == "gt_valid" else t(g[k]).double()
                    for k in ("gts_2d", "gts_3d", "gt_labels", "gt_valid")})
    means, stds = ref.target_stats(t(rois).double(), t(rois_3d).double(), gts,
                                   exp)
    return (means.astype(np.float32).astype(np.float64),
            stds.astype(np.float32).astype(np.float64))

