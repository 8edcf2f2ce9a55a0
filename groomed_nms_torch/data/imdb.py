"""The image database of a KITTI split and its GT rules (counterpart of
``groomed_nms_tpu/data/imdb.py``).

* ``ImageRecord`` and ``build_imdb``: image sizes come from the PNG header
  (``data/png.py``), not from Pillow.
* ``determine_ignores``, ``class_indices``, ``balance_samples`` and
  ``pad_gt_batch``: the GT filtering, the train loader's sampling weights
  and its fixed-shape GT batch, numpy on the host, copied from the JAX
  module.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from ..losses.rpn_3d import GTBatch
from .kitti import read_kitti_calib, read_kitti_label
from .png import png_size


@dataclass
class ImageRecord:
    id: str
    image_path: str
    p2: np.ndarray                 # [4, 4]
    p2_inv: np.ndarray             # [4, 4]
    im_h: int
    im_w: int
    gts: dict = field(default_factory=dict)   # from read_kitti_label
    scale: float = 1.0


def build_imdb(root, split="training", ids=None, use_3d_for_2d=True,
               cache_file=None, im_ext=".png"):
    """Scan ``root/split/{image_2, calib, label_2}`` into ImageRecords.

    The pickle cache is keyed on the build arguments: a cached imdb built
    with a different split/ids/use_3d_for_2d is rebuilt, not returned.
    Only this function writes the cache file it reads.
    """
    meta = {"root": os.path.abspath(root), "split": split,
            "ids": None if ids is None else tuple(ids),
            "use_3d_for_2d": use_3d_for_2d, "im_ext": im_ext}
    if cache_file and os.path.exists(cache_file):
        with open(cache_file, "rb") as f:
            cached = pickle.load(f)
        if isinstance(cached, dict) and cached.get("meta") == meta:
            return cached["imdb"]

    image_dir = os.path.join(root, split, "image_2")
    calib_dir = os.path.join(root, split, "calib")
    label_dir = os.path.join(root, split, "label_2")
    if ids is None:
        ids = sorted(os.path.splitext(f)[0] for f in os.listdir(image_dir)
                     if f.endswith(im_ext))

    imdb = []
    for iid in ids:
        img_path = os.path.join(image_dir, iid + im_ext)
        p2 = read_kitti_calib(os.path.join(calib_dir, iid + ".txt"))
        label_path = os.path.join(label_dir, iid + ".txt")
        gts = (read_kitti_label(label_path, p2, use_3d_for_2d)
               if os.path.exists(label_path) else None)
        h, w = png_size(img_path)
        imdb.append(ImageRecord(id=iid, image_path=img_path, p2=p2,
                                p2_inv=np.linalg.inv(p2), im_h=h, im_w=w,
                                gts=gts if gts is not None else {}))
    if cache_file:
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        with open(cache_file, "wb") as f:
            pickle.dump({"meta": meta, "imdb": imdb}, f)
    return imdb


def determine_ignores(gts, lbls, ilbls, min_gt_vis=0.99, min_gt_h=0,
                      max_gt_h=10e10, scale_factor=1.0, use_trunc=False):
    """(igns, rmvs) boolean arrays over a record's GT rows.

    ignore = a class of ``ilbls``, too occluded (visibility < min_gt_vis),
    a scaled 2D height outside [min_gt_h, max_gt_h], or marked in the
    label; remove = a class in neither list.  ``use_trunc`` also ignores
    GTs truncated beyond ``max(1 - min_gt_vis, 0)``: only the mean pass of
    the bbox statistics sets it.
    """
    n = len(gts.get("cls", []))
    igns = np.zeros(n, bool)
    rmvs = np.zeros(n, bool)
    if n == 0:
        return igns, rmvs
    heights = gts["bbox_full"][:, 3] * scale_factor
    trunc = gts.get("trunc")
    for i in range(n):
        cls = gts["cls"][i]
        ign = bool(gts["ign"][i])
        ign |= gts["visibility"][i] < min_gt_vis
        ign |= heights[i] < min_gt_h
        ign |= heights[i] > max_gt_h
        ign |= cls in ilbls
        if use_trunc and trunc is not None:
            ign |= trunc[i] > max(1 - min_gt_vis, 0)
        igns[i] = ign
        rmvs[i] = cls not in lbls and cls not in ilbls
    return igns, rmvs


def class_indices(gts, lbls):
    """Class name -> 1-based index into lbls (0 reserved for background)."""
    return np.array([lbls.index(c) + 1 if c in lbls else 0
                     for c in gts["cls"]], np.float32)


def balance_samples(imdb, lbls, ilbls, min_gt_vis, min_gt_h,
                    fg_image_ratio=1.0, max_gt_h=10e10, test_scale=None):
    """Per-image sampling weights (summing to 1) by foreground presence.

    * ``fg_image_ratio < 0``: uniform;
    * ``fg_image_ratio == 2``: proportional to each image's valid GT count;
    * otherwise images with a valid GT share ``fg_image_ratio`` of the mass
      uniformly and the others the rest.  Where one of the two groups is
      empty, the other keeps its count-based weights (the reference divides
      by zero there).

    GT validity follows ``determine_ignores`` at the ``test_scale / im_h``
    image scale (``test_scale`` None: the record's own ``scale``).
    """
    weights = np.ones(len(imdb))
    if fg_image_ratio < 0:
        return weights / weights.sum()
    valid_counts = np.zeros(len(imdb))
    for i, rec in enumerate(imdb):
        if not rec.gts:
            continue
        scale = (test_scale / rec.im_h) if test_scale else rec.scale
        igns, rmvs = determine_ignores(rec.gts, lbls, ilbls, min_gt_vis,
                                       min_gt_h, max_gt_h,
                                       scale_factor=scale)
        valid_counts[i] = np.count_nonzero(~igns & ~rmvs)
    weights = valid_counts.copy()
    if fg_image_ratio != 2:
        fg = valid_counts > 0
        n_fg, n_bg = int(fg.sum()), int((~fg).sum())
        if n_fg > 0:
            weights[fg] = len(imdb) * fg_image_ratio / n_fg
        if n_bg > 0:
            weights[~fg] = len(imdb) * (1 - fg_image_ratio) / n_bg
    total = weights.sum()
    if total <= 0:
        return np.full(len(imdb), 1.0 / max(len(imdb), 1))
    return weights / total


def pad_gt_batch(records_gts, p2s, scales, lbls, ilbls, min_gt_vis, min_gt_h,
                 max_gts=64, max_igns=32, n3d_cols=None):
    """A batch of GT dicts -> a ``GTBatch`` of fixed-shape numpy arrays.

    ``records_gts`` hold augmented boxes at the network's input scale
    (``bbox_full`` as x, y, w, h).  The first ``max_gts`` valid GTs and
    ``max_igns`` ignore regions of each record are kept, as corner boxes.
    ``n3d_cols`` fixes the ``bbox_3d`` width (default: the widest record);
    narrower rows are padded with -inf, the no-velocity sentinel.
    """
    b = len(records_gts)
    k3d = n3d_cols or max([g["bbox_3d"].shape[1] for g in records_gts
                           if g and len(g.get("cls", []))], default=16)
    gts_2d = np.zeros((b, max_gts, 4), np.float32)
    gts_3d = np.zeros((b, max_gts, k3d), np.float32)
    gt_labels = np.zeros((b, max_gts), np.float32)
    gt_valid = np.zeros((b, max_gts), bool)
    ign_2d = np.zeros((b, max_igns, 4), np.float32)
    ign_valid = np.zeros((b, max_igns), bool)

    for bi, gts in enumerate(records_gts):
        if not gts or len(gts.get("cls", [])) == 0:
            continue
        igns, rmvs = determine_ignores(gts, lbls, ilbls, min_gt_vis, min_gt_h)
        lbl_idx = class_indices(gts, lbls)
        boxes = gts["bbox_full"].astype(np.float32)
        corners = np.stack([boxes[:, 0], boxes[:, 1],
                            boxes[:, 0] + boxes[:, 2] - 1,
                            boxes[:, 1] + boxes[:, 3] - 1], axis=1)
        val = ~igns & ~rmvs
        ign = ~rmvs & igns
        nv = min(int(val.sum()), max_gts)
        ni = min(int(ign.sum()), max_igns)
        if nv:
            rows = gts["bbox_3d"][val][:nv].astype(np.float32)
            if rows.shape[1] < k3d:
                rows = np.concatenate(
                    [rows, np.full((rows.shape[0], k3d - rows.shape[1]),
                                   -np.inf, np.float32)], axis=1)
            gts_2d[bi, :nv] = corners[val][:nv]
            gts_3d[bi, :nv] = rows
            gt_labels[bi, :nv] = lbl_idx[val][:nv]
            gt_valid[bi, :nv] = True
        if ni:
            ign_2d[bi, :ni] = corners[ign][:ni]
            ign_valid[bi, :ni] = True

    return GTBatch(
        gts_2d=gts_2d, gts_3d=gts_3d, gt_labels=gt_labels, gt_valid=gt_valid,
        ign_2d=ign_2d, ign_valid=ign_valid,
        p2=np.asarray(p2s, np.float32),
        scale=np.asarray(scales, np.float32))
