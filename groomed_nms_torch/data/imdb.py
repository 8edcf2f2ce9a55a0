"""The image database of a KITTI split (counterpart of
``groomed_nms_tpu/data/imdb.py``: ``ImageRecord`` and ``build_imdb``).

Image sizes come from the PNG header (``data/png.py``), not from Pillow.
The GT filtering and batching helpers of the JAX module serve the train
loader and are not ported yet.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field

import numpy as np

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
