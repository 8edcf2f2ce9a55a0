"""Serve an exported artifact over a directory of images, with no model code.

Usage:
  python scripts/serve_torch.py --artifact model.pt2 --images <dir> \
      [--calib <dir>] [--out serve_out] [--score-thres T] [--device cuda]

The port's twin of ``scripts/serve.py``: loads the ``.pt2`` artifact
written by ``scripts/export_torch.py`` (and its sibling meta json), decodes
the directory's PNG files (``data/png.py``; a ``.jpg`` is refused: the port
has no JPEG decoder), fits each into the artifact's input plane
(``fit_image_to_plane``), runs the artifact in batches (the last one
ragged) and writes KITTI-format txt detections.  The model, config, anchor
and checkpoint code paths are not touched: the artifact holds the weights,
anchors, statistics and the whole program.

A video artifact (``--video``; its meta json carries "frames") serves the
same directory as one ordered sequence: each frame's clip is the trailing F
frames (the oldest repeated at the start), and the frame's final tracks are
written.  It serves on ``--device``, the CUDA card by default (raises when
CUDA is absent), which must be the device the artifact was exported on.
``main(argv)`` returns a summary dict.
"""

import argparse
import glob
import json
import logging
import os
import sys
import time

# run as a file, this directory comes first on sys.path, and
# scripts/profile.py would shadow the standard library's profile (torch
# imports it when a custom op first runs): the repository root replaces it
_HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.abspath(sys.path[0]) == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(_HERE))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--images", required=True)
    ap.add_argument("--calib", default=None,
                    help="dir of KITTI calib txts named like the images")
    ap.add_argument("--out", default="serve_out")
    ap.add_argument("--score-thres", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the artifact's device")
    return ap.parse_args(argv)


def _default_p2(src_h, src_w):
    import numpy as np
    p2 = np.eye(4, dtype=np.float32)
    p2[0, 0] = p2[1, 1] = 707.0493
    p2[0, 2], p2[1, 2] = src_w / 2.0, src_h / 2.0
    return p2


def image_paths(images_dir):
    """The directory's PNG files, sorted; a JPEG raises ``ValueError``."""
    jpegs = [p for ext in ("jpg", "jpeg", "JPG", "JPEG")
             for p in glob.glob(os.path.join(images_dir, f"*.{ext}"))]
    if jpegs:
        raise ValueError(f"{jpegs[0]}: JPEG input needs a decoder the port "
                         f"does not have (Pillow or torchvision); convert "
                         f"the frames to PNG")
    paths = sorted(glob.glob(os.path.join(images_dir, "*.png")))
    if not paths:
        raise FileNotFoundError(f"no PNG images under {images_dir}")
    return paths


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from groomed_nms_torch.data.augment import fit_image_to_plane
    from groomed_nms_torch.data.kitti import read_kitti_calib
    from groomed_nms_torch.data.png import read_png
    from groomed_nms_torch.export import load_serving
    from groomed_nms_torch.inference import (write_kitti_detections,
                                             write_kitti_tracks)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "serve a CPU artifact")
    logging.basicConfig(
        force=True, level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("serve_torch")

    with open(args.artifact + ".json") as f:
        meta = json.load(f)
    if torch.device(meta["device"]).type != device.type:
        raise ValueError(f"{args.artifact} was exported on {meta['device']};"
                         f" it cannot be served on {device}")
    src_h, src_w = meta["src_hw"]
    crop_h = meta["crop_size"][0]
    class_names = meta.get("class_names", ["Car", "Pedestrian", "Cyclist"])
    score_thres = (args.score_thres if args.score_thres is not None
                   else meta.get("score_thres", 0.6))
    with open(args.artifact, "rb") as f:
        loaded = load_serving(f.read(), device)
    paths = image_paths(args.images)
    os.makedirs(args.out, exist_ok=True)

    def load_frame(path):
        # the program resizes the whole plane by crop_h / src_h (it cannot
        # see the true extent), so the plane-to-original factor the decode
        # divides by is that times the host's fitting ratio r
        fitted, r = fit_image_to_plane(read_png(path), src_h, src_w)
        return fitted, float(crop_h) / src_h * r

    def calib_for(path):
        if args.calib:
            stem = os.path.splitext(os.path.basename(path))[0]
            cal = os.path.join(args.calib, stem + ".txt")
            if os.path.exists(cal):
                return read_kitti_calib(cal).astype(np.float32)
        return _default_p2(src_h, src_w)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def stem_txt(path):
        return os.path.join(args.out, os.path.splitext(
            os.path.basename(path))[0] + ".txt")

    t0 = time.perf_counter()
    if "frames" in meta:
        n_frames = meta["frames"]
        log.info("video artifact %s: frames=%d src=%dx%d on %s",
                 args.artifact, n_frames, src_h, src_w, device)
        # each frame appears in up to n_frames windows: keep the trailing
        # window's decodes
        cache = {}

        def cached_frame(path):
            if path not in cache:
                cache[path] = load_frame(path)
                while len(cache) > n_frames + 1:
                    cache.pop(next(iter(cache)))
            return cache[path]

        for i, path in enumerate(paths):
            window = paths[max(0, i - n_frames + 1):i + 1]
            window = [window[0]] * (n_frames - len(window)) + window
            frames, scales = zip(*(cached_frame(p) for p in window))
            p2 = calib_for(path)
            tracks = loaded(dev(np.stack(frames)), dev(p2),
                            dev(np.linalg.inv(p2).astype(np.float32)),
                            dev(np.asarray(scales, np.float32)))
            write_kitti_tracks(stem_txt(path), tracks,
                               score_thres=score_thres,
                               class_name=class_names[0])
    else:
        batch = meta["batch"]
        log.info("artifact %s: batch=%d src=%dx%d classes=%s on %s",
                 args.artifact, batch, src_h, src_w, class_names, device)
        for i in range(0, len(paths), batch):
            chunk = paths[i:i + batch]
            imgs = np.zeros((batch, src_h, src_w, 3), np.uint8)
            p2 = np.tile(_default_p2(src_h, src_w)[None], (batch, 1, 1))
            scale = np.full((batch,), float(crop_h) / src_h, np.float32)
            for bi, path in enumerate(chunk):
                imgs[bi], scale[bi] = load_frame(path)
                p2[bi] = calib_for(path)
            dets, valid = loaded(dev(imgs), dev(p2), dev(np.linalg.inv(p2)),
                                 dev(scale))
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            for bi, path in enumerate(chunk):
                write_kitti_detections(stem_txt(path), dets[bi], valid[bi],
                                       class_names, score_thres=score_thres)
    wall_s = time.perf_counter() - t0
    log.info("wrote %d result files to %s in %.2f s", len(paths), args.out,
             wall_s)
    return dict(images=len(paths), out=args.out, wall_s=wall_s)


if __name__ == "__main__":
    main()
