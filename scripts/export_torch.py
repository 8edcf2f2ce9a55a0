"""Export a trained model as one serving artifact with the PyTorch port.

Usage:
  python scripts/export_torch.py --config groomed_nms [--restore N] \
      [--output output] [--batch 8] [--src-h 375] [--src-w 1242] \
      [--out model.pt2] [--device cuda] [--verify] [--video] [--frames F]

The port's twin of ``scripts/export.py``: stages the whole serving program
(uint8 preprocess -> the model -> K1 -> decode -> NMS -> top-k, or for
``--video`` a clip -> measurements -> tracker -> tracks) out with
``torch.export`` (``groomed_nms_torch/export.py``), with the weights,
anchors and statistics inside, and writes one ``.pt2`` artifact and its meta
json (the JAX script's keys, and ``device``).  The weights come from the
port's checkpoint (``training/checkpoint.py``), or for ``--video`` by
``utils/video_weights.py::load_video_variables``; anchors and statistics
from the training run's ``anchors.npz``, as ``scripts/evaluate_torch.py``
reads them.  ``--verify`` loads the artifact back and holds it against the
live program on random input.  The artifact is exported on, and serves on,
``--device``: the CUDA card (the default; raises when CUDA is absent) or
the CPU.  ``main(argv)`` returns a summary dict.
"""

import argparse
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
    ap.add_argument("--config", required=True)
    ap.add_argument("--output", default="output")
    ap.add_argument("--restore", type=int, default=None,
                    help="checkpoint step (default: the latest)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--src-h", type=int, default=375)
    ap.add_argument("--src-w", type=int, default=1242)
    ap.add_argument("--out", default=None,
                    help="artifact path (default <out_dir>/model.pt2)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the artifact serves")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--video", action="store_true",
                    help="export the video/kalman model instead "
                         "(clip in, Tracks out; --frames sets the clip "
                         "length)")
    ap.add_argument("--frames", type=int, default=None,
                    help="video clip length (default cfg.video_count)")
    return ap.parse_args(argv)


def _camera(lead):
    import numpy as np
    p2 = np.tile(np.eye(4, dtype=np.float32), lead + (1, 1))
    p2[..., 0, 0] = p2[..., 1, 1] = 707.0
    p2[..., 0, 2], p2[..., 1, 2] = 604.0, 180.0
    return p2, np.linalg.inv(p2)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from groomed_nms_torch.anchors import locate_anchors
    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.data.pipeline import load_anchors, resolve_stats_dir
    from groomed_nms_torch.export import (build_serving_fn,
                                          build_video_serving_fn,
                                          export_serving,
                                          export_video_serving, load_serving)
    from groomed_nms_torch.models.rpn_3d import RPN3D
    from groomed_nms_torch.training.checkpoint import restore_checkpoint

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "export for the CPU")
    logging.basicConfig(
        force=True, level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("export_torch")
    log.info("torch %s on %s", torch.__version__,
             torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")

    cfg = load_config(args.config)
    out_dir = os.path.join(args.output, cfg.name)
    anchors, means, stds = load_anchors(cfg, resolve_stats_dir(cfg, out_dir))
    feat_hw = (cfg.crop_size[0] // cfg.feat_stride,
               cfg.crop_size[1] // cfg.feat_stride)
    rois = locate_anchors(anchors, feat_hw, cfg.feat_stride)
    rois_3d = anchors[rois[:, 4].astype(np.int64), 4:]
    bf16_input = cfg.compute_dtype == "bfloat16"
    consts = dict(rois=rois, rois_3d=rois_3d, bbox_means=means,
                  bbox_stds=stds, image_means=np.asarray(cfg.image_means),
                  image_stds=np.asarray(cfg.image_stds))
    shape = dict(target_h=cfg.crop_size[0], crop_w=cfg.crop_size[1],
                 bf16_input=bf16_input)

    if args.video:
        from groomed_nms_torch.models.video import VideoConfig, VideoRPN3D
        from groomed_nms_torch.utils.video_weights import \
            load_video_variables
        from groomed_nms_torch.utils.weights import init_weights

        vcfg = VideoConfig(rpn=cfg.rpn_config(anchors.shape[0]),
                           score_thres=cfg.score_thres,
                           nms_thres=cfg.nms_thres,
                           best_thresh=cfg.best_thresh)
        model = VideoRPN3D(vcfg)
        init_weights(model, torch.Generator().manual_seed(cfg.rng_seed))
        pose_means, pose_stds, step = load_video_variables(
            model, cfg, out_dir, args.restore, log)
        n_frames = args.frames or max(2, cfg.video_count)
        model = model.to(device, memory_format=torch.channels_last)
        serve = build_video_serving_fn(
            model, vcfg=vcfg, pose_means=pose_means, pose_stds=pose_stds,
            **consts, **shape)
        t0 = time.perf_counter()
        blob = export_video_serving(serve, n_frames=n_frames,
                                    src_h=args.src_h, src_w=args.src_w)
        out_path = args.out or os.path.join(out_dir, "video_model.pt2")
        meta_io = {
            "inputs": "clip_u8 [F,H0,W0,3] u8; p2 [4,4] f32; "
                      "p2_inv [4,4] f32; scale [F] f32",
            "outputs": "Tracks (fixed-slot kalman state + validity)",
            "frames": n_frames,
        }
    else:
        model = RPN3D(cfg.rpn_config(anchors.shape[0]))
        step = restore_checkpoint(out_dir, model, step=args.restore,
                                  restore_optimizer=False)
        log.info("restored iter %d", step)
        model = model.to(device, memory_format=torch.channels_last)
        serve = build_serving_fn(model, dcfg=cfg.detect_config(), **consts,
                                 **shape)
        t0 = time.perf_counter()
        blob = export_serving(serve, batch=args.batch, src_h=args.src_h,
                              src_w=args.src_w)
        out_path = args.out or os.path.join(out_dir, "model.pt2")
        meta_io = {
            "inputs": "images_u8 [B,H0,W0,3] u8; p2 [B,4,4] f32; "
                      "p2_inv [B,4,4] f32; scale [B] f32",
            "outputs": "dets [B,topN_post,17] f32; valid [B,topN_post] bool",
            "batch": args.batch,
        }
    export_s = time.perf_counter() - t0

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(blob)
    meta = {
        "config": cfg.name, "iter": step,
        "src_hw": [args.src_h, args.src_w],
        "crop_size": list(cfg.crop_size),
        "class_names": list(cfg.lbls), "score_thres": cfg.score_thres,
        "platforms": [device.type], "device": str(serve.rois.device),
        "bytes": len(blob), **meta_io,
    }
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    log.info("wrote %s (%.1f MB) in %.1f s of export", out_path,
             len(blob) / 1e6, export_s)
    summary = dict(path=out_path, bytes=len(blob), export_s=export_s,
                   step=step, verified=False)

    if args.verify:
        rs = np.random.default_rng(0)
        loaded = load_serving(blob, device)
        n = meta_io.get("frames", args.batch)
        imgs = torch.from_numpy(rs.integers(
            0, 256, (n, args.src_h, args.src_w, 3), dtype=np.uint8))
        p2, p2_inv = _camera(() if args.video else (n,))
        scale = np.full((n,), cfg.crop_size[0] / args.src_h, np.float32)
        inputs = [torch.as_tensor(x).to(device)
                  for x in (imgs, p2, p2_inv, scale)]
        with torch.no_grad():
            want = serve(*inputs)
        got = loaded(*inputs)
        if args.video:
            for name in ("valid", "ids", "next_id"):
                if not torch.equal(getattr(got, name), getattr(want, name)):
                    raise AssertionError(f"verify: {name} differs")
            for name in ("X", "C", "A", "box2d", "un"):
                torch.testing.assert_close(getattr(got, name),
                                           getattr(want, name), rtol=0,
                                           atol=1e-4, msg=name)
            log.info("verify OK: the video artifact reproduces the live "
                     "program (%d tracks)", int(want.valid.sum()))
        else:
            if not torch.equal(got[1], want[1]):
                raise AssertionError("verify: the valid masks differ")
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
            log.info("verify OK: the artifact reproduces the live program "
                     "(%d valid rows on random input)", int(want[1].sum()))
        summary["verified"] = True
    return summary


if __name__ == "__main__":
    main()
