"""Evaluate the video model with the PyTorch port: per-frame detections and
Kalman smoothing.

Usage:
  python scripts/test_kalman_torch.py --config kitti_3d_full \
      [--data-root data] [--output output] [--restore N] [--limit N] \
      [--set KEY=VALUE ...] [--device cuda]

The port's twin of ``scripts/test_kalman.py``: the tracking imdb's
``validation`` split, each record's frames read oldest to newest (missing
ones skipped), ``preprocess_images`` on the device, one ``VideoRPN3D``
forward a clip, the measurements (K1, K2), the poses denormalised, the
tracker over the clip, the final tracks written in KITTI format into
``<output>/<name>/results/results_kalman/data/``, then the C++ evaluator
when the split has ``label_2``.  Weights follow
``utils/video_weights.py::load_video_variables``; anchors and statistics
come from the training run's ``anchors.npz``.  ``--set
compute_dtype=bfloat16`` runs the model under bf16 autocast.  It runs on
the CUDA card unless ``--device cpu`` is given, and raises when CUDA is
absent.  ``main(argv)`` returns a summary dict.
"""

import argparse
import contextlib
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
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--output", default="output")
    ap.add_argument("--restore", type=int, default=None,
                    help="checkpoint step (default: the latest)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override any ExperimentConfig field (repeatable); "
                         "values are parsed as Python literals")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from groomed_nms_torch.anchors import locate_anchors
    from groomed_nms_torch.config import apply_overrides, load_config
    from groomed_nms_torch.data.augment import preprocess_images
    from groomed_nms_torch.data.pipeline import load_anchors, resolve_stats_dir
    from groomed_nms_torch.data.png import read_png
    from groomed_nms_torch.data.tracking import build_tracking_imdb
    from groomed_nms_torch.eval.kitti_eval import \
        evaluate_kitti_results_verbose
    from groomed_nms_torch.inference import write_kitti_tracks
    from groomed_nms_torch.models.video import (VideoConfig, VideoRPN3D,
                                                extract_measurements,
                                                video_track)
    from groomed_nms_torch.ops import kernels
    from groomed_nms_torch.utils.video_weights import load_video_variables
    from groomed_nms_torch.utils.weights import init_weights

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "track on the CPU")
    cfg = apply_overrides(load_config(args.config), args.overrides)
    out_dir = os.path.join(args.output, cfg.name)
    results_dir = os.path.join(out_dir, "results", "results_kalman")
    os.makedirs(os.path.join(results_dir, "data"), exist_ok=True)
    logging.basicConfig(
        force=True, level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("test_kalman_torch")
    log.info("torch %s on %s", torch.__version__,
             torch.cuda.get_device_name(device) if cuda else "cpu")

    root = os.path.join(args.data_root, cfg.dataset_test)
    imdb = build_tracking_imdb(root, "validation",
                               use_3d_for_2d=cfg.use_3d_for_2d,
                               im_ext=cfg.im_ext)
    if args.limit:
        imdb = imdb[:args.limit]

    anchors, means, stds = load_anchors(cfg, resolve_stats_dir(cfg, out_dir))
    feat_hw = (cfg.crop_size[0] // cfg.feat_stride,
               cfg.crop_size[1] // cfg.feat_stride)
    rois = locate_anchors(anchors, feat_hw, cfg.feat_stride)
    rois_3d = anchors[rois[:, 4].astype(np.int64), 4:]

    vcfg = VideoConfig(rpn=cfg.rpn_config(anchors.shape[0]),
                       score_thres=cfg.score_thres, nms_thres=cfg.nms_thres,
                       best_thresh=cfg.best_thresh)
    model = VideoRPN3D(vcfg)
    init_weights(model, torch.Generator().manual_seed(cfg.rng_seed))
    pose_means, pose_stds, step = load_video_variables(
        model, cfg, out_dir, args.restore, log)
    model = model.to(device, memory_format=torch.channels_last).eval()
    if cuda:
        torch.backends.cudnn.benchmark = True

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    rois_t, rois_3d_t, means_t, stds_t = map(dev, (rois, rois_3d, means,
                                                   stds))
    pose_means_t, pose_stds_t = dev(pose_means), dev(pose_stds)
    amp = (torch.autocast(device.type, dtype=torch.bfloat16)
           if cfg.compute_dtype == "bfloat16" else contextlib.nullcontext())

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    names = ("fused_head_scores", "greedy_nms")
    before = {n: getattr(kernels, n).launches for n in names}
    clips = frames_total = rows_written = 0
    wait_s = 0.0
    t_loop = time.perf_counter()
    for rec in imdb:
        # oldest -> newest
        frames = [read_png(p) for p in reversed(rec.image_paths)
                  if os.path.exists(p)]
        if not frames:
            continue
        stack = torch.from_numpy(np.stack(frames)).to(device)
        f, h0 = stack.shape[:2]
        scale = cfg.crop_size[0] / h0
        p2 = dev(rec.p2)
        with torch.no_grad():
            x = preprocess_images(stack, None, cfg.image_means,
                                  cfg.image_stds, target_h=cfg.crop_size[0],
                                  crop_w=cfg.crop_size[1])
            with amp:
                out = model(x[None])
            meas, valid = extract_measurements(
                out.frame_outputs, rois_t, rois_3d_t, p2.expand(f, 4, 4),
                torch.full((f,), scale, device=device), means_t, stds_t,
                vcfg)
            poses_dn = torch.cat([torch.zeros((1, 6), device=device),
                                  out.poses[0] * pose_stds_t + pose_means_t])
            final, _ = video_track(meas, valid, poses_dn, p2, vcfg)
        t = time.perf_counter()
        sync()
        wait_s += time.perf_counter() - t
        rows_written += write_kitti_tracks(
            os.path.join(results_dir, "data", rec.id + ".txt"), final,
            score_thres=cfg.score_thres)
        clips += 1
        frames_total += f
        if clips % 200 == 0:
            log.info("tracked %d/%d", clips, len(imdb))
    wall_s = time.perf_counter() - t_loop
    launches = {n: getattr(kernels, n).launches - before[n] for n in names}
    summary = dict(clips=clips, frames=frames_total, rows=rows_written,
                   launches=launches, wall_s=wall_s,
                   clips_per_s=clips / wall_s if wall_s > 0 else 0.0,
                   host_share=1.0 - wait_s / wall_s if wall_s > 0 else 1.0,
                   step=step, results_dir=results_dir, eval=None)
    log.info("test_kalman_torch: %d clips, %d frames, %d track rows "
             "written; launches K1 %d, K2 %d; %.3f clip/s; the host busy "
             "%.1f%% of the wall", clips, frames_total, rows_written,
             launches["fused_head_scores"], launches["greedy_nms"],
             summary["clips_per_s"], 100 * summary["host_share"])

    gt_dir = os.path.join(root, "validation", "label_2")
    if os.path.isdir(gt_dir):
        summary["eval"] = evaluate_kitti_results_verbose(
            results_dir, gt_dir, fast_eval=True, log_fn=log.info)
    return summary


if __name__ == "__main__":
    main()
