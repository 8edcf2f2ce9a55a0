"""Evaluate a trained model on KITTI val with the PyTorch port.

Usage:
  python scripts/evaluate_torch.py --config groomed_nms [--restore N] \
      [--data-root data] [--output output] [--batch 8] [--device cuda]

The port's twin of ``scripts/test.py``: restores the port's checkpoint
(``output/<name>/weights/checkpoint_<step>.pt``, written by
``scripts/torch_checkpoint.py`` or the port's trainer), reads the training
run's ``anchors.npz``, decodes the split's PNGs, runs batched inference
(``eval.tester.test_kitti_3d``), writes KITTI txt files and scores them with
the C++ evaluator.  It runs on the CUDA card unless ``--device cpu`` is
given, and raises when CUDA is absent or the PNG unfilter does not build.
``--set compute_dtype=bfloat16`` runs the model under bf16 autocast.
"""

import argparse
import dataclasses
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
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--split", default="validation")
    ap.add_argument("--limit", type=int, default=None)
    # fan-out: shards write into one results dir; shard 0 scores the union
    # once every shard has left its done-marker
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--single-program", action="store_true",
                    help="one max-size plane for every val image size, each "
                         "resampled by its own scale, instead of one batch "
                         "shape per size")
    ap.add_argument("--render", type=int, default=0,
                    help="not ported: needs matplotlib and Pillow")
    ap.add_argument("--refine", action="store_true",
                    help="not ported: ROADMAP queue 1, item 12")
    ap.add_argument("--cache-images", action="store_true",
                    help="mmap-cache decoded val images in the split's "
                         ".decoded_cache")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override any ExperimentConfig field (repeatable); "
                         "values are parsed as Python literals")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the evaluation; returns the evaluator's AP dict (None when it was
    skipped)."""
    args = parse_args(argv)
    if args.render:
        raise ValueError("--render needs matplotlib and Pillow, which the "
                         "port does not use")
    if args.refine:
        raise ValueError("--refine needs ops/refine.py, ROADMAP queue 1, "
                         "item 12")

    import torch

    from groomed_nms_torch.anchors import locate_anchors
    from groomed_nms_torch.config import apply_overrides, load_config
    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.data.pipeline import load_anchors, resolve_stats_dir
    from groomed_nms_torch.eval.kitti_eval import \
        evaluate_kitti_results_verbose
    from groomed_nms_torch.eval.tester import test_kitti_3d
    from groomed_nms_torch.models.rpn_3d import RPN3D
    from groomed_nms_torch.ops import _build
    from groomed_nms_torch.training.checkpoint import restore_checkpoint

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "evaluate on the CPU")
    _build.png_unfilter_lib()          # a failed build raises here

    cfg = apply_overrides(load_config(args.config), args.overrides)
    if args.single_program:
        cfg = dataclasses.replace(cfg, eval_single_program=True)
    out_dir = os.path.join(args.output, cfg.name)
    # not `args.restore or ...`: --restore 0 is a real checkpoint id
    tag = "latest" if args.restore is None else args.restore
    results_dir = os.path.join(out_dir, "results", f"results_{tag}")
    os.makedirs(os.path.join(results_dir, "data"), exist_ok=True)
    logging.basicConfig(
        force=True, level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger(__name__)
    log.info("torch %s on %s", torch.__version__,
             torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")

    root = os.path.join(args.data_root, cfg.dataset_test)
    imdb = build_imdb(root, args.split, use_3d_for_2d=cfg.use_3d_for_2d,
                      cache_file=None, im_ext=cfg.im_ext)
    if args.limit:
        imdb = imdb[:args.limit]
    if args.num_shards > 1:
        imdb = imdb[args.shard_index::args.num_shards]
    log.info("val imdb: %d images (shard %d/%d)", len(imdb),
             args.shard_index, args.num_shards)

    # anchors and stats of the training run (or, for copy_stats configs,
    # of the pretrained run it reused)
    anchors, means, stds = load_anchors(cfg, resolve_stats_dir(cfg, out_dir))
    feat_hw = (cfg.crop_size[0] // cfg.feat_stride,
               cfg.crop_size[1] // cfg.feat_stride)
    rois = locate_anchors(anchors, feat_hw, cfg.feat_stride)
    rois_3d = anchors[rois[:, 4].astype(int), 4:]

    model = RPN3D(cfg.rpn_config(anchors.shape[0]))
    step = restore_checkpoint(out_dir, model, step=args.restore,
                              restore_optimizer=False)
    log.info("restored iter %d", step)
    model = model.to(device, memory_format=torch.channels_last)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True   # one conv shape per run

    sharded = args.num_shards > 1
    if sharded:
        marker = os.path.join(results_dir, f".shard_done_{args.shard_index}")
        if os.path.exists(marker):
            os.remove(marker)

    gt_dir = os.path.join(root, args.split, "label_2")
    result = test_kitti_3d(
        cfg, model, rois, rois_3d, means, stds, imdb, results_dir,
        gt_dir=gt_dir, batch_size=args.batch, log_fn=log.info,
        skip_eval=args.skip_eval or sharded,
        raw_cache_dir=os.path.join(root, args.split, ".decoded_cache")
        if args.cache_images else None)

    if sharded:
        # barrier: shard 0 scores only once every shard has marked its
        # completion, so the evaluator never sees a partial detection set
        with open(marker, "w") as f:
            f.write(str(len(imdb)))
        if args.shard_index == 0 and not args.skip_eval:
            deadline = time.time() + 6 * 3600
            want = [os.path.join(results_dir, f".shard_done_{i}")
                    for i in range(args.num_shards)]
            while not all(os.path.exists(p) for p in want):
                if time.time() > deadline:
                    missing = [p for p in want if not os.path.exists(p)]
                    raise TimeoutError(f"shards never finished: {missing}")
                log.info("waiting for %d/%d shards...",
                         sum(not os.path.exists(p) for p in want),
                         args.num_shards)
                time.sleep(5)
            if os.path.isdir(gt_dir):
                result = evaluate_kitti_results_verbose(
                    results_dir, gt_dir, fast_eval=cfg.fast_eval,
                    log_fn=log.info)
    return result


if __name__ == "__main__":
    main()
