"""Throughput of the port's training loader alone, no device in the loop
(the counterpart of ``analysis/bench_loader.py``).

Measures the sustained host rate of ``groomed_nms_torch.data.pipeline.
TrainLoader`` (PNG decode fan-out, label sampling, GT padding) in img/s,
the number that must exceed the train step's rate for training never to
wait on the host.

Usage:
  python analysis/bench_loader_torch.py [--data-root data] \
      [--config groomed_nms] [--batch-size 8] [--iters 40] [--workers 8] \
      [--synthetic N] [--cache]

With ``--synthetic N`` a synthetic tree of N images at KITTI's size
(``data.synthetic.make_synthetic_kitti``) is written into a temporary
directory first.  ``--cache`` reads through the raw decoded-image cache
(``raw_cache_dir``; ``scripts/train_torch.py --cache-images``), filled by
one pass over every image before the warm-up.  The last line is JSON.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--config", default="groomed_nms")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate an N-image synthetic tree instead of "
                         "reading --data-root")
    ap.add_argument("--cache", action="store_true",
                    help="read through the raw decoded-image cache, filled "
                         "by one pass first")
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be >= 1")
    return args


def main(argv=None):
    """Returns the JSON line's dict."""
    args = parse_args(argv)
    import dataclasses

    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.data.pipeline import TrainLoader, load_image_cached

    cfg = dataclasses.replace(load_config(args.config),
                              batch_size=args.batch_size)
    with tempfile.TemporaryDirectory(prefix="bench_loader_") as tmp:
        if args.synthetic:
            from groomed_nms_torch.data.synthetic import make_synthetic_kitti
            root = os.path.join(tmp, cfg.dataset_train)
            print(f"generating {args.synthetic} synthetic images...",
                  flush=True)
            make_synthetic_kitti(root, "training", args.synthetic)
        else:
            root = os.path.join(args.data_root, cfg.dataset_train)
        imdb = build_imdb(root, "training", use_3d_for_2d=cfg.use_3d_for_2d,
                          cache_file=None, im_ext=cfg.im_ext)
        print(f"imdb: {len(imdb)} images ({imdb[0].im_h}x{imdb[0].im_w})",
              flush=True)
        cache_dir = os.path.join(tmp, "decoded_cache") if args.cache \
            else None
        # prefetch=2: a deep queue filled during the warm-up would credit
        # the measured window with batches made before t0
        loader = TrainLoader(imdb, cfg, seed=0, prefetch=2,
                             decode_workers=args.workers,
                             raw_cache_dir=cache_dir)
        try:
            if args.cache:              # fill: one pass over every image
                for rec in imdb:
                    load_image_cached(rec.image_path, rec.id, cache_dir)
            for _ in range(args.warmup):
                next(loader)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                b = next(loader)
            dt = time.perf_counter() - t0
        finally:
            loader.close()

    n_img = args.iters * args.batch_size
    print(f"batch {b['images_u8'].shape}, {args.iters} batches in "
          f"{dt:.2f}s", flush=True)
    result = {"metric": "train_loader_throughput",
              "value": round(n_img / dt, 2), "unit": "img/s",
              "batch_size": args.batch_size, "workers": args.workers,
              "cache": bool(args.cache),
              "ms_per_batch": round(1000 * dt / args.iters, 2)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
