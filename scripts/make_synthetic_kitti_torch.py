"""Generate a synthetic KITTI tree at real resolution with the port (the
counterpart of ``scripts/make_synthetic_kitti.py``, same flags and tree).

Usage:
  python scripts/make_synthetic_kitti_torch.py --root data/kitti_split1 \
      --train 400 --val 100 [--im-h 375 --im-w 1242] [--video --n-prev 3]

The real KITTI dataset is not distributable with this repo; this writes a
stand-in of production shape (projection-consistent painted objects, the
devkit's label format) through ``groomed_nms_torch/data/synthetic.py``,
for training rehearsals, loader benchmarks and ablations.  No device is
used.
"""

import argparse
import os
import sys
import time

# run as a file, this directory comes first on sys.path, and
# scripts/profile.py there shadows the standard library's profile: the
# repository root replaces it
_HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.abspath(sys.path[0]) == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(_HERE))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="dataset root, e.g. data/kitti_split1")
    ap.add_argument("--train", type=int, default=400)
    ap.add_argument("--val", type=int, default=100)
    ap.add_argument("--im-h", type=int, default=375)
    ap.add_argument("--im-w", type=int, default=1242)
    ap.add_argument("--classes", default="Car",
                    help="comma-separated KITTI classes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--video", action="store_true",
                    help="generate a tracking tree (prev_2 frames, raw "
                         "drives with poses + track-id labels) instead of "
                         "a still tree")
    ap.add_argument("--n-prev", type=int, default=3,
                    help="--video: previous frames per record")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from groomed_nms_torch.data.synthetic import (make_synthetic_kitti,
                                                  make_synthetic_kitti_video)
    classes = tuple(args.classes.split(","))
    t0 = time.time()

    def progress(done, total):
        print(f"  {done}/{total} ({time.time() - t0:.0f}s)", flush=True)

    if args.video:
        print(f"video tree: {args.train} train / {args.val} val records "
              f"@ {args.im_h}x{args.im_w}, n_prev={args.n_prev}")
        make_synthetic_kitti_video(args.root, n_train=args.train,
                                   n_val=args.val, n_prev=args.n_prev,
                                   im_h=args.im_h, im_w=args.im_w,
                                   seed=args.seed, progress=progress)
    else:
        for split, n, seed in (("training", args.train, args.seed),
                               ("validation", args.val, args.seed + 1)):
            print(f"{split}: {n} images @ {args.im_h}x{args.im_w}")
            make_synthetic_kitti(args.root, split, n, im_h=args.im_h,
                                 im_w=args.im_w, seed=seed, classes=classes,
                                 progress=progress)
    print(f"done in {time.time() - t0:.1f}s -> {args.root}")


if __name__ == "__main__":
    main()
