"""Run ``chip_smoke.py``'s phase 18 (data parallelism) alone on the card.

Usage:
  python3 scripts/parallel_phase_torch.py

Builds the kernels phase 18 launches, writes what it reads -- phase 12's
evaluation tree with its anchors and checkpoint, and phase 13's training
tree with a 2-step ``kitti_3d_warmup`` run to warm-start from -- then calls
``chip_smoke.parallel_phase`` and prints its result.  cuDNN autotunes the
full-width training shapes inside phase 18 here (the whole script has done
so in phase 13), so the phase takes longer alone than in the whole run.
"""

import os
import shutil
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.abspath(sys.path[0]) == _HERE:     # scripts/profile.py shadows
    sys.path.pop(0)                             # the standard library's
ROOT = os.path.dirname(_HERE)
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from card_measure import card_line  # noqa: E402
from groomed_nms_torch.ops import _build  # noqa: E402


def main():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("parallel_phase_torch.py needs a CUDA device")
    from groomed_nms_torch.data.synthetic import (crop_to_sizes,
                                                  make_synthetic_kitti)
    from groomed_nms_torch.flagship import flagship_priors
    from groomed_nms_torch.training.checkpoint import save_checkpoint

    dev = torch.device("cuda")
    stamp = f"[{card_line()}]"
    print(stamp, torch.__version__, torch.version.cuda, flush=True)
    for src in ("greedy_nms.cu", "iou_prune.cu", "group_leaders.cu",
                "png_unfilter.cpp"):
        _build.build(src)
    shutil.rmtree(cs.EVAL_DIR, ignore_errors=True)       # phase 12's tree
    root = os.path.join(cs.EVAL_DIR, "data", "kitti_split1")
    make_synthetic_kitti(root, "validation", cs.EVAL_FRAMES, seed=12,
                         classes=("Car", "Pedestrian", "Cyclist"))
    crop_to_sizes(root, "validation", cs.EVAL_SIZES)
    run_dir = os.path.join(cs.EVAL_DIR, "output", "groomed_nms")
    os.makedirs(run_dir)
    np.savez(os.path.join(run_dir, "anchors.npz"), anchors=flagship_priors(),
             bbox_means=np.zeros(13), bbox_stds=np.ones(13))
    save_checkpoint(run_dir, cs.perturbed_rpn3d(seed=7), step=0)
    shutil.rmtree(cs.TRAIN_DIR, ignore_errors=True)      # phase 13's tree
    troot = os.path.join(cs.TRAIN_DIR, "data", "kitti_split1")
    make_synthetic_kitti(troot, "training", 16, seed=21,
                         classes=("Car", "Pedestrian", "Cyclist"))
    cs.load_script("train_torch").main(
        ["--config", "kitti_3d_warmup", "--data-root",
         os.path.join(cs.TRAIN_DIR, "data"), "--output",
         os.path.join(cs.TRAIN_DIR, "output"), "--max-iter", "2",
         "--set", "do_test=False"])
    torch.cuda.empty_cache()
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    print(cs.parallel_phase(dev, stamp), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
