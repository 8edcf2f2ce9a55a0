"""Run ``chip_smoke.py``'s phase 19 (backbone remat and the tool twins)
alone on the card.

Usage:
  python3 scripts/tools_phase_torch.py

Builds the kernels phase 19 launches and the PNG unfilter, writes what it
reads (phase 13's training tree, 16 frames at 375x1242, for the loader
bench), turns cuDNN autotuning on as the whole script has by then, calls
``chip_smoke.tools_phase`` and prints its result.
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

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from card_measure import card_line  # noqa: E402
from groomed_nms_torch.ops import _build  # noqa: E402


def main():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("tools_phase_torch.py needs a CUDA device")
    from concurrent.futures import ThreadPoolExecutor

    from groomed_nms_torch.data.synthetic import make_synthetic_kitti

    dev = torch.device("cuda")
    stamp = f"[{card_line()}]"
    print(stamp, torch.__version__, torch.version.cuda, flush=True)
    sources = ("greedy_nms.cu", "iou_prune.cu", "group_leaders.cu",
               "png_unfilter.cpp")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    shutil.rmtree(cs.TRAIN_DIR, ignore_errors=True)      # phase 13's tree
    make_synthetic_kitti(os.path.join(cs.TRAIN_DIR, "data", "kitti_split1"),
                         "training", 16, seed=21,
                         classes=("Car", "Pedestrian", "Cyclist"))
    torch.backends.cudnn.benchmark = True
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    print(cs.tools_phase(dev, stamp), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
