#!/usr/bin/env python3
"""Time the greedy-NMS kernel K2 of this checkout, and of other ones, on one
CUDA card, with each call split into its mask and sweep kernels.

    python3 scripts/k2_compare.py [--other DIR ...] [--reps 50]

Builds ``groomed_nms_torch/csrc/greedy_nms.cu`` of this checkout and, with
``--other``, the same file of other checkouts (the parent commit unpacked by
``git archive``, say), with the same nvcc flags.  On two inputs at the main
path's shape [8, 3000] -- ``card_measure.nms_case`` (clustered boxes, padding
rows, IoUs at and next to the 0.4 threshold) and the flagship's own K2
input (the decoded top-3000 rows of one rpn3d batch, seeded weights) -- it
checks each library's keep mask against ``greedy_nms_plain`` (identical, or
the library is marked), times them in the order others, this, this, others
reversed (median device ms of ``--reps`` calls, L2 flushed before each), and
sums the device time of a call's kernels by name (``nms_mask``,
``nms_sweep``; ``card_measure.split_ms``).  Prints one line per reading, each
with the card's name and power limit, then one JSON object.  A library that
disagrees is still timed, marked so, and makes the exit code 1.  Needs a
CUDA card; imports torch, numpy, ``card_measure.py`` and groomed_nms_torch
only.
"""

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# run as a file, this directory comes first on sys.path, and
# scripts/profile.py there shadows the standard library's profile (which
# the custom ops' first call imports through torch._dynamo)
if Path(sys.path[0]).resolve() == ROOT / "scripts":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from card_measure import (K2_SHAPE, card_line,  # noqa: E402
                          k2_flagship_input, k2_work_bound, nms_case,
                          split_ms, time_ms)
from groomed_nms_torch.flagship import build_flagship  # noqa: E402
from groomed_nms_torch.ops import _build, kernels  # noqa: E402

SOURCE = Path("groomed_nms_torch/csrc/greedy_nms.cu")
THRESHOLD, SHIFT = 0.4, 1.0
K2_KERNELS = ("nms_mask", "nms_sweep")


def load(path):
    """The library at ``path`` with its C entry declared."""
    lib = ctypes.CDLL(str(path))
    p = ctypes.c_void_p
    lib.greedy_nms.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, ctypes.c_float, p]
    lib.greedy_nms.restype = ctypes.c_int
    return lib


def run(lib, boxes, scores):
    """``kernels.greedy_nms``'s CUDA path on the library ``lib``."""
    b, n = scores.shape
    words = -(-n // 64)
    mask = torch.empty((b, n, words), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    err = lib.greedy_nms(boxes.data_ptr(), scores.data_ptr(), mask.data_ptr(),
                         keep.data_ptr(), b, n, THRESHOLD, SHIFT,
                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"greedy_nms failed: CUDA error {err}")
    return keep


def inputs(dev):
    """{name: (boxes, scores)} of the two inputs, on ``dev``."""
    boxes, scores = nms_case(np.random.default_rng(2), *K2_SHAPE)
    cases = {"synthetic": (torch.from_numpy(boxes).to(dev),
                           torch.from_numpy(scores).to(dev))}
    infer, args, model = build_flagship(device="cuda")
    cases["flagship"] = k2_flagship_input(model, args)
    del infer, args, model
    torch.cuda.empty_cache()
    return cases


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="other checkouts whose K2 is timed beside this one's")
    ap.add_argument("--reps", type=int, default=50)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("k2_compare.py needs a CUDA device")
    dev = torch.device("cuda")
    stamp = f"[{card_line()}]"
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    others = [d.resolve().name for d in opts.other]
    sources = [ROOT / SOURCE] + [d.resolve() / SOURCE for d in opts.other]
    with ThreadPoolExecutor(len(sources)) as pool:       # one nvcc each
        paths = list(pool.map(lambda src: _build.build(str(src)), sources))
    libs = {name: load(path) for name, path in zip(["this"] + others, paths)}
    order = others + ["this", "this"] + others[::-1]
    wrong = set()
    results = {}
    for case, (boxes, scores) in inputs(dev).items():
        b, n = scores.shape
        ref = kernels.greedy_nms_plain(boxes, scores, nms_threshold=THRESHOLD,
                                       shift=SHIFT)
        kept, valid = int(ref.sum()), int((scores > 0).sum())
        bound_ms, bound_by = k2_work_bound(b, n)
        for name, lib in libs.items():
            n_diff = int((run(lib, boxes, scores) != ref).sum())
            print(f"{case} {name}: keep differs from the plain version in "
                  f"{n_diff} of {b * n} rows ({kept} kept of {valid} valid): "
                  f"{'agrees' if n_diff == 0 else 'DISAGREES'}", flush=True)
            if n_diff:
                wrong.add(name)
        times = {name: [] for name in libs}
        for name in order:
            lib = libs[name]
            times[name].append(time_ms(lambda: run(lib, boxes, scores),
                                       opts.reps, flush))
        for name, lib in libs.items():
            split = split_ms(lambda: run(lib, boxes, scores), K2_KERNELS)
            ms = float(np.median(times[name]))
            results[f"{case} {name}"] = dict(
                ms=times[name], split=split, bound_ms=bound_ms, kept=kept,
                valid=valid, agrees=name not in wrong)
            mark = " (DISAGREES)" if name in wrong else ""
            print(f"{case} {name}{mark} [{b}, {n}]: "
                  f"{' / '.join(f'{t:.4f}' for t in times[name])} ms "
                  f"({bound_ms / ms:.1%} of the {bound_ms:.4f} ms bound by "
                  f"{bound_by}); a call by kernel (torch.profiler): "
                  f"{json.dumps({k: round(v, 4) for k, v in split.items()})} "
                  f"{stamp}", flush=True)
    print(json.dumps(results))
    if wrong:
        raise SystemExit(f"disagree with the plain version: {sorted(wrong)}")


if __name__ == "__main__":
    main()
