#!/usr/bin/env python3
"""Time the IoU/prune kernel K3 and the GrooMeD operator of this checkout,
and of other ones, on one CUDA card.

    python3 scripts/k3_compare.py [--other DIR ...] [--reps 50]

K3: builds ``groomed_nms_torch/csrc/iou_prune.cu`` of this checkout and,
with ``--other``, of other checkouts (the parent commit unpacked by ``git
archive``, say), with the same nvcc flags, and loads each library with the
same C entry.  At ``chip_smoke.K3_SHAPES`` ([8, 512] clustered boxes with
padding rows, [1, 1000] the analysis recipe) it checks each library's IoU
and linear prune against ``fused_iou_prune_plain`` (identical, or the
library is marked) and times them in the order others, this, this, others
reversed (median device ms of ``--reps`` calls, L2 flushed before each),
with a yardstick after each turn of this checkout: ``zero_()`` of one f32
tensor as large as K3's two outputs, the same bytes written and nothing
computed.

The operator: each checkout in a process of its own (two checkouts hold
packages of one name), in the same order.  A process puts its checkout's
package first on the path, loads this checkout's ``chip_smoke.py`` (its
``operator_inputs`` and ``operator_split``) and prints one JSON line: the
host ms of ``groomed_nms_boxes`` (mean of ``--reps`` synchronised calls) and
its split by stage at both shapes, and the host ms of a batch of the
flagship served with GrooMeD-NMS (``build_flagship(differentiable_nms=
True)``: batch 8, 512x1760, bf16, seeded weights; mean of 10 after 3).

Prints one line per reading, each with the card's name and power limit,
then one JSON object.  A library that disagrees is still timed, marked so,
and makes the exit code 1.  Needs a CUDA card; imports torch, numpy and the
checkouts' packages only.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("groomed_nms_torch/csrc/iou_prune.cu")
# run as a file, this directory comes first on sys.path, and
# scripts/profile.py there shadows the standard library's profile (which
# the custom ops' first call imports through torch._dynamo)
if Path(sys.path[0]).resolve() == ROOT / "scripts":
    sys.path.pop(0)


def load(path):
    """The K3 library at ``path`` with its C entry declared."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.iou_prune.argtypes = [p, p, p, p, i, i, i, f, f, f, p]
    lib.iou_prune.restype = ctypes.c_int
    return lib


def run(lib, boxes, valid):
    """``kernels.fused_iou_prune``'s CUDA path (linear, shift 0) on ``lib``."""
    import torch
    b, n, _ = boxes.shape
    iou = torch.empty((b, n, n), dtype=torch.float32, device=boxes.device)
    prune = torch.empty_like(iou)
    err = lib.iou_prune(boxes.data_ptr(), valid.data_ptr(), iou.data_ptr(),
                        prune.data_ptr(), b, n, 0, 0.4, 0.1, 0.0,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"iou_prune failed: CUDA error {err}")
    return iou, prune


def measure_operator(root, reps):
    """One reading of the operator of the checkout at ``root``, in this
    process: {shape name: {ms, split}, "served": ms a batch}."""
    sys.path.insert(0, str(root))
    import torch
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from groomed_nms_torch.flagship import build_flagship
    from groomed_nms_torch.ops.groomed_nms import groomed_nms_boxes
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for name in smoke.K3_SHAPES:
        args = smoke.operator_inputs(name, dev)
        out[name] = dict(
            ms=smoke.wall_ms(lambda: groomed_nms_boxes(*args), reps),
            split=smoke.operator_split(*args, flush, reps))
    torch.backends.cudnn.benchmark = True
    infer, served, _ = build_flagship(device="cuda", differentiable_nms=True)
    for _ in range(3):
        infer(*served)
    out["served"] = smoke.wall_ms(lambda: infer(*served), 10)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="other checkouts timed beside this one")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--operator", type=Path, default=None,
                    help=argparse.SUPPRESS)    # one operator reading
    opts = ap.parse_args()
    if opts.operator is not None:
        print(json.dumps(measure_operator(opts.operator.resolve(),
                                          opts.reps // 2)))
        return

    sys.path.insert(0, str(ROOT))
    import torch
    from chip_smoke import (K3_SHAPES, PEAK_F32, bound, card_line,
                            k3_case, time_ms)
    from groomed_nms_torch.ops import _build, kernels

    if not torch.cuda.is_available():
        raise RuntimeError("k3_compare.py needs a CUDA device")
    dev = torch.device("cuda")
    stamp = f"[{card_line()}]"
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    roots = {"this": ROOT, **{d.resolve().name: d.resolve()
                              for d in opts.other}}
    others = [name for name in roots if name != "this"]
    order = others + ["this", "this"] + others[::-1]
    with ThreadPoolExecutor(len(roots)) as pool:          # one nvcc each
        paths = list(pool.map(lambda r: _build.build(str(r / SOURCE)),
                              roots.values()))
    libs = {name: load(path) for name, path in zip(roots, paths)}
    wrong = set()
    results = {}
    for case, (b, n) in K3_SHAPES.items():
        boxes_np, scores_np = k3_case(case, b, n)
        boxes = torch.from_numpy(boxes_np).to(dev)
        valid = torch.from_numpy(scores_np > 0).to(dev)
        ref_iou, ref_prune = kernels.fused_iou_prune_plain(boxes, valid)
        bound_ms, bound_by = bound(*kernels.iou_prune_work(b, n), PEAK_F32)
        for name, lib in libs.items():
            iou, prune = run(lib, boxes, valid)
            agrees = torch.equal(iou, ref_iou) and torch.equal(prune,
                                                               ref_prune)
            print(f"K3 {case} {name}: IoU and linear prune "
                  f"{'identical' if agrees else 'DIFFER'}", flush=True)
            if not agrees:
                wrong.add(name)
        fill = torch.empty(2 * b * n * n, dtype=torch.float32, device=dev)
        times = {name: [] for name in libs}
        times["fill"] = []
        for name in order:
            lib = libs[name]
            times[name].append(time_ms(lambda: run(lib, boxes, valid),
                                       opts.reps, flush))
            if name == "this":
                times["fill"].append(time_ms(fill.zero_, opts.reps, flush))
        del fill
        for name in times:
            ms = float(np.median(times[name]))
            results[f"K3 {case} {name}"] = dict(ms=times[name],
                                                bound_ms=bound_ms)
            mark = " (DISAGREES)" if name in wrong else ""
            print(f"K3 {case} {name}{mark} [{b}, {n}, 4]: "
                  f"{' / '.join(f'{t:.4f}' for t in times[name])} ms "
                  f"({bound_ms / ms:.1%} of the {bound_ms:.4f} ms bound by "
                  f"{bound_by}) {stamp}", flush=True)
    del libs
    torch.cuda.empty_cache()

    readings = {name: [] for name in roots}
    for name in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--operator",
             str(roots[name]), "--reps", str(opts.reps)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"operator reading of {name} failed:\n"
                               f"{proc.stderr[-4000:]}")
        readings[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for name, runs in readings.items():
        for case in K3_SHAPES:
            ms = [r[case]["ms"] for r in runs]
            print(f"operator {case} {name}: host "
                  f"{' / '.join(f'{t:.4f}' for t in ms)} ms; split (last "
                  f"turn) {json.dumps(runs[-1][case]['split'])} {stamp}",
                  flush=True)
            results[f"operator {case} {name}"] = [r[case] for r in runs]
        served = [r["served"] for r in runs]
        print(f"served with GrooMeD {name}: "
              f"{' / '.join(f'{t:.2f}' for t in served)} ms a batch of 8 "
              f"{stamp}", flush=True)
        results[f"served {name}"] = served
    print(json.dumps(results))
    if wrong:
        raise SystemExit(f"disagree with the plain version: {sorted(wrong)}")


if __name__ == "__main__":
    main()
