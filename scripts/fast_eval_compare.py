#!/usr/bin/env python3
"""Time the fast_eval engine of this checkout, and of other ones, on one
CUDA card: its trunk, each K4 block, the whole model and a served batch.

    python3 scripts/fast_eval_compare.py [--other DIR ...] [--reps 10]

Each checkout runs in a process of its own (two checkouts hold packages of
one name), in the order others, this, this, others reversed.  A process
imports its checkout's ``groomed_nms_torch``, loads this checkout's
``card_measure.py`` by path (so a checkout without one can be compared),
builds the flagship's fast_eval engine (``build_flagship(engine=
"fast_eval")``: batch 8, 512x1760, bf16, seeded weights), and prints one
JSON line: the median device ms (``card_measure.time_ms``, L2 flushed
before each of ``--reps`` runs) of the trunk, of each K4 block on its own
input, of the trunk outside K4 and of the whole model, and the host ms of
a served batch through ``make_infer`` (mean of ``--reps``, synchronised),
and the device ms of one trunk call by ATen operator (``torch.profiler``,
the largest ``TOP_OPS``).  Then one line per checkout with its readings, each with the
card's name and power limit.
Needs a CUDA card; imports torch, this checkout's ``card_measure.py`` and
the checkouts' packages only.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# run as a file, this directory comes first on sys.path, and
# scripts/profile.py there shadows the standard library's profile (which
# the custom ops' first call imports through torch._dynamo)
if Path(sys.path[0]).resolve() == ROOT / "scripts":
    sys.path.pop(0)
TOP_OPS = 16


def by_op(fn):
    """Device ms of one call of ``fn`` per ATen operator (the kernels each
    launched, ``torch.profiler``), the TOP_OPS largest; an operator that
    calls another counts the other's kernels too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")    # the profiler can miss its first
        torch.cuda.synchronize()         # kernel: a throwaway one
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if e.key.startswith("aten::") and us > 0:
            out[e.key] = us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:TOP_OPS])


def measure(root, reps):
    """One reading of the checkout at ``root``, in this process."""
    sys.path.insert(0, str(root))
    import torch
    spec = importlib.util.spec_from_file_location("card_measure",
                                                  ROOT / "card_measure.py")
    cm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cm)
    from groomed_nms_torch.data.augment import preprocess_images
    from groomed_nms_torch.flagship import build_flagship
    from groomed_nms_torch.models.fast_eval import KernelDenseBlock

    torch.backends.cudnn.benchmark = True
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    infer, args, engine = build_flagship(device="cuda", engine="fast_eval")
    images_u8, means, stds = args[:3]
    with torch.inference_mode():
        images = preprocess_images(images_u8, None, means, stds, target_h=512,
                                   crop_w=1760, out_dtype=torch.bfloat16)
        bb = engine.backbone
        x = bb.stem(images)
        blocks = []
        for stage in bb.stages:
            if isinstance(stage, KernelDenseBlock):
                blocks.append((stage, x))
            x = stage(x)
        (blk1, x1), (blk2, x2) = blocks
        out = {name: cm.time_ms(fn, reps, flush) for name, fn in (
            ("trunk", lambda: bb(images)), ("K4 block1", lambda: blk1(x1)),
            ("K4 block2", lambda: blk2(x2)), ("model", lambda: engine(images)))}
        split = by_op(lambda: bb(images))
    out["trunk outside K4"] = out["trunk"] - out["K4 block1"] - out["K4 block2"]
    out["served batch (host)"] = cm.wall_ms(lambda: infer(*args), reps)
    out["card"] = cm.card_line()
    out["trunk by op"] = split
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="other checkouts timed beside this one")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.child is not None:
        print(json.dumps(measure(opts.child.resolve(), opts.reps)),
              flush=True)
        return
    roots = {"this": ROOT, **{d.resolve().name: d.resolve()
                              for d in opts.other}}
    others = [name for name in roots if name != "this"]
    readings = {name: [] for name in roots}
    for name in others + ["this", "this"] + others[::-1]:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(roots[name]), "--reps", str(opts.reps)],
            capture_output=True, text=True, cwd=roots[name])
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed:\n{proc.stderr[-4000:]}")
        readings[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for name, runs in readings.items():
        keys = [k for k in runs[0] if k not in ("card", "trunk by op")]
        line = {k: [round(r[k], 4) for r in runs] for k in keys}
        medians = {k: round(float(np.median(v)), 4) for k, v in line.items()}
        split = {k: round(v, 4) for k, v in runs[0]["trunk by op"].items()}
        print(f"{name}: ms {json.dumps(line)}; medians {json.dumps(medians)}; "
              f"one trunk call by operator {json.dumps(split)} "
              f"[{runs[0]['card']}]", flush=True)
    print(json.dumps(readings))


if __name__ == "__main__":
    main()
