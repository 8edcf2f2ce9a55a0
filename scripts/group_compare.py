#!/usr/bin/env python3
"""Time the GrooMeD grouping kernel's two paths against each other on one
CUDA card.

    python3 scripts/group_compare.py [--reps 50] [--shapes 8x512 1x1000 ...]

Builds ``groomed_nms_torch/csrc/group_leaders.cu`` and, at each [B, N],
launches it by the plan ``kernels.group_leaders_plan`` gives and, where
that is the cluster path (N <= 1024), also by the two-kernel path (the bits
and sweep kernels, the earlier design), forced here.
The input at [8, 512] and [1, 1000] is the operator's own (K3's IoU of
``chip_smoke.k3_case``'s sorted rows, as ``chip_smoke.group_phase`` times
it), elsewhere ``chip_smoke.group_case``'s clustered IoU with padding rows.
Each plan's leaders are checked against ``group_leaders_plain`` at group
sizes -1, 0, 1 and 100 (identical, or the plan is marked and the exit code
is 1), then the plans are timed in the order given and in reverse (median
device ms of ``--reps`` calls, the L2 flushed before each, as
``chip_smoke.time_ms``), beside the bound of ``kernels.group_leaders_work``.

Prints one line per shape, each with the card's name and power limit, then
one JSON object.  Needs a CUDA card; imports torch, numpy and this
checkout's package and ``chip_smoke.py``, no JAX.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# run as a file, this directory comes first on sys.path, and
# scripts/profile.py there shadows the standard library's profile (which
# torch.profiler imports): the repository root replaces it
if Path(sys.path[0]).resolve() == ROOT / "scripts":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))
DEFAULT_SHAPES = ("8x512", "1x1000", "8x1000", "1x1024")


def load_smoke():
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def plans(kernels, n):
    """{label: GroupPlan} of the paths to time at N: the planned one and,
    below the cluster path's limit, the two-kernel path forced (its sweep's
    shared memory is the C entry's own business, so none is given)."""
    plan = kernels.group_leaders_plan(n)
    out = {plan.path: plan}
    if plan.path == "cluster":
        out["two_kernel"] = kernels.GroupPlan("two_kernel", 0, None)
    return out


def case(smoke, kernels, b, n, dev):
    """The input at [b, n]: (m, valid, what)."""
    import torch
    for name, shape in smoke.K3_SHAPES.items():
        if shape == (b, n):
            boxes_np, scores_np = smoke.k3_case(name, b, n)
            valid = torch.from_numpy(scores_np > 0).to(dev)
            m = kernels.fused_iou_prune(torch.from_numpy(boxes_np).to(dev),
                                        valid)[0]
            return m, valid, f"the operator's input ({name})"
    m, valid = smoke.group_case(b, n, "iou", dev, seed=b * n)
    return m, valid, "clustered IoU, padding rows"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--shapes", nargs="+", default=list(DEFAULT_SHAPES),
                    help="BxN, e.g. 8x512")
    args = ap.parse_args(argv)
    import torch
    smoke = load_smoke()
    from groomed_nms_torch.ops import kernels
    from groomed_nms_torch.utils.measure import PEAK_F32, bound, card_line
    if not torch.cuda.is_available():
        raise RuntimeError("group_compare.py needs a CUDA card")
    dev = torch.device("cuda")
    stamp = f"[{card_line()}]"
    print(stamp[1:-1], flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    results, ok = {}, True
    for shape in args.shapes:
        b, n = (int(x) for x in shape.split("x"))
        m, valid, what = case(smoke, kernels, b, n, dev)
        by_plan = plans(kernels, n)
        row = {}
        for label, plan in by_plan.items():
            same = True
            for gs in (-1, 0, 1, 100):
                got = kernels._group_leaders_launch(m, valid, 0.4, gs, plan)
                ref = kernels.group_leaders_plain(
                    m, valid, nms_threshold=0.4, group_size=gs)
                same &= bool(torch.equal(got, ref))
            ok &= same
            row[label] = {"plan": plan._asdict(), "identical": same,
                          "ms": []}
        order = list(by_plan) + list(reversed(by_plan))
        for label in order:
            plan = by_plan[label]
            row[label]["ms"].append(smoke.time_ms(
                lambda: kernels._group_leaders_launch(m, valid, 0.4, 100,
                                                      plan),
                args.reps, flush))
        bound_ms, bound_by = bound(*kernels.group_leaders_work(b, n),
                                   PEAK_F32)
        results[shape] = {"input": what, "bound_ms": bound_ms,
                          "bound_by": bound_by, "plans": row}
        readings = "; ".join(
            f"{k}{'' if v['identical'] else ' (DIFFERS)'} "
            f"{' / '.join(f'{t:.4f}' for t in v['ms'])} ms"
            for k, v in row.items())
        print(f"group_leaders [{b}, {n}], {what}, {int(valid.sum())} valid "
              f"rows: {readings}; bound {bound_ms:.4f} ms ({bound_by}) "
              f"{stamp}", flush=True)
    print(json.dumps({"card": stamp[1:-1], "reps": args.reps,
                      "shapes": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
