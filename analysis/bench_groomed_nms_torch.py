"""Micro-benchmark of the port's GrooMeD-NMS operator and of K3 at N boxes
(the counterpart of ``analysis/bench_groomed_nms.py``).

The full operator is ``ops/iou.py::pairwise_iou`` then
``ops/groomed_nms.py::differentiable_nms(...).rescored`` (sort, prune,
the grouping kernel on the card, masked rescore), in Mboxes/s; K3 alone is
``ops/kernels.py::fused_iou_prune`` in Gpairs/s.  The boxes and scores are
the JAX tool's, drawn from numpy ``default_rng(0)``.

Before it times, each is checked against its plain version by the smoke
run's rules: K3's IoU identical to ``fused_iou_prune_plain``,
and the operator's leaders and keep identical to the CPU path's with its
rescored values within 1e-6.  If either differs, no number is printed and
the tool raises.

Usage: python analysis/bench_groomed_nms_torch.py [N] [iters] [--device cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np

OPERATOR_ATOL = 1e-6


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1000)
    ap.add_argument("iters", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def inputs(n):
    """[N, 4] f32 boxes and [N] f32 scores, the JAX tool's draws."""
    rng = np.random.default_rng(0)
    x1 = rng.uniform(0, 1600, n)
    y1 = rng.uniform(0, 480, n)
    w = rng.uniform(30, 300, n)
    h = rng.uniform(30, 200, n)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
    return boxes, rng.uniform(0, 1, n).astype(np.float32)


def operator(scores, boxes):
    """The timed operator: GrooMeD-NMS of ``scores`` [N] over the pairwise
    IoU of ``boxes`` [N, 4], at the operator's defaults."""
    from groomed_nms_torch.ops.groomed_nms import differentiable_nms
    from groomed_nms_torch.ops.iou import pairwise_iou
    return differentiable_nms(scores, pairwise_iou(boxes, boxes))


def check(scores, boxes):
    """The operator against the CPU path (leaders and keep identical,
    rescored within OPERATOR_ATOL) and K3 against its plain version (IoU
    identical); raises if either differs.  Returns (rescored max |err|,
    kept, grouped)."""
    import torch

    from groomed_nms_torch.ops import kernels

    got = operator(scores, boxes)
    ref = operator(scores.cpu(), boxes.cpu())
    err = (got.rescored.cpu() - ref.rescored).abs().max().item()
    if not (torch.equal(got.leader.cpu(), ref.leader)
            and torch.equal(got.keep.cpu(), ref.keep)
            and err <= OPERATOR_ATOL):
        raise AssertionError(f"the operator differs from the CPU path "
                             f"(rescored max|err| {err:.3e})")
    iou, _ = kernels.fused_iou_prune(boxes[None])
    ref_iou, _ = kernels.fused_iou_prune_plain(
        boxes[None], torch.ones((1, len(boxes)), dtype=torch.bool,
                                device=boxes.device))
    if not torch.equal(iou, ref_iou):
        raise AssertionError("K3's IoU differs from its plain version")
    return err, int(ref.keep.sum()), int((ref.leader >= 0).sum())


def main(argv=None):
    """Check, then time; returns {"operator_ms", "mboxes_per_s", "k3_ms",
    "gpairs_per_s", "launches_per_call", "rescored_err"}."""
    args = parse_args(argv)
    n, iters = args.n, args.iters
    import torch

    from groomed_nms_torch.ops import kernels
    import card_measure as measure

    device = measure.tool_device(args.device)
    print(measure.header(device), flush=True)
    boxes_np, scores_np = inputs(n)
    boxes = torch.from_numpy(boxes_np).to(device)
    scores = torch.from_numpy(scores_np).to(device)
    err, kept, grouped = check(scores, boxes)
    print(f"checked at N={n}: leaders and keep identical to the CPU path "
          f"({kept} kept, {grouped} grouped), rescored max|err| {err:.3e} "
          f"(atol {OPERATOR_ATOL:g}); K3 IoU identical to its plain version",
          flush=True)

    measure.sync(device)
    measure.reset_launches()
    t0 = time.perf_counter()
    for _ in range(iters):
        r = operator(scores, boxes).rescored
    r.cpu()
    dt = (time.perf_counter() - t0) / iters
    op_launches = measure.launches()
    print(f"groomed_nms N={n}: {dt * 1000:.4f} ms "
          f"-> {n / dt / 1e6:.4f} Mboxes/s", flush=True)

    rows = boxes[None].contiguous()
    kernels.fused_iou_prune(rows)
    measure.sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        kernels.fused_iou_prune(rows)
    measure.sync(device)
    dk = (time.perf_counter() - t0) / iters
    print(f"fused_iou_prune N={n}: {dk * 1000:.4f} ms "
          f"-> {n * n / dk / 1e9:.4f} Gpairs/s", flush=True)
    per_call = {k: v / iters for k, v in op_launches.items()}
    print("kernel launches a call of the operator: "
          + ", ".join(f"{k} {v:g}" for k, v in per_call.items()), flush=True)
    return dict(operator_ms=dt * 1e3, mboxes_per_s=n / dt / 1e6,
                k3_ms=dk * 1e3, gpairs_per_s=n * n / dk / 1e9,
                launches_per_call=per_call, rescored_err=err)


if __name__ == "__main__":
    main()
