"""Roofline of the port's flagship train step (or serving call) on the card
(the counterpart of ``analysis/roofline_train.py``).

Method: one call is counted, then ``--iters`` calls are timed apart from
the counting.
- Logical FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one call
  (convolutions and matrix products, forward and backward).
- Logical traffic: the bytes of every ATen op's input and output tensors
  over one call, under a ``TorchDispatchMode`` (views, which move nothing,
  left out): the analogue of XLA's "bytes accessed" for an unfused
  program.  The kernels are counted the same way: K1-K3 and the grouping
  are the ``torch.ops.groomed_nms.*`` custom ops, seen by the dispatcher
  with their inputs and outputs; no kernel of these paths runs outside it.
- Timing: ``--iters`` calls after a warm-up, closed by
  ``torch.cuda.synchronize()``.
The achieved FLOP/s is held against the H100's 989 TFLOP/s bf16 tensor
peak and the traffic against what 3.35 TB/s moves in the window
(``utils/measure.py``).  As the JAX tool does, it refuses to print a
roofline when the implied FLOP/s exceeds the peak: the timing did not
await the card.

Usage:
  python analysis/roofline_train_torch.py [--mode train|infer] [--batch 8] \
      [--iters 30] [--trace DIR] [--remat none|layer|epilogue]

Train mode is ``flagship.build_flagship_train(batch, backbone_remat=...)``
(DenseNet-121, GrooMeD-NMS in the loss, SGD, bf16 autocast on the card);
infer mode ``flagship.build_flagship(batch)``.  ``--crop`` and ``--src``
shrink the workload (the CPU tests run it at 64x128).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("train", "infer"), default="train")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--trace", default=None,
                    help="also write a torch.profiler trace of one call "
                         "into this directory")
    ap.add_argument("--remat", choices=("none", "layer", "epilogue"),
                    default="none",
                    help="train mode: recompute whole dense layers or their "
                         "BN2/ReLU/conv2 tails in the backward pass")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crop", type=int, nargs=2, default=(512, 1760),
                    metavar=("H", "W"))
    ap.add_argument("--src", type=int, nargs=2, default=(375, 1242),
                    metavar=("H", "W"), help="the uint8 frames' size")
    return ap.parse_args(argv)


def _nbytes(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def count(fn):
    """(FLOPs, bytes, kernel bytes) of one call of ``fn``: FlopCounterMode's
    total, and the input + output tensor bytes of every ATen op that is not
    a view, of which ``kernel bytes`` are the ``groomed_nms`` custom ops'."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    class Traffic(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = self.kernels = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                n = _nbytes(args) + _nbytes(kwargs or {}) + _nbytes(out)
                self.total += n
                if func.namespace == "groomed_nms":
                    self.kernels += n
            return out

    flops = FlopCounterMode(display=False)
    traffic = Traffic()
    with flops, traffic:
        fn()
    return flops.get_total_flops(), traffic.total, traffic.kernels


def roofline(mode, batch, flops, nbytes, kernel_bytes, dt):
    """The JSON fields for one call of ``flops`` and ``nbytes`` taking
    ``dt`` seconds; SystemExit when the implied FLOP/s exceeds the card's
    bf16 peak."""
    from groomed_nms_torch.utils.measure import PEAK_BF16, PEAK_BYTES

    if flops / dt > PEAK_BF16:
        raise SystemExit(
            f"implied {flops / dt / 1e12:.1f} TFLOP/s exceeds the "
            f"{PEAK_BF16 / 1e12:.0f} TFLOP/s peak: timing did not await "
            "the card -- refusing to print a roofline from it")
    gb = nbytes / 1e9
    achieved = flops / dt / 1e12
    window_gb = PEAK_BYTES * dt / 1e9
    pct = 100 * achieved / (PEAK_BF16 / 1e12)
    return {
        "mode": mode, "batch": batch,
        "ms_per_call": round(1000 * dt, 4),
        "img_per_sec": round(batch / dt, 2),
        "logical_tflop_per_call": round(flops / 1e12, 4),
        "logical_traffic_gb_per_call": round(gb, 3),
        "kernel_traffic_gb_per_call": round(kernel_bytes / 1e9, 4),
        "kernels_outside_dispatcher": [],
        "achieved_tflops": round(achieved, 3),
        "pct_of_tensor_peak": round(pct, 2),
        "hbm_movable_in_window_gb": round(window_gb, 3),
        "traffic_elision_needed_pct": round(
            100 * max(0.0, 1.0 - window_gb / gb), 1) if gb else 0.0,
        # logical traffic beyond what the memory moves in the window: the
        # fused kernels elide the rest and the step presses on memory; a
        # high tensor-core share with traffic to spare would say FLOP-bound
        "binding_resource": (
            "memory (logical traffic > HBM window: fusion elides the rest)"
            if gb > window_gb else
            "tensor cores" if pct > 50 else
            "neither saturated (launch / serial latency bound)"),
    }


def build(mode, batch, crop, src, remat, device):
    """``run()``: one call of the workload, returning a small tensor."""
    import torch

    from groomed_nms_torch.flagship import (build_flagship,
                                            build_flagship_train)

    dtype = torch.bfloat16 if device.type == "cuda" else None
    kw = dict(batch=batch, height=crop[0], width=crop[1], src_hw=tuple(src),
              device=device, compute_dtype=dtype)
    if mode == "train":
        step, state, raw = build_flagship_train(
            backbone_remat=False if remat == "none" else remat, **kw)
        return lambda: step(state, raw)["total"]
    infer, args, _ = build_flagship(**kw)
    return lambda: infer(*args)[1]


def main(argv=None):
    """Print and return the roofline's JSON fields."""
    args = parse_args(argv)
    if args.remat != "none" and args.mode != "train":
        raise SystemExit("--remat applies to --mode train")
    from groomed_nms_torch.utils import measure

    device = measure.tool_device(args.device)
    card = measure.header(device)
    print(card, flush=True)
    run = build(args.mode, args.batch, args.crop, args.src, args.remat,
                device)
    run()                                          # warm-up
    measure.sync(device)
    flops, nbytes, kbytes = count(run)
    measure.sync(device)
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            run()
            measure.sync(device)
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, f"roofline_{args.mode}.json")
        prof.export_chrome_trace(path)
        print(f"trace -> {path}", flush=True)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        run()
    measure.sync(device)
    dt = (time.perf_counter() - t0) / args.iters
    result = roofline(args.mode, args.batch, flops, nbytes, kbytes, dt)
    result.update(remat=args.remat, device=card)
    print(json.dumps(result, indent=2), flush=True)
    return result


if __name__ == "__main__":
    main()
