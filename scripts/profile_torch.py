"""Capture a ``torch.profiler`` trace of the flagship's serving call or
train step (the port's counterpart of ``scripts/profile.py``).

Usage:
  python scripts/profile_torch.py --mode infer --out DIR [--batch 8]
  python scripts/profile_torch.py --mode train --out DIR [--iters 3]

Infer mode profiles ``flagship.build_flagship(batch)`` (DenseNet-121, 36
anchors, acceptance, 512x1760 crops of uint8 375x1242 frames, bf16 on the
card), whose call runs K1 and K2 once a batch.  Train mode profiles
``flagship.build_flagship_train(batch)``, the counterpart of
``__graft_entry__.py::_flagship_train``: six synthetic GTs an image, so the
loss runs GrooMeD-NMS (K3 and the grouping kernel once a step) and its
after-NMS terms.  JAX's script instead builds its own step with no valid GT
(``gt_valid`` all False), which ``_flagship_train``'s docstring calls a
lighter graph than production that skips the NMS loss terms.  ``--remat``
sets the train step's ``backbone_remat``.

After one warm-up call, ``--iters`` calls run under ``torch.profiler`` (CPU
and CUDA activities), the window closed by ``torch.cuda.synchronize()``, with
the program's spans on (``groomed_nms_torch/utils/spans.py``: ``gnms.infer``,
``gnms.step``, the trunk's stages, the loss's, ...); the Chrome trace JSON is
written into ``--out`` (the counterpart of the XPlane trace, loadable in
Perfetto or chrome://tracing, where the spans show the stages).  Printed:
the card's name and power limit, the top kernels by total device time (ops
by CPU time on the CPU), the window's host ms a call beside the device's
busy ms a call (the union of the kernels' intervals; their ratio the
device's busy share, the rest idle; the profiler's own cost is in both),
each kernel's launches a call from the wrappers' counters and its device
kernels in the trace.  ``--crop`` and ``--src`` shrink the workload (the
CPU tests run it at 64x128).
"""

import argparse
import os
import sys

# run as a file, this directory comes first on sys.path, and
# scripts/profile.py there shadows the standard library's profile: the
# repository root replaces it
_HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.abspath(sys.path[0]) == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(_HERE))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("infer", "train"), default="infer")
    ap.add_argument("--out", default="torch_trace")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--remat", choices=("none", "layer", "epilogue"),
                    default="none", help="train mode: backbone_remat")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crop", type=int, nargs=2, default=(512, 1760),
                    metavar=("H", "W"))
    ap.add_argument("--src", type=int, nargs=2, default=(375, 1242),
                    metavar=("H", "W"), help="the uint8 frames' size")
    return ap.parse_args(argv)


def build(mode, batch, crop, src, device, remat="none"):
    """``run()``: one serving call or train step of the flagship on
    ``device`` (bf16 autocast on a card, f32 on the CPU)."""
    import torch

    from groomed_nms_torch.flagship import (build_flagship,
                                            build_flagship_train)

    dtype = torch.bfloat16 if device.type == "cuda" else None
    kw = dict(batch=batch, height=crop[0], width=crop[1], src_hw=tuple(src),
              device=device, compute_dtype=dtype)
    if mode == "infer":
        infer, args, _ = build_flagship(**kw)
        return lambda: infer(*args)
    step, state, raw = build_flagship_train(
        backbone_remat=False if remat == "none" else remat, **kw)
    return lambda: step(state, raw)


def main(argv=None):
    """Write the trace; returns {"trace", "launches_per_call",
    "trace_kernels", "wall_ms", "device_ms"} (both a call)."""
    args = parse_args(argv)
    import time

    from torch.profiler import ProfilerActivity, profile

    import card_measure as measure
    from groomed_nms_torch.utils import spans

    device = measure.tool_device(args.device)
    print(measure.header(device), flush=True)
    if args.remat != "none" and args.mode != "train":
        raise SystemExit("--remat applies to --mode train")
    run = build(args.mode, args.batch, args.crop, args.src, device,
                args.remat)
    run()
    measure.sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    measure.reset_launches()
    spans.enable(True)
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                run()
            measure.sync(device)
            wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
    finally:
        spans.enable(False)
    per_call = {k: v / args.iters for k, v in measure.launches().items()}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.mode}_trace.json")
    prof.export_chrome_trace(path)
    in_trace = measure.trace_counts(path)
    device_ms = measure.trace_kernel_ms(path) / args.iters
    key = "self_cuda_time_total" if device.type == "cuda" \
        else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=key, row_limit=15), flush=True)
    print(f"{args.mode}, batch {args.batch}, {args.crop[0]}x{args.crop[1]}"
          f"{', remat ' + args.remat if args.remat != 'none' else ''}, "
          f"{args.iters} calls: {wall_ms:.2f} ms a call on the host, "
          f"{device_ms:.2f} ms of device busy time a call; kernel launches a "
          f"call "
          + ", ".join(f"{k} {v:g}" for k, v in per_call.items())
          + "; device kernels in the trace "
          + ", ".join(f"{k} {v}" for k, v in in_trace.items()), flush=True)
    print("trace written to", path, flush=True)
    return dict(trace=path, launches_per_call=per_call,
                trace_kernels=in_trace, wall_ms=wall_ms, device_ms=device_ms)


if __name__ == "__main__":
    main()
