"""Serving latency of the port: blocking per-call latency and the pipelined
rate, across batch sizes (the counterpart of ``analysis/bench_latency.py``).

For each batch size, ``flagship.build_flagship(batch=b)`` (DenseNet-121, 36
anchors, acceptance, greedy NMS on K2, 512x1760 crops of uint8 375x1242
frames, bf16 on the card) gives two columns:

- blocking: ms a call when each call ends in a host read of its result
  (queue depth 1: a request is served when its rows are on the host);
- pipelined: ``--queue`` calls enqueued back to back and closed by one
  ``torch.cuda.synchronize()``: ms a call and img/s.

Usage:
  python analysis/bench_latency_torch.py [--batches 1 2 8] [--iters 30] \
      [--queue 40] [--device cuda]

Prints the card's name and power limit, then the table.  ``--crop`` and
``--src`` shrink the workload (the CPU tests run it at 64x128).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 8])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--queue", type=int, default=40,
                    help="calls in flight for the pipelined column")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crop", type=int, nargs=2, default=(512, 1760),
                    metavar=("H", "W"))
    ap.add_argument("--src", type=int, nargs=2, default=(375, 1242),
                    metavar=("H", "W"), help="the uint8 frames' size")
    return ap.parse_args(argv)


def main(argv=None):
    """Print the table; returns its rows, {batch, blocking_ms,
    pipelined_ms, img_per_s} a batch size."""
    args = parse_args(argv)
    import torch

    from groomed_nms_torch.flagship import build_flagship
    from groomed_nms_torch.utils import measure

    device = measure.tool_device(args.device)
    print(measure.header(device), flush=True)
    dtype = torch.bfloat16 if device.type == "cuda" else None
    print(f"{'batch':>5} {'blocking ms/call':>17} {'ms/img':>7} "
          f"{'pipelined ms/call':>18} {'img/s':>7}", flush=True)
    rows = []
    for batch in args.batches:
        infer, fargs, _ = build_flagship(
            batch=batch, height=args.crop[0], width=args.crop[1],
            src_hw=tuple(args.src), device=device, compute_dtype=dtype)
        dets, valid = infer(*fargs)
        valid.cpu()

        # blocking: each call waits for its rows on the host
        t0 = time.perf_counter()
        for _ in range(args.iters):
            dets, valid = infer(*fargs)
            dets.cpu(), valid.cpu()
        block_ms = (time.perf_counter() - t0) / args.iters * 1e3

        # pipelined: a deep queue of calls, one synchronize at the end
        measure.sync(device)
        t0 = time.perf_counter()
        for _ in range(args.queue):
            infer(*fargs)
        measure.sync(device)
        pipe_ms = (time.perf_counter() - t0) / args.queue * 1e3

        rows.append(dict(batch=batch, blocking_ms=block_ms,
                         pipelined_ms=pipe_ms,
                         img_per_s=batch / pipe_ms * 1e3))
        print(f"{batch:>5} {block_ms:>17.2f} {block_ms / batch:>7.2f} "
              f"{pipe_ms:>18.2f} {batch / pipe_ms * 1e3:>7.1f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
