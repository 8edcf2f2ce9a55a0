#!/usr/bin/env python3
"""Time the dense-block kernel K4 of this checkout, and of another one, on
one CUDA card, with each call split into its 1x1 and 3x3 kernels.

    python3 scripts/k4_compare.py [--other DIR ...] [--reps 20]
        [--dtype bf16|f32]

Builds K4's source of this checkout and, with ``--other``, the same file of
other checkouts (the parent commit unpacked by ``git archive``, say), with
the same nvcc flags: ``groomed_nms_torch/csrc/dense_block.cu`` for bf16;
for f32 ``csrc/dense_block_f32.cu`` where the checkout has it (the entry
that takes a scratch for the weights' TF32 halves) and ``dense_block.cu``'s
``dense_block_eval_f32`` where it does not (the earlier design; checkouts
that predate K4's f32 entry take bf16 only).  At each of the flagship's two
kernel blocks (``chip_smoke.K4_BLOCKS``; in f32 also DenseNet-121's
blocks 3-4, ``chip_smoke.K4_MORE_BLOCKS``), in ``--dtype``, it checks
each library against
``dense_block_eval_plain`` with chip_smoke.py's rule
(``chip_smoke.k4_agrees``), times them in
the order others, this, this, others reversed (median device ms of
``--reps`` calls, L2 flushed before each), and sums the device time of a
call's kernels by name (``chip_smoke.split_ms``).  Prints one line per
reading, each with the card's name and power limit, then one JSON object.
A library that disagrees is still timed, marked so (a variant with a part
switched off, to see what that part costs), and makes the exit code 1.
Needs a CUDA card; imports torch, numpy and groomed_nms_torch only.
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
sys.path.insert(0, str(ROOT))

from chip_smoke import (K4_BLOCKS, K4_DTYPES, K4_MORE_BLOCKS,  # noqa: E402
                        PEAK_BF16, PEAK_F32_PRODUCTS, bound, card_line,
                        dense_block_case, k4_agrees, split_ms, time_ms)
from groomed_nms_torch.ops import _build, kernels  # noqa: E402

CSRC = Path("groomed_nms_torch/csrc")
KERNEL_NAMES = ("tf32_split", "conv1x1_bn_relu", "conv3x3")


def source(checkout, dtype):
    """K4's source for ``dtype`` in ``checkout``, and whether its entry takes
    the weights' split scratch (the f32 design with a prep kernel)."""
    f32 = checkout / CSRC / "dense_block_f32.cu"
    if dtype == torch.float32 and f32.exists():
        return f32, True
    return checkout / CSRC / "dense_block.cu", False


def load(path, dtype, scratch):
    """The library at ``path``: its C entry for ``dtype``, declared, and
    for an entry that takes the split scratch its size in floats as a
    function of (cmax, L, bw, G), else None."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.dense_block_eval if dtype == torch.bfloat16 else \
        lib.dense_block_eval_f32
    fn.argtypes = [p] * (9 if scratch else 8) + [i] * 9 + [p]
    fn.restype = ctypes.c_int
    if not scratch:
        return fn, None
    size = lib.dense_block_eval_f32_scratch
    size.argtypes, size.restype = [i] * 4, ctypes.c_longlong
    return fn, size


def run(entry, x0, mul1, add1, w1, mul2, add2, w2, dilation):
    """``kernels.dense_block_eval``'s CUDA path on the C entry ``entry`` (a
    function, and the size of its split scratch or None), in ``x0``'s
    dtype."""
    fn, scratch = entry
    layers, bw, cmax = w1.shape
    growth = w2.shape[1]
    b, c0, h, w = x0.shape
    stack = torch.empty((b, cmax, h, w), dtype=x0.dtype, device=x0.device,
                        memory_format=torch.channels_last)
    stack[:, :c0].copy_(x0)
    hbuf = torch.empty((b * h * w, bw), dtype=x0.dtype, device=x0.device)
    extra = ()
    if scratch:
        wsplit = torch.empty(scratch(cmax, layers, bw, growth),
                             dtype=torch.float32, device=x0.device)
        extra = (wsplit.data_ptr(),)
    err = fn(stack.data_ptr(), hbuf.data_ptr(), *extra, mul1.data_ptr(),
             add1.data_ptr(), w1.data_ptr(), mul2.data_ptr(),
             add2.data_ptr(), w2.data_ptr(), b, h, w, c0, cmax, layers, bw,
             growth, dilation, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_block_eval failed: CUDA error {err}")
    return stack


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="other checkouts whose K4 is timed beside this one's")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=tuple(K4_DTYPES), default="bf16")
    opts = ap.parse_args()
    dtype = K4_DTYPES[opts.dtype]
    if not torch.cuda.is_available():
        raise RuntimeError("k4_compare.py needs a CUDA device")
    dev = torch.device("cuda")
    stamp = f"[{card_line()}]"
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    others = [d.resolve().name for d in opts.other]
    sources = [source(d, dtype) for d in [ROOT] + [d.resolve()
                                                   for d in opts.other]]
    with ThreadPoolExecutor(len(sources)) as pool:       # one nvcc each
        paths = list(pool.map(lambda src: _build.build(str(src[0])),
                              sources))
    libs = {name: load(path, dtype, scratch)
            for name, path, (_, scratch) in zip(["this"] + others, paths,
                                                sources)}
    order = others + ["this", "this"] + others[::-1]
    wrong = set()
    torch.backends.cudnn.allow_tf32 = False       # the plain version in f32
    results = {}
    blocks = {**K4_BLOCKS,
              **(K4_MORE_BLOCKS if dtype == torch.float32 else {})}
    for i, (block, shape) in enumerate(blocks.items()):
        *dims, dil = shape
        args = dense_block_case(np.random.default_rng(10 + i), *dims, dev,
                                dtype)
        flop, nbytes = kernels.dense_block_work(
            *dims, elem_bytes=dtype.itemsize)
        bound_ms, bound_by = bound(
            flop, nbytes,
            PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32_PRODUCTS)
        for name, lib in libs.items():
            got = run(lib, *args, dil)
            ok, _, text = k4_agrees(block, got, args, dil)
            print(f"{block} {opts.dtype} {name}: {text}: "
                  f"{'agrees' if ok else 'DISAGREES'}", flush=True)
            if not ok:
                wrong.add(name)
            del got
        times = {name: [] for name in libs}
        for name in order:
            lib = libs[name]
            times[name].append(time_ms(lambda: run(lib, *args, dil),
                                       opts.reps, flush))
        for name, lib in libs.items():
            split = split_ms(lambda: run(lib, *args, dil), KERNEL_NAMES,
                             {"tf32_split": 1, "conv1x1_bn_relu": dims[4],
                              "conv3x3": dims[4]})
            ms = float(np.median(times[name]))
            results[f"{block} {opts.dtype} {name}"] = dict(
                ms=times[name], split=split, bound_ms=bound_ms,
                agrees=name not in wrong)
            mark = " (DISAGREES)" if name in wrong else ""
            print(f"{block} {opts.dtype} {name}{mark}: "
                  f"{' / '.join(f'{t:.4f}' for t in times[name])}"
                  f" ms ({flop / 1e9 / ms:.1f} TFLOP/s, {bound_ms / ms:.1%} "
                  f"of the {bound_ms:.4f} ms bound by {bound_by}); a call by "
                  f"kernel (torch.profiler): "
                  f"{json.dumps({k: round(v, 4) for k, v in split.items()})} "
                  f"{stamp}", flush=True)
    print(json.dumps(results))
    if wrong:
        raise SystemExit(f"disagree with the plain version: {sorted(wrong)}")


if __name__ == "__main__":
    main()
