"""What the port's measurement tools share: the card's line, its peaks, the
least time of a piece of work, the device a tool runs on, and the kernels'
names in a profiler trace.

``chip_smoke.py`` and the tool twins under ``scripts/`` and ``analysis/``
import these; none of them runs at import.
"""

from __future__ import annotations

import json
import subprocess

import torch

# the H100 SXM's published peaks (dense, 700 W): bf16 tensor-core FLOP/s,
# f32 FLOP/s outside the tensor cores, device-memory bytes/s, TF32
# tensor-core FLOP/s
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_TF32 = 494.7e12
# the fastest route to products at f32 accuracy: three TF32 products for
# one on the tensor cores (3xTF32, PEAK_TF32 / 3), or f32 FMA, whichever is
# faster (the former: 164.9 TFLOP/s)
PEAK_F32_PRODUCTS = max(PEAK_TF32 / 3, PEAK_F32)

# the port's kernels by wrapper name, and the device kernels of each of
# which one runs once a wrapper launch (substrings of the profiler's kernel
# names): K1's Triton kernel, K2's sweep (after its mask kernel), K3, and
# the grouping's cluster kernel or, on its two-kernel path, its sweep (after
# its bits kernel)
TRACE_KERNELS = {"fused_head_scores": ("head_scores",),
                 "greedy_nms": ("nms_sweep",),
                 "fused_iou_prune": ("iou_prune_kernel",),
                 "group_leaders": ("group_cluster", "group_sweep")}


def card_line():
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(ops, nbytes, peak_ops):
    """The least time of a kernel's work on the card, (ms, limiter): the
    larger of its operations over ``peak_ops`` and its bytes (each input read
    once, each output written once) over the memory rate."""
    ops_ms, bytes_ms = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def tool_device(name):
    """The device a tool runs on: ``name`` ("cuda" by default in the
    tools, "cpu" when asked).  A CUDA device without a card raises: a
    measurement never falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device (pass --device "
                           "cpu to run on the CPU)")
    return device


def header(device):
    """The line a tool prints before any number: the card's name and power
    limit on a CUDA device, else the device."""
    if device.type == "cuda":
        return card_line()
    return f"device {device} (not a card: no number here is a card's)"


def sync(device):
    """Close a timing window: wait for the card's queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches():
    """{wrapper name: launches so far} of the port's four main-path
    kernels (``ops/kernels.py``'s counters)."""
    from ..ops import kernels
    return {n: getattr(kernels, n).launches for n in TRACE_KERNELS}


def reset_launches():
    from ..ops import kernels
    for n in TRACE_KERNELS:
        getattr(kernels, n).launches = 0


def _kernel_events(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat", "").lower() == "kernel"]


def trace_counts(path):
    """{wrapper name: device kernels of that name} in a Chrome trace JSON
    written by ``torch.profiler`` (events of category "kernel")."""
    names = [e.get("name", "") for e in _kernel_events(path)]
    return {k: sum(any(v in n for v in vs) for n in names)
            for k, vs in TRACE_KERNELS.items()}


def trace_kernel_ms(path):
    """The device's busy time (ms) in a Chrome trace JSON written by
    ``torch.profiler``: the length of the union of its kernels' intervals,
    so kernels that overlap (on other streams) count once."""
    ivs = sorted((float(k["ts"]), float(k["ts"]) + float(k.get("dur", 0.0)))
                 for k in _kernel_events(path))
    busy, end = 0.0, float("-inf")
    for s, e in ivs:
        busy += max(e - max(s, end), 0.0)
        end = max(end, e)
    return busy / 1e3
