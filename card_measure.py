"""What the port's card measurements share: the card's line and peaks, the
least time of a piece of work, the timers, the kernels in a profiler trace,
and the main path's shapes and inputs with the rule that holds K4 to its
plain version.

``chip_smoke.py`` checks the port on the card with these; the compare
scripts (``scripts/*_compare.py``) time its kernels with them, and the
tool twins under ``scripts/`` and ``analysis/`` read the card and the
launch counters through them.  At import this module loads only the
standard library, numpy and torch: ``groomed_nms_torch`` is imported inside
the functions that use it, so a compare script can load this file by path
into a process that runs another checkout's package.  Nothing runs at
import.
"""

import json
import subprocess
import time

import numpy as np
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

K2_SHAPE = (8, 3000)                  # nms_topN_pre rows per image
K3_SHAPES = {"train": (8, 512), "analysis": (1, 1000)}
# K4 at the flagship's kernel blocks: (B, c0, H, W, L, G, bw, dilation)
K4_BLOCKS = {"block1": (8, 64, 128, 440, 6, 32, 128, 1),
             "block2": (8, 128, 64, 220, 12, 32, 128, 1)}
# and at DenseNet-121's blocks 3-4, which fast_eval runs with K4 when asked
K4_MORE_BLOCKS = {"block3": (8, 256, 32, 110, 24, 32, 128, 1),
                  "block4": (8, 512, 32, 110, 16, 32, 128, 2)}
K4_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# K4 vs its plain version over the new channels: max |err| / max |ref| and
# mean |err| / mean |ref|; the two sum in other orders, so a bf16 rounding
# of h or of an output may land one step (2^-8 relative) apart.  Held layer
# by layer (each layer's plain version fed the kernel's own stack) at every
# block, and over the whole block at the flagship's blocks 1-2: over more
# layers a step in an early layer moves every later layer's inputs, and two
# bf16 computations of 24 layers drift apart by more than one layer's steps
K4_MAX_REL, K4_MEAN_REL = 1e-2, 1e-3
# f32, over the whole block: products at f32 accuracy (3xTF32) summed in
# other orders (a single TF32 product would be ~5e-4 off)
K4_F32_MAX_REL, K4_F32_MEAN_REL = 1e-5, 1e-5


# -- the card ---------------------------------------------------------------

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
    from groomed_nms_torch.ops import kernels
    return {n: getattr(kernels, n).launches for n in TRACE_KERNELS}


def reset_launches():
    from groomed_nms_torch.ops import kernels
    for n in TRACE_KERNELS:
        getattr(kernels, n).launches = 0


# -- timers -----------------------------------------------------------------

def time_ms(fn, reps, flush):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), the
    50 MB L2 overwritten before each, as after the conv that feeds it.  A
    ~1 ms spin kernel ahead of the start event keeps the card busy while the
    host enqueues ``fn``, so host launch overhead does not show as time."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def wall_ms(fn, reps):
    """Mean host time of ``fn`` over ``reps`` runs, synchronised: for
    host-bound work (many small launches) that a user waits for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# -- kernels in a trace: from a profiler object, from a Chrome JSON -----------

def kernel_events(prof):
    """The CUDA kernels of a torch.profiler trace after its last spin kernel:
    the profiler can deliver a trace's kernels to the next trace, so each
    trace starts with ``torch.cuda._sleep`` as a marker."""
    from torch.autograd import DeviceType
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    start = max((e.time_range.start for e in ks if "spin_kernel" in e.name),
                default=float("-inf"))
    return [e for e in ks if e.time_range.start > start]


def trace_kernels(fn, reps=1):
    """The CUDA kernels (``kernel_events``) of ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_events(prof)


def split_ms(fn, names, per_call=None, reps=3):
    """Device ms of a call of ``fn`` in the kernels whose name holds each of
    ``names`` (``trace_kernels``): the mean kernel time over ``reps`` calls
    times its launches a call (``per_call``, default 1).  A kernel that the
    profiler missed leaves the mean as it is."""
    per_call = per_call or {}
    kernels_ = trace_kernels(fn, reps)
    out = {}
    for name in names:
        us = [e.time_range.elapsed_us() for e in kernels_ if name in e.name]
        out[name] = sum(us) / len(us) * per_call.get(name, 1) / 1e3 \
            if us else 0.0
    return out


def _chrome_kernels(path):
    """The events of category "kernel" in a Chrome trace JSON written by
    ``torch.profiler``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat", "").lower() == "kernel"]


def trace_counts(path):
    """{wrapper name: device kernels of that name} in a Chrome trace JSON
    written by ``torch.profiler``."""
    names = [e.get("name", "") for e in _chrome_kernels(path)]
    return {k: sum(any(v in n for v in vs) for n in names)
            for k, vs in TRACE_KERNELS.items()}


def trace_kernel_ms(path):
    """The device's busy time (ms) in a Chrome trace JSON written by
    ``torch.profiler``: the length of the union of its kernels' intervals,
    so kernels that overlap (on other streams) count once."""
    ivs = sorted((float(k["ts"]), float(k["ts"]) + float(k.get("dur", 0.0)))
                 for k in _chrome_kernels(path))
    busy, end = 0.0, float("-inf")
    for s, e in ivs:
        busy += max(e - max(s, end), 0.0)
        end = max(end, e)
    return busy / 1e3


# -- K2: greedy NMS ---------------------------------------------------------

def nms_case(rs, b, n):
    """Score-sorted boxes with clusters, padding rows, equal scores and
    same-size pairs whose IoU (W-d)/(W+d) is at or next to 0.4 (d = 3W/7)."""
    boxes = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        centers = rs.uniform([0, 0], [1200, 350], (24, 2))
        c = centers[rs.integers(0, 24, n)] + rs.normal(0, 8, (n, 2))
        wh = rs.uniform(20, 160, (n, 2))
        boxes[i, :, :2] = c - wh / 2
        boxes[i, :, 2:] = c + wh / 2
        # every 7th row: a shifted copy of the row before it at IoU ~ 0.4
        for j in range(1, n, 7):
            w = boxes[i, j - 1, 2] - boxes[i, j - 1, 0] + 1.0
            d = np.float32(3.0 * w / 7.0) + np.float32(rs.integers(-2, 3)) \
                * np.float32(1e-5) * w
            boxes[i, j] = boxes[i, j - 1] + np.array([d, 0, d, 0], np.float32)
    scores = np.round(rs.uniform(0.05, 1.0, (b, n)), 2).astype(np.float32)
    scores = -np.sort(-scores, axis=1)
    scores[:, -n // 10:] = 0.0                         # padding rows
    return boxes, scores


def k2_flagship_input(model, args):
    """K2's input on the flagship's main path, captured once: the decoded,
    score-sorted top-``nms_topN_pre`` rows of one batch through
    ``make_infer``'s steps (boxes [B, 3000, 4], scores [B, 3000], f32)."""
    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.data.augment import preprocess_images
    from groomed_nms_torch.inference import (decode_detections,
                                             rpn_outputs_dict,
                                             select_top_pre_nms)
    (images_u8, means, stds, rois, rois_3d, p2, p2_inv, scale, bmeans,
     bstds) = args
    dcfg = load_config("groomed_nms").detect_config()
    with torch.inference_mode():
        images = preprocess_images(images_u8, None, means, stds, target_h=512,
                                   crop_w=1760, out_dtype=torch.bfloat16)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            outs = rpn_outputs_dict(model(images))
        sel, sr, sr3 = select_top_pre_nms(outs, rois, rois_3d, dcfg)
        d, s = decode_detections(sel, sr, sr3, p2, p2_inv, scale, bmeans,
                                 bstds, dcfg)
        k = min(dcfg.nms_topN_pre, s.shape[1])
        return d[:, :k, :4].contiguous(), s[:, :k].contiguous()


def k2_work_bound(b, n):
    """K2's least time at [b, n], (ms, limiter): each pair of rows tested
    once (kernels.IOU_TEST_OPS f32 operations), boxes, scores and keep
    moved once."""
    from groomed_nms_torch.ops import kernels
    return bound(b * n * (n - 1) // 2 * kernels.IOU_TEST_OPS,
                 b * n * (16 + 4 + 1), PEAK_F32)


# -- K3, the grouping and the GrooMeD operator ------------------------------

def analysis_boxes(rs, n):
    """The box recipe of analysis/bench_groomed_nms.py: [1, n, 4] f32 and
    [1, n] scores."""
    x1, y1 = rs.uniform(0, 1600, n), rs.uniform(0, 480, n)
    w, h = rs.uniform(30, 300, n), rs.uniform(30, 200, n)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], 1)[None].astype(np.float32)
    return boxes, rs.uniform(0, 1, (1, n)).astype(np.float32)


def k3_case(name, b, n):
    """K3's inputs at a named shape: score-sorted clustered boxes with
    padding rows (scores 0) for "train", the analysis recipe otherwise."""
    if name == "train":
        return nms_case(np.random.default_rng(20), b, n)
    boxes, scores = analysis_boxes(np.random.default_rng(0), n)
    return boxes, -np.sort(-scores, axis=1)


def group_case(b, n, kind, dev, seed):
    """The grouping's input on ``dev``: m [b, n, n] f32 and valid [b, n].
    "iou": the IoU of ``nms_case``'s clustered boxes, left unmasked, with
    its padding rows and a hole every 9th row; "mixed": that IoU scaled by
    random gains in [0.75, 1.25) (asymmetric), 1% of its entries exactly
    at the 0.4 threshold and 0.5% NaN."""
    from groomed_nms_torch.ops import kernels
    rs = np.random.default_rng(seed)
    boxes_np, scores_np = nms_case(rs, b, n)
    valid_np = scores_np > 0
    valid_np[:, ::9] = False
    boxes = torch.from_numpy(boxes_np).to(dev)
    m = kernels.fused_iou_prune_plain(
        boxes, torch.ones((b, n), dtype=torch.bool, device=dev))[0]
    if kind == "mixed":
        g = torch.Generator(device=dev).manual_seed(seed)
        m = m * (0.75 + 0.5 * torch.rand(m.shape, generator=g, device=dev))
        u = torch.rand(m.shape, generator=g, device=dev)
        m = torch.where(u < 0.01, torch.full_like(m, 0.4), m)
        m = torch.where(u > 0.995, torch.full_like(m, float("nan")), m)
    return m.contiguous(), torch.from_numpy(valid_np).to(dev)


def group_cases():
    """The grouping's (B, N) checks: row-block edges (63-65, 128 on two
    CTAs, 576 on nine), the cluster path's limit on both sides, the
    two-kernel path and its largest N."""
    from groomed_nms_torch.ops import kernels
    limit = kernels._GROUP_CLUSTER_MAX_N
    return tuple((b, n) for n in (1, 63, 64, 65, 128, 512, 576, 1000,
                                  limit - 1, limit, limit + 1, 4096)
                 for b in (1, 8)) + ((1, kernels._GROUP_MAX_N),)


def operator_inputs(name, dev):
    """The operator's input at a K3_SHAPES name: (scores, boxes, valid),
    the rows unsorted (the operator sorts them, ties by index), on dev."""
    b, n = K3_SHAPES[name]
    boxes_np, scores_np = k3_case(name, b, n)
    perm = np.random.default_rng(21).permutation(n)
    scores = torch.from_numpy(scores_np[:, perm])
    return (scores.to(dev), torch.from_numpy(boxes_np[:, perm]).to(dev),
            (scores > 0).to(dev))


def operator_split(scores, boxes, valid, flush, reps=20):
    """The operator's stages at the shipped config, each run alone on the
    outputs of the one before: sort (order, sorted rows), K3, the grouping,
    grouping + rescore (``differentiable_nms_sorted``), unsort, and the
    whole operator.  Returns {"host": {stage: ms}, "device": {stage: ms}}:
    host ms of ``reps`` synchronised runs (``wall_ms``) and device ms
    (``time_ms``, CUDA events)."""
    from groomed_nms_torch.ops import groomed_nms as gn
    from groomed_nms_torch.ops import kernels
    order = gn._descending(gn._sort_key(scores, valid))
    v = torch.gather(valid, 1, order)
    rows = gn._rows(boxes.float(), order).contiguous()
    s = torch.gather(scores, 1, order)
    iou, prune = kernels.fused_iou_prune(rows, v)
    res = gn.differentiable_nms_sorted(s, iou, prune, v)

    def sort():
        o = gn._descending(gn._sort_key(scores, valid))
        return (torch.gather(valid, 1, o),
                gn._rows(boxes.float(), o).contiguous(),
                torch.gather(scores, 1, o))

    stages = {
        "sort": sort,
        "K3": lambda: kernels.fused_iou_prune(rows, v),
        "grouping": lambda: gn.group_leaders(iou, s, v, 0.4, 100),
        "grouping + rescore": lambda: gn.differentiable_nms_sorted(
            s, iou, prune, v),
        "unsort": lambda: gn._unsort(res, order),
        "operator": lambda: gn.groomed_nms_boxes(scores, boxes, valid),
    }
    return {"host": {k: round(wall_ms(f, reps), 4) for k, f in stages.items()},
            "device": {k: round(time_ms(f, reps, flush), 4)
                       for k, f in stages.items()}}


# -- K4: the dense block ----------------------------------------------------

def rel_err(got, ref):
    """(max |err| / max |ref|, mean |err| / mean |ref|, max |err|)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    return ((err.max() / ref.abs().max()).item(),
            (err.mean() / ref.abs().mean()).item(), err.max().item())


def dense_block_case(rs, b, c0, h, w, layers, growth, bw, dev,
                     dtype=torch.bfloat16):
    """Seeded block input and K4's packed weights in ``dtype``: folded
    affines with mul ~ U(0.5, 1.5), add ~ N(0, 0.2), LeCun-normal
    kernels."""
    cmax = c0 + layers * growth

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    x0 = t(rs.normal(size=(b, c0, h, w))).contiguous(
        memory_format=torch.channels_last)
    return (x0, t(rs.uniform(0.5, 1.5, (layers, cmax))),
            t(rs.normal(0, 0.2, (layers, cmax))),
            t(rs.normal(size=(layers, bw, cmax)) / np.sqrt(cmax)),
            t(rs.uniform(0.5, 1.5, (layers, bw))),
            t(rs.normal(0, 0.2, (layers, bw))),
            t(rs.normal(size=(layers, growth, 9 * bw)) / np.sqrt(9 * bw)))


def dense_block_layer_errors(got, bargs, dil):
    """K4's new channels layer by layer against the plain version fed the
    kernel's own stack (each layer's input channels as the kernel wrote
    them): (max |err| / max |ref|, mean |err| / mean |ref|) over all the new
    channels.  Each layer's rounding is held apart from the steps that
    earlier layers' roundings passed on."""
    from groomed_nms_torch.ops import kernels
    x0, mul1, add1, w1, mul2, add2, w2 = bargs
    layers, growth, c0 = w1.shape[0], w2.shape[1], x0.shape[1]
    err_max = ref_max = err_sum = ref_sum = 0.0
    for l in range(layers):
        cin = c0 + l * growth
        cut = cin + growth
        ref = kernels.dense_block_eval_plain(
            got[:, :cin], mul1[l:l + 1, :cut], add1[l:l + 1, :cut],
            w1[l:l + 1, :, :cut], mul2[l:l + 1], add2[l:l + 1],
            w2[l:l + 1], dilation=dil)[:, cin:].float()
        err = (got[:, cin:cut].float() - ref).abs()
        err_max = max(err_max, err.max().item())
        ref_max = max(ref_max, ref.abs().max().item())
        err_sum += err.sum().item()
        ref_sum += ref.abs().sum().item()
    return err_max / ref_max, err_sum / ref_sum


def k4_agrees(name, got, bargs, dil):
    """K4's stack ``got`` against its plain version on ``bargs`` (run here;
    TF32 must be off): the input channels exact, and the new channels
    within K4_F32_* over the whole block in f32; in bf16 within K4_MAX_REL
    and K4_MEAN_REL layer by layer, and over the whole block at the
    flagship's blocks (K4_BLOCKS).  Returns (ok, figures, a line)."""
    from groomed_nms_torch.ops import kernels
    c0 = bargs[0].shape[1]
    ref = kernels.dense_block_eval_plain(*bargs, dilation=dil)
    max_rel, mean_rel, max_abs = rel_err(got[:, c0:], ref[:, c0:])
    del ref
    same_x0 = torch.equal(got[:, :c0], bargs[0])
    layer_rel = None
    if got.dtype == torch.float32:
        tol = (K4_F32_MAX_REL, K4_F32_MEAN_REL)
        ok = max_rel <= tol[0] and mean_rel <= tol[1]
        held = "whole block held"
    else:
        tol = (K4_MAX_REL, K4_MEAN_REL)
        layer_rel = dense_block_layer_errors(got, bargs, dil)
        ok = layer_rel[0] <= tol[0] and layer_rel[1] <= tol[1]
        if name in K4_BLOCKS:
            ok = ok and max_rel <= tol[0] and mean_rel <= tol[1]
            held = "whole block and each layer held"
        else:
            held = "each layer held, the whole block reported"
    layers = ("" if layer_rel is None else
              f"; layer by layer from the kernel's own inputs max/max "
              f"{layer_rel[0]:.3e}, mean/mean {layer_rel[1]:.3e}")
    text = (f"whole block max|err|/max|ref| {max_rel:.3e}, mean|err|/"
            f"mean|ref| {mean_rel:.3e}, max|err| {max_abs:.3e}{layers} (tol "
            f"{tol[0]:g} / {tol[1]:g}, {held}); input channels copied "
            f"exactly: {same_x0}")
    figures = dict(max_abs=max_abs, max_rel=max_rel, mean_rel=mean_rel,
                   layer_rel=layer_rel)
    return same_x0 and ok, figures, text
