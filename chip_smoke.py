#!/usr/bin/env python3
"""Smoke run of ``groomed_nms_torch`` on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. device  -- a CUDA card is required; prints its name and power limit;
  2. build   -- nvcc builds the greedy-NMS, dense-block, IoU/prune and
                grouping libraries (csrc/greedy_nms.cu, csrc/dense_block.cu,
                csrc/iou_prune.cu, csrc/group_leaders.cu), all at once,
                into build/groomed_nms_torch/ and prints their -Xptxas -v
                logs;
                Triton compiles the head-score kernel on its first launch;
  3. K1      -- fused_head_scores against its plain version at the main-path
                shape [8, 126720, 18] bf16, with and without acceptance;
  4. K2      -- greedy_nms against its plain version at [8, 3000, 4] with
                clustered boxes, padding rows, equal scores and IoUs at and
                next to the 0.4 threshold: keep masks must be identical;
                kernel and plain times, the kept rows and the nms_mask /
                nms_sweep split of a call (torch.profiler);
  5. slice   -- the flagship (DenseNet-121, 36 anchors, acceptance, bf16,
                batch 8, 512x1760) on uint8 375x1242 frames through
                make_infer: checked against the CPU path at a small size,
                then timed; both kernels must launch once per batch; the
                detections must be finite and write 8 KITTI txt files.
                Then K2 again on the flagship's own K2 input (the decoded
                top-3000 rows of one batch, captured once; the sweep's time
                grows with the rows kept): identical keep masks, times,
                split;
  6. K4     -- dense_block_eval against its plain version at the flagship's
                block-1 [8, 64, 128, 440] -> 256 ch and block-2
                [8, 128, 64, 220] -> 512 ch shapes, bf16, seeded input and
                folded affines; relative errors, kernel and plain times,
                TFLOP/s, the bound (kernels.dense_block_work at the card's
                peaks) and the kernel's share of it, and as a yardstick the
                block's 2L cuDNN convolutions alone at the same shapes;
  7. fast_eval -- the weight-folded engine: (a) on the card against the CPU
                path at 2x64x128 bf16; (b) against the rpn3d engine at full
                size from one RPN3D with perturbed BatchNorm statistics;
                (c) the flagship through make_infer with engine="fast_eval",
                timed: K4 twice per batch, K1 and K2 once; trunk breakdown;
  8. K3     -- fused_iou_prune against its plain version at the training
                and test-time shape [8, 512, 4] (clustered boxes, padding
                rows) for the three pruning methods, at the analysis shape
                [1, 1000, 4], at the edge sizes K3_EDGE and on boxes whose
                sizes span 2^-25..2^63 (quotients outside the kernel's
                fast range, unions at the 1e-12 clamp and past 2^126);
                kernel and plain times at the two shapes, Gpairs/s, the
                bound (kernels.iou_prune_work) and the share of it;
  9. operator -- the grouping kernel (kernels.group_leaders) against its
                plain version on GROUP_CASES (IoUs with padding holes;
                asymmetric overlaps with ties at the threshold and NaNs;
                group sizes -1, 0, 1, 100), timed on the operator's own
                input at [8, 512] beside its bound; then GrooMeD-NMS (sort,
                K3, grouping, rescoring) on the card against the CPU path
                at [8, 512] and [1, 1000]: one K3 and one grouping launch a
                call, no host synchronisation (torch.cuda sync debug mode
                "error"), host ms, Mboxes/s and the split by stage;
 10. groomed test -- the flagship through make_infer with GrooMeD-NMS at
                test time: K3, the grouping and K1 once per batch, K2
                never; timed;
 11. train  -- (a) one step of the flagship train workload with the tiny
                backbone at 2x64x128 f32 on the card against the CPU path;
                (b) build_flagship_train
                at full size (batch 8, 512x1760, bf16 autocast): 3 warm-up
                and 10 timed steps, K3 and the grouping once per step,
                finite loss and
                gradients, parameters and running statistics moved; ms per
                step, img/s, a stage split and the peak device memory;
 12. the kernels JSON line, then the last line:
     {"ok": true, "device": {...}}.
Every timing line carries the card's name and power limit.  Imports torch,
numpy and groomed_nms_torch only.  Tolerances are fixed below, before any
run; every error is printed before it is checked.
"""

import copy
import json
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from groomed_nms_torch.config import load_config
from groomed_nms_torch.data.augment import preprocess_images
from groomed_nms_torch.flagship import (NUM_ANCHORS, build_flagship,
                                        build_flagship_train)
from groomed_nms_torch.inference import (decode_detections, im_detect_3d,
                                         nms_and_topk, rpn_outputs_dict,
                                         select_top_pre_nms,
                                         write_kitti_detections)
from groomed_nms_torch.models.densenet import tiny_densenet_config
from groomed_nms_torch.models.fast_eval import FastEvalRPN3D, KernelDenseBlock
from groomed_nms_torch.models.rpn_3d import RPN3D
from groomed_nms_torch.ops import _build, kernels
from groomed_nms_torch.ops.groomed_nms import groomed_nms_boxes
from groomed_nms_torch.ops.iou import pairwise_iou
from groomed_nms_torch.utils.weights import init_weights

K1_SHAPE = (8, 126720, 18)            # 32 x 110 x 36 anchors, bf16 head
K2_SHAPE = (8, 3000)                  # nms_topN_pre rows per image
WARMUP, TIMED = 3, 10
KITTI_CLASSES = ["Car", "Pedestrian", "Cyclist"]
# K4 at the flagship's kernel blocks: (B, c0, H, W, L, G, bw, dilation)
K4_BLOCKS = {"block1": (8, 64, 128, 440, 6, 32, 128, 1),
             "block2": (8, 128, 64, 220, 12, 32, 128, 1)}
# K4 vs its plain version over the new channels: max |err| / max |ref| and
# mean |err| / mean |ref|; the two sum in other orders, so a bf16 rounding
# of h or of an output may land one step (2^-8 relative) apart
K4_MAX_REL, K4_MEAN_REL = 1e-2, 1e-3
# the fast_eval engine, fused_raw: max |err| / max |ref|, mean |err| / mean
# |ref| (121 bf16 layers summed in other orders; against rpn3d also the
# folded BatchNorm applied in bf16, where autocast applies it in f32), and
# the acceptance probability's max |err| against the CPU path
FE_MAX_REL, FE_MEAN_REL, FE_ACCEPT_ATOL = 0.05, 0.02, 0.02
# K3: IoU and the linear prune bit-identical (the same f32 ops in the same
# order, no FMA on either side); the sigmoid and exp of the other two
# methods within 1e-6; the operator's rescored values within 1e-6 of the
# CPU path with identical leaders and keep masks
K3_ATOL, OPERATOR_ATOL = 1e-6, 1e-6
K3_SHAPES = {"train": (8, 512), "analysis": (1, 1000)}
# K3's edge sizes (B, N): one box, ragged tiles, N % 4 != 0 (scalar
# stores), many tiles
K3_EDGE = ((1, 1), (2, 31), (3, 33), (2, 64), (3, 65), (2, 100), (1, 2048))
# the grouping kernel: identical to its plain version at each (B, N) and
# group size
GROUP_CASES = tuple((b, n) for n in (1, 63, 64, 65, 512, 1000, 4096)
                    for b in (1, 8))
GROUP_SIZES = (-1, 0, 1, 100)
# one train step of the tiny model at 2x64x128 f32 on the card vs the CPU
# path: stats at rtol 1e-3 (atol 1e-5), parameters within 1e-4 of each
# tensor's max (convolutions and their gradients summed in other orders).
# Not DenseNet-121: at random init its train-mode step turns a 1e-7
# relative change of its weights into a ~0.4% change of the whole update
# (measured on the CPU), so two backends cannot agree on it to 1e-4

TRAIN_RTOL, TRAIN_ATOL, TRAIN_PARAM_REL = 1e-3, 1e-5, 1e-4
# the H100 SXM's published peaks (dense, 700 W): bf16 tensor-core FLOP/s,
# f32 FLOP/s outside the tensor cores, device-memory bytes/s
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# f32 operations of K1 per logit (exp, sum, max, divide); an IoU test's are
# kernels.IOU_TEST_OPS
HEAD_OPS = 4


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def rel_err(got, ref):
    """(max |err| / max |ref|, mean |err| / mean |ref|, max |err|)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    return ((err.max() / ref.abs().max()).item(),
            (err.mean() / ref.abs().mean()).item(), err.max().item())


def dense_block_case(rs, b, c0, h, w, layers, growth, bw, dev):
    """Seeded block input and K4's packed bf16 weights: folded affines with
    mul ~ U(0.5, 1.5), add ~ N(0, 0.2), LeCun-normal kernels."""
    cmax = c0 + layers * growth

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(
            torch.bfloat16)

    x0 = t(rs.normal(size=(b, c0, h, w))).contiguous(
        memory_format=torch.channels_last)
    return (x0, t(rs.uniform(0.5, 1.5, (layers, cmax))),
            t(rs.normal(0, 0.2, (layers, cmax))),
            t(rs.normal(size=(layers, bw, cmax)) / np.sqrt(cmax)),
            t(rs.uniform(0.5, 1.5, (layers, bw))),
            t(rs.normal(0, 0.2, (layers, bw))),
            t(rs.normal(size=(layers, growth, 9 * bw)) / np.sqrt(9 * bw)))


def bound(ops, nbytes, peak_ops):
    """The least time of a kernel's work on the card, (ms, limiter): the
    larger of its operations over ``peak_ops`` and its bytes (each input read
    once, each output written once) over the memory rate."""
    ops_ms, bytes_ms = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def dense_block_convs(b, c0, h, w, layers, growth, bw, dil, dev):
    """K4's yardstick (the port never calls it): the block's 2L cuDNN
    convolutions alone, bf16, channels_last; per layer the 1x1 from a
    contiguous [b, cin, h, w] to bw and the dilated 3x3 from [b, bw, h, w]
    to G.  No BatchNorm, ReLU or concatenation.  Returns a function that
    runs them all."""
    g = torch.Generator(device=dev).manual_seed(0)

    def t(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.1).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    xs = [t(b, c0 + l * growth, h, w) for l in range(layers)]
    k1s = [t(bw, c0 + l * growth, 1, 1) for l in range(layers)]
    k2s = [t(growth, bw, 3, 3) for _ in range(layers)]
    hin = t(b, bw, h, w)

    def run():
        for x, k1, k2 in zip(xs, k1s, k2s):
            F.conv2d(x, k1)
            F.conv2d(hin, k2, padding=dil, dilation=dil)
    return run


def perturbed_rpn3d(seed):
    """The flagship RPN3D (seeded init) with every BatchNorm's affine and
    running statistics drawn from a seeded generator, so a fold is tested:
    weight ~ U(0.5, 1.5), bias ~ N(0, 0.2), mean ~ N(0, 0.2),
    var ~ U(0.5, 1.5)."""
    model = RPN3D(load_config("groomed_nms").rpn_config(NUM_ANCHORS))
    init_weights(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.2)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
    return model.eval()


def perturb_(model, seed):
    """Every BatchNorm weight ~ U(0.5, 1.5), running mean ~ N(0, 0.2) and
    variance ~ U(0.5, 1.5), every bias ~ N(0, 0.2), drawn on the CPU from a
    seeded generator: no parameter starts at 0, so a parameter's error
    after a step is measured against a scale that is not the step itself."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
            if getattr(m, "bias", None) is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)


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


def split_ms(fn, names, per_call=None, reps=3):
    """Device ms of a call of ``fn`` in the kernels whose name holds each of
    ``names`` (``torch.profiler``): the mean kernel time over ``reps`` calls
    times its launches a call (``per_call``, default 1).  The profiler can
    deliver a trace's kernels to the next trace: a spin kernel marks this
    trace's start and kernels before it are left out, and a kernel that was
    missed leaves the mean as it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    per_call = per_call or {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    start = max((e.time_range.start for e in kernels
                 if "spin_kernel" in e.name), default=float("-inf"))
    out = {}
    for name in names:
        us = [e.time_range.elapsed_us() for e in kernels
              if name in e.name and e.time_range.start >= start]
        out[name] = sum(us) / len(us) * per_call.get(name, 1) / 1e3 \
            if us else 0.0
    return out


K2_KERNELS = ("nms_mask", "nms_sweep")


def k2_work_bound(b, n):
    """K2's least time at [b, n], (ms, limiter): each pair of rows tested
    once (kernels.IOU_TEST_OPS f32 operations), boxes, scores and keep
    moved once."""
    return bound(b * n * (n - 1) // 2 * kernels.IOU_TEST_OPS,
                 b * n * (16 + 4 + 1), PEAK_F32)


def k2_phase(name, boxes, scores, flush, stamp):
    """K2 against its plain version on one input: identical keep masks,
    then kernel and plain times and the mask / sweep split of a call.
    Returns {ms, plain_ms, kept, split}."""
    keep = kernels.greedy_nms(boxes, scores, nms_threshold=0.4, shift=1.0)
    keep_ref = kernels.greedy_nms_plain(boxes, scores, nms_threshold=0.4,
                                        shift=1.0)
    n_diff = int((keep != keep_ref).sum().item())
    assert n_diff == 0, f"K2 keep mask differs from the plain version in " \
                        f"{n_diff} of {keep.numel()} rows ({name})"
    ms = time_ms(lambda: kernels.greedy_nms(boxes, scores), 50, flush)
    plain_ms = time_ms(lambda: kernels.greedy_nms_plain(boxes, scores), 3,
                       flush)
    split = split_ms(lambda: kernels.greedy_nms(boxes, scores), K2_KERNELS)
    kept, valid = int(keep.sum()), int((scores > 0).sum())
    print(f"K2 greedy_nms {name} {list(scores.shape)}: keep masks identical "
          f"({kept} kept of {valid} valid rows); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; a call by kernel (torch.profiler) "
          f"{json.dumps({k: round(v, 4) for k, v in split.items()})} {stamp}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, kept=kept, split=split)


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


def wide_range_boxes(rs, b, n):
    """[b, n, 4] f32 boxes whose sides span 2^-25..2^63 (log-uniform),
    nested across scales: K3's quotients outside its fast range (unions at
    the 1e-12 clamp, past 2^126, tiny ratios) next to ordinary ones."""
    side = np.exp2(rs.uniform(-25, 63, (b, n, 2)))
    center = np.exp2(rs.uniform(-25, 63, (b, n, 2))) * rs.uniform(
        -1, 1, (b, n, 2))
    return np.concatenate([center - side / 2, center + side / 2],
                          -1).astype(np.float32)


def k3_check(name, boxes, valid):
    """K3 against its plain version, three methods: IoU and the linear
    prune identical, the other two within K3_ATOL.  Returns the methods'
    max |err| of the prune."""
    errs = {}
    for method in kernels.PRUNING_METHODS:
        kw = dict(nms_threshold=0.4, temperature=0.1, pruning_method=method)
        iou, prune = kernels.fused_iou_prune(boxes, valid, **kw)
        ref_iou, ref_prune = kernels.fused_iou_prune_plain(boxes, valid, **kw)
        errs[method] = (prune - ref_prune).abs().max().item()
        assert torch.equal(iou, ref_iou), \
            f"K3 IoU differs from its plain version ({name})"
        assert errs[method] <= (0.0 if method == "linear" else K3_ATOL), \
            f"K3 {method} prune differs by {errs[method]} ({name})"
    return errs


def k3_phase(dev, flush, stamp):
    """K3 against its plain version at each of K3_SHAPES (timed), the edge
    sizes and the wide-range boxes; returns {shape name: {ms, plain_ms,
    max_abs}}."""
    k3 = {}
    for name, (b, n) in K3_SHAPES.items():
        boxes_np, scores_np = k3_case(name, b, n)
        boxes = torch.from_numpy(boxes_np).to(dev)
        valid = torch.from_numpy(scores_np > 0).to(dev)
        errs = k3_check(name, boxes, valid)
        ms = time_ms(lambda: kernels.fused_iou_prune(boxes, valid), 50, flush)
        plain_ms = time_ms(lambda: kernels.fused_iou_prune_plain(
            boxes, valid), 20, flush)
        bound_ms, bound_by = bound(*kernels.iou_prune_work(b, n), PEAK_F32)
        k3[name] = dict(ms=ms, plain_ms=plain_ms, max_abs=max(errs.values()),
                        bound_ms=bound_ms, bound_by=bound_by)
        print(f"K3 fused_iou_prune {name} [{b}, {n}, 4] "
              f"({int(valid.sum())} valid rows): IoU identical, prune "
              f"max|err| {json.dumps(errs)} (linear 0, else atol "
              f"{K3_ATOL:g}); kernel {ms:.4f} ms ({b * n * n / ms / 1e6:.2f} "
              f"Gpairs/s, {bound_ms / ms:.1%} of the {bound_ms:.4f} ms "
              f"bound by {bound_by}), plain {plain_ms:.4f} ms "
              f"({b * n * n / plain_ms / 1e6:.2f} Gpairs/s) {stamp}",
              flush=True)
    for b, n in K3_EDGE:
        boxes_np, scores_np = nms_case(np.random.default_rng(n), b, n)
        k3_check(f"[{b}, {n}]", torch.from_numpy(boxes_np).to(dev),
                 torch.from_numpy(scores_np > 0).to(dev))
    rs = np.random.default_rng(22)
    boxes = torch.from_numpy(wide_range_boxes(rs, 2, 1000)).to(dev)
    valid = torch.from_numpy(rs.uniform(size=(2, 1000)) > 0.05).to(dev)
    k3_check("wide range", boxes, valid)
    print(f"K3 edge sizes {list(K3_EDGE)} and boxes of sides 2^-25..2^63 at "
          f"[2, 1000]: IoU and linear prune identical, the other methods "
          f"within {K3_ATOL:g}", flush=True)
    return k3


GROUP_KERNELS = ("group_bits", "group_sweep")


def group_case(b, n, kind, dev, seed):
    """The grouping's input on ``dev``: m [b, n, n] f32 and valid [b, n].
    "iou": the IoU of ``nms_case``'s clustered boxes, left unmasked, with
    its padding rows and a hole every 9th row; "mixed": that IoU scaled by
    random gains in [0.75, 1.25) (asymmetric), 1% of its entries exactly
    at the 0.4 threshold and 0.5% NaN."""
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


def group_phase(dev, flush, stamp):
    """The grouping kernel against its plain version on GROUP_CASES, then
    timed on the operator's own input (K3's IoU of the sorted "train"
    rows, [8, 512]).  Returns {ms, plain_ms, bound_ms, bound_by}."""
    for b, n in GROUP_CASES:
        for kind in ("iou", "mixed"):
            m, valid = group_case(b, n, kind, dev, seed=b * n)
            for gs in GROUP_SIZES:
                kw = dict(nms_threshold=0.4, group_size=gs)
                got = kernels.group_leaders(m, valid, **kw)
                ref = kernels.group_leaders_plain(m, valid, **kw)
                assert torch.equal(got, ref), \
                    f"group_leaders differs from its plain version at " \
                    f"[{b}, {n}] {kind}, group_size {gs}"
    print(f"group_leaders: identical to its plain version at {len(GROUP_CASES)}"
          f" (B, N) from [1, 1] to [8, 4096], IoU and asymmetric overlaps "
          f"(ties at the threshold, NaN), group sizes {list(GROUP_SIZES)}",
          flush=True)
    b, n = K3_SHAPES["train"]
    boxes_np, scores_np = k3_case("train", b, n)
    valid = torch.from_numpy(scores_np > 0).to(dev)
    m = kernels.fused_iou_prune(torch.from_numpy(boxes_np).to(dev), valid)[0]
    kw = dict(nms_threshold=0.4, group_size=100)
    leader = kernels.group_leaders(m, valid, **kw)
    leaders = int((leader == torch.arange(n, device=dev)).sum())
    ms = time_ms(lambda: kernels.group_leaders(m, valid, **kw), 50, flush)
    plain_ms = time_ms(lambda: kernels.group_leaders_plain(m, valid, **kw),
                       10, flush)
    split = split_ms(lambda: kernels.group_leaders(m, valid, **kw),
                     GROUP_KERNELS)
    bound_ms, bound_by = bound(*kernels.group_leaders_work(b, n), PEAK_F32)
    print(f"group_leaders on the operator's input [{b}, {n}] "
          f"({int(valid.sum())} valid rows, {leaders} leaders): kernel "
          f"{ms:.4f} ms ({bound_ms / ms:.1%} of the {bound_ms:.4f} ms bound "
          f"by {bound_by}), plain {plain_ms:.4f} ms; a call by kernel "
          f"(torch.profiler) "
          f"{json.dumps({k: round(v, 4) for k, v in split.items()})} {stamp}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


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


def operator_phase(dev, flush, stamp):
    """GrooMeD-NMS of unsorted rows (sort, K3, grouping, rescoring) on the
    card against the CPU path at each of K3_SHAPES: one K3 and one grouping
    launch a call, no host synchronisation; timed on the host, with the
    split by stage.  Returns {shape name: {ms, split}}."""
    out = {}
    for name, (b, n) in K3_SHAPES.items():
        args_g = operator_inputs(name, dev)
        ref = groomed_nms_boxes(*(t.cpu() for t in args_g))
        groomed_nms_boxes(*args_g)                       # warm
        torch.cuda.synchronize()
        kernels.fused_iou_prune.launches = 0
        kernels.group_leaders.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = groomed_nms_boxes(*args_g)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = {"fused_iou_prune": kernels.fused_iou_prune.launches,
                    "group_leaders": kernels.group_leaders.launches}
        assert launches == {"fused_iou_prune": 1, "group_leaders": 1}, \
            f"expected one K3 and one grouping launch a call, got {launches}"
        same_leader = torch.equal(got.leader.cpu(), ref.leader)
        same_keep = torch.equal(got.keep.cpu(), ref.keep)
        err = (got.rescored.cpu() - ref.rescored).abs().max().item()
        ms = wall_ms(lambda: groomed_nms_boxes(*args_g), 20)
        split = operator_split(*args_g, flush)
        print(f"operator groomed_nms_boxes {name} [{b}, {n}]: leaders "
              f"identical {same_leader}, keep identical {same_keep} "
              f"({int(ref.keep.sum())} kept, {int((ref.leader >= 0).sum())} "
              f"grouped), rescored max|err| {err:.3e} (atol "
              f"{OPERATOR_ATOL:g}); launches {launches}, no host sync "
              f"(sync debug mode error); {ms:.3f} ms, "
              f"{b * n / ms / 1e3:.3f} Mboxes/s {stamp}", flush=True)
        print(f"operator split {name} [{b}, {n}] ms by stage: "
              f"{json.dumps(split)} {stamp}", flush=True)
        assert same_leader and same_keep and err <= OPERATOR_ATOL, \
            f"the operator on the card disagrees with the CPU path ({name})"
        out[name] = dict(ms=ms, split=split)
    return out


def groomed_test_phase(stamp):
    """The flagship served with GrooMeD-NMS at test time, timed."""
    infer, args, _ = build_flagship(device="cuda", differentiable_nms=True)
    batch = args[0].shape[0]
    for _ in range(WARMUP):
        infer(*args)
    torch.cuda.synchronize()
    kernels.fused_head_scores.launches = 0
    kernels.greedy_nms.launches = 0
    kernels.fused_iou_prune.launches = 0
    kernels.group_leaders.launches = 0
    t0 = time.perf_counter()
    for _ in range(TIMED):
        dets, valid = infer(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_head_scores": kernels.fused_head_scores.launches,
                "greedy_nms": kernels.greedy_nms.launches,
                "fused_iou_prune": kernels.fused_iou_prune.launches,
                "group_leaders": kernels.group_leaders.launches}
    assert launches == {"fused_head_scores": TIMED, "greedy_nms": 0,
                        "fused_iou_prune": TIMED, "group_leaders": TIMED}, \
        f"expected K1, K3 and the grouping once per batch and no K2, got " \
        f"{launches}"
    dets, valid = dets.cpu(), valid.cpu()
    assert dets.shape == (batch, 40, 17) and torch.isfinite(dets).all(), \
        "non-finite GrooMeD detections"
    print(f"groomed test: {TIMED} batches of {batch} at 512x1760 bf16 with "
          f"GrooMeD-NMS in {wall * 1e3:.1f} ms: {batch * TIMED / wall:.2f} "
          f"img/s, {wall * 1e3 / TIMED:.2f} ms/batch; launches {launches}; "
          f"{int(valid.sum())} valid rows {stamp}", flush=True)


def train_phase(stamp):
    """(a) one f32 step of the tiny model at 2x64x128 on the card against
    the CPU path; (b) the
    flagship train step at full size, timed, with a stage split and the
    peak memory.  Returns the launches of K3 and the grouping in the timed
    steps."""
    torch.backends.cudnn.allow_tf32 = False
    small = dict(batch=2, height=64, width=128, src_hw=(48, 96),
                 compute_dtype=None, backbone=tiny_densenet_config())
    results = []
    for device in ("cpu", "cuda"):
        step, state, batch = build_flagship_train(device=device, **small)
        perturb_(state.model, seed=5)
        stats = step(state, batch)
        results.append(({k: float(v) for k, v in stats.items()},
                        {k: v.cpu() for k, v in
                         state.model.state_dict().items()}))
    torch.backends.cudnn.allow_tf32 = True
    (s_c, p_c), (s_g, p_g) = results
    stat_err = max(abs(s_g[k] - s_c[k]) / max(abs(s_c[k]), TRAIN_ATOL)
                   for k in s_c)
    param_err = max(((p_g[k] - v).abs().max() / v.abs().max()).item()
                    for k, v in p_c.items()
                    if v.is_floating_point() and v.abs().max() > 0)
    print(f"train (a): one step of the tiny model at 2x64x128 f32, card vs "
          f"CPU path: loss "
          f"{s_g['total']:.6f} vs {s_c['total']:.6f}, max stat rel err "
          f"{stat_err:.3e} (rtol {TRAIN_RTOL:g}), max param err / max "
          f"{param_err:.3e} (tol {TRAIN_PARAM_REL:g}); {s_c['fg_num']:.0f} "
          f"fg", flush=True)
    assert s_c["fg_num"] > 0
    for k in s_c:
        assert abs(s_g[k] - s_c[k]) <= TRAIN_ATOL + TRAIN_RTOL * abs(s_c[k]), \
            f"train step stat {k} differs on the card: {s_g[k]} vs {s_c[k]}"
    assert param_err <= TRAIN_PARAM_REL, "train step parameters differ"

    events = None                  # the stage hook records only into a list

    def on_stage(stage):
        if events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

    step, state, batch = build_flagship_train(device="cuda",
                                              on_stage=on_stage)
    n_img = batch["images_u8"].shape[0]
    for _ in range(WARMUP):
        step(state, batch)
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in state.model.state_dict().items()
              if v.is_floating_point()}
    kernels.fused_iou_prune.launches = 0
    kernels.group_leaders.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TIMED):
        losses.append(step(state, batch)["total"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"fused_iou_prune": kernels.fused_iou_prune.launches,
                "group_leaders": kernels.group_leaders.launches}
    losses = torch.stack(losses).cpu()
    grads_ok = all(torch.isfinite(p.grad).all().item()
                   for p in state.model.parameters() if p.grad is not None)
    after = state.model.state_dict()
    moved = {kind: all(not torch.equal(before[k], after[k])
                       for k in before if k.endswith(kind))
             for kind in ("weight", "running_mean", "running_var")}
    print(f"train (b): {TIMED} steps of batch {n_img} at 512x1760 bf16 in "
          f"{wall * 1e3:.1f} ms: {wall * 1e3 / TIMED:.2f} ms/step, "
          f"{n_img * TIMED / wall:.2f} img/s; launches {launches}; loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; grads finite {grads_ok}; "
          f"moved {moved}; peak memory {peak_gb:.2f} GB {stamp}", flush=True)
    assert launches == {"fused_iou_prune": TIMED, "group_leaders": TIMED}, \
        "expected one K3 and one grouping launch per train step"
    assert torch.isfinite(losses).all() and grads_ok, "non-finite training"
    assert all(moved.values()), "a parameter or statistic did not move"

    # the stage split: device time between the step's hooks, from an event
    # recorded just before the step (preprocess counts with the forward)
    splits = []
    for _ in range(5):
        events = []
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        torch.cuda.synchronize()
        prev, split = start, {}
        for stage, ev in events:
            split[stage] = prev.elapsed_time(ev)
            prev = ev
        splits.append(split)
    events = None
    split = {k: round(float(np.median([sp[k] for sp in splits])), 4)
             for k in splits[0]}
    print(f"train (b) split ms/step (median of 5, CUDA events): "
          f"{json.dumps(split)} {stamp}", flush=True)
    return launches


def main():
    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    dev = torch.device("cuda")
    card = card_line()
    stamp = f"[{card}]"
    print(card, flush=True)              # as nvidia-smi gives it
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    sources = ("greedy_nms.cu", "dense_block.cu", "iou_prune.cu",
               "group_leaders.cu")
    with ThreadPoolExecutor(len(sources)) as pool:       # one nvcc per source
        libs = list(pool.map(_build.build, sources))
    _build.greedy_nms_lib()
    _build.dense_block_lib()
    _build.iou_prune_lib()
    _build.group_leaders_lib()
    print(f"build: nvcc {' + '.join(sources)} -> "
          f"{', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip(), flush=True)
    t0 = time.perf_counter()
    kernels.fused_head_scores(
        torch.zeros((1, 64, 18), dtype=torch.bfloat16, device=dev),
        num_classes=4)
    torch.cuda.synchronize()
    print(f"build: triton head_scores compiled and launched in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. K1 --------------------------------------------------------------
    g = torch.Generator().manual_seed(1)
    fused = (torch.randn(K1_SHAPE, generator=g) * 3).to(torch.bfloat16).to(dev)
    accept = (torch.rand(K1_SHAPE[:2], generator=g) * 0.9 + 0.1).to(dev)
    k1_err = 0.0
    for acc in (None, accept):
        got = kernels.fused_head_scores(fused, acc, num_classes=4)
        ref = kernels.fused_head_scores_plain(fused, acc, num_classes=4)
        err = (got - ref).abs().max().item()
        assert err <= 1e-6, f"K1 disagrees with its plain version: {err}"
        k1_err = max(k1_err, err)
    k1_ms = time_ms(lambda: kernels.fused_head_scores(
        fused, accept, num_classes=4), 50, flush)
    k1_plain_ms = time_ms(lambda: kernels.fused_head_scores_plain(
        fused, accept, num_classes=4), 20, flush)
    print(f"K1 fused_head_scores {list(K1_SHAPE)} bf16 + accept: max|err| "
          f"{k1_err:.3e} (atol 1e-6); kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.4f} ms {stamp}", flush=True)

    # -- 4. K2 --------------------------------------------------------------
    boxes_np, scores_np = nms_case(np.random.default_rng(2), *K2_SHAPE)
    k2 = {"synthetic": k2_phase("synthetic", torch.from_numpy(boxes_np).to(dev),
                                torch.from_numpy(scores_np).to(dev), flush,
                                stamp)}

    # -- 5. slice -----------------------------------------------------------
    # (a) against the CPU path (the kernels' plain versions, which the CPU
    # tests hold against the JAX package) at a small size in f32, with TF32
    # off so both sides convolve in full f32; the same seed gives the same
    # weights and frames on both devices
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dict(batch=2, height=64, width=128, src_hw=(48, 96),
                 compute_dtype=None)
    infer_g, args_g, _ = build_flagship(device="cuda", **small)
    infer_c, args_c, _ = build_flagship(device="cpu", **small)
    dets_g, valid_g = (x.cpu() for x in infer_g(*args_g))
    dets_c, valid_c = infer_c(*args_c)
    assert torch.equal(valid_g, valid_c), "valid masks differ from the CPU path"
    assert valid_c.any(), "the small-size reference kept no detection"
    err = (dets_g - dets_c).abs()[valid_c].max().item()
    # 121 conv layers in other summation orders on each side
    torch.testing.assert_close(dets_g[valid_c], dets_c[valid_c], rtol=1e-3,
                               atol=1e-2)
    print(f"slice: GPU vs CPU path at 2x64x128 f32: valid masks identical, "
          f"max|err| {err:.3e} over {int(valid_c.sum())} rows "
          f"(rtol 1e-3, atol 1e-2)", flush=True)
    torch.backends.cudnn.allow_tf32 = True

    # (b) the flagship: bf16, batch 8, 512x1760, timed
    torch.backends.cudnn.benchmark = True    # autotune each conv shape once
    infer, args, model = build_flagship(device="cuda")
    batch = args[0].shape[0]
    for _ in range(WARMUP):
        infer(*args)
    torch.cuda.synchronize()
    kernels.fused_head_scores.launches = 0
    kernels.greedy_nms.launches = 0
    t0 = time.perf_counter()
    for _ in range(TIMED):
        dets, valid = infer(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_head_scores": kernels.fused_head_scores.launches,
                "greedy_nms": kernels.greedy_nms.launches}
    assert launches == {"fused_head_scores": TIMED, "greedy_nms": TIMED}, \
        f"expected one launch of each kernel per batch, got {launches}"
    dets, valid = dets.cpu(), valid.cpu()
    assert dets.shape == (batch, 40, 17) and valid.shape == (batch, 40)
    assert torch.isfinite(dets[valid]).all(), "non-finite detections"
    with tempfile.TemporaryDirectory() as out_dir:
        for i in range(batch):
            write_kitti_detections(os.path.join(out_dir, f"{i:06d}.txt"),
                                   dets[i].numpy(), valid[i].numpy(),
                                   KITTI_CLASSES, score_thres=0.0)
        n_txt = len([f for f in os.listdir(out_dir) if f.endswith(".txt")])
    assert n_txt == batch, f"expected {batch} KITTI files, found {n_txt}"
    img_s = batch * TIMED / wall
    print(f"slice: {TIMED} batches of {batch} at 512x1760 bf16 in "
          f"{wall * 1e3:.1f} ms: {img_s:.2f} img/s, {wall * 1e3 / TIMED:.2f} "
          f"ms/batch; launches {launches}; {int(valid.sum())} valid rows, "
          f"{n_txt} KITTI files {stamp}", flush=True)
    k2["flagship"] = k2_phase("flagship input", *k2_flagship_input(model, args),
                              flush, stamp)

    # where a batch's device time goes, stage by stage (CUDA events, each
    # stage alone on the outputs of the one before)
    (images_u8, means, stds, rois, rois_3d, p2, p2_inv, scale, bmeans,
     bstds) = args
    dcfg = load_config("groomed_nms").detect_config()

    def forward(module):
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return module(images)

    with torch.inference_mode():
        images = preprocess_images(images_u8, None, means, stds, target_h=512,
                                   crop_w=1760, out_dtype=torch.bfloat16)
        outs = rpn_outputs_dict(forward(model))
        sel, sr, sr3 = select_top_pre_nms(outs, rois, rois_3d, dcfg)
        d, s = decode_detections(sel, sr, sr3, p2, p2_inv, scale, bmeans,
                                 bstds, dcfg)
        stages = {
            "preprocess": lambda: preprocess_images(
                images_u8, None, means, stds, target_h=512, crop_w=1760,
                out_dtype=torch.bfloat16),
            "trunk": lambda: forward(model.backbone),
            "model": lambda: forward(model),
            "K1 + top-k": lambda: select_top_pre_nms(outs, rois, rois_3d,
                                                     dcfg),
            "decode": lambda: decode_detections(
                sel, sr, sr3, p2, p2_inv, scale, bmeans, bstds, dcfg),
            "K2 + top-40": lambda: nms_and_topk(d, s, dcfg, presorted=True),
        }
        breakdown = {k: round(time_ms(fn, 5, flush), 4)
                     for k, fn in stages.items()}
    breakdown["head (model - trunk)"] = round(
        breakdown["model"] - breakdown["trunk"], 4)
    print(f"breakdown ms/batch-8: {json.dumps(breakdown)} {stamp}",
          flush=True)

    # -- 6. K4 --------------------------------------------------------------
    # the plain version's products in full f32 (no TF32), from the same
    # bf16-rounded operands as the kernel's
    torch.backends.cudnn.allow_tf32 = False
    k4 = {}
    for i, (name, shape) in enumerate(K4_BLOCKS.items()):
        *dims, dil = shape
        c0 = dims[1]
        bargs = dense_block_case(np.random.default_rng(10 + i), *dims, dev)
        got = kernels.dense_block_eval(*bargs, dilation=dil)
        ref = kernels.dense_block_eval_plain(*bargs, dilation=dil)
        max_rel, mean_rel, max_abs = rel_err(got[:, c0:], ref[:, c0:])
        same_x0 = torch.equal(got[:, :c0], bargs[0])
        print(f"K4 dense_block_eval {name} {list(dims[:4])} -> "
              f"{list(got.shape)} L={dims[4]} bf16: max|err|/max|ref| "
              f"{max_rel:.3e} (tol "
              f"{K4_MAX_REL:g}), mean|err|/mean|ref| {mean_rel:.3e} (tol "
              f"{K4_MEAN_REL:g}), max|err| {max_abs:.3e}, input channels "
              f"copied exactly: {same_x0}", flush=True)
        assert same_x0 and max_rel <= K4_MAX_REL and mean_rel <= K4_MEAN_REL, \
            f"K4 disagrees with its plain version at {name}"
        del got, ref
        ms = time_ms(lambda: kernels.dense_block_eval(*bargs, dilation=dil),
                     20, flush)
        plain_ms = time_ms(lambda: kernels.dense_block_eval_plain(
            *bargs, dilation=dil), 3, flush)
        lib_ms = time_ms(dense_block_convs(*dims, dil, dev), 20, flush)
        flop, nbytes = kernels.dense_block_work(*dims)
        bound_ms, bound_by = bound(flop, nbytes, PEAK_BF16)
        gflop = flop / 1e9
        print(f"K4 {name}: {gflop:.2f} GFLOP, {nbytes / 1e6:.1f} MB; bound "
              f"{bound_ms:.4f} ms ({bound_by}); kernel {ms:.4f} ms "
              f"({gflop / ms:.1f} TFLOP/s, {bound_ms / ms:.1%} of the bound), "
              f"plain {plain_ms:.4f} ms ({gflop / plain_ms:.1f} TFLOP/s); "
              f"cuDNN's {2 * dims[4]} convs alone {lib_ms:.4f} ms "
              f"({gflop / lib_ms:.1f} TFLOP/s) {stamp}", flush=True)
        k4[name] = dict(ms=ms, plain_ms=plain_ms, max_abs=max_abs,
                        max_rel=max_rel, mean_rel=mean_rel, lib_ms=lib_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
    torch.backends.cudnn.allow_tf32 = True

    # -- 7. fast_eval slice --------------------------------------------------
    # (a) the engine on the card against the engine on the CPU (its plain
    # path), bf16 both, at 2x64x128, same seeded weights and input
    rpn = perturbed_rpn3d(seed=3)
    engine_cpu = FastEvalRPN3D(rpn, torch.bfloat16)
    engine_gpu = copy.deepcopy(engine_cpu).to(
        dev, memory_format=torch.channels_last)
    x = torch.randn((2, 3, 64, 128), generator=torch.Generator().manual_seed(
        4)).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        out_c = engine_cpu(x)
        out_g = engine_gpu(x.to(dev))
    max_rel, mean_rel, _ = rel_err(out_g.fused_raw.cpu(), out_c.fused_raw)
    acc_err = (out_g.accept_prob.cpu() - out_c.accept_prob).abs().max().item()
    print(f"fast_eval (a): GPU vs CPU path at 2x64x128 bf16, fused_raw "
          f"{list(out_c.fused_raw.shape)}: max|err|/max|ref| {max_rel:.3e} "
          f"(tol {FE_MAX_REL:g}), mean|err|/mean|ref| {mean_rel:.3e} (tol "
          f"{FE_MEAN_REL:g}); accept_prob max|err| {acc_err:.3e} (tol "
          f"{FE_ACCEPT_ATOL:g})", flush=True)
    assert max_rel <= FE_MAX_REL and mean_rel <= FE_MEAN_REL and \
        acc_err <= FE_ACCEPT_ATOL, "fast_eval on the card disagrees with CPU"
    del engine_cpu, engine_gpu

    # (b) against the rpn3d engine at full size, one perturbed RPN3D
    rpn = rpn.to(dev, memory_format=torch.channels_last)
    engine_full = FastEvalRPN3D(rpn, torch.bfloat16)
    with torch.inference_mode():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out_r, out_f = rpn(images), engine_full(images)
        det_args = (rois, rois_3d, p2, p2_inv, scale, bmeans, bstds, dcfg)
        d_r, v_r = im_detect_3d(rpn_outputs_dict(out_r), *det_args)
        d_f, v_f = im_detect_3d(rpn_outputs_dict(out_f), *det_args)
    max_rel, mean_rel, _ = rel_err(out_f.fused_raw, out_r.fused_raw)
    matched = total = 0
    for i in range(batch):
        a, b = d_r[i][v_r[i], :4], d_f[i][v_f[i], :4]
        total += len(a)
        if len(a) and len(b):
            matched += int((pairwise_iou(a, b).amax(1) >= 0.9).sum())
    print(f"fast_eval (b): vs rpn3d at 8x512x1760 bf16, perturbed BN, "
          f"fused_raw {list(out_f.fused_raw.shape)}: max|err|/max|ref| "
          f"{max_rel:.3e} (tol {FE_MAX_REL:g}), mean|err|/mean|ref| "
          f"{mean_rel:.3e} (tol {FE_MEAN_REL:g}); top-40 overlap {matched} "
          f"of {total} rpn3d rows (IoU >= 0.9 with a fast_eval row; "
          f"{int(v_f.sum())} fast_eval rows)", flush=True)
    assert max_rel <= FE_MAX_REL and mean_rel <= FE_MEAN_REL, \
        "fast_eval disagrees with rpn3d"
    del rpn, engine_full, out_r, out_f

    # (c) the flagship through make_infer with engine="fast_eval", timed
    infer_f, args_f, engine = build_flagship(device="cuda", engine="fast_eval")
    for _ in range(WARMUP):
        infer_f(*args_f)
    torch.cuda.synchronize()
    kernels.fused_head_scores.launches = 0
    kernels.greedy_nms.launches = 0
    kernels.dense_block_eval.launches = 0
    t0 = time.perf_counter()
    for _ in range(TIMED):
        dets, valid = infer_f(*args_f)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    fe_launches = {"fused_head_scores": kernels.fused_head_scores.launches,
                   "greedy_nms": kernels.greedy_nms.launches,
                   "dense_block_eval": kernels.dense_block_eval.launches}
    assert fe_launches == {"fused_head_scores": TIMED, "greedy_nms": TIMED,
                           "dense_block_eval": 2 * TIMED}, \
        f"expected K4 twice and K1, K2 once per batch, got {fe_launches}"
    dets, valid = dets.cpu(), valid.cpu()
    assert dets.shape == (batch, 40, 17) and valid.shape == (batch, 40)
    assert valid.any() and torch.isfinite(dets[valid]).all(), \
        "no or non-finite fast_eval detections"
    print(f"fast_eval (c): {TIMED} batches of {batch} at 512x1760 bf16 in "
          f"{wall_f * 1e3:.1f} ms: {batch * TIMED / wall_f:.2f} img/s, "
          f"{wall_f * 1e3 / TIMED:.2f} ms/batch; launches {fe_launches}; "
          f"{int(valid.sum())} valid rows {stamp}", flush=True)

    with torch.inference_mode():
        bb = engine.backbone
        x = bb.stem(images)
        k4_inputs = []
        for stage in bb.stages:
            if isinstance(stage, KernelDenseBlock):
                k4_inputs.append((stage, x))
            x = stage(x)
        (blk1, x1), (blk2, x2) = k4_inputs
        fe_stages = {
            "rpn3d trunk": lambda: forward(model.backbone),
            "fast_eval trunk": lambda: bb(images),
            "K4 block1": lambda: blk1(x1),
            "K4 block2": lambda: blk2(x2),
            "fast_eval model": lambda: engine(images),
        }
        fe_breakdown = {k: round(time_ms(fn, 5, flush), 4)
                        for k, fn in fe_stages.items()}
    fe_breakdown["fast_eval trunk outside K4"] = round(
        fe_breakdown["fast_eval trunk"] - fe_breakdown["K4 block1"]
        - fe_breakdown["K4 block2"], 4)
    print(f"fast_eval breakdown ms/batch-8: {json.dumps(fe_breakdown)} "
          f"{stamp}", flush=True)


    # -- 8-11. K3, the grouping and the operator, GrooMeD-NMS at test time,
    # training ---------------------------------------------------------------
    del model, engine, infer, infer_f, args_f, images, outs, bb, x1, x2, \
        k4_inputs, stages, fe_stages
    torch.cuda.empty_cache()
    k3 = k3_phase(dev, flush, stamp)
    group = group_phase(dev, flush, stamp)
    operator_phase(dev, flush, stamp)
    groomed_test_phase(stamp)
    train_launches = train_phase(stamp)

    # -- 12. results ----------------------------------------------------------
    # bounds at the timed shapes: K1 reads the bf16 head and the f32
    # acceptance and writes f32 scores; K2 tests each pair of rows once and
    # moves boxes, scores and keep (its times on the main path's own input,
    # the flagship's decoded rows); K3 tests the lower triangle and writes
    # two f32 [B, N, N] matrices; the grouping reads m's strict lower
    # triangle.  No single PyTorch call computes K1-K3's functions or the
    # grouping (library_ms null); K4's is its cuDNN yardstick (phase 6)
    b, r, per = K1_SHAPE                    # 4 class logits a row
    k1_bound = bound(b * r * 4 * HEAD_OPS, b * r * (per * 2 + 4 + 4),
                     PEAK_F32)
    k2_bound = k2_work_bound(*K2_SHAPE)
    k4_ops = sum(kernels.dense_block_work(*s[:-1])[0]
                 for s in K4_BLOCKS.values())
    k4_bytes = sum(kernels.dense_block_work(*s[:-1])[1]
                   for s in K4_BLOCKS.values())
    k4_bound = bound(k4_ops, k4_bytes, PEAK_BF16)
    print(json.dumps({"kernels": [
        {"name": "fused_head_scores", "route": "triton",
         "source": "groomed_nms_torch/ops/kernels.py",
         "replaces": "groomed_nms_tpu/ops/pallas_kernels.py:146",
         "launches": launches["fused_head_scores"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "greedy_nms", "route": "cuda",
         "source": "groomed_nms_torch/csrc/greedy_nms.cu",
         "replaces": "groomed_nms_tpu/ops/pallas_kernels.py:266",
         "launches": launches["greedy_nms"], "max_abs_err": 0.0,
         "ms": k2["flagship"]["ms"], "plain_ms": k2["flagship"]["plain_ms"],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
        # one batch's two blocks: ms, plain_ms, bound_ms and library_ms are
        # block 1 + block 2
        {"name": "dense_block_eval", "route": "cuda",
         "source": "groomed_nms_torch/csrc/dense_block.cu",
         "replaces": "groomed_nms_tpu/ops/pallas_dense_block.py:140",
         "launches": fe_launches["dense_block_eval"],
         "max_abs_err": max(v["max_abs"] for v in k4.values()),
         "max_rel_err": max(v["max_rel"] for v in k4.values()),
         "mean_rel_err": max(v["mean_rel"] for v in k4.values()),
         "ms": sum(v["ms"] for v in k4.values()),
         "plain_ms": sum(v["plain_ms"] for v in k4.values()),
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "library_ms": sum(v["lib_ms"] for v in k4.values())},
        # launches: the full-size train loop's; ms at its shape [8, 512, 4]
        {"name": "fused_iou_prune", "route": "cuda",
         "source": "groomed_nms_torch/csrc/iou_prune.cu",
         "replaces": "groomed_nms_tpu/ops/pallas_kernels.py:76",
         "launches": train_launches["fused_iou_prune"],
         "max_abs_err": max(v["max_abs"] for v in k3.values()),
         "ms": k3["train"]["ms"], "plain_ms": k3["train"]["plain_ms"],
         "bound_ms": k3["train"]["bound_ms"],
         "bound_by": k3["train"]["bound_by"], "library_ms": None},
        # no TPU kernel: the JAX grouping is a lax.while_loop; launches the
        # train loop's, ms on the operator's own input at [8, 512]
        {"name": "group_leaders", "route": "cuda",
         "source": "groomed_nms_torch/csrc/group_leaders.cu",
         "replaces": "groomed_nms_tpu/ops/groomed_nms.py:94",
         "launches": train_launches["group_leaders"], "max_abs_err": 0.0,
         "ms": group["ms"], "plain_ms": group["plain_ms"],
         "bound_ms": group["bound_ms"], "bound_by": group["bound_by"],
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
