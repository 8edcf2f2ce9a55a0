#!/usr/bin/env python3
"""Smoke run of ``groomed_nms_torch`` on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. device  -- a CUDA card is required; prints its name and power limit;
  2. build   -- nvcc builds the greedy-NMS library (csrc/greedy_nms.cu) into
                build/groomed_nms_torch/, Triton compiles the head-score
                kernel on its first launch;
  3. K1      -- fused_head_scores against its plain version at the main-path
                shape [8, 126720, 18] bf16, with and without acceptance;
  4. K2      -- greedy_nms against its plain version at [8, 3000, 4] with
                clustered boxes, padding rows, equal scores and IoUs at and
                next to the 0.4 threshold: keep masks must be identical;
  5. slice   -- the flagship (DenseNet-121, 36 anchors, acceptance, bf16,
                batch 8, 512x1760) on uint8 375x1242 frames through
                make_infer: checked against the CPU path at a small size,
                then timed; both kernels must launch once per batch; the
                detections must be finite and write 8 KITTI txt files;
  6. the last line: {"ok": true, "device": {...}}.
Every timing line carries the card's name and power limit.  Imports torch,
numpy and groomed_nms_torch only.
"""

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from groomed_nms_torch.config import load_config
from groomed_nms_torch.data.augment import preprocess_images
from groomed_nms_torch.flagship import build_flagship
from groomed_nms_torch.inference import (decode_detections, nms_and_topk,
                                         rpn_outputs_dict, select_top_pre_nms,
                                         write_kitti_detections)
from groomed_nms_torch.ops import _build, kernels

K1_SHAPE = (8, 126720, 18)            # 32 x 110 x 36 anchors, bf16 head
K2_SHAPE = (8, 3000)                  # nms_topN_pre rows per image
WARMUP, TIMED = 3, 10
KITTI_CLASSES = ["Car", "Pedestrian", "Cyclist"]


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
    lib = _build.build("greedy_nms.cu")
    _build.greedy_nms_lib()
    print(f"build: nvcc greedy_nms.cu -> {lib.name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
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
    boxes = torch.from_numpy(boxes_np).to(dev)
    scores = torch.from_numpy(scores_np).to(dev)
    keep = kernels.greedy_nms(boxes, scores, nms_threshold=0.4, shift=1.0)
    keep_ref = kernels.greedy_nms_plain(boxes, scores, nms_threshold=0.4,
                                        shift=1.0)
    n_diff = int((keep != keep_ref).sum().item())
    assert n_diff == 0, f"K2 keep mask differs from the plain version in " \
                        f"{n_diff} of {keep.numel()} rows"
    k2_ms = time_ms(lambda: kernels.greedy_nms(boxes, scores), 50, flush)
    k2_plain_ms = time_ms(lambda: kernels.greedy_nms_plain(boxes, scores),
                          3, flush)
    print(f"K2 greedy_nms {list(K2_SHAPE)}: keep masks identical "
          f"({int(keep.sum())} kept of {keep.numel()}); kernel "
          f"{k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms {stamp}", flush=True)

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

    # -- 6. results -----------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": "fused_head_scores", "route": "triton",
         "source": "groomed_nms_torch/ops/kernels.py",
         "replaces": "groomed_nms_tpu/ops/pallas_kernels.py:146",
         "launches": launches["fused_head_scores"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "greedy_nms", "route": "cuda",
         "source": "groomed_nms_torch/csrc/greedy_nms.cu",
         "replaces": "groomed_nms_tpu/ops/pallas_kernels.py:266",
         "launches": launches["greedy_nms"], "max_abs_err": float(n_diff),
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
