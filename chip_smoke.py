#!/usr/bin/env python3
"""Smoke run of ``groomed_nms_torch`` on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. device  -- a CUDA card is required; prints its name and power limit;
  2. build   -- nvcc builds the greedy-NMS, dense-block (bf16 and f32),
                IoU/prune and grouping libraries (csrc/greedy_nms.cu,
                csrc/dense_block.cu, csrc/dense_block_f32.cu,
                csrc/iou_prune.cu, csrc/group_leaders.cu), and the host
                compiler the PNG unfilter (csrc/png_unfilter.cpp) and the
                C++ evaluator (make -C eval), all at once, into
                build/groomed_nms_torch/ and eval/; prints the -Xptxas -v
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
  6. K4     -- dense_block_eval against its plain version (TF32 off), in
                bf16 and in f32, at DenseNet-121's four block shapes: the
                flagship's kernel blocks 1 [8, 64, 128, 440] -> 256 ch and
                2 [8, 128, 64, 220] -> 512 ch, and blocks 3
                [8, 256, 32, 110] -> 1024 ch and 4 (dilation 2)
                [8, 512, 32, 110] -> 1024 ch; seeded input and folded
                affines; relative errors (bf16 also layer by layer from the
                kernel's own inputs), kernel and plain times, TFLOP/s, the
                bound (kernels.dense_block_work at the card's peaks; f32
                products at 3xTF32's rate) and the kernel's share of it,
                and as a yardstick the block's 2L cuDNN convolutions alone
                at the same shapes in the same dtype; in f32 a call split
                by kernel (tf32_split, the 1x1, the 3x3; torch.profiler)
                beside the earlier design's times (K4_F32_EARLIER);
  7. fast_eval -- the weight-folded engine: (a) on the card against the CPU
                path at 2x64x128 bf16; (b) against the rpn3d engine at full
                size from one RPN3D with perturbed BatchNorm statistics;
                (c) the flagship through make_infer with engine="fast_eval",
                timed: K4 twice per batch, K1 and K2 once; trunk breakdown;
                (d) the f32 engine on the card against the CPU path at
                2x64x128, TF32 off; (e) the f32 flagship (compute_dtype
                None, as the shipped configs) through make_infer, fast_eval
                beside rpn3d at each cuDNN TF32 setting, timed: K4 twice
                per batch in fast_eval and on all four dense blocks in
                rpn3d (its eval trunk in f32), K1 and K2 once;
  8. K3     -- fused_iou_prune against its plain version at the training
                and test-time shape [8, 512, 4] (clustered boxes, padding
                rows) for the three pruning methods, at the analysis shape
                [1, 1000, 4], at the edge sizes K3_EDGE and on boxes whose
                sizes span 2^-25..2^63 (quotients outside the kernel's
                fast range, unions at the 1e-12 clamp and past 2^126);
                kernel and plain times at the two shapes, Gpairs/s, the
                bound (kernels.iou_prune_work) and the share of it;
  9. operator -- the grouping kernel (kernels.group_leaders) against its
                plain version at group_cases() (IoUs with padding holes;
                asymmetric overlaps with ties at the threshold and NaNs;
                group sizes -1, 0, 1, 100; N on both sides of the cluster
                path's limit, each case on the path group_leaders_plan
                names, by the per-path launch counts), timed on the
                operator's own input at [8, 512] and [1, 1000] (one
                cluster launch a call) beside its bound, its split by
                kernel and its plain version; then GrooMeD-NMS (sort,
                K3, grouping, rescoring) on the card against the CPU path
                at [8, 512] and [1, 1000]: one K3 and one grouping launch a
                call, on the cluster path, no host synchronisation
                (torch.cuda sync debug mode "error"), host ms, Mboxes/s
                and the split by stage;
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
 12. eval   -- the evaluation slice: a synthetic KITTI val tree of 40
                frames at 375x1242 and 370x1224, a port checkpoint of a
                perturbed RPN3D and an anchors.npz; scripts/evaluate_torch.py
                at full width (groomed_nms, 512x1760, bf16, batch 8) in three
                modes, each writing rows: (a) grouped (K1 + K2), (b)
                --single-program, (c) GrooMeD-NMS (K1, K3, the grouping),
                with the launches of each run counted; the C++ evaluator's
                AP dict; grouped against single-program in bf16, traced to
                its cause on 8 frames (bf16_divergence: the two modes'
                inputs within 1e-4 in f32 and one bf16 step in bf16, each
                mode's rows the model's on its input, beside a control of
                random one-step moves), and in f32 (TF32 off) row for row;
                the card against the CPU path at 128x416 f32, row for row;
                the loop's img/s after a warm-up pass, over the tree and
                over the tree repeated EVAL_REPEAT times, beside
                make_infer's served img/s and the host's time to queue a
                batch, the share of the loop's wall with a batch in flight,
                the loop again with the decode cache warm, decode ms
                (inflate, unfilter), the copy of a batch and the evaluator's
                seconds;
 13. train entry -- scripts/train_torch.py's main() over a synthetic KITTI
                tree (32 training, 16 validation frames at 375x1242): stage
                1 (kitti_3d_warmup as shipped: DenseNet-121, 512x1760,
                batch 2, f32; 20 steps): anchors.npz learned on the card,
                its anchors identical to prepare_anchors on the CPU path
                and its statistics within STATS_RTOL, the loss finite and
                every weight moved, no kernel launched; stage 2
                (groomed_nms warm-started from stage 1, 20 steps, the
                snapshot evaluation on) under torch.profiler: only the
                acceptance branch left fresh and the log saying so, K3 and
                the grouping once a step, K1 and K2 once an evaluation
                batch, a txt file per val frame and the evaluator's AP
                dict; the same run extended to 40 steps resumes at 20 and
                metrics.csv continues; ms/step, img/s through the loader,
                the host_wait share and the peak memory of each stage, the
                prepare_anchors seconds, the train wall at batch 2 and 8;
                3 loop steps of tiny_synthetic (BatchNorm perturbed) on the
                card against the CPU path (f64 asserted, f32 with TF32 off
                reported);
 14. video  -- the video slice's test path: (a) video_track over three
                synthetic 4-frame clips (models/kalman.py, T 128, M 64) on
                the card against the CPU path under sync debug mode
                "error", f64 identical (f32 reported), a clip's host ms and
                device busy ms and launches; (b) K2 at [4, 64] with padded
                slots against greedy_nms_plain, both timed; (c)
                scripts/test_kalman_torch.py's main() with kitti_3d_full at
                512x1760 f32 on a synthetic tracking tree (8 validation
                clips of 4 frames at 375x1242), a perturbed _un checkpoint
                as its pretrained run, a pose npz: track rows written, K1
                and K2 one launch a clip each, clip/s and the host's share
                of the wall (after a warm-up run), then K1 against its
                plain version on the last clip's head as the path gave it
                ([4, 126720, per] f32, no acceptance), both timed; (d) the
                same script's rows, card against CPU path at 128x416 f32
                (TF32 off, 2 clips); (e) kitti_3d_uncertainty through
                scripts/train_torch.py on phase 13's tree, warm-started from
                its stage 1: only the head of another shape, the un stat
                finite every step, the uncertainty channel moved, ms/step;
 15. video train -- the video stage's training on a synthetic tracking tree
                (16 training records of 4 frames at 375x1242, seed 41) and
                a perturbed _un run of its own (as phase 14 builds one):
                the anchors.npz a kitti_3d_uncertainty run learns on the
                tree (no velocity column) and a checkpoint of that anchor
                count; (a) scripts/train_pose_torch.py's main()
                (kitti_3d_full at 512x1760 f32, 10 steps from that _un
                run): copy_stats turns the _un run's statistics down, so
                the script learns the detector run's anchors and 14-column
                statistics on the card (velocity statistics learned, equal
                to prepare_anchors on the CPU path), the pose loss finite,
                only pose_net moved, every other tensor bit-identical to the
                _un run's; (b)
                scripts/train_torch.py --config kitti_3d_full warm-started
                from that _un run and (a)'s pose npz, 10 steps, then auto-
                resumed to 14: only the velocity channel fresh, the vel
                term finite and rows with a velocity target every step, the
                backbone and its statistics bit-identical, the velocity
                channel moved, no K1-K4 or grouping launch; ms/step after
                step 3, clips/s, the host_wait share and the peak memory of
                each stage; (c) two steps of tiny_video_synthetic through
                scripts/train_torch.py's build_training, VideoTrainLoader
                and device_prefetch on the tree (f64, BatchNorm perturbed)
                card against the CPU path; (d) fused_track_loss and its gradient
                with respect to the poses at T 128, M 64, F 4 in f64, card
                against the CPU path under sync debug mode "error", its host
                ms and launches;
 16. export -- the serving artifacts (groomed_nms_torch/export.py on
                torch.export): (a) the flagship (rpn3d, bf16, batch 8,
                512x1760 from uint8 375x1242) through build_serving_fn ->
                export_serving -> bytes -> load_serving: the loaded artifact
                against the live closure (valid identical, dets within
                ARTIFACT_TOL of 1 + |x|), K1 and K2 once a batch through it,
                the export and load seconds, the artifact's MB, img/s
                through the artifact beside make_infer's (10 batches after
                warm-up); (b) the same with GrooMeD-NMS: K1, K3 and the
                grouping once a batch, K2 never; (c) the video artifact of
                kitti_3d_full (T 128, M 64, F 4): at full width in f32 the
                graph's size, export seconds, MB, one K1 and one K2 launch a
                clip and the loaded artifact against the live closure
                reported; at 128x416 in f64 masks and ids identical and
                numbers within TRACK_TOL of 1 + |x|; (d)
                scripts/serve_torch.py's main() over 16 PNG frames of phase
                12's tree in a directory holding only the artifact, its
                json, the images and the calibs: one txt a frame, the
                375x1242 frames' rows (r = 1) equal to make_infer's on the
                same planes by phase 12's rule;
 17. options -- the options of the entry points: (a)
                scripts/evaluate_torch.py's main() with --refine on phase
                12's tree (groomed_nms, grouped, bf16, batch 8): a txt file
                a frame, K1 and K2 once a batch; the loop's img/s with and
                without --refine, in turns, over the tree x OPTION_REPEAT;
                one batch's refine_detections card against CPU path in f64
                under sync debug mode "error" (f32 reported), its host ms,
                device ms and launches (torch.profiler); (b)
                scripts/train_torch.py's main() with --config groomed_nms
                --set distort_prob=0.5 on phase 13's tree (batch 2, f32,
                512x1760, warm-started from phase 13's stage 1,
                JITTER_STEPS steps): K3 and the grouping once a step, the
                loss finite; ms/step in two runs beside two of the same run
                without jitter, in turns, and phase 13's stage 2; the draws
                of those steps equal on the card and the CPU path, the
                jitter of two training frames card against CPU path; (c)
                soft_nms at N SOFT_NMS_N (the three methods), roi_align on
                a [32, 110, 256] map with 64 rois (values and feature
                gradients), ranknet_loss and custom_mse (values and
                gradients), card against CPU path;
 18. parallel -- data parallelism (groomed_nms_torch/parallel): (a)
                dryrun_multichip(2) on the card (two ranks sharing it
                through gloo): the still-image step with the fused
                preprocess and jitter, 1-vs-2 parity, the video step, the
                sharded evaluation, K3 and the grouping once a step and K1
                and K2 once a batch on each rank; (b) the tiny GrooMeD step
                of two ranks sharing the card against one process in f64,
                every tensor within DP_PARITY_REL of its max and the ranks'
                parameters and running statistics identical, one process
                on the card against the CPU path by phase 13's tiny-loop
                rule; (c) scripts/train_torch.py as stage 2 (groomed_nms,
                f32, 512x1760, global batch DP_BATCH, warm-started from
                phase 13's stage 1 on its tree), DP_STEPS steps with one
                rank on nccl (in this process) and with two ranks sharing
                the card (torchrun, gloo, the last DP_PROFILED steps under
                torch.profiler): ms/step,
                img/s, host_wait and peak memory a rank, K3 and the
                grouping once a step a rank, the collectives a step with
                their device and host ms, finite losses, identical
                parameters on the ranks, one checkpoint a run, and the
                one-rank run resumed to DP_RESUME, its last step under
                torch.profiler (the nccl collectives); (d)
                scripts/evaluate_torch.py on phase 12's tree (groomed_nms,
                f32, TF32 off, batch 8), two ranks (torchrun, gloo, run
                beside (a) and (b) on a copy of phase 12's run directory)
                against one: rows equal by phase 12's
                rule, K1 and K2 once a batch a rank; K4 counted on every
                run of (c) and (d): 0 in training, once a dense block of
                each batch a rank in the f32 evaluation; each
                torchrun's time split (start, imports, main(), the
                profiler's digest, exit) printed;
 19. remat and tools -- (a) build_flagship_train at batch 8, 512x1760,
                bf16 with backbone_remat none, layer and epilogue from the
                same weights and batch: the first step's loss identical to
                the none run's, every gradient within REMAT_GRAD_REL of its
                tensor's max, the running statistics and
                num_batches_tracked identical, K3 and the grouping once a
                step; each mode's ms/step (TIMED steps after WARMUP) and
                peak memory, in turns; (b) scripts/profile_torch.py's
                main() in both modes into a temporary directory: the trace
                parses, K1 and K2 once a batch and K3 and the grouping once
                a step in it; (c) analysis/bench_latency_torch.py at
                batches 1 and 8; (d) analysis/bench_groomed_nms_torch.py at
                N = 1000, its check against the plain versions first; (e)
                analysis/roofline_train_torch.py in train mode (also with
                --remat layer) and infer mode at batch 8, its guard
                untripped; (f) analysis/bench_loader_torch.py on phase 13's
                tree; (g) analysis/compare_video_training_schemes_torch.py
                --iters 4 --batch 2 into a temporary file, every value
                finite or null; each part's kernel launches counted (K4 held
                at 0);
 20. the kernels JSON line (K1 and K2 with a "video" entry each: the check
     at the video path's shape, its times and bound, and its launches; K1,
     K2, K3 and the grouping with an "export" entry: their launches through
     the detection artifacts of phase 16, K1's and K2's through one video
     clip; K1 and K2 with an "options" entry: their launches in the
     --refine run, K3 and the grouping: in the jittered run; each kernel
     with a "parallel" entry: its launches a rank on phase 18's paths; each
     kernel with a "tools" entry: its launches in each part of phase 19),
     then the last line: {"ok": true, "device": {...}}.
Every timing line carries the card's name and power limit.  Imports torch,
numpy and groomed_nms_torch only.  ``chip_smoke.py --rank-worker SCRIPT DIR
[--no-tf32] -- ARGS`` is phase 18's rank under torchrun (``rank_worker``).  Tolerances are fixed below, before any
run; every error is printed before it is checked.
"""

import atexit
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from groomed_nms_torch.config import load_config
from groomed_nms_torch.data.augment import preprocess_images
from groomed_nms_torch.eval.kitti_eval import ensure_binary
from groomed_nms_torch.flagship import (NUM_ANCHORS, build_flagship,
                                        build_flagship_train)
from groomed_nms_torch.inference import (clip_detections, decode_detections,
                                         im_detect_3d, nms_and_topk,
                                         rpn_outputs_dict, select_top_pre_nms,
                                         write_kitti_detections)
from groomed_nms_torch.models.densenet import tiny_densenet_config
from groomed_nms_torch.models.fast_eval import FastEvalRPN3D, KernelDenseBlock
from groomed_nms_torch.models.rpn_3d import RPN3D
from groomed_nms_torch.ops import _build, kernels
from groomed_nms_torch.ops.groomed_nms import groomed_nms_boxes
from groomed_nms_torch.ops.iou import pairwise_iou
from groomed_nms_torch.utils.measure import (PEAK_BF16, PEAK_F32,
                                             PEAK_F32_PRODUCTS, bound,
                                             card_line)
from groomed_nms_torch.utils.weights import init_weights

K1_SHAPE = (8, 126720, 18)            # 32 x 110 x 36 anchors, bf16 head
K2_SHAPE = (8, 3000)                  # nms_topN_pre rows per image
WARMUP, TIMED = 3, 10
KITTI_CLASSES = ["Car", "Pedestrian", "Cyclist"]
# K4 at the flagship's kernel blocks: (B, c0, H, W, L, G, bw, dilation)
K4_BLOCKS = {"block1": (8, 64, 128, 440, 6, 32, 128, 1),
             "block2": (8, 128, 64, 220, 12, 32, 128, 1)}
# and at DenseNet-121's blocks 3-4, which fast_eval runs with K4 when asked
K4_MORE_BLOCKS = {"block3": (8, 256, 32, 110, 24, 32, 128, 1),
                  "block4": (8, 512, 32, 110, 16, 32, 128, 2)}
K4_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# DenseNet-121's dense blocks: K4 calls a batch of RPN3D in f32 eval
TRUNK_BLOCKS = 4
# f32 K4's kernels, split by name in phase 6: the prep kernel (once a call)
# and the 1x1 and 3x3 (L each)
K4_F32_KERNELS = ("tf32_split", "conv1x1_bn_relu", "conv3x3")
# f32 K4's earlier design (the TF32 split inside both product loops, both
# kernels on mma.sync), read in one call by scripts/k4_compare.py --dtype
# f32 on that design's tree (an H100 80GB HBM3 at 700 W): ms a call (CUDA
# events) and its 1x1 / 3x3 kernels' ms (torch.profiler), printed as
# earlier values beside the new design's split; not part of this run
K4_F32_EARLIER = {
    "block1": (6.9113, {"conv1x1_bn_relu": 2.4772, "conv3x3": 4.364}),
    "block2": (5.2759, {"conv1x1_bn_relu": 2.691, "conv3x3": 2.559}),
    "block3": (4.4736, {"conv1x1_bn_relu": 3.0197, "conv3x3": 1.2811}),
    "block4": (3.4448, {"conv1x1_bn_relu": 2.4331, "conv3x3": 0.862})}
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
# the fast_eval engine, fused_raw: max |err| / max |ref|, mean |err| / mean
# |ref| (121 bf16 layers summed in other orders; against rpn3d also the
# folded BatchNorm applied in bf16, where autocast applies it in f32), and
# the acceptance probability's max |err| against the CPU path
FE_MAX_REL, FE_MEAN_REL, FE_ACCEPT_ATOL = 0.05, 0.02, 0.02
# the f32 engine on the card (TF32 off) against the CPU path: 121 f32
# layers summed in other orders
FE32_MAX_REL, FE32_MEAN_REL, FE32_ACCEPT_ATOL = 1e-4, 1e-4, 1e-4
# K3: IoU and the linear prune bit-identical (the same f32 ops in the same
# order, no FMA on either side); the sigmoid and exp of the other two
# methods within 1e-6; the operator's rescored values within 1e-6 of the
# CPU path with identical leaders and keep masks
K3_ATOL, OPERATOR_ATOL = 1e-6, 1e-6
K3_SHAPES = {"train": (8, 512), "analysis": (1, 1000)}
# K3's edge sizes (B, N): one box, ragged tiles, N % 4 != 0 (scalar
# stores), many tiles
K3_EDGE = ((1, 1), (2, 31), (3, 33), (2, 64), (3, 65), (2, 100), (1, 2048))
# the grouping's time at [8, 512] with its earlier design, the bits and
# sweep kernels alone (as first measured by this script on the H100), for
# the line that prints the cluster kernel's beside it
GROUP_TWO_KERNEL_MS = 0.0237
# the grouping kernel: identical to its plain version at each (B, N) of
# group_cases() and each of these group sizes
GROUP_SIZES = (-1, 0, 1, 100)
# one train step of the tiny model at 2x64x128 f32 on the card vs the CPU
# path: stats at rtol 1e-3 (atol 1e-5), parameters within 1e-4 of each
# tensor's max (convolutions and their gradients summed in other orders).
# Not DenseNet-121: at random init its train-mode step turns a 1e-7
# relative change of its weights into a ~0.4% change of the whole update
# (measured on the CPU), so two backends cannot agree on it to 1e-4

TRAIN_RTOL, TRAIN_ATOL, TRAIN_PARAM_REL = 1e-3, 1e-5, 1e-4
# the card's peaks, card_line and bound are groomed_nms_torch/utils/
# measure.py's, shared with the tools
# f32 operations of K1 per logit (exp, sum, max, divide); an IoU test's are
# kernels.IOU_TEST_OPS
HEAD_OPS = 4


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


def dense_block_convs(b, c0, h, w, layers, growth, bw, dil, dev,
                      dtype=torch.bfloat16):
    """K4's yardstick (the port never calls it): the block's 2L cuDNN
    convolutions alone in ``dtype``, channels_last; per layer the 1x1 from
    a contiguous [b, cin, h, w] to bw and the dilated 3x3 from [b, bw, h, w]
    to G.  No BatchNorm, ReLU or concatenation.  Returns a function that
    runs them all (in f32, with whatever ``cudnn.allow_tf32`` is set when
    it runs)."""
    g = torch.Generator(device=dev).manual_seed(0)

    def t(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.1).to(
            dtype).contiguous(memory_format=torch.channels_last)

    xs = [t(b, c0 + l * growth, h, w) for l in range(layers)]
    k1s = [t(bw, c0 + l * growth, 1, 1) for l in range(layers)]
    k2s = [t(growth, bw, 3, 3) for _ in range(layers)]
    hin = t(b, bw, h, w)

    def run():
        for x, k1, k2 in zip(xs, k1s, k2s):
            F.conv2d(x, k1)
            F.conv2d(hin, k2, padding=dil, dilation=dil)
    return run


def dense_block_layer_errors(got, bargs, dil):
    """K4's new channels layer by layer against the plain version fed the
    kernel's own stack (each layer's input channels as the kernel wrote
    them): (max |err| / max |ref|, mean |err| / mean |ref|) over all the new
    channels.  Each layer's rounding is held apart from the steps that
    earlier layers' roundings passed on."""
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


def k4_phase(dev, flush, stamp):
    """Phase 6: K4 against its plain version (TF32 off: products in full
    f32 from the same operands as the kernel's) in each dtype at each of
    DenseNet-121's four block shapes, timed beside its bound, its plain
    version and cuDNN's 2L convolutions in the same dtype (f32 also with
    TF32 on, as cuDNN runs f32 by default).  Returns {dtype: {block:
    figures}}."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    k4 = {}
    for dname, dtype in K4_DTYPES.items():
        f32 = dtype == torch.float32
        k4[dname] = {}
        for i, (name, shape) in enumerate({**K4_BLOCKS,
                                           **K4_MORE_BLOCKS}.items()):
            *dims, dil = shape
            bargs = dense_block_case(np.random.default_rng(10 + i), *dims,
                                     dev, dtype)
            got = kernels.dense_block_eval(*bargs, dilation=dil)
            ok, figures, text = k4_agrees(name, got, bargs, dil)
            print(f"K4 dense_block_eval {name} {list(dims[:4])} -> "
                  f"{list(got.shape)} L={dims[4]} d={dil} {dname}: {text}",
                  flush=True)
            assert ok, f"K4 disagrees with its plain version at {name} {dname}"
            del got
            ms = time_ms(lambda: kernels.dense_block_eval(
                *bargs, dilation=dil), 20, flush)
            plain_ms = time_ms(lambda: kernels.dense_block_eval_plain(
                *bargs, dilation=dil), 3, flush)
            convs = dense_block_convs(*dims, dil, dev, dtype)
            lib_ms = time_ms(convs, 20, flush)
            flop, nbytes = kernels.dense_block_work(
                *dims, elem_bytes=dtype.itemsize)
            bound_ms, bound_by = bound(
                flop, nbytes, PEAK_F32_PRODUCTS if f32 else PEAK_BF16)
            gflop = flop / 1e9
            extra = ""
            lib_tf32_ms = None
            if f32:
                torch.backends.cudnn.allow_tf32 = True
                lib_tf32_ms = time_ms(convs, 20, flush)
                torch.backends.cudnn.allow_tf32 = False
                extra = (f", with TF32 (not f32-accurate) "
                         f"{lib_tf32_ms:.4f} ms")
            del convs
            print(f"K4 {name} {dname}: {gflop:.2f} GFLOP, {nbytes / 1e6:.1f} "
                  f"MB; bound {bound_ms:.4f} ms ({bound_by}); kernel "
                  f"{ms:.4f} ms ({gflop / ms:.1f} TFLOP/s, "
                  f"{bound_ms / ms:.1%} of the bound), plain {plain_ms:.4f} "
                  f"ms ({gflop / plain_ms:.1f} TFLOP/s); cuDNN's "
                  f"{2 * dims[4]} convs alone {lib_ms:.4f} ms "
                  f"({gflop / lib_ms:.1f} TFLOP/s){extra} {stamp}",
                  flush=True)
            k4[dname][name] = dict(
                ms=ms, plain_ms=plain_ms, **figures, lib_ms=lib_ms,
                lib_tf32_ms=lib_tf32_ms, bound_ms=bound_ms,
                bound_by=bound_by)
            if f32:
                split = split_ms(
                    lambda: kernels.dense_block_eval(*bargs, dilation=dil),
                    K4_F32_KERNELS, {"tf32_split": 1,
                                     "conv1x1_bn_relu": dims[4],
                                     "conv3x3": dims[4]})
                earlier_ms, earlier_split = K4_F32_EARLIER[name]
                print(f"K4 {name} f32 a call by kernel (torch.profiler): "
                      f"{json.dumps({k: round(v, 4) for k, v in split.items()})}"
                      f" ms, {ms:.4f} ms in all; earlier design (the split "
                      f"in the product loops, mma.sync; earlier values, "
                      f"K4_F32_EARLIER) {earlier_ms} ms, by kernel "
                      f"{json.dumps(earlier_split)} {stamp}", flush=True)
                k4[dname][name]["split"] = split
            del bargs
    torch.backends.cudnn.allow_tf32 = tf32
    return k4


def serve_rate(infer, args, want):
    """img/s of ``infer`` over TIMED batches after WARMUP (host wall closed
    by ``synchronize()``), with the launches of K1, K2 and K4 in the timed
    batches held to ``want`` (a batch's) and the last batch's rows checked:
    (img/s, launches, the last batch's valid rows)."""
    names = ("fused_head_scores", "greedy_nms", "dense_block_eval")
    for _ in range(WARMUP):
        infer(*args)
    torch.cuda.synchronize()
    for n in names:
        getattr(kernels, n).launches = 0
    t0 = time.perf_counter()
    for _ in range(TIMED):
        dets, valid = infer(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: getattr(kernels, n).launches for n in names}
    assert got == {n: TIMED * want[n] for n in names}, \
        f"expected {want} launches a batch, got {got} in {TIMED} batches"
    batch = args[0].shape[0]
    dets, valid = dets.cpu(), valid.cpu()
    assert dets.shape == (batch, 40, 17) and valid.shape == (batch, 40)
    assert valid.any() and torch.isfinite(dets[valid]).all(), \
        "no or non-finite detections"
    return batch * TIMED / wall, got, int(valid.sum())


def fast_eval_f32_phase(dev, stamp):
    """Phase 7 (d) and (e): the f32 fast_eval engine, K4 in f32.  (d) on
    the card against the CPU path at 2x64x128 with TF32 off, one RPN3D with
    perturbed BatchNorm statistics; (e) the f32 flagship (compute_dtype
    None, as the shipped configs compute) through make_infer at batch 8,
    512x1760, fast_eval beside rpn3d at each cuDNN TF32 setting.  Returns
    the launches of (e)'s fast_eval run with TF32 at its default (on)."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rpn = perturbed_rpn3d(seed=3)
    engine_cpu = FastEvalRPN3D(rpn, torch.float32)
    engine_gpu = copy.deepcopy(engine_cpu).to(
        dev, memory_format=torch.channels_last)
    x = torch.randn((2, 3, 64, 128), generator=torch.Generator().manual_seed(
        4)).contiguous(memory_format=torch.channels_last)
    kernels.dense_block_eval.launches = 0
    with torch.inference_mode():
        out_c = engine_cpu(x)
        out_g = engine_gpu(x.to(dev))
    torch.cuda.synchronize()
    k4_launches = kernels.dense_block_eval.launches
    max_rel, mean_rel, _ = rel_err(out_g.fused_raw.cpu(), out_c.fused_raw)
    acc_err = (out_g.accept_prob.cpu() - out_c.accept_prob).abs().max().item()
    print(f"fast_eval (d): f32 GPU vs CPU path at 2x64x128, TF32 off, "
          f"fused_raw {list(out_c.fused_raw.shape)}: max|err|/max|ref| "
          f"{max_rel:.3e} (tol {FE32_MAX_REL:g}), mean|err|/mean|ref| "
          f"{mean_rel:.3e} (tol {FE32_MEAN_REL:g}); accept_prob max|err| "
          f"{acc_err:.3e} (tol {FE32_ACCEPT_ATOL:g}); K4 launches "
          f"{k4_launches}", flush=True)
    assert k4_launches == 2 and out_g.fused_raw.dtype == torch.float32, \
        "the f32 engine on the card did not run K4 on blocks 1-2"
    assert max_rel <= FE32_MAX_REL and mean_rel <= FE32_MEAN_REL and \
        acc_err <= FE32_ACCEPT_ATOL, "f32 fast_eval on the card disagrees"
    del rpn, engine_cpu, engine_gpu, out_c, out_g

    rates, launches = {}, None
    for cudnn_tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        for engine in ("fast_eval", "rpn3d"):
            infer, args, _ = build_flagship(device="cuda", engine=engine,
                                            compute_dtype=None)
            want = {"fused_head_scores": 1, "greedy_nms": 1,
                    "dense_block_eval": 2 if engine == "fast_eval"
                    else TRUNK_BLOCKS}
            rate, got, _ = serve_rate(infer, args, want)
            rates[engine] = rate
            if engine == "fast_eval" and cudnn_tf32:
                launches = got
            del infer, args
            torch.cuda.empty_cache()
        print(f"fast_eval (e): f32 flagship, {TIMED} batches of 8 at "
              f"512x1760, cudnn.allow_tf32={cudnn_tf32} (matmul TF32 off; "
              f"K4 f32-accurate either way): fast_eval "
              f"{rates['fast_eval']:.2f} img/s (K4 twice, K1 and K2 once a "
              f"batch), rpn3d {rates['rpn3d']:.2f} img/s (K4 {TRUNK_BLOCKS} "
              f"times) {stamp}",
              flush=True)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32
    return launches


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


# the grouping's device kernels: the cluster path's one, the two-kernel
# path's two
GROUP_KERNELS = ("group_cluster", "group_bits", "group_sweep")


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


def group_cases():
    """The grouping's (B, N) checks: row-block edges (63-65, 128 on two
    CTAs, 576 on nine), the cluster path's limit on both sides, the
    two-kernel path and its largest N.  A function, not a constant, so that
    ``scripts/k3_compare.py`` can load this file beside an older package."""
    limit = kernels._GROUP_CLUSTER_MAX_N
    return tuple((b, n) for n in (1, 63, 64, 65, 128, 512, 576, 1000,
                                  limit - 1, limit, limit + 1, 4096)
                 for b in (1, 8)) + ((1, kernels._GROUP_MAX_N),)


def group_path_launches():
    """{path: launches so far} of the grouping kernel's two paths."""
    return {"cluster": kernels.group_leaders.cluster_launches,
            "two_kernel": kernels.group_leaders.two_kernel_launches}


def group_phase(dev, flush, stamp):
    """The grouping kernel against its plain version at group_cases(), each
    case on the path ``group_leaders_plan`` names (by the per-path launch
    counts), then timed on the operator's own input (K3's IoU of the sorted
    rows) at each of K3_SHAPES.  Returns {ms, plain_ms, bound_ms, bound_by,
    split} at [8, 512] with the same under "analysis" at [1, 1000], and
    "paths": the per-path launches of the timed calls."""
    cases = group_cases()
    for b, n in cases:
        path = kernels.group_leaders_plan(n).path
        for kind in ("iou", "mixed"):
            m, valid = group_case(b, n, kind, dev, seed=b * n)
            for gs in GROUP_SIZES:
                kw = dict(nms_threshold=0.4, group_size=gs)
                before = group_path_launches()
                got = kernels.group_leaders(m, valid, **kw)
                after = group_path_launches()
                assert {k: after[k] - before[k] for k in after} == {
                    k: int(k == path) for k in after}, \
                    f"group_leaders at [{b}, {n}] did not take the " \
                    f"{path} path: {before} -> {after}"
                ref = kernels.group_leaders_plain(m, valid, **kw)
                assert torch.equal(got, ref), \
                    f"group_leaders differs from its plain version at " \
                    f"[{b}, {n}] {kind}, group_size {gs}"
    limit = kernels._GROUP_CLUSTER_MAX_N
    print(f"group_leaders: identical to its plain version at {len(cases)}"
          f" (B, N) from [1, 1] to [1, {kernels._GROUP_MAX_N}], IoU and "
          f"asymmetric overlaps (ties at the threshold, NaN), group sizes "
          f"{list(GROUP_SIZES)}; N <= {limit} on the cluster path, above it "
          f"on the two-kernel path, as planned", flush=True)
    out = {}
    for name, (b, n) in K3_SHAPES.items():
        boxes_np, scores_np = k3_case(name, b, n)
        valid = torch.from_numpy(scores_np > 0).to(dev)
        m = kernels.fused_iou_prune(torch.from_numpy(boxes_np).to(dev),
                                    valid)[0]
        kw = dict(nms_threshold=0.4, group_size=100)
        plan = kernels.group_leaders_plan(n)
        leader = kernels.group_leaders(m, valid, **kw)
        assert torch.equal(leader, kernels.group_leaders_plain(m, valid, **kw))
        leaders = int((leader == torch.arange(n, device=dev)).sum())
        before = group_path_launches()
        ms = time_ms(lambda: kernels.group_leaders(m, valid, **kw), 50, flush)
        after = group_path_launches()
        paths = {k: after[k] - before[k] for k in after}
        assert paths == {"cluster": 51, "two_kernel": 0}, \
            f"the grouping at [{b}, {n}] left the cluster path: {paths}"
        plain_ms = time_ms(lambda: kernels.group_leaders_plain(m, valid, **kw),
                           10, flush)
        split = split_ms(lambda: kernels.group_leaders(m, valid, **kw),
                         GROUP_KERNELS)
        bound_ms, bound_by = bound(*kernels.group_leaders_work(b, n), PEAK_F32)
        earlier = f", earlier design (bits + sweep) {GROUP_TWO_KERNEL_MS} " \
            f"ms" if name == "train" else ""
        print(f"group_leaders on the operator's input {name} [{b}, {n}] "
              f"({int(valid.sum())} valid rows, {leaders} leaders), "
              f"{plan.path} path, {plan.ctas} CTAs, {plan.smem} B of shared "
              f"memory a CTA: kernel "
              f"{ms:.4f} ms ({bound_ms / ms:.1%} of the {bound_ms:.4f} ms "
              f"bound by {bound_by}){earlier}, plain {plain_ms:.4f} ms; a call "
              f"by kernel (torch.profiler) "
              f"{json.dumps({k: round(v, 4) for k, v in split.items()})}; "
              f"launches by path over the timed calls {json.dumps(paths)} "
              f"{stamp}", flush=True)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, split=split, paths=paths,
                         plan=plan._asdict())
    return dict(out.pop("train"), analysis=out["analysis"])


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
        paths = group_path_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = groomed_nms_boxes(*args_g)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = {"fused_iou_prune": kernels.fused_iou_prune.launches,
                    "group_leaders": kernels.group_leaders.launches}
        assert launches == {"fused_iou_prune": 1, "group_leaders": 1}, \
            f"expected one K3 and one grouping launch a call, got {launches}"
        assert group_path_launches()["cluster"] == paths["cluster"] + 1, \
            "the operator's grouping left the cluster path"
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


# the evaluation slice (phase 12): a synthetic KITTI val tree at two of
# KITTI's sizes, frames alternating; KITTI txt rows compared as the CPU
# tests compare them: the same files, rows and classes, every number within
# 1e-3 absolute + 1e-4 relative
EVAL_FRAMES, EVAL_SIZES = 40, ((375, 1242), (370, 1224))
EVAL_REPEAT = 10                      # the tree's records repeated for timing
TXT_ATOL, TXT_RTOL = 1e-3, 1e-4
EVAL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_eval")


def read_rows(data_dir):
    """{file: [(class, numbers)]} of a directory of KITTI txt files."""
    out = {}
    for name in sorted(os.listdir(data_dir)):
        with open(os.path.join(data_dir, name)) as f:
            out[name] = [(p[0], np.array([float(v) for v in p[1:]]))
                         for p in (ln.split() for ln in f.read().splitlines())]
    return out


def row_agreement(got, want):
    """(files and row counts and classes all equal, rows compared, rows
    within TXT_ATOL + TXT_RTOL * |want|, max |err| over compared numbers)."""
    same = sorted(got) == sorted(want)
    n = ok = 0
    max_err = 0.0
    for name, rows in want.items():
        g = got.get(name, [])
        same &= len(g) == len(rows)
        for (cls_g, v_g), (cls_w, v_w) in zip(g, rows):
            same &= cls_g == cls_w
            err = np.abs(v_g - v_w)
            n += 1
            ok += bool(np.all(err <= TXT_ATOL + TXT_RTOL * np.abs(v_w)))
            max_err = max(max_err, float(err.max()))
    return same, n, ok, max_err


def box_matches(got, want, px=1.0):
    """Rows of ``want`` with a row of the same class in the same file of
    ``got`` whose 2D box is within ``px`` pixels on every side."""
    n = 0
    for name, rows in want.items():
        cand = got.get(name, [])
        for cls_w, v_w in rows:
            n += any(c == cls_w and np.abs(v[3:7] - v_w[3:7]).max() <= px
                     for c, v in cand)
    return n


def bf16_step(x):
    """The spacing of bf16 values at magnitude ``x`` (0 at 0)."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs())) - 7)


def bf16_divergence(model, cfg, imdb, rois, rois_3d, dev, flush, stamp):
    """Why grouped and single-program rows differ in bf16, at full width.

    Eight frames of the smaller size, preprocessed as each mode does:
    statically (grouped) and edge-padded into the larger plane and
    resampled (single-program).  Checked: the two inputs agree within 1e-4
    in f32 (the resample's products out of TF32's reach, with TF32
    allowed globally), and in bf16 every element within 1e-4 plus one
    bf16 step at its magnitude (near zero an f32 difference spans many
    steps); each mode's rows through ``make_infer`` are the model's rows
    on that input, and the model gives the same rows on one input twice.
    So the two modes' bf16 rows differ only through inputs one rounding
    apart.  Beside them a control moves as many elements of the grouped
    input, chosen at random, by one bf16 step: the head's divergence on
    the single-program input must stay within twice the control's."""
    from groomed_nms_torch.data import png
    from groomed_nms_torch.data.augment import (pad_image_edge,
                                                preprocess_images_dynamic)
    from groomed_nms_torch.eval import tester

    b, (h0, w0) = 8, EVAL_SIZES[0]
    recs = [r for r in imdb if (r.im_h, r.im_w) == EVAL_SIZES[1]][:b]
    frames = np.stack([png.read_png(r.image_path) for r in recs])
    plane = np.stack([pad_image_edge(f, h0, w0) for f in frames])
    p2 = np.stack([r.p2 for r in recs]).astype(np.float32)

    def on_dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    target_h, crop_w = cfg.crop_size
    means, stds = on_dev(cfg.image_means), on_dev(cfg.image_stds)
    hw = on_dev([[r.im_h, r.im_w] for r in recs])
    rest = (on_dev(rois), on_dev(rois_3d), on_dev(p2),
            on_dev(np.linalg.inv(p2)),
            on_dev([target_h / r.im_h for r in recs]), on_dev(np.zeros(13)),
            on_dev(np.ones(13)))
    size = dict(target_h=target_h, crop_w=crop_w)
    u8_a, u8_b = on_dev(frames, torch.uint8), on_dev(plane, torch.uint8)
    x_a = preprocess_images(u8_a, None, means, stds, **size)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x_b = preprocess_images_dynamic(u8_b, hw, means, stds, **size)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    pre_ms = {
        "static": time_ms(lambda: preprocess_images(
            u8_a, None, means, stds, out_dtype=torch.bfloat16, **size), 5,
            flush),
        "dynamic": time_ms(lambda: preprocess_images_dynamic(
            u8_b, hw, means, stds, out_dtype=torch.bfloat16, **size), 5,
            flush)}
    f32_err = float((x_a - x_b).abs().max())
    a16, b16 = x_a.bfloat16(), x_b.bfloat16()
    diff = (a16.float() - b16.float()).abs()
    room = 1e-4 + bf16_step(torch.maximum(a16.float().abs(),
                                          b16.float().abs()))
    n_moved = int((diff > 0).sum())
    worst = float((diff / room).max())
    # the control: as many elements of the grouped input, at random, one
    # bf16 step away from zero
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pick = torch.randperm(a16.numel(), generator=gen, device=dev)[:n_moved]
    c16 = a16.clone(memory_format=torch.contiguous_format)
    c16.view(-1).view(torch.int16)[pick] += 1
    c16 = c16.contiguous(memory_format=torch.channels_last)
    dcfg = cfg.detect_config()
    lbls = list(cfg.lbls)

    @torch.inference_mode()
    def detect(x):
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            out = model(x)
        return out.fused_raw.float(), im_detect_3d(rpn_outputs_dict(out),
                                                   *rest, dcfg)

    def rows(dets_valid, name):
        dets, valid = (t.cpu().numpy() for t in dets_valid)
        out = os.path.join(EVAL_DIR, "bf16_" + name)
        os.makedirs(out)
        for bi, rec in enumerate(recs):
            d = dets[bi]
            if cfg.clip_boxes:
                d = clip_detections(d, rec.im_w, rec.im_h)
            write_kitti_detections(os.path.join(out, rec.id + ".txt"), d,
                                   valid[bi], lbls,
                                   score_thres=cfg.score_thres)
        return read_rows(out)

    infer = tester.make_infer(model, dcfg, target_h, crop_w, torch.bfloat16)
    rows_ia = rows(infer(on_dev(frames, torch.uint8), means, stds, *rest),
                   "infer_a")
    rows_ib = rows(infer(on_dev(plane, torch.uint8), means, stds, *rest,
                         src_hw=hw), "infer_b")
    head, rows_x = {}, {}
    for name, x in (("a", a16), ("a_again", a16), ("b", b16),
                    ("control", c16)):
        head[name], dv = detect(x)
        rows_x[name] = rows(dv, name)
    ref = head["a"]

    rel = {name: float((head[name] - ref).abs().mean() / ref.abs().mean())
           for name in head}

    def diverge(name):
        same, n, ok, err = row_agreement(rows_x[name], rows_x["a"])
        return (f"{ok} of {n} rows within {TXT_ATOL:g} + {TXT_RTOL:g}*|x| in "
                f"order (files/rows/classes equal {same}), max |err| "
                f"{err:.3e}, {box_matches(rows_x[name], rows_x['a'])} of {n} "
                f"with a row of their class within 1 px; the head's "
                f"mean|diff|/mean|ref| {rel[name]:.3e}")

    print(f"eval bf16 divergence, 8 frames {EVAL_SIZES[1]}: single-program "
          f"input vs grouped, f32 max |err| {f32_err:.3e} (tol 1e-4, the "
          f"static resize's), bf16 {n_moved} of {a16.numel()} elements "
          f"moved, max |diff| {float(diff.max()):.3e}, at most {worst:.3f} "
          f"of 1e-4 + one bf16 step at its magnitude (tol 1); "
          f"device ms a batch of {b}: static preprocess "
          f"{pre_ms['static']:.4f}, dynamic {pre_ms['dynamic']:.4f} {stamp}",
          flush=True)
    for name in ("a_again", "b", "control"):
        print(f"eval bf16 divergence, model on input {name} vs on input a: "
              f"{diverge(name)}", flush=True)
    for got, want, what in ((rows_ia, rows_x["a"], "grouped"),
                            (rows_ib, rows_x["b"], "single-program")):
        same, n, ok, err = row_agreement(got, want)
        print(f"eval bf16 divergence, {what} make_infer vs the model on its "
              f"input: {ok} of {n} rows, max |err| {err:.3e}", flush=True)
        assert same and ok == n, \
            f"{what} rows are not the model's on its input"
    same, n, ok, _ = row_agreement(rows_x["a_again"], rows_x["a"])
    assert same and ok == n, "the bf16 model's rows differ on one input"
    assert f32_err <= 1e-4, "the two modes' f32 inputs differ"
    assert worst <= 1.0, "the two modes' bf16 inputs differ"
    assert rel["b"] <= 2 * rel["control"], \
        "the single-program head diverges beyond one-step input moves"
    print(f"eval bf16 divergence checked {stamp}", flush=True)


def eval_phase(dev, flush, stamp):
    """12: scripts/evaluate_torch.py over a synthetic val tree, checked and
    timed (see the module docstring)."""
    import importlib.util
    import shutil

    from groomed_nms_torch.anchors import locate_anchors
    from groomed_nms_torch.config import apply_overrides
    from groomed_nms_torch.data import png
    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.data.synthetic import (crop_to_sizes,
                                                  make_synthetic_kitti)
    from groomed_nms_torch.eval import tester
    from groomed_nms_torch.eval.kitti_eval import \
        evaluate_kitti_results_verbose
    from groomed_nms_torch.flagship import flagship_priors
    from groomed_nms_torch.training.checkpoint import save_checkpoint

    print(f"eval: make {shutil.which('make')}, g++ {shutil.which('g++')}, "
          f"c++ {shutil.which('c++')}", flush=True)
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    data_root = os.path.join(EVAL_DIR, "data")
    out_root = os.path.join(EVAL_DIR, "output")
    root = os.path.join(data_root, "kitti_split1")
    t0 = time.perf_counter()
    make_synthetic_kitti(root, "validation", EVAL_FRAMES, seed=12,
                         classes=("Car", "Pedestrian", "Cyclist"))
    crop_to_sizes(root, "validation", EVAL_SIZES)
    run_dir = os.path.join(out_root, "groomed_nms")
    os.makedirs(run_dir)
    priors = flagship_priors()
    np.savez(os.path.join(run_dir, "anchors.npz"), anchors=priors,
             bbox_means=np.zeros(13), bbox_stds=np.ones(13))
    model = perturbed_rpn3d(seed=7)
    save_checkpoint(run_dir, model, step=0)
    imdb = build_imdb(root, "validation")
    sizes = sorted({(r.im_h, r.im_w) for r in imdb})
    print(f"eval: {len(imdb)} frames at sizes {sizes}, anchors.npz and "
          f"checkpoint_0.pt written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    assert sizes == sorted(EVAL_SIZES)

    spec = importlib.util.spec_from_file_location(
        "evaluate_torch", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "scripts", "evaluate_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    results = os.path.join(run_dir, "results", "results_0", "data")
    base = ["--config", "groomed_nms", "--data-root", data_root, "--output",
            out_root, "--restore", "0", "--batch", "8", "--set",
            "score_thres=0.0"]
    names = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
             "group_leaders")

    def run(name, *extra, device="cuda", dtype="bfloat16"):
        """One run of the script; returns (AP dict, rows, launches)."""
        shutil.rmtree(results, ignore_errors=True)   # no earlier run's files
        for n in names:
            getattr(kernels, n).launches = 0
        t = time.perf_counter()
        ap = script.main([*base, "--device", device, "--set",
                          f"compute_dtype={dtype}", *extra])
        wall = time.perf_counter() - t
        launches = {n: getattr(kernels, n).launches for n in names}
        keep = os.path.join(EVAL_DIR, name)
        shutil.copytree(results, keep)
        rows = read_rows(keep)
        n_rows = sum(len(v) for v in rows.values())
        print(f"eval ({name}): {len(rows)} txt files, {n_rows} rows, "
              f"launches {launches}, {wall:.1f} s with set-up and the "
              f"evaluator {stamp}", flush=True)
        assert n_rows > 0, f"mode {name} wrote no row"
        return ap, rows, launches

    groomed = ("--set", "use_differentiable_nms_at_test=True", "--set",
               "diff_nms_valid_box_prob_threshold=0.0")
    b = 8
    n_grouped = sum(-(-sum(1 for r in imdb if (r.im_h, r.im_w) == sz) // b)
                    for sz in EVAL_SIZES)
    n_single = -(-len(imdb) // b)
    ap_a, rows_a, launch_a = run("a_grouped")
    _, rows_b, launch_b = run("b_single_program", "--single-program")
    _, rows_c, launch_c = run("c_groomed", *groomed)
    assert launch_a == dict(fused_head_scores=n_grouped, greedy_nms=n_grouped,
                            fused_iou_prune=0, group_leaders=0), launch_a
    assert launch_b == dict(fused_head_scores=n_single, greedy_nms=n_single,
                            fused_iou_prune=0, group_leaders=0), launch_b
    assert launch_c == dict(fused_head_scores=n_grouped, greedy_nms=0,
                            fused_iou_prune=n_grouped,
                            group_leaders=n_grouped), launch_c
    assert len(rows_a) == len(rows_b) == len(rows_c) == len(imdb)
    assert isinstance(ap_a, dict) and ap_a["main"], "no AP dict"
    aps = {f"{c} {m}": [round(v, 2) for v in ap]
           for (c, m), ap in sorted(ap_a["main"].items())}
    print(f"eval (a): the evaluator's AP|R40 main pass on random weights "
          f"(means nothing; shows the evaluator ran): {json.dumps(aps)}",
          flush=True)

    # grouped against single-program: in bf16 the two resamples (a 2-tap
    # bilinear kernel in f32, a weight-matrix product) round apart, which
    # can move a trunk input by one bf16 step, so the bf16 rows are
    # reported here and the cause is checked by bf16_divergence; the rows'
    # agreement is checked in f32 with TF32 off, at full width
    same, n, ok, err = row_agreement(rows_b, rows_a)
    print(f"eval (a) vs (b), bf16 (reported): files/rows/classes equal "
          f"{same}; {ok} of {n} rows within {TXT_ATOL:g} + {TXT_RTOL:g}*|x| "
          f"in order, max |err| {err:.3e}; {box_matches(rows_b, rows_a)} of "
          f"{n} (a) rows have a (b) row of their class whose 2D box is "
          f"within 1 px", flush=True)
    cfg = apply_overrides(load_config("groomed_nms"),
                          ["score_thres=0.0", "compute_dtype=bfloat16"])
    model = model.to(dev, memory_format=torch.channels_last)
    rois = locate_anchors(priors, (512 // 16, 1760 // 16), 16)
    rois_3d = priors[rois[:, 4].astype(np.int64), 4:]
    bf16_divergence(model, cfg, imdb, rois, rois_3d, dev, flush, stamp)

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lim = ("--limit", "16")
        _, rows_af, _ = run("a_grouped_f32", *lim, dtype="float32")
        _, rows_bf, _ = run("b_single_program_f32", "--single-program", *lim,
                            dtype="float32")
        same, n, ok, err = row_agreement(rows_bf, rows_af)
        print(f"eval (a) vs (b), f32, TF32 off, 16 frames: files/rows/classes "
              f"equal {same}; {ok} of {n} rows within {TXT_ATOL:g} + "
              f"{TXT_RTOL:g}*|x|; max |err| {err:.3e}", flush=True)
        assert same and ok == n, "grouped and single-program rows disagree"
        # the same tester on the card and on the CPU (the kernels' plain
        # versions) at a small crop, f32, TF32 off
        small = ("--limit", "8", "--set", "crop_size=(128, 416)")
        _, rows_cpu, _ = run("cpu_small_f32", *small, device="cpu",
                             dtype="float32")
        _, rows_gpu, _ = run("card_small_f32", *small, dtype="float32")
        same, n, ok, err = row_agreement(rows_gpu, rows_cpu)
        print(f"eval: card vs CPU path at 128x416 f32, TF32 off, 8 frames: "
              f"files/rows/classes equal {same}; {ok} of {n} rows within "
              f"{TXT_ATOL:g} + {TXT_RTOL:g}*|x|; max |err| {err:.3e}",
              flush=True)
        assert same and ok == n, "the card's rows differ from the CPU path's"
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    # the loop's speed: bf16 grouped, after one warm-up pass, over the tree
    # and over the tree repeated EVAL_REPEAT times (the pipeline's fill and
    # drain amortised), beside make_infer serving one resident batch
    loop_dir = os.path.join(EVAL_DIR, "loop")
    long_imdb = list(imdb) * EVAL_REPEAT

    def loop(recs, **kw):
        stats = {}
        tester.test_kitti_3d(cfg, model, rois, rois_3d, np.zeros(13),
                             np.ones(13), recs, loop_dir, batch_size=b,
                             skip_eval=True, log_fn=lambda s: None,
                             loop_stats=stats, **kw)
        return stats

    loop(imdb)
    stats, steady = loop(imdb), loop(long_imdb)
    infer = tester.make_infer(model, cfg.detect_config(), 512, 1760,
                              torch.bfloat16)
    frames = np.stack([png.read_png(r.image_path) for r in imdb
                       if (r.im_h, r.im_w) == EVAL_SIZES[0]][:b])
    p2 = np.stack([r.p2 for r in imdb if (r.im_h, r.im_w) ==
                   EVAL_SIZES[0]][:b]).astype(np.float32)

    def on_dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    args = (on_dev(frames, torch.uint8), on_dev(cfg.image_means),
            on_dev(cfg.image_stds), on_dev(rois), on_dev(rois_3d), on_dev(p2),
            on_dev(np.linalg.inv(p2)),
            on_dev(np.full((b,), 512 / EVAL_SIZES[0][0], np.float32)),
            on_dev(np.zeros(13)), on_dev(np.ones(13)))
    served_ms = wall_ms(lambda: infer(*args), TIMED)

    def enqueue_ms(fn):
        """Median host time of one call started on an idle card: the
        launches' cost, or the device time once the launch queue fills."""
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        return float(np.median(times))

    enqueue = enqueue_ms(lambda: infer(*args))
    # the same kernels at 128x416 (1/17 of the pixels): the launches alone
    rois_s = locate_anchors(priors, (128 // 16, 416 // 16), 16)
    infer_s = tester.make_infer(model, cfg.detect_config(), 128, 416,
                                torch.bfloat16)
    args_s = (*args[:3], on_dev(rois_s),
              on_dev(priors[rois_s[:, 4].astype(np.int64), 4:]), *args[5:7],
              on_dev(np.full((b,), 128 / EVAL_SIZES[0][0], np.float32)),
              *args[8:])
    infer_s(*args_s)
    enqueue_small = enqueue_ms(lambda: infer_s(*args_s))
    # the same loop with the frames' decode served from the mmap cache
    # (the warm-up pass fills it): what the loop reaches without PNG decode
    cache = os.path.join(EVAL_DIR, "cache")
    loop(imdb, raw_cache_dir=cache)
    cached = loop(long_imdb, raw_cache_dir=cache)

    def rate(st):
        wall = st["wall_s"]
        return (f"{st['images'] / wall:.2f} img/s over {st['images']} "
                f"frames ({wall * 1e3:.1f} ms), a batch in flight on the "
                f"card {st['busy_s'] / wall:.1%} of the loop's wall")

    print(f"eval loop: grouped, bf16, batch {b}, {len(EVAL_SIZES)} sizes, "
          f"after a warm-up pass: the tree {rate(stats)}; the tree x "
          f"{EVAL_REPEAT} {rate(steady)}; the tree x {EVAL_REPEAT} with the "
          f"decode cache warm {rate(cached)}; make_infer serving a "
          f"resident batch of {b} {EVAL_SIZES[0]} frames: "
          f"{b / served_ms * 1e3:.2f} img/s ({served_ms:.2f} ms/batch); one "
          f"call from an idle card returns to the host after {enqueue:.2f} "
          f"ms, at 128x416 after {enqueue_small:.2f} ms (median of 5) "
          f"{stamp}", flush=True)

    # where the loop's host time goes: decode split, the copy of one batch,
    # the evaluator
    inflate_ms, unfilter_ms = [], []
    for r in imdb:
        with open(r.image_path, "rb") as f:
            data = f.read()
        t = time.perf_counter()
        shape, idat = png.read_chunks(data, r.image_path)
        raw = png.inflate(idat, shape, r.image_path)
        t1 = time.perf_counter()
        png.unfilter(raw, shape, r.image_path)
        t2 = time.perf_counter()
        inflate_ms.append((t1 - t) * 1e3)
        unfilter_ms.append((t2 - t1) * 1e3)
    pinned = torch.empty((b, *EVAL_SIZES[0], 3), dtype=torch.uint8,
                         pin_memory=True)
    gpu = torch.empty_like(pinned, device=dev)
    h2d = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gpu.copy_(pinned, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        h2d.append(start.elapsed_time(end))
    t = time.perf_counter()
    evaluate_kitti_results_verbose(
        loop_dir, os.path.join(root, "validation", "label_2"),
        log_fn=lambda s: None)
    eval_s = time.perf_counter() - t
    print(f"eval host: decode ms a frame (median, one thread) inflate "
          f"{np.median(inflate_ms):.3f} + unfilter "
          f"{np.median(unfilter_ms):.3f}; host-to-device "
          f"{np.median(h2d):.3f} ms a batch of {b} {EVAL_SIZES[0]} frames "
          f"({pinned.numel() / 1e6:.1f} MB, pinned); the evaluator "
          f"(main + side pass) {eval_s:.2f} s {stamp}", flush=True)


# the train entry point (phase 13): a synthetic KITTI tree with a training
# and a validation split at KITTI's size; the paper's two stages through
# scripts/train_torch.py at full width; card-vs-CPU rules fixed here.  The
# bbox statistics: stds at rtol 1e-6, means at 1e-6 of |mean| + std (the
# log columns' roundings differ by a step between devices, and a mean that
# cancels to 1e-3 of its column's spread carries them at 1e-3 of its size).
# The tiny loop, BatchNorm perturbed as in phase 11 (perturb_; from
# init_weights a BatchNorm bias starts at 0, so its largest magnitude after
# 3 steps is the updates themselves, and the stem's cancelling BatchNorm
# gradients put 1e-3 of that between two devices' f32 losses): parameters
# within 1e-4 of each tensor's max, asserted with the parameters and the
# trunk in f64 (the loss is f32 by design, as JAX's is), reported in f32
# with TF32 off (9.6e-05 in a first run: too close to the rule for cuDNN
# algorithms that may change between runs)
TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_train")
TRAIN_FRAMES, VAL_FRAMES, TRAIN_STEPS, RESUME_STEPS = 32, 16, 20, 40
STATS_RTOL, TINY_LOOP_REL, TINY_STEPS = 1e-6, 1e-4, 3
STEADY_FROM = 5                       # steps left out of the steady ms/step


def stats_close(got, want, rtol=STATS_RTOL):
    """(means, stds) against a reference: (max |err| / (|mean| + std) of
    the means, max relative error of the stds), asserted within ``rtol``."""
    (gm, gs), (wm, ws) = got, want
    mean_err = float((np.abs(gm - wm) / (np.abs(wm) + ws)).max())
    std_err = float((np.abs(gs - ws) / ws).max())
    assert mean_err <= rtol and std_err <= rtol, (mean_err, std_err)
    return mean_err, std_err


def train_rate(summary):
    """(ms/step over the steps after STEADY_FROM, img/s, host_wait share of
    the loop's wall) of one train_torch.main() run."""
    ends, n = summary["step_end_s"], summary["steps"]
    k = min(STEADY_FROM, n - 1)
    ms = (summary["train_s"] - ends[k - 1]) / (n - k) * 1e3 if k else \
        summary["train_s"] / n * 1e3
    return (ms, summary["batch_size"] / ms * 1e3,
            summary["host_wait_s"] / summary["train_s"])


def count_kernels(prof):
    """{kernel name: launches} of a torch.profiler trace (``kernel_events``)."""
    kernels_ = kernel_events(prof)
    names = ("head_scores", "nms_mask", "nms_sweep", "iou_prune_kernel",
             "group_cluster", "group_bits", "group_sweep")
    return {n: sum(1 for e in kernels_ if n in e.name) for n in names}


def tiny_loop(script, root, device, dtype):
    """TINY_STEPS steps of tiny_synthetic through train_torch's pieces
    (prepare_anchors, build_training, TrainLoader, device_prefetch) on
    ``device`` with parameters in ``dtype``, BatchNorm perturbed
    (``perturb_``); the state_dict on the CPU."""
    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.data.pipeline import (TrainLoader, device_prefetch,
                                                 prepare_anchors)
    cfg = load_config("tiny_synthetic")
    imdb = build_imdb(root, "training")
    anchors, means, stds = prepare_anchors(cfg, imdb, device=device)
    run = script.build_training(cfg, anchors, means, stds, device,
                                param_dtype=dtype)
    perturb_(run.model, seed=5)
    loader = TrainLoader(imdb, cfg, seed=cfg.rng_seed, prefetch=1)
    batches = device_prefetch(script.host_tensors(
        loader, pin=torch.device(device).type == "cuda"), device)
    try:
        for _ in range(TINY_STEPS):
            run.step(run.state, script.raw_batch(next(batches)[1]))
    finally:
        batches.close()
        loader.close()
    return {k: v.detach().cpu() for k, v in run.model.state_dict().items()}


def train_entry_phase(dev, stamp):
    """13: scripts/train_torch.py, the paper's two stages at full width,
    checked and timed (see the module docstring).  Returns the resumed
    stage 2's (ms/step, img/s, host_wait share)."""
    import importlib.util
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.data.pipeline import prepare_anchors
    from groomed_nms_torch.data.synthetic import make_synthetic_kitti
    from groomed_nms_torch.training.checkpoint import checkpoint_path

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    data_root = os.path.join(TRAIN_DIR, "data")
    out_root = os.path.join(TRAIN_DIR, "output")
    root = os.path.join(data_root, "kitti_split1")
    tiny_root = os.path.join(TRAIN_DIR, "tiny")
    t0 = time.perf_counter()
    classes = ("Car", "Pedestrian", "Cyclist")
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda a: make_synthetic_kitti(*a[:3], seed=a[3],
                                                     classes=classes, **a[4]),
                      [(root, "training", TRAIN_FRAMES, 21, {}),
                       (root, "validation", VAL_FRAMES, 22, {}),
                       (tiny_root, "training", 10, 23,
                        dict(im_h=96, im_w=320))]))
    print(f"train entry: a tree of {TRAIN_FRAMES} training and {VAL_FRAMES} "
          f"validation frames at 375x1242 (and 10 at 96x320) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "scripts", "train_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    base = ["--data-root", data_root, "--output", out_root, "--set",
            "display=5"]
    names = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
             "group_leaders")

    def run(*argv):
        for n in names:
            getattr(kernels, n).launches = 0
        t = time.perf_counter()
        summary = script.main([*base, *argv])
        summary["wall_s"] = time.perf_counter() - t
        summary["counts"] = {n: getattr(kernels, n).launches for n in names}
        torch.cuda.empty_cache()
        return summary

    def rate_line(summary):
        ms, ips, wait = train_rate(summary)
        first = summary["start_step"] + STEADY_FROM + 1
        return (f"{ms:.2f} ms/step over steps {first}-"
                f"{summary['start_step'] + summary['steps']} (after "
                f"{STEADY_FROM} warm-up steps), {ips:.2f} img/s through the "
                f"loader, host_wait {wait:.2%} of the loop's wall, peak "
                f"memory after the first step "
                f"{summary['peak_bytes'] / 1e9:.2f} GB")

    # -- stage 1: kitti_3d_warmup as shipped (f32, batch 2), no NMS in loss
    warm_dir = os.path.join(out_root, "kitti_3d_warmup")
    s1 = run("--config", "kitti_3d_warmup", "--max-iter", str(TRAIN_STEPS),
             "--set", "do_test=False")
    cfg1 = load_config("kitti_3d_warmup")
    t = time.perf_counter()
    cpu_stats = prepare_anchors(cfg1, build_imdb(root, "training"),
                                device="cpu")
    cpu_anchor_s = time.perf_counter() - t
    z = np.load(os.path.join(warm_dir, "anchors.npz"))
    assert np.array_equal(z["anchors"], cpu_stats[0]), \
        "anchors learned on the card differ from the CPU path's"
    mean_err, std_err = stats_close((z["bbox_means"], z["bbox_stds"]),
                                    cpu_stats[1:])
    ckpt = torch.load(checkpoint_path(warm_dir, TRAIN_STEPS),
                      map_location="cpu", weights_only=True)["model"]
    fresh = RPN3D(cfg1.rpn_config(z["anchors"].shape[0]))
    init_weights(fresh, torch.Generator().manual_seed(cfg1.rng_seed))
    still = [k for k, v in fresh.state_dict().items()
             if k.endswith("weight") and torch.equal(v, ckpt[k])]
    with open(os.path.join(warm_dir, "metrics.csv")) as f:
        rows = f.read().splitlines()
    totals = [float(r.split(",")[rows[0].split(",").index("total")])
              for r in rows[1:]]
    print(f"train entry (stage 1): kitti_3d_warmup, DenseNet-121, batch 2, "
          f"512x1760 f32, {s1['steps']} steps: {rate_line(s1)}; "
          f"prepare_anchors {s1['anchors_s']:.2f} s on the card "
          f"({cpu_anchor_s:.2f} s on the CPU path), anchors "
          f"{z['anchors'].shape} identical to the CPU path's, means max "
          f"|err|/(|m|+s) {mean_err:.2e}, stds max rel err {std_err:.2e} "
          f"(tol {STATS_RTOL:g}); loss (total) by window "
          f"{[round(v, 4) for v in totals]}; launches {s1['counts']}; "
          f"{len(still)} weights unmoved {stamp}", flush=True)
    assert s1["step"] == TRAIN_STEPS and len(totals) == TRAIN_STEPS // 5
    assert all(np.isfinite(totals)), "non-finite stage-1 loss"
    assert not still, f"weights that did not move: {still[:3]}"
    assert s1["counts"] == dict.fromkeys(names, 0), \
        "stage 1 (no NMS in the loss, no evaluation) launched a kernel"

    # -- stage 2: groomed_nms warm-started from stage 1, GrooMeD in the
    # loss, the snapshot evaluation at the last step, under the profiler
    pre = ("--set", f"pretrained={warm_dir!r}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        s2 = run("--config", "groomed_nms", "--max-iter", str(TRAIN_STEPS),
                 *pre)
        torch.cuda.synchronize()
    traced = count_kernels(prof)
    del prof
    g_dir = os.path.join(out_root, "groomed_nms")
    with open(os.path.join(g_dir, "train.log")) as f:
        log_text = f.read()
    rep = s2["restore"]
    val = build_imdb(root, "validation")
    n_eval = -(-len(val) // load_config("groomed_nms").test_batch_size)
    txts = sorted(os.listdir(os.path.join(
        g_dir, "results", f"results_{TRAIN_STEPS}", "data")))
    ap = s2["eval_results"].get(TRAIN_STEPS)
    print(f"train entry (stage 2): groomed_nms warm-started from stage 1: "
          f"fresh {rep['fresh']}, other shape {rep['mismatched']}, dropped "
          f"{rep['dropped']}; launches in training {s2['launches']['train']},"
          f" in the snapshot evaluation {s2['launches']['eval']}; "
          f"torch.profiler kernels {traced}; {len(txts)} txt files for "
          f"{len(val)} val frames, evaluator ran: {isinstance(ap, dict)}; "
          f"{s2['wall_s']:.1f} s with the profiler on", flush=True)
    assert sorted(rep["fresh"]) == ["accept_out.bias", "accept_out.weight"]
    assert rep["mismatched"] == [] and rep["dropped"] == []
    assert f"warm-started from {warm_dir} (2 tensors fresh" in log_text
    assert "copy_stats: reusing anchors/statistics" in log_text
    assert s2["launches"]["train"] == dict(
        fused_head_scores=0, greedy_nms=0, fused_iou_prune=TRAIN_STEPS,
        group_leaders=TRAIN_STEPS), s2["launches"]
    assert s2["launches"]["eval"] == dict(
        fused_head_scores=n_eval, greedy_nms=n_eval, fused_iou_prune=0,
        group_leaders=0), s2["launches"]
    assert traced == dict(head_scores=n_eval, nms_mask=n_eval,
                          nms_sweep=n_eval, iou_prune_kernel=TRAIN_STEPS,
                          group_cluster=TRAIN_STEPS, group_bits=0,
                          group_sweep=0), traced
    assert txts == [f"{r.id}.txt" for r in val] and isinstance(ap, dict)

    # -- auto-resume: the same run extended to RESUME_STEPS (timed)
    s3 = run("--config", "groomed_nms", "--max-iter", str(RESUME_STEPS),
             *pre)
    with open(os.path.join(g_dir, "metrics.csv")) as f:
        iters = [r.split(",")[0] for r in f.read().splitlines()]
    with open(os.path.join(g_dir, "train.log")) as f:
        resumed = f"auto-resumed own checkpoint at iter {TRAIN_STEPS}" \
            in f.read()
    print(f"train entry (stage 2, resumed): start {s3['start_step']}, "
          f"{s3['steps']} steps: {rate_line(s3)}; metrics.csv iters "
          f"{iters[1:]}; launches in training {s3['launches']['train']} "
          f"{stamp}", flush=True)
    assert resumed and s3["start_step"] == TRAIN_STEPS
    assert s3["step"] == RESUME_STEPS
    assert iters == ["iter"] + [str(i) for i in range(5, RESUME_STEPS + 1,
                                                      5)], iters
    assert s3["launches"]["train"]["fused_iou_prune"] == \
        RESUME_STEPS - TRAIN_STEPS

    # -- the train wall at batch 2 and batch 8 (stage 1's config)
    walls = {2: s1}
    s8 = run("--config", "kitti_3d_warmup", "--max-iter", "10",
             "--set", "do_test=False", "--set", "batch_size=8",
             "--output", os.path.join(TRAIN_DIR, "output_b8"))
    walls[8] = s8
    print("train entry: the train wall through the loader, kitti_3d_warmup "
          "f32 512x1760: " + "; ".join(
              f"batch {b}: {w['train_s']:.2f} s for {w['steps']} steps, "
              f"{rate_line(w)}" for b, w in walls.items()) + f" {stamp}",
          flush=True)

    # -- the tiny loop on the card against the CPU path
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        errs = {}
        for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            cpu = tiny_loop(script, tiny_root, "cpu", dtype)
            gpu = tiny_loop(script, tiny_root, dev, dtype)
            errs[name] = max(((gpu[k] - v).abs().max() / v.abs().max()).item()
                             for k, v in cpu.items()
                             if v.is_floating_point() and v.abs().max() > 0)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    print(f"train entry: {TINY_STEPS} loop steps of tiny_synthetic "
          f"(BatchNorm perturbed), card vs CPU path, max param err / max: "
          f"f64 {errs['f64']:.3e} (tol "
          f"{TINY_LOOP_REL:g}), f32 with TF32 off {errs['f32']:.3e} "
          f"(reported)", flush=True)
    assert errs["f64"] <= TINY_LOOP_REL, "the tiny loop differs on the card"
    return train_rate(s3)


# the video slice (phase 14): the tracker on the card against its CPU path
# in f64, masks and ids identical and every number within 1e-9 (+ 1e-9
# |x|; the same f64 ops, summed in other orders); the script's rows card
# against CPU path at 128x416 f32 with TF32 off, as phase 12 compares
# them (TXT_ATOL, TXT_RTOL).  Random weights score every anchor near 1/C,
# and a track's confidence is the uncertainty times the score, so the
# script runs at score_thres 0.2 (the BatchNorm perturbed as perturb_
# does) to write rows
VIDEO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_video")
VIDEO_CLIPS, VIDEO_SCORE_THRES = 8, 0.2
TRACK_TOL = 1e-9
UN_STEPS = 10                          # kitti_3d_uncertainty steps


def tracks_agree(got, ref):
    """(masks, ids and next_id identical over every frame, max |err| /
    (1 + |ref|) of the numbers) of two ``video_track`` snapshot lists."""
    same, err = len(got) == len(ref), 0.0
    for g, r in zip(got, ref):
        for f in ("valid", "ids", "next_id"):
            same &= torch.equal(getattr(g, f).cpu(), getattr(r, f))
        for f in ("X", "C", "A", "box2d", "un"):
            a, b = getattr(g, f).cpu().double(), getattr(r, f).double()
            err = max(err, ((a - b).abs() / (1 + b.abs())).max().item())
    return same, err


def video_phase(dev, flush, stamp):
    """14: the video slice's test path (see the module docstring).
    Returns {"fused_head_scores": ..., "greedy_nms": ...}, each kernel's
    check at the video path's shape (ms, plain_ms, max_abs_err, bound_ms,
    bound_by) and its launches in the timed scripts/test_kalman_torch.py
    run."""
    import importlib.util
    import shutil

    from groomed_nms_torch.data.synthetic import (kitti_p2,
                                                  make_synthetic_kitti_video,
                                                  make_synthetic_track_clip)
    from groomed_nms_torch.flagship import flagship_priors
    from groomed_nms_torch.models.video import VideoConfig, video_track
    from groomed_nms_torch.training.checkpoint import (checkpoint_path,
                                                       save_checkpoint)

    here = os.path.dirname(os.path.abspath(__file__))

    def script(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(here, "scripts", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    # -- (a) the tracker: card against the CPU path, no host sync
    p2 = np.concatenate([kitti_p2(), [[0.0, 0.0, 0.0, 1.0]]])
    vcfg = VideoConfig()
    errs = {}
    for seed in (1, 2, 3):
        clip = [torch.from_numpy(a) for a in make_synthetic_track_clip(
            seed, n_frames=4, m=vcfg.max_measurements, n_objects=24, p2=p2)]
        for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            args = [clip[0].to(dtype), clip[1], clip[2].to(dtype),
                    torch.from_numpy(p2).to(dtype)]
            _, ref = video_track(*args, vcfg)
            args_g = [a.to(dev) for a in args]
            video_track(*args_g, vcfg)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, got = video_track(*args_g, vcfg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            errs.setdefault(name, []).append(tracks_agree(got, ref))
    host_ms = wall_ms(lambda: video_track(*args_g, vcfg), 5)
    traced = trace_kernels(lambda: video_track(*args_g, vcfg))
    dev_ms = sum(e.time_range.elapsed_us() for e in traced) / 1e3
    n_launch = len(traced)
    print(f"video (a): video_track over 3 synthetic 4-frame clips (24 "
          f"objects, M {vcfg.max_measurements}, T {vcfg.max_tracks}) on the "
          f"card against the CPU path, no host sync (sync debug mode "
          f"error): masks and ids identical in f64 "
          f"{[ok for ok, _ in errs['f64']]}, max err "
          f"{max(e for _, e in errs['f64']):.3e} (tol {TRACK_TOL:g}); in f32 "
          f"(reported) {[ok for ok, _ in errs['f32']]}, max err "
          f"{max(e for _, e in errs['f32']):.3e}; a clip in f32: "
          f"host {host_ms:.2f} ms (synchronised), device busy "
          f"{dev_ms:.3f} ms in {n_launch} kernel launches {stamp}",
          flush=True)
    assert all(ok and err <= TRACK_TOL for ok, err in errs["f64"]), \
        errs["f64"]

    # -- (b) K2 at the measurements' shape, padded slots
    boxes_np, scores_np = nms_case(np.random.default_rng(14), 4, 64)
    boxes_np[scores_np <= 0] = 0.0
    boxes, scores = (torch.from_numpy(boxes_np).to(dev),
                     torch.from_numpy(scores_np).to(dev))
    keep = kernels.greedy_nms(boxes, scores, nms_threshold=0.4, shift=1.0)
    keep_ref = kernels.greedy_nms_plain(boxes, scores, nms_threshold=0.4,
                                        shift=1.0)
    assert torch.equal(keep, keep_ref), "K2 at [4, 64] differs from plain"
    k2_ms = time_ms(lambda: kernels.greedy_nms(boxes, scores), 50, flush)
    k2_plain_ms = time_ms(lambda: kernels.greedy_nms_plain(boxes, scores), 5,
                          flush)
    k2_bound = k2_work_bound(*scores.shape)
    print(f"video (b): K2 at [4, 64] with {int((scores <= 0).sum())} padded "
          f"slots: keep identical to greedy_nms_plain ({int(keep.sum())} "
          f"kept); kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, bound "
          f"{k2_bound[0]:.6f} ms ({k2_bound[1]}) {stamp}", flush=True)
    video = {"greedy_nms": dict(ms=k2_ms, plain_ms=k2_plain_ms, max_abs_err=0.0,
                                bound_ms=k2_bound[0], bound_by=k2_bound[1])}

    # -- (c) scripts/test_kalman_torch.py at full width
    shutil.rmtree(VIDEO_DIR, ignore_errors=True)
    data_root = os.path.join(VIDEO_DIR, "data")
    out_root = os.path.join(VIDEO_DIR, "output")
    t0 = time.perf_counter()
    make_synthetic_kitti_video(os.path.join(data_root, "kitti_split1"),
                               n_train=1, n_val=VIDEO_CLIPS, seed=31)
    run_dir = os.path.join(out_root, "kitti_3d_full")
    os.makedirs(run_dir)
    priors = flagship_priors()
    priors = np.concatenate(
        [priors, np.full((priors.shape[0], 1), 0.3, np.float32)], 1)
    np.savez(os.path.join(run_dir, "anchors.npz"), anchors=priors,
             bbox_means=np.zeros(14), bbox_stds=np.ones(14))
    un_model = RPN3D(load_config("kitti_3d_uncertainty").rpn_config(
        NUM_ANCHORS))
    init_weights(un_model, torch.Generator().manual_seed(8))
    perturb_(un_model, seed=8)
    un_dir = os.path.join(out_root, "kitti_3d_uncertainty_perturbed")
    save_checkpoint(un_dir, un_model, step=0)
    rs = np.random.default_rng(9)
    c2 = 2 * un_model.config.backbone.out_features
    pose_dir = run_dir + "_pose"
    os.makedirs(pose_dir)
    np.savez(os.path.join(pose_dir, "pose_net_params.npz"), **{
        "pose_feats/kernel": (rs.normal(size=(3, 3, c2, 512))
                              / np.sqrt(9 * c2)).astype(np.float32),
        "pose_feats/bias": np.zeros(512, np.float32),
        "pose/kernel": (rs.normal(size=(1, 1, 512, 6)) / np.sqrt(512))
        .astype(np.float32),
        "pose/bias": np.zeros(6, np.float32),
        "conf/kernel": (rs.normal(size=(1, 1, 512, 1)) / np.sqrt(512))
        .astype(np.float32),
        "conf/bias": np.zeros(1, np.float32)})
    np.savez(os.path.join(pose_dir, "pose_stats.npz"),
             means=np.zeros(6), stds=np.full(6, 0.1))
    print(f"video (c): a tracking tree of {VIDEO_CLIPS} validation clips "
          f"(4 frames at 375x1242), anchors.npz, a perturbed _un checkpoint "
          f"and a pose npz written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    tk = script("test_kalman_torch")
    base = ["--config", "kitti_3d_full", "--data-root", data_root,
            "--output", out_root, "--set", f"pretrained={un_dir!r}",
            "--set", f"score_thres={VIDEO_SCORE_THRES}"]
    names = ("fused_head_scores", "greedy_nms")

    def run(*argv):
        for n in names:
            getattr(kernels, n).launches = 0
        summary = tk.main([*base, *argv])
        counts = {n: getattr(kernels, n).launches for n in names}
        assert counts == summary["launches"], (counts, summary["launches"])
        return summary

    run()                                           # cuDNN autotuning
    # the timed run's K1 input, kept as the path hands it to the wrapper
    # (the counts stay the wrapper's own)
    import groomed_nms_torch.models.video as video_mod
    k1_in = {}

    def k1_spy(fused, accept=None, **kw):
        k1_in.update(fused=fused, accept=accept, kw=kw)
        return kernels.fused_head_scores(fused, accept, **kw)

    video_mod.fused_head_scores = k1_spy
    try:
        s = run()
    finally:
        video_mod.fused_head_scores = kernels.fused_head_scores
    print(f"video (c): test_kalman_torch main(), kitti_3d_full at 512x1760 "
          f"f32: {s['clips']} clips, {s['frames']} frames, {s['rows']} track "
          f"rows written, launches {s['launches']}, {s['clips_per_s']:.3f} "
          f"clip/s ({s['frames'] / s['wall_s']:.2f} frames/s) with the PNG "
          f"decode, the host busy {s['host_share']:.1%} of the wall {stamp}",
          flush=True)
    assert s["clips"] == VIDEO_CLIPS and s["frames"] == 4 * VIDEO_CLIPS
    assert s["rows"] > 0, "the video path wrote no track row"
    assert s["launches"] == dict.fromkeys(names, VIDEO_CLIPS), s["launches"]
    launches = dict(s["launches"])

    # -- (c) K1 on the last clip's head as the path gave it: [F, R, per] f32
    # (the script's default compute dtype), no acceptance
    fused, kw = k1_in["fused"], k1_in["kw"]
    assert k1_in["accept"] is None and fused.is_cuda
    assert fused.dtype == torch.float32 and fused.shape[:2] == (4, 126720), \
        (fused.dtype, fused.shape)
    with torch.inference_mode():
        got = kernels.fused_head_scores(fused, None, **kw)
        ref = kernels.fused_head_scores_plain(fused, None, **kw)
        k1_err = (got - ref).abs().max().item()
        print(f"video (c): K1 on the video path's head {list(fused.shape)} "
              f"f32, no acceptance: max|err| {k1_err:.3e} (atol 1e-6)",
              flush=True)
        assert k1_err <= 1e-6, f"K1 disagrees with its plain version: {k1_err}"
        k1_ms = time_ms(lambda: kernels.fused_head_scores(fused, None, **kw),
                        50, flush)
        k1_plain_ms = time_ms(lambda: kernels.fused_head_scores_plain(
            fused, None, **kw), 20, flush)
    f, r, per = fused.shape
    k1_bound = bound(f * r * kw["num_classes"] * HEAD_OPS, f * r * (per * 4 + 4),
                     PEAK_F32)
    print(f"video (c): K1 at {list(fused.shape)} f32: kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.4f} ms, bound {k1_bound[0]:.4f} ms "
          f"({k1_bound[1]}) {stamp}", flush=True)
    video["fused_head_scores"] = dict(
        ms=k1_ms, plain_ms=k1_plain_ms, max_abs_err=k1_err,
        bound_ms=k1_bound[0], bound_by=k1_bound[1])
    del fused, k1_in, got, ref

    # -- (d) card against the CPU path at 128x416 f32, TF32 off
    small = ("--set", "crop_size=(128, 416)", "--limit", "2")
    results = s["results_dir"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    try:
        for device in ("cpu", "cuda"):
            shutil.rmtree(results, ignore_errors=True)
            run(*small, "--device", device)
            rows[device] = read_rows(os.path.join(results, "data"))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    same, n, ok, max_err = row_agreement(rows["cuda"], rows["cpu"])
    print(f"video (d): card vs CPU path at 128x416 f32, TF32 off, 2 clips: "
          f"files/rows/classes equal {same}, {ok}/{n} rows within "
          f"{TXT_ATOL:g} + {TXT_RTOL:g}|x|, max |err| {max_err:.3e}",
          flush=True)
    assert same and n > 0 and ok == n, "the video path differs on the card"

    # -- (e) the _un stage: kitti_3d_uncertainty warm-started from phase
    # 13's stage 1
    train = script("train_torch")
    t_out = os.path.join(VIDEO_DIR, "train_output")
    warm_dir = os.path.join(TRAIN_DIR, "output", "kitti_3d_warmup")
    su = train.main(["--config", "kitti_3d_uncertainty", "--data-root",
                     os.path.join(TRAIN_DIR, "data"), "--output", t_out,
                     "--max-iter", str(UN_STEPS), "--set",
                     f"pretrained={warm_dir!r}", "--set", "do_test=False",
                     "--set", "display=1"])
    u_dir = os.path.join(t_out, "kitti_3d_uncertainty")
    with open(os.path.join(u_dir, "metrics.csv")) as f:
        csv_rows = [r.split(",") for r in f.read().splitlines()]
    un_vals = [float(r[csv_rows[0].index("un")]) for r in csv_rows[1:]]
    ucfg = load_config("kitti_3d_uncertainty")
    n_anchors = np.load(os.path.join(warm_dir, "anchors.npz"))[
        "anchors"].shape[0]
    fresh = RPN3D(ucfg.rpn_config(n_anchors))
    init_weights(fresh, torch.Generator().manual_seed(ucfg.rng_seed))
    head = torch.load(checkpoint_path(u_dir, UN_STEPS), map_location="cpu",
                      weights_only=True)["model"]["head.weight"]
    per = fresh.config.per_anchor
    moved = (head[per - 1::per] - fresh.head.weight[per - 1::per]).abs() \
        .max().item()
    ms, ips, wait = train_rate(su)
    rep = su["restore"]
    print(f"video (e): kitti_3d_uncertainty ({UN_STEPS} steps, batch 2, "
          f"512x1760 f32) warm-started from phase 13's stage 1: other "
          f"shape {rep['mismatched']}, fresh {rep['fresh']}, dropped "
          f"{rep['dropped']}; un by step {[round(v, 4) for v in un_vals]}; "
          f"the uncertainty channel's weights moved by up to {moved:.3e}; "
          f"{ms:.2f} ms/step ({ips:.2f} img/s), host_wait {wait:.2%} "
          f"{stamp}", flush=True)
    assert sorted(rep["mismatched"]) == ["head.bias", "head.weight"]
    assert rep["fresh"] == [] and rep["dropped"] == []
    assert len(un_vals) == UN_STEPS and all(np.isfinite(un_vals))
    assert moved > 0, "the uncertainty channel did not train"
    for n in names:
        video[n]["launches"] = launches[n]
    return video


# the video stage's training (phase 15): the pose stage and the video stage
# through their scripts at full width on a synthetic tracking tree (16
# training records of 4 frames at 375x1242, seed 41), both started from a
# perturbed _un run of the anchor count the scripts learn on that tree, the
# video stage also from the pose stage's npz; the learned statistics at
# phase 13's card-vs-CPU rule.  Two tiny_video_synthetic steps through
# train_torch's build_training (BatchNorm perturbed, the backbone frozen as
# shipped) card against CPU path in f64, parameters
# within 1e-4 of each tensor's max (phase 13's tiny-loop rule; the loss is
# f32 by design); the fused-track loss and its pose gradient at T 128, M 64,
# F 4 card against CPU path in f64 within 1e-9 (+ 1e-9 |x|), the tracker's
# rule
VTRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_video_train")
VTRAIN_RECORDS, POSE_STEPS, VIDEO_STEPS, VIDEO_RESUME = 16, 10, 10, 14
RATE_FROM = 3                         # steps left out of ms/step
VIDEO_TRAIN_REL, FUSED_TRACK_TOL = 1e-4, 1e-9
TRAIN_KERNELS = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
                 "group_leaders", "dense_block_eval")


def rate_after(summary, k=RATE_FROM):
    """(ms/step over the steps after the k-th, img/s, host_wait share of
    the loop's wall) of a training script's summary."""
    ends, n = summary["step_end_s"], summary["steps"]
    ms = (summary["train_s"] - ends[k - 1]) / (n - k) * 1e3
    return (ms, summary["batch_size"] / ms * 1e3,
            summary["host_wait_s"] / summary["train_s"])


def video_train_phase(dev, stamp):
    """15: the video stage's training (see the module docstring)."""
    import importlib.util
    import shutil

    from groomed_nms_torch.data.pipeline import (ClipRecordView,
                                                 VideoTrainLoader,
                                                 device_prefetch,
                                                 prepare_anchors)
    from groomed_nms_torch.data.synthetic import (kitti_p2,
                                                  make_synthetic_kitti_video,
                                                  make_synthetic_track_clip)
    from groomed_nms_torch.data.tracking import build_tracking_imdb
    from groomed_nms_torch.losses.fused_track import fused_track_loss
    from groomed_nms_torch.models.video import VideoConfig, VideoRPN3D
    from groomed_nms_torch.training.checkpoint import (checkpoint_path,
                                                       latest_checkpoint,
                                                       save_checkpoint)
    from groomed_nms_torch.utils.video_weights import load_video_variables

    here = os.path.dirname(os.path.abspath(__file__))

    def script(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(here, "scripts", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def counted(fn, *argv):
        for n in TRAIN_KERNELS:
            getattr(kernels, n).launches = 0
        summary = fn(list(argv))
        return summary, {n: getattr(kernels, n).launches
                         for n in TRAIN_KERNELS}

    shutil.rmtree(VTRAIN_DIR, ignore_errors=True)
    data = os.path.join(VTRAIN_DIR, "data")
    out = os.path.join(VTRAIN_DIR, "output")
    t0 = time.perf_counter()
    root = os.path.join(data, "kitti_split1")
    make_synthetic_kitti_video(root, n_train=VTRAIN_RECORDS, n_val=1,
                               seed=41)
    views = [ClipRecordView(r) for r in build_tracking_imdb(root,
                                                            "training")]
    # the _un run: the anchors a kitti_3d_uncertainty run learns on this
    # tree, without the velocity column, and a perturbed checkpoint of
    # that anchor count (templates no synthetic car falls to are dropped,
    # so it is not the flagship's 36)
    ucfg = load_config("kitti_3d_uncertainty")
    un_dir = os.path.join(out, "kitti_3d_uncertainty_perturbed")
    ua, um, _ = prepare_anchors(ucfg, views, cache_dir=un_dir, device=dev)
    un_model = RPN3D(ucfg.rpn_config(ua.shape[0]))
    init_weights(un_model, torch.Generator().manual_seed(8))
    perturb_(un_model, seed=8)
    save_checkpoint(un_dir, un_model, step=0)
    del un_model
    run_dir = os.path.join(out, "kitti_3d_full")
    print(f"video train: a tracking tree of {VTRAIN_RECORDS} training "
          f"records (4 frames at 375x1242) and a perturbed _un run "
          f"({ua.shape[0]} anchors of {ua.shape[1]} columns, {um.shape[0]} "
          f"statistics) written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    common = ["--config", "kitti_3d_full", "--data-root", data, "--output",
              out, "--device", dev.type, "--set", f"pretrained={un_dir!r}"]

    # -- (a) the pose stage: only pose_net moves
    assert not os.path.exists(os.path.join(run_dir, "anchors.npz"))
    sp, lp = counted(script("train_pose_torch").main, *common, "--max-iter",
                     str(POSE_STEPS))
    cfg = load_config("kitti_3d_full")
    with np.load(os.path.join(run_dir, "anchors.npz")) as z:
        anchors, means, stds = z["anchors"], z["bbox_means"], z["bbox_stds"]
    n_anchors = anchors.shape[0]
    a_cpu, m_cpu, s_cpu = prepare_anchors(cfg, views, device="cpu")
    anchors_same = bool(np.array_equal(anchors, a_cpu))
    mean_err, std_err = stats_close((means, stds), (m_cpu, s_cpu),
                                    rtol=np.inf)
    print(f"video train (a): the pose stage learned the detector run's "
          f"anchors.npz on the card: anchors {list(anchors.shape)} (the _un "
          f"run's {list(ua.shape)}), {means.shape[0]} statistics, velocity "
          f"mean {means[13]:.4f} std {stds[13]:.4f}; against prepare_anchors "
          f"on the CPU path: anchors identical {anchors_same}, means "
          f"{mean_err:.3e}, stds {std_err:.3e} (rtol {STATS_RTOL:g})",
          flush=True)
    assert anchors.shape == (ua.shape[0], 12) and means.shape == (14,)
    assert anchors_same and max(mean_err, std_err) <= STATS_RTOL
    assert means[13] != 0 and stds[13] != 1
    assert np.isfinite(means).all() and np.isfinite(stds).all()
    # the script's start: seeded init, then the _un rpn (its pose npz did
    # not exist yet); the end: that rpn and the npz it wrote
    ref = VideoRPN3D(VideoConfig(rpn=cfg.rpn_config(n_anchors)))
    init_weights(ref, torch.Generator().manual_seed(cfg.rng_seed))
    start = {k: v.clone() for k, v in ref.state_dict().items()}
    load_video_variables(ref, dataclasses.replace(cfg, pretrained=un_dir),
                         run_dir)
    trained = {k: v.cpu() for k, v in sp["model"].state_dict().items()}
    assert all(torch.equal(trained[k], v)
               for k, v in ref.state_dict().items()), "npz or rpn differ"
    moved = sorted(k for k in trained if k.startswith("pose_net.")
                   and not torch.equal(trained[k], start[k]))
    same = [k for k in trained if not k.startswith("pose_net.")]
    ms, ips, wait = rate_after(sp)
    print(f"video train (a): train_pose_torch main(), kitti_3d_full at "
          f"512x1760 f32, batch {sp['batch_size']} pairs, {sp['steps']} "
          f"steps over {sp['records']} records: pose loss by step "
          f"{[round(v, 4) for v in sp['losses']]}; {len(moved)} pose_net "
          f"tensors moved ({moved}), the other {len(same)} bit-identical to "
          f"the _un run's; launches {lp}; "
          f"{ms:.2f} ms/step after step {RATE_FROM} ({ips:.2f} pairs/s, "
          f"{2 * ips:.2f} frames/s), "
          f"host_wait {wait:.2%}, peak {(sp['peak_bytes'] or 0) / 1e9:.2f} GB "
          f"{stamp}", flush=True)
    assert sp["steps"] == POSE_STEPS and all(np.isfinite(sp["losses"]))
    assert moved, "the pose branch did not train"
    assert not any(lp.values()), lp
    pose_npz = os.path.join(run_dir + "_pose", "pose_net_params.npz")
    assert os.path.exists(pose_npz)
    del sp

    # -- (b) the video stage: warm start, 10 steps, auto-resume to 14
    train = script("train_torch")
    sv, lv = counted(train.main, *common, "--max-iter", str(VIDEO_STEPS),
                     "--set", "display=1")
    rep = sv["restore"]
    sr, lr_ = counted(train.main, *common, "--max-iter", str(VIDEO_RESUME),
                      "--set", "display=1")
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        rows = [r.split(",") for r in f.read().splitlines()]
    col = lambda name: [float(r[rows[0].index(name)]) for r in rows[1:]]
    vel, vel_num = col("vel"), col("vel_num")
    un_sd = torch.load(checkpoint_path(un_dir, latest_checkpoint(un_dir)),
                       map_location="cpu", weights_only=True)["model"]
    ck = torch.load(checkpoint_path(run_dir, VIDEO_RESUME),
                    map_location="cpu", weights_only=True)["model"]
    backbone = [k for k in un_sd if k.startswith("backbone.")
                and not k.endswith("num_batches_tracked")]
    changed = [k for k in backbone if not torch.equal(ck["rpn." + k],
                                                       un_sd[k])]
    per = cfg.rpn_config(n_anchors).per_anchor
    vel_rows = slice(cfg.num_classes + 4 + 10, None, per)
    vel_moved = ck["rpn.head.weight"][vel_rows].abs().max().item()
    ms, ips, wait = rate_after(sv)
    print(f"video train (b): train_torch main(), kitti_3d_full at 512x1760 "
          f"f32, batch {sv['batch_size']} clips of 2 frames: warm-started "
          f"from the _un run (fresh {rep['fresh']}, other shape "
          f"{rep['mismatched']}, dropped {rep['dropped']}, the velocity "
          f"channel of {rep['widened']}, pose_net from {rep['pose']}); "
          f"{sv['steps']} steps, resumed at {sr['start_step']} to "
          f"{sr['step']}; vel by step {[round(v, 4) for v in vel]}, rows "
          f"with a velocity target {[int(v) for v in vel_num]}; backbone "
          f"tensors changed {len(changed)} of {len(backbone)}; the velocity "
          f"channel's weights up to {vel_moved:.3e}; launches {lv}, {lr_}; "
          f"{ms:.2f} ms/step after step {RATE_FROM} ({ips:.2f} clips/s, "
          f"{2 * ips:.2f} frames/s), "
          f"host_wait {wait:.2%}, peak {(sv['peak_bytes'] or 0) / 1e9:.2f} GB "
          f"{stamp}", flush=True)
    assert rep["fresh"] == rep["mismatched"] == rep["dropped"] == []
    assert rep["pose"] == pose_npz
    assert sv["steps"] == VIDEO_STEPS and sr["start_step"] == VIDEO_STEPS
    assert sr["step"] == VIDEO_RESUME and len(vel) == VIDEO_RESUME
    assert all(np.isfinite(vel)) and all(v > 0 for v in vel_num)
    assert not changed and backbone, changed
    assert vel_moved > 0, "the velocity channel did not train"
    assert not any(lv.values()) and not any(lr_.values()), (lv, lr_)

    # -- (c) the tiny video step: card against the CPU path, f64
    tcfg = load_config("tiny_video_synthetic")
    t_anchors = prepare_anchors(tcfg, views, device="cpu")
    results = []
    for device in (torch.device("cpu"), dev):
        run = train.build_training(tcfg, *t_anchors, device,
                                   param_dtype=torch.float64)
        perturb_(run.model, seed=5)
        loader = VideoTrainLoader(views, tcfg, seed=tcfg.rng_seed,
                                  prefetch=1)
        batches = device_prefetch(train.host_tensors(
            loader, pin=device.type == "cuda"), device)
        try:
            stats = [{k: float(v) for k, v in run.step(
                run.state, train.raw_batch(next(batches)[1])).items()}
                for _ in range(2)]
        finally:
            batches.close()
            loader.close()
        results.append((stats, {k: v.cpu() for k, v in
                                run.model.state_dict().items()}))
    (s_c, p_c), (s_g, p_g) = results
    err = max(((p_g[k] - v).abs().max() / v.abs().max()).item()
              for k, v in p_c.items()
              if v.is_floating_point() and v.abs().max() > 0)
    stat_err = max(abs(a[k] - b[k]) / (abs(b[k]) + 1e-6)
                   for a, b in zip(s_g, s_c) for k in b)
    print(f"video train (c): two tiny_video_synthetic steps (train_torch's "
          f"build_training, VideoTrainLoader batches of the tree, f64, "
          f"BatchNorm perturbed, backbone frozen) card vs CPU path: "
          f"parameters max |err| / max |ref| {err:.3e} (tol "
          f"{VIDEO_TRAIN_REL:g}), stats max rel {stat_err:.3e}; vel "
          f"{s_g[-1]['vel']:.4f} over {int(s_g[-1]['vel_num'])} rows",
          flush=True)
    assert err <= VIDEO_TRAIN_REL, "the video step differs on the card"
    assert s_c[0]["vel_num"] > 0

    # -- (d) the fused-track loss and its pose gradient, T 128, M 64, F 4
    p2 = np.concatenate([kitti_p2(), [[0.0, 0.0, 0.0, 1.0]]])
    vcfg = VideoConfig()
    meas, valid, poses = make_synthetic_track_clip(
        15, n_frames=4, m=vcfg.max_measurements, n_objects=24,
        kill_frame=-1, p2=p2)
    rs = np.random.default_rng(15)
    gts = meas[-1, :24, 6:9] + rs.normal(0, 0.3, (24, 3))
    poses = poses + rs.normal(0, 0.05, poses.shape)
    host = [torch.from_numpy(a) for a in (poses, meas, valid, gts,
                                          np.ones(24, bool), p2)]

    def fwd_bwd(args):
        pose = args[0].detach().requires_grad_()
        loss, n = fused_track_loss(pose, *args[1:], vcfg)
        loss.backward()
        return loss.detach(), n, pose.grad

    ref = fwd_bwd(host)
    args_g = [a.to(dev) for a in host]
    fwd_bwd(args_g)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fwd_bwd(args_g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    errs = [((g.cpu() - r).abs() / (1 + r.abs())).max().item()
            for g, r in ((got[0], ref[0]), (got[2], ref[2]))]
    host_ms = wall_ms(lambda: fwd_bwd(args_g), 3)
    n_launch = len(trace_kernels(lambda: fwd_bwd(args_g)))
    print(f"video train (d): fused_track_loss + backward to the poses "
          f"(T {vcfg.max_tracks}, M {vcfg.max_measurements}, F 4, f64) on "
          f"the card vs the CPU path, no host sync (sync debug mode error): "
          f"{int(got[1])} GTs matched ({int(ref[1])} on the CPU), max err "
          f"loss {errs[0]:.3e}, gradient {errs[1]:.3e} (tol "
          f"{FUSED_TRACK_TOL:g}); forward + backward host {host_ms:.2f} ms "
          f"(synchronised) in {n_launch} kernel launches {stamp}", flush=True)
    assert int(got[1]) == int(ref[1]) > 0 and ref[2].abs().max() > 0
    assert max(errs) <= FUSED_TRACK_TOL, errs


# the serving artifact (phase 16): the flagship's serving program and the
# video model's clip program staged out with torch.export, saved to bytes,
# loaded back and run on the card.  The loaded artifact runs the same ops as
# the live closure on the same card, so the detection rows are held to
# 1e-5 + 1e-5 |x| with valid masks identical, and the video program in f64
# (the tracker's discrete points) to the tracker's rule; the served rows of
# scripts/serve_torch.py against make_infer's on the same planes at phase
# 12's rule
SERVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_serve")
ARTIFACT_TOL = 1e-5
SERVE_FRAMES = 16                     # of phase 12's tree, both sizes
SERVING_KERNELS = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
                   "group_leaders")


def count_launches(fn, names=SERVING_KERNELS):
    """(fn's result, the launches of each kernel while it ran)."""
    for n in names:
        getattr(kernels, n).launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: getattr(kernels, n).launches for n in names}


def video_serving(vcfg, dtype, crop_hw, seed=8):
    """A perturbed kitti_3d_full VideoRPN3D on the card in ``dtype`` and
    its serving closure (flagship priors with a velocity column, unit
    statistics, pose statistics of 0.1)."""
    from groomed_nms_torch.anchors import locate_anchors
    from groomed_nms_torch.export import build_video_serving_fn
    from groomed_nms_torch.flagship import flagship_priors
    from groomed_nms_torch.models.video import VideoRPN3D

    model = VideoRPN3D(vcfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    perturb_(model, seed=seed)
    model = model.to("cuda", dtype, memory_format=torch.channels_last)
    priors = flagship_priors()
    priors = np.concatenate(
        [priors, np.full((priors.shape[0], 1), 0.3, np.float32)], 1)
    rois = locate_anchors(priors, (crop_hw[0] // 16, crop_hw[1] // 16), 16)
    cfg = load_config("kitti_3d_full")
    return build_video_serving_fn(
        model, rois, priors[rois[:, 4].astype(np.int64), 4:],
        np.zeros(14, np.float32), np.ones(14, np.float32),
        np.asarray(cfg.image_means), np.asarray(cfg.image_stds), vcfg,
        np.zeros(6), np.full(6, 0.1), target_h=crop_hw[0], crop_w=crop_hw[1],
        bf16_input=False)


def export_phase(dev, stamp):
    """16: the serving artifacts (see the module docstring).  Returns the
    launches of each kernel through the detection artifacts' timed runs."""
    import importlib.util
    import shutil

    from groomed_nms_torch.data.augment import fit_image_to_plane
    from groomed_nms_torch.data.kitti import read_kitti_calib
    from groomed_nms_torch.data.png import read_png
    from groomed_nms_torch.data.synthetic import kitti_p2
    from groomed_nms_torch.export import (build_serving_fn, export_serving,
                                          export_video_serving, load_serving)
    from groomed_nms_torch.models.kalman import Tracks
    from groomed_nms_torch.models.video import VideoConfig

    launches = {}
    # -- (a), (b) the detection artifact: greedy NMS, then GrooMeD-NMS
    for name, groomed in (("greedy", False), ("groomed", True)):
        infer, args, model = build_flagship(device="cuda",
                                            differentiable_nms=groomed)
        (u8, means, stds, rois, rois_3d, p2, p2_inv, scale, bmeans,
         bstds) = args
        dcfg = dataclasses.replace(
            load_config("groomed_nms"),
            use_differentiable_nms_at_test=groomed).detect_config()
        batch, src_h, src_w = u8.shape[:3]
        serve = build_serving_fn(model, rois, rois_3d, bmeans, bstds, means,
                                 stds, dcfg, target_h=512, crop_w=1760,
                                 bf16_input=True)
        t0 = time.perf_counter()
        blob = export_serving(serve, batch=batch, src_h=src_h, src_w=src_w)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_serving(blob, dev)
        load_s = time.perf_counter() - t0
        inputs = (u8, p2, p2_inv, scale)
        with torch.no_grad():
            want_d, want_v = serve(*inputs)
        got_d, got_v = loaded(*inputs)
        same = torch.equal(got_v, want_v)
        err = ((got_d - want_d).abs() / (1 + want_d.abs()))[want_v].max() \
            .item() if want_v.any() else 0.0
        for _ in range(WARMUP):
            loaded(*inputs)
            infer(*args)
        torch.cuda.synchronize()

        def timed(fn):
            t0 = time.perf_counter()
            for _ in range(TIMED):
                fn()
            torch.cuda.synchronize()
            return batch * TIMED / (time.perf_counter() - t0)

        art_img_s, n = count_launches(lambda: timed(lambda: loaded(*inputs)))
        infer_img_s = timed(lambda: infer(*args))
        want_n = dict.fromkeys(SERVING_KERNELS, 0)
        want_n.update(dict.fromkeys(
            ("fused_head_scores", "fused_iou_prune", "group_leaders")
            if groomed else ("fused_head_scores", "greedy_nms"), TIMED))
        print(f"export ({'b' if groomed else 'a'}): the flagship with "
              f"{name} NMS (rpn3d, bf16, batch {batch}, 512x1760 from uint8 "
              f"{src_h}x{src_w}): exported in {export_s:.1f} s, "
              f"{len(blob) / 1e6:.1f} MB, loaded in {load_s:.1f} s; the "
              f"loaded artifact vs the live closure: valid identical {same} "
              f"({int(want_v.sum())} rows), max |err| / (1 + |x|) {err:.3e} "
              f"(tol {ARTIFACT_TOL:g}); {TIMED} batches through the "
              f"artifact {art_img_s:.2f} img/s beside make_infer's "
              f"{infer_img_s:.2f}; launches {n} {stamp}", flush=True)
        assert same and err <= ARTIFACT_TOL, \
            f"the {name} artifact differs from its live closure"
        assert n == want_n, f"expected {want_n} through the artifact, got {n}"
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        if not groomed:
            served = (blob, infer, args)       # (d) serves this one
        del serve, loaded, model
    torch.cuda.empty_cache()

    # -- (c) the video artifact: kitti_3d_full (T 128, M 64), 4 frames
    cfg = load_config("kitti_3d_full")
    vcfg = VideoConfig(rpn=cfg.rpn_config(NUM_ANCHORS),
                       score_thres=VIDEO_SCORE_THRES, nms_thres=cfg.nms_thres,
                       best_thresh=cfg.best_thresh)
    rs = np.random.default_rng(16)
    cam = np.concatenate([kitti_p2(), [[0.0, 0.0, 0.0, 1.0]]]).astype(
        np.float32)
    video = {}
    for label, dtype, crop_hw in (("full width f32", torch.float32,
                                   (512, 1760)),
                                  ("128x416 f64", torch.float64, (128, 416))):
        serve = video_serving(vcfg, dtype, crop_hw)
        t0 = time.perf_counter()
        blob = export_video_serving(serve, n_frames=4, src_h=375, src_w=1242)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_serving(blob, dev)
        load_s = time.perf_counter() - t0
        clip = torch.from_numpy(rs.integers(0, 256, (4, 375, 1242, 3),
                                            dtype=np.uint8)).to(dev)
        inputs = (clip, torch.from_numpy(cam).to(dev),
                  torch.from_numpy(np.linalg.inv(cam)).to(dev),
                  torch.full((4,), crop_hw[0] / 375, device=dev))
        with torch.no_grad():
            want = serve(*inputs)
        got, n = count_launches(lambda: loaded(*inputs))
        ok, err = tracks_agree(
            [got], [Tracks(**{f.name: getattr(want, f.name).cpu()
                              for f in dataclasses.fields(Tracks)})])
        nodes = len(loaded.program.graph.nodes)
        print(f"export (c): the video artifact, kitti_3d_full {label} "
              f"(T {vcfg.max_tracks}, M {vcfg.max_measurements}, F 4, "
              f"uint8 375x1242 clips): {nodes} graph nodes, exported in "
              f"{export_s:.1f} s, {len(blob) / 1e6:.1f} MB, loaded in "
              f"{load_s:.1f} s; loaded vs live closure: masks and ids "
              f"identical {ok}, max err {err:.3e}; {int(want.valid.sum())} "
              f"tracks; launches a clip {n} {stamp}", flush=True)
        assert n == {**dict.fromkeys(SERVING_KERNELS, 0),
                     "fused_head_scores": 1, "greedy_nms": 1}, n
        if dtype == torch.float64:
            assert ok and err <= TRACK_TOL, \
                "the f64 video artifact differs from its live closure"
        video[label] = n
        del serve, loaded
    torch.cuda.empty_cache()

    # -- (d) scripts/serve_torch.py's main() over phase 12's frames
    blob, infer, args = served
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    img_dir, cal_dir = (os.path.join(SERVE_DIR, d) for d in ("image_2",
                                                             "calib"))
    os.makedirs(img_dir)
    os.makedirs(cal_dir)
    split = os.path.join(EVAL_DIR, "data", "kitti_split1", "validation")
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(
        os.path.join(split, "image_2")))[:SERVE_FRAMES]
    for stem in stems:
        shutil.copy(os.path.join(split, "image_2", stem + ".png"), img_dir)
        shutil.copy(os.path.join(split, "calib", stem + ".txt"), cal_dir)
    art = os.path.join(SERVE_DIR, "model.pt2")
    with open(art, "wb") as f:
        f.write(blob)
    batch, src_h, src_w = args[0].shape[:3]
    with open(art + ".json", "w") as f:
        json.dump({"batch": batch, "src_hw": [src_h, src_w],
                   "crop_size": [512, 1760], "class_names": KITTI_CLASSES,
                   "score_thres": 0.0, "device": str(dev)}, f)
    assert sorted(os.listdir(SERVE_DIR)) == ["calib", "image_2", "model.pt2",
                                             "model.pt2.json"]
    spec = importlib.util.spec_from_file_location(
        "serve_torch", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "scripts", "serve_torch.py"))
    serve_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_script)
    out_dir = os.path.join(SERVE_DIR, "served")
    summary = serve_script.main(["--artifact", art, "--images", img_dir,
                                 "--calib", cal_dir, "--out", out_dir])
    # make_infer on the planes serve_torch builds: the same frames fitted
    # into the 375x1242 plane (r = 1; the 370x1224 frames edge-padded), the
    # same calibs and scales, batches of 8 in the same order
    (_, means, stds, rois, rois_3d, _, _, _, bmeans, bstds) = args
    ref_dir = os.path.join(SERVE_DIR, "make_infer")
    os.makedirs(ref_dir)
    sizes = {}
    for i in range(0, len(stems), batch):
        chunk = stems[i:i + batch]
        planes, p2s, scales = [], [], []
        for stem in chunk:
            img = read_png(os.path.join(img_dir, stem + ".png"))
            sizes[stem] = img.shape[:2]
            plane, r = fit_image_to_plane(img, src_h, src_w)
            planes.append(plane)
            p2s.append(read_kitti_calib(os.path.join(
                cal_dir, stem + ".txt")).astype(np.float32))
            scales.append(512 / src_h * r)
        p2b = np.stack(p2s)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        dets, valid = infer(t(np.stack(planes), torch.uint8), means, stds,
                            rois, rois_3d, t(p2b), t(np.linalg.inv(p2b)),
                            t(scales), bmeans, bstds)
        for j, stem in enumerate(chunk):
            write_kitti_detections(os.path.join(ref_dir, stem + ".txt"),
                                   dets[j].cpu().numpy(),
                                   valid[j].cpu().numpy(), KITTI_CLASSES,
                                   score_thres=0.0)
    got, want = read_rows(out_dir), read_rows(ref_dir)
    full = [s + ".txt" for s in stems if sizes[s] == (src_h, src_w)]
    same, n, ok, max_err = row_agreement(
        {k: got.get(k, []) for k in full}, {k: want[k] for k in full})
    all_same, n_all, ok_all, _ = row_agreement(got, want)
    print(f"export (d): serve_torch.py main() over {len(stems)} PNG frames "
          f"of phase 12's tree ({len(full)} at {src_h}x{src_w}, r = 1), "
          f"from a directory holding only the artifact, its json, the "
          f"images and the calibs: {len(got)} txt files in "
          f"{summary['wall_s']:.2f} s; against make_infer on the same "
          f"planes: at {src_h}x{src_w} files/rows/classes equal {same}, "
          f"{ok}/{n} rows within {TXT_ATOL:g} + {TXT_RTOL:g}|x|, max |err| "
          f"{max_err:.3e}; every frame {all_same}, {ok_all}/{n_all} {stamp}",
          flush=True)
    assert sorted(got) == [s + ".txt" for s in stems], "one txt a frame"
    assert same and n > 0 and ok == n, \
        "serve_torch's rows differ from make_infer's"
    return launches, video


# the options of the entry points (phase 17): --refine on phase 12's tree,
# photometric jitter on phase 13's, the library ops.  refine_detections card
# against CPU path in f64: the same rows kept as they came and every number
# within REFINE_TOL of 1 + |x| (each climb step is a discrete choice, held
# where a rounding is ~1e-16; f32 reported); the jitter's draws equal on
# both, a jittered batch within JITTER_ATOL_255 on the 0-255 scale (the
# resize and the means summed in other orders); soft-NMS keep masks
# identical and scores within OPS_TOL; RoIAlign values and feature gradients
# within ROI_TOL of their largest magnitude (atomic adds in the backward on
# the card); RankNet and the MSE, values and gradients within OPS_TOL
REFINE_TOL, JITTER_ATOL_255, OPS_TOL, ROI_TOL = 1e-9, 1e-3, 1e-6, 1e-5
OPTION_REPEAT = 3                     # phase 12's tree repeated for img/s
JITTER_STEPS, SOFT_NMS_N = 8, 1000


def load_tool(relpath):
    """``relpath`` (a script under scripts/ or analysis/) of this checkout
    as a module."""
    import importlib.util
    name = os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_script(name):
    """``scripts/<name>.py`` of this checkout as a module."""
    return load_tool(os.path.join("scripts", name + ".py"))


def refine_check(dets, valid, p2, p2_inv, dev, stamp):
    """refine_detections of one batch: card against CPU path in f64 (no
    host synchronisation on the card) and in f32 (reported); its host ms,
    device ms and launches.  Returns the host ms, device ms and launches."""
    from groomed_nms_torch.inference import refine_detections

    def kept(out, d):
        return (out == d).all(-1)

    errs = {}
    for name, dt in (("f64", torch.float64), ("f32", torch.float32)):
        args = (dets.to(dt), valid, p2.to(dt), p2_inv.to(dt))
        refine_detections(*args)             # the signs' constants copied
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = refine_detections(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cpu = [a.cpu() for a in args]
        want = refine_detections(*cpu)
        got = got.cpu()
        err = ((got - want).abs() / (1 + want.abs())).amax(-1)
        errs[name] = (torch.equal(kept(got, cpu[0]), kept(want, cpu[0])),
                      err.max().item(), int((err > 1e-4).sum()),
                      int((~kept(want, cpu[0]) & cpu[1]).sum()))
    same, err, _, moved = errs["f64"]
    print(f"options (a): refine_detections of one batch {list(dets.shape)}, "
          f"card vs CPU path: f64 the same rows kept {same}, {moved} valid "
          f"rows refined, max err / (1 + |x|) {err:.3e} (tol "
          f"{REFINE_TOL:g}), no host synchronisation; f32 (reported) the "
          f"same rows kept {errs['f32'][0]}, max err {errs['f32'][1]:.3e}, "
          f"{errs['f32'][2]} rows past 1e-4", flush=True)
    assert same and err <= REFINE_TOL and moved > 0, errs["f64"]

    def call():
        refine_detections(dets, valid, p2, p2_inv)

    host_ms = wall_ms(call, 5)
    ks = trace_kernels(call)
    dev_ms = sum(e.time_range.elapsed_us() for e in ks) / 1e3
    print(f"options (a): refine_detections a batch of 8 x 40 rows (f32): "
          f"host {host_ms:.2f} ms (synchronised), device {dev_ms:.3f} ms in "
          f"{len(ks)} kernel launches (torch.profiler) {stamp}", flush=True)
    return host_ms, dev_ms, len(ks)


def library_ops_check(dev, stamp):
    """17 (c): soft-NMS, RoIAlign, RankNet and the MSE, card against CPU
    path (see the module docstring)."""
    from groomed_nms_torch.losses import ranknet_loss
    from groomed_nms_torch.losses.custom_loss import custom_mse
    from groomed_nms_torch.ops import nms
    from groomed_nms_torch.ops.roi_align import roi_align

    rs = np.random.default_rng(17)
    xy = rs.uniform(0, 1200, (SOFT_NMS_N, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(20, 200, (SOFT_NMS_N, 2))],
                           1).astype(np.float32)
    scores = rs.uniform(0.01, 1, SOFT_NMS_N).astype(np.float32)
    soft = {}
    for method in ("linear", "gaussian", "hard"):
        kw = dict(nms_threshold=0.3, method=method, score_threshold=0.05)
        got = nms.soft_nms(torch.from_numpy(boxes).to(dev),
                           torch.from_numpy(scores).to(dev), **kw)
        want = nms.soft_nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores), **kw)
        same = torch.equal(got[1].cpu(), want[1])
        err = (got[0].cpu() - want[0]).abs().max().item()
        ms_ = wall_ms(lambda: nms.soft_nms(
            torch.from_numpy(boxes).to(dev),
            torch.from_numpy(scores).to(dev), **kw), 2)
        soft[method] = (same, err, int(want[1].sum()), ms_)
        assert same and err <= OPS_TOL, (method, same, err)
    feats = torch.from_numpy(rs.normal(size=(32, 110, 256)).astype(
        np.float32))
    xy = rs.uniform(0, [1700, 480], (64, 2))
    rois_np = np.concatenate([xy, xy + rs.uniform(16, 400, (64, 2))],
                             1).astype(np.float32)
    cot = torch.from_numpy(rs.normal(size=(64, 7, 7, 256)).astype(
        np.float32))
    roi_out = {}
    for device in ("cpu", dev):
        f = feats.to(device).detach().requires_grad_()
        out = roi_align(f, torch.from_numpy(rois_np).to(device),
                        output_size=(7, 7), spatial_scale=1 / 16)
        (out * cot.to(device)).sum().backward()
        roi_out[str(device)] = (out.detach().cpu(), f.grad.cpu())
    (o_g, g_g), (o_c, g_c) = roi_out[str(dev)], roi_out["cpu"]
    roi_err = ((o_g - o_c).abs().max() / o_c.abs().max()).item()
    roi_gerr = ((g_g - g_c).abs().max() / g_c.abs().max()).item()
    s = rs.normal(0, 2, 512).astype(np.float32)
    rel = rs.integers(0, 4, 512).astype(np.float32)
    mask = rs.uniform(size=512) > 0.1
    loss_err = 0.0
    for fn in (lambda x, d: ranknet_loss(
                   x, torch.from_numpy(rel).to(d),
                   torch.from_numpy(mask).to(d), weight_by_diff=True),
               lambda x, d: custom_mse(x, torch.from_numpy(rel).to(d), 2.5)):
        res = []
        for device in ("cpu", dev):
            x = torch.from_numpy(s).to(device).requires_grad_()
            val = fn(x, device)
            val.backward()
            res.append((val.detach().cpu(), x.grad.cpu()))
        loss_err = max(loss_err, (res[1][0] - res[0][0]).abs().item(),
                       (res[1][1] - res[0][1]).abs().max().item())
    print(f"options (c): card vs CPU path: soft_nms at N {SOFT_NMS_N} "
          + "; ".join(f"{m} keep identical {v[0]} ({v[2]} kept), max "
                      f"|score err| {v[1]:.2e}, {v[3]:.1f} ms a call"
                      for m, v in soft.items())
          + f"; roi_align [32, 110, 256] x 64 rois (7x7, 1/16): max err / "
          f"max {roi_err:.2e}, feature gradient {roi_gerr:.2e} (tol "
          f"{ROI_TOL:g}); ranknet_loss and custom_mse at N 512, values and "
          f"gradients max |err| {loss_err:.2e} (tol {OPS_TOL:g}) {stamp}",
          flush=True)
    assert roi_err <= ROI_TOL and roi_gerr <= ROI_TOL
    assert loss_err <= OPS_TOL


def options_phase(dev, flush, stamp, stage2_rate):
    """17: --refine, photometric jitter and the library ops (see the module
    docstring).  ``stage2_rate`` is phase 13's stage-2 (ms/step, img/s,
    host_wait share).  Returns the kernels' launches on the two paths."""
    import shutil

    from groomed_nms_torch.anchors import locate_anchors
    from groomed_nms_torch.config import apply_overrides
    from groomed_nms_torch.data import png
    from groomed_nms_torch.data.augment import photometric_distort
    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.eval import tester
    from groomed_nms_torch.flagship import flagship_priors
    from groomed_nms_torch.training.trainer import (fuse_preprocess,
                                                    jitter_draws)

    names = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
             "group_leaders")

    def counts():
        return {n: getattr(kernels, n).launches for n in names}

    # -- (a) --refine through scripts/evaluate_torch.py on phase 12's tree
    data_root = os.path.join(EVAL_DIR, "data")
    out_root = os.path.join(EVAL_DIR, "output")
    imdb = build_imdb(os.path.join(data_root, "kitti_split1"), "validation")
    b = 8
    n_batches = sum(-(-sum(1 for r in imdb if (r.im_h, r.im_w) == sz) // b)
                    for sz in EVAL_SIZES)
    results = os.path.join(out_root, "groomed_nms", "results", "results_0",
                           "data")
    shutil.rmtree(results, ignore_errors=True)
    script = load_script("evaluate_torch")
    for n in names:
        getattr(kernels, n).launches = 0
    t = time.perf_counter()
    script.main(["--config", "groomed_nms", "--data-root", data_root,
                 "--output", out_root, "--restore", "0", "--batch", str(b),
                 "--set", "score_thres=0.0", "--set",
                 "compute_dtype=bfloat16", "--refine"])
    wall = time.perf_counter() - t
    refine_launches = counts()
    rows = read_rows(results)
    n_rows = sum(len(v) for v in rows.values())
    moved = None
    plain_dir = os.path.join(EVAL_DIR, "a_grouped")
    if os.path.isdir(plain_dir):           # phase 12's grouped bf16 rows
        plain = read_rows(plain_dir)
        moved = sum(not np.array_equal(r[1], p[1]) for name, rs in
                    rows.items() for r, p in zip(rs, plain.get(name, [])))
    print(f"options (a): evaluate_torch.py --refine, groomed_nms grouped "
          f"bf16 batch {b}: {len(rows)} txt files for {len(imdb)} frames, "
          f"{n_rows} rows ({moved} differ from phase 12's grouped rows); "
          f"launches {refine_launches}; {wall:.1f} s with set-up and the "
          f"evaluator {stamp}", flush=True)
    assert sorted(rows) == sorted(r.id + ".txt" for r in imdb) and n_rows
    assert refine_launches == dict(
        fused_head_scores=n_batches, greedy_nms=n_batches, fused_iou_prune=0,
        group_leaders=0), refine_launches

    # the loop's img/s with and without --refine, in turns, after a warm-up
    cfg = apply_overrides(load_config("groomed_nms"),
                          ["score_thres=0.0", "compute_dtype=bfloat16"])
    model = perturbed_rpn3d(seed=7).to(dev, memory_format=torch.channels_last)
    priors = flagship_priors()
    rois = locate_anchors(priors, (512 // 16, 1760 // 16), 16)
    rois_3d = priors[rois[:, 4].astype(np.int64), 4:]
    long_imdb = list(imdb) * OPTION_REPEAT

    def loop(refine):
        stats = {}
        tester.test_kitti_3d(cfg, model, rois, rois_3d, np.zeros(13),
                             np.ones(13), long_imdb,
                             os.path.join(EVAL_DIR, "loop_refine"),
                             batch_size=b, skip_eval=True,
                             log_fn=lambda s: None, loop_stats=stats,
                             refine=refine)
        return stats["images"] / stats["wall_s"]

    loop(True)
    rates = {False: [], True: []}
    for refine in (False, True, True, False):
        rates[refine].append(loop(refine))

    # one batch's refine on the card against the CPU path, and its cost
    recs = [r for r in imdb if (r.im_h, r.im_w) == EVAL_SIZES[0]][:b]
    p2 = np.stack([r.p2 for r in recs]).astype(np.float32)

    def on_dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    infer = tester.make_infer(model, cfg.detect_config(), 512, 1760,
                              torch.bfloat16)
    p2_d, p2i_d = on_dev(p2), on_dev(np.linalg.inv(p2))
    dets, valid = infer(
        on_dev(np.stack([png.read_png(r.image_path) for r in recs]),
               torch.uint8), on_dev(cfg.image_means), on_dev(cfg.image_stds),
        on_dev(rois), on_dev(rois_3d), p2_d, p2i_d,
        on_dev(np.full((b,), 512 / EVAL_SIZES[0][0], np.float32)),
        on_dev(np.zeros(13)), on_dev(np.ones(13)))
    host_ms, dev_ms, n_launch = refine_check(dets, valid, p2_d, p2i_d, dev,
                                             stamp)
    print(f"options (a): the evaluation loop over phase 12's tree x "
          f"{OPTION_REPEAT} ({len(long_imdb)} frames), grouped bf16 batch "
          f"{b}, in turns: without --refine "
          f"{', '.join(f'{r:.2f}' for r in rates[False])} img/s, with "
          f"{', '.join(f'{r:.2f}' for r in rates[True])} img/s {stamp}",
          flush=True)
    del model, infer, dets, valid
    torch.cuda.empty_cache()

    # -- (b) photometric jitter through scripts/train_torch.py on phase 13's
    # tree, warm-started as phase 13's stage 2
    train = load_script("train_torch")
    t_root = os.path.join(TRAIN_DIR, "data")
    warm_dir = os.path.join(TRAIN_DIR, "output", "kitti_3d_warmup")
    jit_out = os.path.join(TRAIN_DIR, "output_jitter")

    def train_run(distort_prob):
        """One fresh run of JITTER_STEPS steps; (summary, launches, the
        total loss of each step)."""
        shutil.rmtree(jit_out, ignore_errors=True)
        for n in names:
            getattr(kernels, n).launches = 0
        summary = train.main([
            "--config", "groomed_nms", "--data-root", t_root, "--output",
            jit_out, "--max-iter", str(JITTER_STEPS), "--set",
            f"distort_prob={distort_prob}", "--set",
            f"pretrained={warm_dir!r}", "--set", "do_test=False", "--set",
            "display=1"])
        launched = counts()
        torch.cuda.empty_cache()
        with open(os.path.join(jit_out, "groomed_nms", "metrics.csv")) as f:
            lines = f.read().splitlines()
        col = lines[0].split(",").index("total")
        return summary, launched, [float(r.split(",")[col])
                                   for r in lines[1:]]

    # the jittered run beside the same run without jitter, in turns
    summary, jitter_launches, totals = train_run(0.5)
    ms = {0.5: [rate_after(summary)[0]], -1.0: []}
    for p in (-1.0, -1.0, 0.5):
        ms[p].append(rate_after(train_run(p)[0])[0])
    _, ips, wait = rate_after(summary)
    print(f"options (b): train_torch.py --config groomed_nms --set "
          f"distort_prob=0.5, batch 2, 512x1760 f32, warm-started from phase "
          f"13's stage 1, {summary['steps']} steps: "
          f"{', '.join(f'{v:.2f}' for v in ms[0.5])} ms/step after step "
          f"{RATE_FROM} in two runs (the first {ips:.2f} img/s, host_wait "
          f"{wait:.2%}), the same runs with distort_prob=-1 in turns "
          f"{', '.join(f'{v:.2f}' for v in ms[-1.0])}, phase 13's stage 2 "
          f"{stage2_rate[0]:.2f} ms/step; loss (total) "
          f"{[round(v, 4) for v in totals]}; launches in training "
          f"{summary['launches']['train']} {stamp}", flush=True)
    assert summary["steps"] == JITTER_STEPS and all(np.isfinite(totals))
    assert jitter_launches == summary["launches"]["train"] == dict(
        fused_head_scores=0, greedy_nms=0, fused_iou_prune=JITTER_STEPS,
        group_leaders=JITTER_STEPS), jitter_launches

    # the draws and a jittered batch of two training frames, card against
    # CPU path, at the steps the run took
    gcfg = load_config("groomed_nms")
    frames = torch.from_numpy(np.stack([png.read_png(r.image_path) for r in
                                        build_imdb(os.path.join(
                                            t_root, "kitti_split1"),
                                            "training")[:2]]))
    mirror = torch.tensor([True, False])
    means = np.asarray(gcfg.image_means, np.float32)
    stds = np.asarray(gcfg.image_stds, np.float32)
    seen = {}

    def keep(state, batch):
        seen[batch["images"].device.type] = batch["images"]

    scale = torch.from_numpy(stds * 255.0)[None, :, None, None]

    def preprocessed(step, distort_prob):
        """{device type: the fused preprocess's images of ``step``}."""
        for device in ("cpu", dev):
            fuse_preprocess(
                keep, torch.from_numpy(means).to(device),
                torch.from_numpy(stds).to(device),
                target_h=gcfg.crop_size[0], crop_w=gcfg.crop_size[1],
                distort_prob=distort_prob, rng_seed=gcfg.rng_seed)(
                    SimpleNamespace(step=step),
                    {"images_u8": frames.to(device),
                     "mirror": mirror.to(device)})
        return ((seen["cuda"].cpu() - seen["cpu"]) * scale).abs().max().item()

    # the resize alone (no jitter), card against CPU path: its own distance
    own = preprocessed(0, -1.0)
    x = frames.permute(0, 3, 1, 2).float()
    worst = distort = 0.0
    applied, draws_equal = 0, True
    for step in range(JITTER_STEPS):
        worst = max(worst, preprocessed(step, 0.5))
        d = jitter_draws(gcfg.rng_seed, step, 2, 0.5)
        d_dev = d.to(dev, non_blocking=True)
        draws_equal &= all(torch.equal(a, c.cpu()) for a, c in zip(d, d_dev))
        applied += int(d.apply.sum())
        jit = photometric_distort(x.to(dev), *d_dev[1:]).cpu()
        distort = max(distort, (jit - photometric_distort(x, *d[1:])).abs()
                      .max().item())
    print(f"options (b): the jitter of steps 0-{JITTER_STEPS - 1} on two "
          f"375x1242 frames, card vs CPU path: draws equal {draws_equal}, "
          f"{applied} of {2 * JITTER_STEPS} images jittered; "
          f"photometric_distort max err {distort:.3e}, the jittered batch "
          f"after the resize {worst:.3e} beside the resize's own {own:.3e}, "
          f"on the 0-255 scale (tol {JITTER_ATOL_255:g}, beyond the "
          f"resize's own)", flush=True)
    assert draws_equal and applied > 0 and distort <= JITTER_ATOL_255
    assert worst <= own + JITTER_ATOL_255

    # -- (c) the library ops, card against CPU path
    library_ops_check(dev, stamp)
    return {"refine": refine_launches, "jitter": jitter_launches,
            "refine_batch": {"host_ms": host_ms, "device_ms": dev_ms,
                             "launches": n_launch},
            "img_s": {"plain": rates[False], "refine": rates[True]}}


# data parallelism (phase 18): groomed_nms_torch/parallel on the card.  Two
# ranks share the one card through gloo (nccl takes a card a rank); the
# one-rank runs use nccl.  (b) holds two ranks to one process in f64 to
# 1e-9 of each tensor's max and the card to the CPU path by phase 13's
# tiny-loop rule; (d) holds the two ranks' rows to one rank's by phase 12's
# rule, both in f32 with TF32 off.  The two-rank figures of (c) measure the
# path on one card, not a scaling: the ranks take turns on it.
DP_STEPS, DP_RESUME, DP_BATCH, DP_PROFILED = 8, 10, 8, 1
DP_PARITY_REL = 1e-9
DP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "chip_smoke_parallel")
DP_KERNELS = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
              "group_leaders", "dense_block_eval")
COLLECTIVE_KEYS = ("nccl", "gloo", "all_reduce", "allreduce", "broadcast",
                   "all_gather", "allgather", "barrier")


def collectives(prof, steps):
    """{op or kernel name: [calls a step, device ms a step, host ms a step]}
    of the collectives in a torch.profiler trace over ``steps`` steps."""
    out = {}
    for e in prof.key_averages():
        name = e.key
        if name.startswith(("aten::", "autograd::engine")) or not any(
                k in name.lower() for k in COLLECTIVE_KEYS):
            continue
        dev_us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
        out[name] = [e.count / steps, dev_us / 1e3 / steps,
                     e.cpu_time_total / 1e3 / steps]
    return out


def profile_last(run, steps, last):
    """Wrap ``run.step`` (``train_torch.build_training``'s) so that
    torch.profiler records the last ``last`` of ``steps`` steps; returns
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    step, calls = run.step, [0]

    def profiled(state, raw):
        n = calls[0]
        calls[0] += 1
        if n == steps - last:
            torch.cuda.synchronize()
            prof.start()
        out = step(state, raw)
        if n == steps - 1:
            torch.cuda.synchronize()
            prof.stop()
        return out
    run.step = profiled
    return prof


def rank_worker(argv):
    """``chip_smoke.py --rank-worker SCRIPT OUT_DIR [--no-tf32] -- ARGS``,
    as torchrun starts it on each rank: ``scripts/SCRIPT.py``'s main(ARGS),
    then OUT_DIR/rank<r>.json with the rank's kernel launches and, for
    train_torch (a fresh run to ARGS' --max-iter), its summary, a digest of
    its parameters and the collectives of its last DP_PROFILED steps
    (torch.profiler)."""
    import contextlib
    import hashlib

    from groomed_nms_torch.parallel.dryrun import tf32_off

    t_entry = time.time()
    script_name, out_dir, *rest = argv
    flags = contextlib.nullcontext()
    if rest[0] == "--no-tf32":
        flags = tf32_off()
        rest = rest[1:]
    assert rest[0] == "--", rest
    args = rest[1:]
    script = load_script(script_name)
    built = {}
    if hasattr(script, "build_training"):
        build = script.build_training
        steps = int(args[args.index("--max-iter") + 1])

        def keep(*a, **k):
            run = build(*a, **k)
            built["prof"] = profile_last(run, steps, DP_PROFILED)
            built["run"] = run
            return run
        script.build_training = keep
    for n in DP_KERNELS:
        getattr(kernels, n).launches = 0
    t_main = time.time()
    with flags:
        result = script.main(args)
    torch.cuda.synchronize()
    out = {"rank": int(os.environ["RANK"]),
           "launches": {n: getattr(kernels, n).launches for n in DP_KERNELS},
           "times": {"entry": t_entry, "main": t_main, "main_end": time.time()}}
    if built:
        out["summary"] = {k: result.get(k) for k in (
            "steps", "step", "start_step", "train_s", "host_wait_s",
            "step_end_s", "batch_size", "peak_bytes", "peak_bytes_by_rank",
            "world", "launches")}
        out["collectives"] = collectives(built["prof"], DP_PROFILED)
        out["times"]["profile_end"] = time.time()
        sd = built["run"].model.state_dict()
        out["digest"] = hashlib.sha256(b"".join(
            v.detach().cpu().numpy().tobytes() for v in sd.values())
        ).hexdigest()
    out["times"]["done"] = time.time()
    with open(os.path.join(out_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)


def torchrun(nproc, script_name, out_dir, *args, no_tf32=False):
    """Start ``rank_worker`` on ``nproc`` ranks through torchrun (a
    subprocess); returns ``finish()``, which waits for it and returns (the
    ranks' json in rank order, its wall seconds).  A rank that fails fails
    ``finish()``; a run still going when this process exits is ended."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", os.path.abspath(__file__),
           "--rank-worker", script_name, out_dir,
           *(["--no-tf32"] if no_tf32 else []), "--", *args]
    t = time.perf_counter()
    t_start = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def stop():                       # torchrun ends its ranks on SIGTERM
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=60)
    atexit.register(stop)             # a phase that raises leaves no ranks

    def finish():
        stdout, stderr = proc.communicate()
        wall = time.perf_counter() - t
        t_end = time.time()
        if proc.returncode:
            print(stdout[-4000:], stderr[-8000:], flush=True)
            raise RuntimeError(f"torchrun of {script_name} failed "
                               f"({proc.returncode})")
        ranks = []
        for r in range(nproc):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        tr = ranks[0]["times"]
        split = {"start to rank entry": tr["entry"] - t_start,
                 "imports and flags": tr["main"] - tr["entry"],
                 "main()": tr["main_end"] - tr["main"],
                 "profiler digest": tr.get("profile_end", tr["main_end"]) -
                 tr["main_end"],
                 "rank end to exit": t_end - tr["done"]}
        print(f"torchrun of {script_name} on {nproc} ranks: {wall:.1f} s, "
              f"rank 0's split (s) "
              f"{json.dumps({k: round(v, 2) for k, v in split.items()})}",
              flush=True)
        return ranks, wall
    return finish


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_rank(fn):
    """fn() as rank 0 of a one-rank nccl group (torchrun's environment set
    for the call, so the script joins and leaves the group itself)."""
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def parallel_phase(dev, stamp):
    """18: data parallelism (see the module docstring).  Returns the
    kernels' launches a rank on the data-parallel paths."""
    import shutil

    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.parallel.dryrun import (dryrun_multichip,
                                                   one_process_step,
                                                   step_parity, tf32_off)
    from groomed_nms_torch.training.checkpoint import checkpoint_path

    t_phase = time.perf_counter()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    names = DP_KERNELS

    # (d)'s two ranks start first, on a copy of phase 12's run directory,
    # and run beside (a) and (b), which time nothing; (c) waits for them
    ev_script = load_script("evaluate_torch")
    ev_root = os.path.join(EVAL_DIR, "data")
    ev_out = os.path.join(EVAL_DIR, "output")
    ev_out2 = os.path.join(DP_DIR, "eval_two_ranks")
    shutil.copytree(os.path.join(ev_out, "groomed_nms"),
                    os.path.join(ev_out2, "groomed_nms"),
                    ignore=shutil.ignore_patterns("results"))
    ev_args = ["--config", "groomed_nms", "--data-root", ev_root,
               "--restore", "0", "--batch", "8", "--set", "score_thres=0.0",
               "--set", "compute_dtype=float32", "--skip-eval"]
    finish_eval = torchrun(2, "evaluate_torch",
                           os.path.join(DP_DIR, "json_eval"), *ev_args,
                           "--output", ev_out2, "--dist-backend", "gloo",
                           no_tf32=True)

    # -- (a) dryrun_multichip(2) on the card -------------------------------
    t = time.perf_counter()
    dry = dryrun_multichip(2, dev)
    print(f"parallel (a): dryrun_multichip(2) on the card, {dry['backend']}: "
          f"train launches by rank "
          f"{[r['train_launches'] for r in dry['ranks']]} (2 steps), eval "
          f"launches by rank {[r['eval_launches'] for r in dry['ranks']]} "
          f"(1 batch); {time.perf_counter() - t:.1f} s {stamp}", flush=True)
    for r in dry["ranks"]:
        assert r["train_launches"]["fused_iou_prune"] == 2
        assert r["train_launches"]["group_leaders"] == 2
        assert r["eval_launches"] == dict(fused_head_scores=1, greedy_nms=1)

    # -- (b) the tiny step: one rank against two sharing the card, f64 -----
    t = time.perf_counter()
    worst, key, same, one, _, one_stats = step_parity(2, dev, torch.float64)
    cpu, cpu_stats = one_process_step(2, "cpu", torch.float64)
    cpu_err = max(((one[k] - v).abs().max() / v.abs().max()).item()
                  for k, v in cpu.items()
                  if v.is_floating_point() and v.abs().max() > 0)
    print(f"parallel (b): the tiny GrooMeD step (batch_skip 2, 2 micro-"
          f"steps), 2 ranks sharing the card (gloo) vs one process, f64: max "
          f"param err / max {worst:.3e} at {key} (tol {DP_PARITY_REL:g}), "
          f"ranks' parameters and running statistics identical: {same}; one "
          f"process card vs CPU path {cpu_err:.3e} (tol {TINY_LOOP_REL:g}); "
          f"loss {one_stats[-1]['total']:.6f} (CPU {cpu_stats[-1]['total']:.6f}"
          f"); {time.perf_counter() - t:.1f} s", flush=True)
    assert same and worst <= DP_PARITY_REL and cpu_err <= TINY_LOOP_REL

    ev_ranks, ev_wall = finish_eval()

    # -- (c) scripts/train_torch.py at full width: stage 2 on phase 13's
    # tree, warm-started from its stage 1, global batch DP_BATCH --------------
    script = load_script("train_torch")
    data_root = os.path.join(TRAIN_DIR, "data")
    warm_dir = os.path.join(TRAIN_DIR, "output", "kitti_3d_warmup")
    train_args = ["--config", "groomed_nms", "--data-root", data_root,
                  "--set", f"pretrained={warm_dir!r}", "--set",
                  f"batch_size={DP_BATCH}", "--set", "do_test=False",
                  "--set", "display=4"]

    def rate(s, last=None):
        """(ms/step from the second step to step ``last`` (the last), img/s,
        host_wait share) of a summary."""
        ends = s["step_end_s"]
        last = last or s["steps"]
        ms = (ends[last - 1] - ends[0]) / (last - 1) * 1e3
        return ms, s["batch_size"] / ms * 1e3, s["host_wait_s"] / s["train_s"]

    one_out = os.path.join(DP_DIR, "one_rank")
    for n in names:
        getattr(kernels, n).launches = 0
    t = time.perf_counter()
    s1 = one_rank(lambda: script.main([*train_args, "--output", one_out,
                                       "--max-iter", str(DP_STEPS),
                                       "--dist-backend", "nccl"]))
    wall1 = time.perf_counter() - t
    l1 = {n: getattr(kernels, n).launches for n in names}
    ms1, ips1, wait1 = rate(s1)
    print(f"parallel (c): train_torch.py groomed_nms f32 512x1760, global "
          f"batch {DP_BATCH}, 1 rank (nccl), {s1['steps']} steps: "
          f"{ms1:.2f} ms/step over steps 2-{DP_STEPS}, {ips1:.2f} img/s, "
          f"host_wait "
          f"{wait1:.2%}, peak memory {s1['peak_bytes_by_rank']} B by rank; "
          f"launches {l1}; {wall1:.1f} s with set-up {stamp}", flush=True)
    assert s1["world"] == 1 and s1["step"] == DP_STEPS
    assert l1["fused_iou_prune"] == l1["group_leaders"] == DP_STEPS, l1
    assert l1["dense_block_eval"] == 0, l1        # no fast_eval in training

    two_out = os.path.join(DP_DIR, "two_ranks")
    ranks, wall2 = torchrun(2, "train_torch", os.path.join(DP_DIR, "json2"),
                            *train_args, "--output", two_out, "--max-iter",
                            str(DP_STEPS), "--dist-backend", "gloo")()
    digests = {r["digest"] for r in ranks}
    for r in ranks:
        s = r["summary"]
        ms, ips, wait = rate(s, DP_STEPS - DP_PROFILED)
        print(f"parallel (c): 2 ranks sharing the card (gloo), rank "
              f"{r['rank']}: {ms:.2f} ms/step over steps 2-"
              f"{DP_STEPS - DP_PROFILED} (a check of the path on one card, "
              f"not a scaling number), {ips:.2f} img/s, host_wait "
              f"{wait:.2%}, peak memory {s['peak_bytes']} B; launches a step "
              f"{ {n: v / s['steps'] for n, v in r['launches'].items()} }; "
              f"collectives a step over the last {DP_PROFILED} (torch."
              f"profiler) [calls, device ms, host ms] "
              f"{json.dumps(r['collectives'])} {stamp}", flush=True)
        assert s["world"] == 2 and s["step"] == DP_STEPS
        assert r["launches"]["fused_iou_prune"] == DP_STEPS
        assert r["launches"]["group_leaders"] == DP_STEPS
        assert r["launches"]["dense_block_eval"] == 0
    print(f"parallel (c): 2 ranks: parameters identical across ranks: "
          f"{len(digests) == 1}; {wall2:.1f} s for torchrun with set-up",
          flush=True)
    assert len(digests) == 1, "the ranks' parameters differ"
    for out in (one_out, two_out):
        wdir = os.path.dirname(checkpoint_path(
            os.path.join(out, "groomed_nms"), DP_STEPS))
        assert os.listdir(wdir) == [f"checkpoint_{DP_STEPS}.pt"], \
            os.listdir(wdir)
        with open(os.path.join(out, "groomed_nms", "metrics.csv")) as f:
            rows = f.read().splitlines()
        col = rows[0].split(",").index("total")
        totals = [float(r.split(",")[col]) for r in rows[1:]]
        assert len(totals) == DP_STEPS // 4 and np.isfinite(totals).all(), \
            totals

    # the one-rank run resumed to DP_RESUME, its last step under
    # torch.profiler: the collectives of a step on nccl, with device time
    build, profiled = script.build_training, {}

    def build_profiled(*a, **k):
        run = build(*a, **k)
        profiled["prof"] = profile_last(run, DP_RESUME - DP_STEPS,
                                        DP_PROFILED)
        return run
    script.build_training = build_profiled
    try:
        s3 = one_rank(lambda: script.main([*train_args, "--output", one_out,
                                           "--max-iter", str(DP_RESUME),
                                           "--dist-backend", "nccl"]))
    finally:
        script.build_training = build
    coll1 = collectives(profiled.pop("prof"), DP_PROFILED)
    print(f"parallel (c): 1 rank resumed at {s3['start_step']} to "
          f"{s3['step']}; collectives a step [calls, device ms, host ms] "
          f"{json.dumps(coll1)} {stamp}", flush=True)
    assert s3["start_step"] == DP_STEPS and s3["step"] == DP_RESUME
    torch.cuda.empty_cache()

    # -- (d) scripts/evaluate_torch.py, 2 ranks against 1, f32 TF32 off ----
    def results(out):
        return os.path.join(out, "groomed_nms", "results", "results_0",
                            "data")
    shutil.rmtree(results(ev_out), ignore_errors=True)
    for n in names:
        getattr(kernels, n).launches = 0
    with tf32_off():
        ev_script.main([*ev_args, "--output", ev_out])
    le1 = {n: getattr(kernels, n).launches for n in names}
    rows1 = read_rows(results(ev_out))
    rows2 = read_rows(results(ev_out2))
    same_rows, n_cmp, n_ok, max_err = row_agreement(rows2, rows1)
    imdb = build_imdb(os.path.join(ev_root, "kitti_split1"), "validation")
    want = [0, 0]                     # K1/K2 launches of each rank
    for size in EVAL_SIZES:
        n = sum(1 for r in imdb if (r.im_h, r.im_w) == size)
        for i in range(0, n, 8):
            for rank in range(2):
                want[rank] += len(range(n)[i:i + 8][rank * 4:rank * 4 + 4]) > 0
    print(f"parallel (d): evaluate_torch.py groomed_nms f32 (TF32 off) on "
          f"phase 12's tree, batch 8: 1 rank launches {le1}; 2 ranks "
          f"sharing the card (gloo, 4 frames a rank a batch) launches by rank "
          f"{[r['launches'] for r in ev_ranks]}; rows: files, counts and "
          f"classes equal {same_rows}, {n_ok}/{n_cmp} rows within phase 12's "
          f"rule, max |err| {max_err:.3e}; {ev_wall:.1f} s for torchrun, "
          f"beside (a) and (b) "
          f"{stamp}", flush=True)
    assert same_rows and n_ok == n_cmp > 0
    for r, w in zip(ev_ranks, want):
        assert r["launches"]["fused_head_scores"] == w, (r, w)
        assert r["launches"]["greedy_nms"] == w, (r, w)
        # the f32 eval trunk: K4 once a dense block of each batch
        assert r["launches"]["dense_block_eval"] == TRUNK_BLOCKS * w, (r, w)
    assert le1["dense_block_eval"] == \
        TRUNK_BLOCKS * le1["fused_head_scores"] > 0, le1
    print(f"parallel: phase 18 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"train_rank_launches_per_step": {
                n: ranks[0]["launches"][n] / DP_STEPS
                for n in ("fused_iou_prune", "group_leaders")},
            "eval_rank_launches": [
                {n: r["launches"][n] for n in ("fused_head_scores",
                                               "greedy_nms")}
                for r in ev_ranks],
            # K4: measured on every phase-18 run
            "dense_block_eval": {
                "one_rank_train_launches": l1["dense_block_eval"],
                "train_launches_by_rank": [
                    r["launches"]["dense_block_eval"] for r in ranks],
                "one_rank_eval_launches": le1["dense_block_eval"],
                "eval_launches_by_rank": [
                    r["launches"]["dense_block_eval"] for r in ev_ranks]},
            "dryrun_train_launches": dry["ranks"][0]["train_launches"],
            "dryrun_eval_launches": dry["ranks"][0]["eval_launches"]}


# backbone rematerialisation and the tool twins (phase 19): the flagship
# step with backbone_remat none, layer and epilogue from the same weights
# and batch (the forward is the same, so the first loss is identical; the
# gradients within REMAT_GRAD_REL of each tensor's max, bf16 backward
# kernels summing in other orders; the running statistics identical), then
# each tool twin's main() at the flagship's width
REMAT_MODES = (False, "layer", "epilogue")
REMAT_GRAD_REL = 1e-2
PHASE19_KERNELS = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
                   "group_leaders", "dense_block_eval")


def tool_launches(fn):
    """(fn's result, each kernel's launches while it ran)."""
    return count_launches(fn, PHASE19_KERNELS)


def remat_step_check(stamp):
    """(a): one step of each remat mode from the same weights and batch,
    checked against the none run, then 3 warm-up + TIMED steps of each in
    turns (none, layer, epilogue and back): ms/step and peak memory.
    Returns {mode: {ms, peak_gb, launches}}."""
    runs = {}
    for mode in REMAT_MODES:
        step, state, batch = build_flagship_train(device="cuda",
                                                  backbone_remat=mode)
        stats, launches = tool_launches(lambda: step(state, batch))
        assert launches["fused_iou_prune"] == launches["group_leaders"] == 1, \
            f"remat {mode}: expected one K3 and one grouping launch a step, " \
            f"got {launches}"
        runs[mode] = dict(step=step, state=state, batch=batch,
                          loss=float(stats["total"]), launches=launches,
                          grads={n: p.grad.clone() for n, p in
                                 state.model.named_parameters()},
                          buffers={k: v.clone() for k, v in
                                   state.model.named_buffers()})
    ref = runs[False]
    for mode in REMAT_MODES[1:]:
        r = runs[mode]
        grad_err = max(((r["grads"][n] - g).abs().max() / g.abs().max()).item()
                       for n, g in ref["grads"].items() if g.abs().max() > 0)
        same_buffers = all(torch.equal(r["buffers"][k], v)
                           for k, v in ref["buffers"].items())
        print(f"remat (a) {mode}: first step's loss {r['loss']:.6f} vs none "
              f"{ref['loss']:.6f}; max gradient err / max {grad_err:.3e} "
              f"(tol {REMAT_GRAD_REL:g}); running statistics and "
              f"num_batches_tracked identical {same_buffers}; launches "
              f"{r['launches']}", flush=True)
        assert r["loss"] == ref["loss"], f"remat {mode}: the loss differs"
        assert grad_err <= REMAT_GRAD_REL, f"remat {mode}: gradients differ"
        assert same_buffers, f"remat {mode}: running statistics differ"
    for r in runs.values():
        r.pop("grads")
        for p in r["state"].model.parameters():
            p.grad = None
    n_img = ref["batch"]["images_u8"].shape[0]
    timed = {mode: [] for mode in REMAT_MODES}
    for mode in REMAT_MODES + REMAT_MODES[::-1]:
        r = runs[mode]
        for _ in range(WARMUP):
            r["step"](r["state"], r["batch"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(TIMED):
            r["step"](r["state"], r["batch"])
        torch.cuda.synchronize()
        timed[mode].append(((time.perf_counter() - t0) / TIMED * 1e3,
                            torch.cuda.max_memory_allocated() / 1e9))
    out = {}
    for mode, rows in timed.items():
        name = mode or "none"
        out[name] = dict(ms=[ms for ms, _ in rows],
                         peak_gb=[gb for _, gb in rows],
                         launches=runs[mode]["launches"])
        print(f"remat (a) {name}: batch {n_img}, 512x1760 bf16, {TIMED} "
              f"steps after {WARMUP}, two turns: "
              f"{', '.join(f'{ms:.2f}' for ms, _ in rows)} ms/step, peak "
              f"memory {', '.join(f'{gb:.2f}' for _, gb in rows)} GB {stamp}",
              flush=True)
    del runs
    torch.cuda.empty_cache()
    return out


def tools_phase(dev, stamp):
    """Phase 19 (see the module docstring).  Returns {"remat": (a)'s
    table, "launches": {part: {kernel: launches}}}."""
    t_phase = time.perf_counter()
    launches = {}
    remat = remat_step_check(stamp)
    launches["remat"] = {k: sum(v["launches"][k] for v in remat.values())
                         for k in PHASE19_KERNELS}

    # (b) scripts/profile_torch.py, both modes, into a temporary directory
    profile = load_tool("scripts/profile_torch.py")
    iters = 3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as d:
        for mode, want in (("infer", ("fused_head_scores", "greedy_nms")),
                           ("train", ("fused_iou_prune", "group_leaders"))):
            res, n = tool_launches(lambda: profile.main(
                ["--mode", mode, "--out", d, "--iters", str(iters)]))
            launches[f"profile_{mode}"] = n
            with open(res["trace"]) as f:
                json.load(f)                     # the trace parses
            got = {k: res["trace_kernels"][k] for k in want}
            print(f"tools (b) profile_torch --mode {mode}: {iters} calls, "
                  f"device kernels in the trace {res['trace_kernels']}, "
                  f"launches a call {res['launches_per_call']} {stamp}",
                  flush=True)
            assert got == {k: iters for k in want}, \
                f"profile {mode}: expected {want} once a call, got {got}"

    # (c) analysis/bench_latency_torch.py
    rows, launches["latency"] = tool_launches(lambda: load_tool(
        "analysis/bench_latency_torch.py").main(
            ["--batches", "1", "8", "--iters", "10"]))
    print(f"tools (c) bench_latency_torch: {json.dumps(rows)} {stamp}",
          flush=True)

    # (d) analysis/bench_groomed_nms_torch.py at N = 1000 (checked first)
    gb, launches["groomed_bench"] = tool_launches(lambda: load_tool(
        "analysis/bench_groomed_nms_torch.py").main(["1000"]))
    assert gb["launches_per_call"]["group_leaders"] == 1, gb
    print(f"tools (d) bench_groomed_nms_torch: {json.dumps(gb)} {stamp}",
          flush=True)

    # (e) analysis/roofline_train_torch.py: train, train --remat layer, infer
    roof = {}
    rt = load_tool("analysis/roofline_train_torch.py")
    for name, argv in (("train", ["--mode", "train"]),
                       ("train_remat_layer", ["--mode", "train", "--remat",
                                              "layer"]),
                       ("infer", ["--mode", "infer"])):
        roof[name], launches[f"roofline_{name}"] = tool_launches(
            lambda: rt.main([*argv, "--iters", str(TIMED)]))
    print(f"tools (e) roofline_train_torch: {json.dumps(roof)}", flush=True)

    # (f) analysis/bench_loader_torch.py on phase 13's tree
    loader, _ = tool_launches(lambda: load_tool(
        "analysis/bench_loader_torch.py").main(
            ["--data-root", os.path.join(TRAIN_DIR, "data"), "--iters", "10",
             "--warmup", "2"]))

    # (g) analysis/compare_video_training_schemes_torch.py
    with tempfile.TemporaryDirectory(prefix="chip_smoke_schemes_") as d:
        t0 = time.perf_counter()
        path = load_tool("analysis/compare_video_training_schemes_torch.py"
                         ).main(["--iters", "4", "--batch", "2", "--out",
                                 os.path.join(d, "schemes.json")])
        with open(path) as f:
            schemes = json.load(f)
    finite = all(v is None or np.isfinite(v) for m in schemes.values()
                 for v in m.values())
    print(f"tools (g) compare_video_training_schemes_torch --iters 4 --batch "
          f"2 in {time.perf_counter() - t0:.1f} s: {json.dumps(schemes)}; "
          f"finite or null {finite} {stamp}", flush=True)
    assert set(schemes) == {"direct", "fused", "untrained"} and finite

    for part, n in launches.items():
        assert n["dense_block_eval"] == 0, f"{part} launched K4"
    for part in ("profile_infer", "latency", "roofline_infer"):
        assert launches[part]["fused_head_scores"] > 0 and \
            launches[part]["greedy_nms"] > 0, f"{part}: no K1 or K2 launch"
    for part in ("remat", "profile_train", "roofline_train",
                 "roofline_train_remat_layer", "groomed_bench"):
        assert launches[part]["fused_iou_prune"] > 0 and \
            launches[part]["group_leaders"] > 0, f"{part}: no K3 or grouping"
    print(f"tools: launches by part {json.dumps(launches)}; loader "
          f"{json.dumps(loader)}; phase 19 in "
          f"{time.perf_counter() - t_phase:.1f} s {stamp}", flush=True)
    return dict(remat=remat, launches=launches)


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
    sources = ("greedy_nms.cu", "dense_block.cu", "dense_block_f32.cu",
               "iou_prune.cu", "group_leaders.cu", "png_unfilter.cpp")
    # one compiler per source, and the C++ evaluator (eval/Makefile) beside
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        evaluator = pool.submit(ensure_binary)
        libs = list(pool.map(_build.build, sources))
        evaluator = evaluator.result()
    _build.greedy_nms_lib()
    _build.dense_block_lib()
    _build.dense_block_f32_lib()
    _build.iou_prune_lib()
    _build.group_leaders_lib()
    _build.png_unfilter_lib()
    print(f"build: nvcc / c++ {' + '.join(sources)} -> "
          f"{', '.join(lib.name for lib in libs)}, and {evaluator}, in "
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
    k4 = k4_phase(dev, flush, stamp)

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
    rate_f, fe_launches, n_valid = serve_rate(
        infer_f, args_f, {"fused_head_scores": 1, "greedy_nms": 1,
                          "dense_block_eval": 2})
    print(f"fast_eval (c): {TIMED} batches of {batch} at 512x1760 bf16: "
          f"{rate_f:.2f} img/s, {batch * 1e3 / rate_f:.2f} ms/batch; "
          f"launches {fe_launches}; {n_valid} valid rows {stamp}",
          flush=True)

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
    fe32_launches = fast_eval_f32_phase(dev, stamp)    # 7 (d), (e)
    k3 = k3_phase(dev, flush, stamp)
    group = group_phase(dev, flush, stamp)
    operator_phase(dev, flush, stamp)
    groomed_test_phase(stamp)
    train_launches = train_phase(stamp)
    eval_phase(dev, flush, stamp)
    stage2_rate = train_entry_phase(dev, stamp)
    video = video_phase(dev, flush, stamp)
    video_train_phase(dev, stamp)
    export_launches, export_video = export_phase(dev, stamp)
    options = options_phase(dev, flush, stamp, stage2_rate)
    parallel = parallel_phase(dev, stamp)
    tools = tools_phase(dev, stamp)

    # -- 20. results ----------------------------------------------------------
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
    def k4_figures(dname, launches):
        # one batch's two blocks (1 and 2): ms, plain_ms, bound_ms and
        # library_ms are block 1 + block 2; the bound from the two blocks'
        # summed work
        main = [k4[dname][n] for n in K4_BLOCKS]
        nbytes = 2 if dname == "bf16" else 4
        work = [kernels.dense_block_work(*s[:-1], elem_bytes=nbytes)
                for s in K4_BLOCKS.values()]
        ms_bound = bound(sum(w[0] for w in work), sum(w[1] for w in work),
                         PEAK_BF16 if dname == "bf16" else PEAK_F32_PRODUCTS)
        return {"launches": launches,
                "max_abs_err": max(v["max_abs"] for v in main),
                "max_rel_err": max(v["max_rel"] for v in main),
                "mean_rel_err": max(v["mean_rel"] for v in main),
                "ms": sum(v["ms"] for v in main),
                "plain_ms": sum(v["plain_ms"] for v in main),
                "bound_ms": ms_bound[0], "bound_by": ms_bound[1],
                "library_ms": sum(v["lib_ms"] for v in main)}
    entries = [
        {"name": "fused_head_scores", "route": "triton",
         "source": "groomed_nms_torch/ops/kernels.py",
         "replaces": "groomed_nms_tpu/ops/pallas_kernels.py:146",
         "launches": launches["fused_head_scores"],
         "max_abs_err": max(k1_err, video["fused_head_scores"]["max_abs_err"]),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "video": video["fused_head_scores"],
         "export": {"launches": export_launches["fused_head_scores"],
                    "video_launches": export_video["full width f32"][
                        "fused_head_scores"]},
         "options": {"refine_launches":
                     options["refine"]["fused_head_scores"]},
         "parallel": {"eval_launches_by_rank": [
             r["fused_head_scores"] for r in parallel["eval_rank_launches"]],
             "dryrun_eval_launches_a_rank":
             parallel["dryrun_eval_launches"]["fused_head_scores"]}},
        {"name": "greedy_nms", "route": "cuda",
         "source": "groomed_nms_torch/csrc/greedy_nms.cu",
         "replaces": "groomed_nms_tpu/ops/pallas_kernels.py:266",
         "launches": launches["greedy_nms"], "max_abs_err": 0.0,
         "ms": k2["flagship"]["ms"], "plain_ms": k2["flagship"]["plain_ms"],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None, "video": video["greedy_nms"],
         "export": {"launches": export_launches["greedy_nms"],
                    "video_launches": export_video["full width f32"][
                        "greedy_nms"]},
         "options": {"refine_launches": options["refine"]["greedy_nms"]},
         "parallel": {"eval_launches_by_rank": [
             r["greedy_nms"] for r in parallel["eval_rank_launches"]],
             "dryrun_eval_launches_a_rank":
             parallel["dryrun_eval_launches"]["greedy_nms"]}},
        # bf16 (the flagship's fast_eval) at the top level, f32 (the f32
        # fast_eval of phase 7 e) under "f32", each block of both dtypes
        # under "blocks"
        {"name": "dense_block_eval", "route": "cuda",
         "source": "groomed_nms_torch/csrc/dense_block.cu",
         "replaces": "groomed_nms_tpu/ops/pallas_dense_block.py:140",
         **k4_figures("bf16", fe_launches["dense_block_eval"]),
         "f32": {"source": "groomed_nms_torch/csrc/dense_block_f32.cu",
                 **k4_figures("f32", fe32_launches["dense_block_eval"]),
                 "split": {n: v["split"] for n, v in k4["f32"].items()}},
         "blocks": k4,
         "parallel": parallel["dense_block_eval"]},
        # launches: the full-size train loop's; ms at its shape [8, 512, 4]
        {"name": "fused_iou_prune", "route": "cuda",
         "source": "groomed_nms_torch/csrc/iou_prune.cu",
         "replaces": "groomed_nms_tpu/ops/pallas_kernels.py:76",
         "launches": train_launches["fused_iou_prune"],
         "max_abs_err": max(v["max_abs"] for v in k3.values()),
         "ms": k3["train"]["ms"], "plain_ms": k3["train"]["plain_ms"],
         "bound_ms": k3["train"]["bound_ms"],
         "bound_by": k3["train"]["bound_by"], "library_ms": None,
         "export": {"launches": export_launches["fused_iou_prune"]},
         "options": {"jitter_launches":
                     options["jitter"]["fused_iou_prune"]},
         "parallel": {"train_launches_a_rank_a_step": parallel[
             "train_rank_launches_per_step"]["fused_iou_prune"],
             "dryrun_train_launches_a_rank":
             parallel["dryrun_train_launches"]["fused_iou_prune"]}},
        # no TPU kernel: the JAX grouping is a lax.while_loop; launches the
        # train loop's, ms on the operator's own input at [8, 512]
        {"name": "group_leaders", "route": "cuda",
         "source": "groomed_nms_torch/csrc/group_leaders.cu",
         "replaces": "groomed_nms_tpu/ops/groomed_nms.py:94",
         "launches": train_launches["group_leaders"], "max_abs_err": 0.0,
         "ms": group["ms"], "plain_ms": group["plain_ms"],
         "bound_ms": group["bound_ms"], "bound_by": group["bound_by"],
         "library_ms": None, "split": group["split"],
         "paths": group["paths"], "analysis": group["analysis"],
         "export": {"launches": export_launches["group_leaders"]},
         "options": {"jitter_launches": options["jitter"]["group_leaders"]},
         "parallel": {"train_launches_a_rank_a_step": parallel[
             "train_rank_launches_per_step"]["group_leaders"],
             "dryrun_train_launches_a_rank":
             parallel["dryrun_train_launches"]["group_leaders"]}},
    ]
    for entry in entries:            # launches in each part of phase 19
        entry["tools"] = {part: n[entry["name"]]
                          for part, n in tools["launches"].items()}
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(sys.argv[2:])
    else:
        main()
