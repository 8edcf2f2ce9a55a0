"""``dryrun_multichip``: the data-parallel path in n processes, checked
(counterpart of ``__graft_entry__.py::dryrun_multichip``).

Four checks, each printing the JAX dryrun's "OK" line:

1. the still-image step of a tiny acceptance model with GrooMeD-NMS in the
   loss, the fused preprocess (uint8 48x96 frames resized to 64x128,
   mirrored) and the photometric jitter (``distort_prob`` 0.5), SGD with
   ``batch_skip`` 2, on a global batch of n (one image a rank): the loss
   finite;
2. 1-vs-n parity: the same two micro-steps (one update) in this process on
   the whole batch land on the same parameters;
3. the video step (``VideoRPN3D`` on 2-frame clips, the ``has_vel`` loss):
   two steps, the loss finite;
4. sharded evaluation: each rank runs ``make_infer`` on its rows and writes
   their KITTI txt files into one directory, n files in all.

The ranks run on ``device``: the CPU with gloo, or the card, with nccl when
each rank has a card of its own and gloo when they share one.  On the card
the checks run with TF32 off, in the f32 that JAX's rule (5e-5) is for:
TF32 rounds each convolution's inputs to 10 mantissa bits, and the one
process (batch n) and the ranks (batch 1 each) sum the weight gradients in
another order and may take other cuDNN algorithms for their shapes, so
with TF32 on the parity holds only to TF32's rounding (2.2e-3 on an H100).
Training keeps cuDNN's default TF32; ``step_parity`` in f64 is what holds
the data-parallel step itself to one process.

``step_parity`` holds the still-image step of n ranks to one process on
the global batch in f64 with BatchNorm perturbed, where two exact runs
agree to rounding (``chip_smoke.py`` phase 18 (b)).
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch

B_H, B_W, SRC_H, SRC_W = 64, 128, 48, 96
NUM_ANCHORS = 6
MEANS, STDS = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
KERNELS = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
           "group_leaders")
PARAM_ATOL = 5e-5                     # JAX's dryrun rule, f32
PARITY_STEPS = 2                      # batch_skip 2: one update


def _setup(n):
    """The dryrun's numpy inputs for a global batch of n (seed 0)."""
    from ..anchors import locate_anchors

    rs = np.random.default_rng(0)
    templates = np.abs(rs.normal(size=(NUM_ANCHORS, 4))).astype(np.float32)
    templates[:, 2:] += templates[:, :2] + 16.0
    priors = np.concatenate(
        [templates,
         np.abs(rs.normal(size=(NUM_ANCHORS, 7))).astype(np.float32) + 1.0],
        axis=1)
    rois = np.asarray(locate_anchors(priors, (B_H // 16, B_W // 16), 16))
    g, i = 4, 2
    gts_2d = np.zeros((n, g, 4), np.float32)
    gts_3d = np.zeros((n, g, 16), np.float32)
    gt_valid = np.zeros((n, g), bool)
    for bi in range(n):
        for gi in range(2):
            x1, y1 = rs.uniform(0, 80), rs.uniform(0, 30)
            bw, bh = rs.uniform(15, 40), rs.uniform(15, 30)
            gts_2d[bi, gi] = [x1, y1, x1 + bw, y1 + bh]
            gts_3d[bi, gi] = [x1 + bw / 2, y1 + bh / 2, 30.0, 1.6, 1.5, 3.9,
                              0.2, 1.0, 1.5, 30.0, 0.3, 0.1, 0.2, -0.9, 0, 0]
            gt_valid[bi, gi] = True
    p2 = np.tile(np.eye(4, dtype=np.float32)[None], (n, 1, 1))
    p2[:, 0, 0] = 700.0
    p2[:, 1, 1] = 700.0
    batch = {
        "images_u8": rs.integers(0, 255, (n, SRC_H, SRC_W, 3)).astype(
            np.uint8),
        "mirror": (np.arange(n) % 2).astype(bool),
        "gts_2d": gts_2d, "gts_3d": gts_3d,
        "gt_labels": np.ones((n, g), np.float32), "gt_valid": gt_valid,
        "ign_2d": np.zeros((n, i, 4), np.float32),
        "ign_valid": np.zeros((n, i), bool),
        "p2": p2, "scale": np.ones((n,), np.float32),
    }
    eval_images = rs.normal(size=(n, SRC_H, SRC_W, 3))
    eval_u8 = np.clip(eval_images * 60 + 128, 0, 255).astype(np.uint8)
    return dict(priors=priors, rois=rois, batch=batch, eval_u8=eval_u8)


def _tensors(batch, rows, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
            for k, v in batch.items()}


def perturb_batchnorm(model, seed):
    """Seeded weights (``init_weights``) with every ``FlaxBatchNorm2d``'s
    affine terms and running statistics drawn away from the identity, so
    no batch statistic sits at a symmetric point."""
    from ..models.densenet import FlaxBatchNorm2d
    from ..utils.weights import init_weights

    init_weights(model, torch.Generator().manual_seed(seed))
    rs = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FlaxBatchNorm2d):
                c = m.num_features
                for t, draw in ((m.weight, rs.uniform(0.5, 1.5, c)),
                                (m.bias, rs.normal(0, 0.2, c)),
                                (m.running_mean, rs.normal(0, 0.2, c)),
                                (m.running_var, rs.uniform(0.5, 1.5, c))):
                    t.copy_(torch.from_numpy(draw.astype(np.float32)))
    return model


def _still(setup, device, dist=None, dtype=torch.float32, perturb=None,
           distort_prob=0.5):
    """(state, fused step) of the still-image check on ``device`` with
    parameters in ``dtype``; ``perturb``, a seed, perturbs BatchNorm
    (``perturb_batchnorm``)."""
    from ..losses.rpn_3d import LossConfig, UncertaintyState
    from ..models.densenet import tiny_densenet_config
    from ..models.rpn_3d import RPN3D, RPNConfig
    from ..training.schedules import build_lr_schedule
    from ..training.trainer import (TrainState, build_optimizer,
                                    fuse_preprocess, make_train_step)
    from ..utils.weights import init_weights
    from .dist import Dist, wrap_model

    dist = dist or Dist(device=torch.device(device))
    model = RPN3D(RPNConfig(num_classes=4, num_anchors=NUM_ANCHORS,
                            prop_features=64, predict_acceptance_prob=True,
                            backbone=tiny_densenet_config()))
    if perturb is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        perturb_batchnorm(model, perturb)
    model = model.to(device, dtype)
    lcfg = LossConfig(use_nms_in_loss=True, predict_acceptance_prob=True,
                      use_acceptance_prob_in_regression_loss=True,
                      bbox_un_dynamic=True, max_nms_boxes=32,
                      max_ap_boxes=64)
    opt = build_optimizer(list(model.parameters()), "sgd",
                          build_lr_schedule(0.004, 100), batch_skip=2)
    rois = setup["rois"]
    rois_3d = setup["priors"][rois[:, 4].astype(np.int64), 4:]
    dev = lambda x, dt=dtype: torch.as_tensor(np.asarray(x), dtype=dt,
                                              device=device)
    step = make_train_step(lcfg, dev(rois), dev(rois_3d), dev(np.zeros(13)),
                           dev(np.ones(13)), dist=dist)
    f32 = torch.float32
    fused = fuse_preprocess(step, dev(MEANS, f32), dev(STDS, f32),
                            target_h=B_H, crop_w=B_W,
                            distort_prob=distort_prob, rng_seed=0,
                            out_dtype=None if dtype == f32 else dtype,
                            dist=dist)
    state = TrainState(model, opt, UncertaintyState.init(device))
    state.ddp = wrap_model(model, dist) if dist.group is not None else None
    return state, fused


def _video_step(setup, dist):
    """Two video steps (2-frame clips, ``has_vel``) on this rank's rows;
    returns their global losses."""
    from ..losses.rpn_3d import LossConfig, UncertaintyState
    from ..models.densenet import tiny_densenet_config
    from ..models.rpn_3d import RPNConfig
    from ..models.video import VideoConfig, VideoRPN3D
    from ..training.schedules import build_lr_schedule
    from ..training.trainer import (TrainState, build_optimizer,
                                    fuse_preprocess, make_video_train_step,
                                    unused_parameters)
    from ..utils.weights import init_weights
    from .dist import local_rows, wrap_model

    device = dist.device
    rpn = RPNConfig(num_classes=4, num_anchors=NUM_ANCHORS, prop_features=64,
                    predict_velocity=True, predict_uncertainty=True,
                    backbone=tiny_densenet_config())
    model = VideoRPN3D(VideoConfig(rpn=rpn))
    init_weights(model, torch.Generator().manual_seed(1))
    model = model.to(device)
    lcfg = LossConfig(has_vel=True, has_un=True, bbox_un_dynamic=True,
                      max_nms_boxes=32, max_ap_boxes=64)
    priors = np.concatenate([setup["priors"], np.full((NUM_ANCHORS, 1), 0.5,
                                                      np.float32)], axis=1)
    rois = setup["rois"]
    rois_3d = priors[rois[:, 4].astype(np.int64), 4:]
    dev = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    step = make_video_train_step(lcfg, dev(rois), dev(rois_3d),
                                 dev(np.zeros(14)), dev(np.ones(14)),
                                 dist=dist)
    fused = fuse_preprocess(step, dev(MEANS), dev(STDS), target_h=B_H,
                            crop_w=B_W, video=True, dist=dist)
    n = setup["batch"]["images_u8"].shape[0]
    opt = build_optimizer(list(model.parameters()), "sgd",
                          build_lr_schedule(0.004, 100))
    state = TrainState(model, opt, UncertaintyState.init(device))
    state.ddp = wrap_model(model, dist, ignore=unused_parameters(model, lcfg))
    batch = dict(setup["batch"])
    batch["images_u8"] = np.repeat(batch["images_u8"], 2, axis=0).reshape(
        n, 2, SRC_H, SRC_W, 3)
    vel = np.where(batch["gt_valid"][..., None], 0.5, -np.inf)
    batch["gts_3d"] = np.concatenate([batch["gts_3d"], vel.astype(
        np.float32)], axis=2)
    batch = _tensors(batch, local_rows(n, dist.rank, dist.world), device)
    return [float(fused(state, batch)["total"]) for _ in range(2)]


def _sharded_eval(setup, state, dist, out_dir):
    """This rank's rows through ``make_infer``, one txt file a frame into
    ``out_dir``; returns (rows written, the K1/K2 launches)."""
    from ..eval.tester import make_infer
    from ..inference import DetectConfig, write_kitti_detections
    from ..ops import kernels
    from .dist import barrier, local_rows

    device = dist.device
    n = setup["eval_u8"].shape[0]
    rows = local_rows(n, dist.rank, dist.world)
    infer = make_infer(state.model, DetectConfig(nms_topN_pre=64,
                                                 nms_topN_post=8),
                       B_H, B_W)
    rois = setup["rois"]
    rois_3d = setup["priors"][rois[:, 4].astype(np.int64), 4:]
    p2 = setup["batch"]["p2"][rows]
    dev = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    before = {k: getattr(kernels, k).launches for k in KERNELS[:2]}
    dets, valid = infer(
        torch.from_numpy(setup["eval_u8"][rows]).to(device), dev(MEANS),
        dev(STDS), dev(rois), dev(rois_3d), dev(p2), dev(np.linalg.inv(p2)),
        dev(np.full(len(p2), B_H / SRC_H)), dev(np.zeros(13)),
        dev(np.ones(13)))
    launches = {k: getattr(kernels, k).launches - before[k]
                for k in KERNELS[:2]}
    dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
    if not np.isfinite(dets[valid]).all():
        raise AssertionError("non-finite detections")
    for bi, gi in enumerate(range(rows.start, rows.stop)):
        write_kitti_detections(os.path.join(out_dir, f"{gi:06d}.txt"),
                               dets[bi], valid[bi],
                               ["Car", "Pedestrian", "Cyclist"],
                               score_thres=0.0)
    barrier(dist)
    return int(valid.sum()), launches


@contextlib.contextmanager
def tf32_off():
    """TF32 off for matmuls and convolutions inside the block, the flags
    restored after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _rank(dist, setup, out_dir):
    """One rank of the dryrun: the checks' numbers on this rank."""
    from ..ops import kernels
    from .dist import local_rows

    n = setup["batch"]["images_u8"].shape[0]
    with tf32_off():
        state, fused = _still(setup, dist.device, dist)
        before = {k: getattr(kernels, k).launches for k in KERNELS}
        batch = _tensors(setup["batch"],
                         local_rows(n, dist.rank, dist.world), dist.device)
        losses = [float(fused(state, batch)["total"]) for _ in range(2)]
        train_launches = {k: getattr(kernels, k).launches - before[k]
                          for k in KERNELS}
        params = {k: v.detach().cpu()
                  for k, v in state.model.state_dict().items()}
        video_loss = _video_step(setup, dist)
        n_rows, eval_launches = _sharded_eval(setup, state, dist, out_dir)
    return dict(losses=losses, params=params, video_loss=video_loss,
                eval_rows=n_rows, train_launches=train_launches,
                eval_launches=eval_launches)


def _steps(state, fused, batch):
    """PARITY_STEPS steps; (the state_dict on the CPU, each step's
    stats)."""
    stats = [{k: float(v) for k, v in fused(state, batch).items()}
             for _ in range(PARITY_STEPS)]
    return ({k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}, stats)


def _parity_rank(dist, setup, dtype):
    from .dist import local_rows

    n = setup["batch"]["images_u8"].shape[0]
    state, fused = _still(setup, dist.device, dist, getattr(torch, dtype),
                          perturb=2, distort_prob=0.0)
    return _steps(state, fused, _tensors(
        setup["batch"], local_rows(n, dist.rank, dist.world), dist.device))


def one_process_step(n, device, dtype=torch.float64):
    """The still-image step of ``step_parity`` in this process on the
    global batch of n: (state_dict on the CPU, each step's stats)."""
    setup = _setup(n)
    state, fused = _still(setup, device, None, dtype, perturb=2,
                          distort_prob=0.0)
    return _steps(state, fused, _tensors(setup["batch"], slice(None),
                                         device))


def step_parity(n, device="cpu", dtype=torch.float64):
    """The still-image step (the dryrun's GrooMeD loss and fused
    preprocess without the jitter, BatchNorm perturbed; ``batch_skip`` 2,
    so two steps make one update) on n ranks against one process on the
    global batch of n, in ``dtype``.  Returns (max over tensors of max
    |ranks - one| / max |one|, that tensor's name, whether every rank holds
    the same parameters and running statistics, the one process's
    state_dict, the ranks' stats, the one process's stats)."""
    from .dist import spawn

    device = torch.device(device)
    setup = _setup(n)
    ranks = spawn(_parity_rank, n, setup, str(dtype).split(".")[-1],
                  backend=_backend(n, device), device=device.type)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as each rank: one reduction order
    try:
        one, one_stats = one_process_step(n, device, dtype)
    finally:
        torch.set_num_threads(threads)
    got = ranks[0][0]
    worst, key = 0.0, None
    for k, v in one.items():
        if v.is_floating_point() and v.abs().max() > 0:
            e = float((got[k] - v).abs().max() / v.abs().max())
            if e > worst:
                worst, key = e, k
    same = all(torch.equal(r[0][k], got[k]) for r in ranks[1:] for k in got)
    return worst, key, same, one, [r[1] for r in ranks], one_stats


def _backend(n, device):
    """nccl when each of n ranks has a card, else gloo."""
    return "nccl" if device.type == "cuda" and \
        torch.cuda.device_count() >= n else "gloo"


def dryrun_multichip(n, device="cpu"):
    """Run the four checks (module docstring) on n ranks of ``device``,
    print their "OK" lines and return the numbers: losses, the 1-vs-n
    parameter delta, the ranks' results.  Any failed check raises."""
    from .dist import spawn

    device = torch.device(device)
    backend = _backend(n, device)
    setup = _setup(n)
    with tempfile.TemporaryDirectory(prefix="dryrun_eval_") as out_dir:
        ranks = spawn(_rank, n, setup, out_dir, backend=backend,
                      device=device.type)
        n_txt = len([f for f in os.listdir(out_dir) if f.endswith(".txt")])
    loss = ranks[0]["losses"][0]
    if not all(np.isfinite(r["losses"]).all() for r in ranks):
        raise AssertionError(f"non-finite loss {[r['losses'] for r in ranks]}")
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError("the ranks report different losses")
    print(f"dryrun_multichip({n}) OK: still-image loss={loss:.4f}",
          flush=True)

    with tf32_off():
        state, fused = _still(setup, device)
        batch = _tensors(setup["batch"], slice(None), device)
        losses1 = [float(fused(state, batch)["total"]) for _ in range(2)]
    ref = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    worst = max(float((ranks[0]["params"][k] - v).abs().max())
                for k, v in ref.items() if v.is_floating_point())
    if abs(losses1[0] - loss) >= 2e-4 * max(1.0, abs(loss)):
        raise AssertionError(f"loss divergence 1-process {losses1[0]} vs "
                             f"{n} ranks {loss}")
    if worst >= PARAM_ATOL:
        raise AssertionError(f"param divergence {worst}")
    for r in ranks[1:]:
        if any(not torch.equal(r["params"][k], v)
               for k, v in ranks[0]["params"].items()):
            raise AssertionError("the ranks' parameters differ")
    print(f"dryrun_multichip({n}) OK: 1-vs-{n} grad parity, max param "
          f"delta={worst:.2e}", flush=True)

    v_loss = ranks[0]["video_loss"][0]
    if not np.isfinite(ranks[0]["video_loss"]).all():
        raise AssertionError(f"non-finite video loss {v_loss}")
    print(f"dryrun_multichip({n}) OK: video loss={v_loss:.4f}", flush=True)

    if n_txt != n:
        raise AssertionError(f"expected {n} detection files, found {n_txt}")
    n_det = sum(r["eval_rows"] for r in ranks)
    print(f"dryrun_multichip({n}) OK: sharded eval wrote {n_txt} txts, "
          f"{n_det} detections", flush=True)
    return dict(loss=loss, loss_1=losses1[0], max_param_delta=worst,
                video_loss=v_loss, n_txt=n_txt, backend=backend, ranks=ranks)
