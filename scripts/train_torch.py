"""Train a 3D RPN on KITTI with the PyTorch port.

Usage:
  python scripts/train_torch.py --config groomed_nms [--restore N] \
      [--data-root data] [--output output] [--max-iter N] [--fresh] \
      [--set KEY=VALUE ...] [--cache-images] [--device cuda]
  python -m torch.distributed.run --nproc_per_node 4 \
      scripts/train_torch.py --config groomed_nms [--dist-backend nccl] ...

The port's twin of ``scripts/train.py``, for the still-image models
(``rpn_3d``, and ``rpn_3d_un``, whose ``RPN3D`` predicts the uncertainty
channel) and the video stage (``kalman``, ``VideoRPN3D``; see below):
build the training imdb, learn the
anchor priors and bbox statistics (``prepare_anchors``, cached as
``anchors.npz``; a ``copy_stats`` config reuses its pretrained run's), build
the model, the optimizer and the freezing, then start from ``--restore N``,
else from this run's own latest checkpoint (auto-resume, unless
``--fresh``), else from ``cfg.pretrained``'s latest checkpoint (a warm start
across configs, at step 0).  The loop: ``TrainLoader`` (weighted, one image
size a batch, a prefetch thread) -> ``device_prefetch`` (pinned copies on a
side stream) -> ``fuse_preprocess`` -> the train step; a ``StatTracker``
line and a ``metrics.csv`` row every ``display`` steps (with ``host_wait``,
the time the loop waited for a batch); a checkpoint every
``snapshot_iter`` steps and at ``max_iter``, each followed, when
``do_test``, by ``test_kitti_3d`` on the validation split into
``results/results_<iter>/`` and the C++ evaluator.  ``conf.json``,
``train.log`` and ``metrics.csv`` go to ``<output>/<name>/``.

The video stage (``kitti_3d_full``): the tracking imdb with per-object
velocities, each record seen through ``ClipRecordView``; anchors and
statistics with the velocity column (the ``_un`` run's lack it, so
``copy_stats`` falls back to learning them); ``VideoRPN3D`` frozen by flax
path (``freeze_whitelist=("backbone",)`` freezes ``rpn/backbone/...``);
the warm start fills ``rpn`` from the ``_un`` checkpoint of
``cfg.pretrained``, its head widened by a zero velocity channel, and
``pose_net`` from ``<output>/<name>_pose/pose_net_params.npz``
(``scripts/train_pose_torch.py``), else from ``cfg.pretrained``'s; then
``VideoTrainLoader`` -> ``device_prefetch`` -> the video step, whose loss
reads each clip's current frame.  Its snapshot evaluation is skipped:
``scripts/test_kalman_torch.py`` evaluates the video model.

Data parallelism (the twin of ``scripts/train.py``'s mesh): under torchrun
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) each process is a rank on
``cuda:<LOCAL_RANK>`` (``--dist-backend nccl``, the default on cards) or on
the CPU or a shared card (``gloo``); ``cfg.batch_size`` is the global batch
and must divide by the world.  The loader gives each rank its rows of the
global batch (the same draws on every rank); the still-image and video
steps run under ``DistributedDataParallel`` with the global batch's
BatchNorm statistics and loss (``parallel``, ``trainer``), so the ranks
train as one process on the global batch.  Rank 0 writes ``conf.json``,
``train.log``, ``metrics.csv``, the imdb cache, ``anchors.npz`` and the
checkpoints while the others wait; every rank reads a restore or a warm
start; the snapshot evaluation is sharded over the ranks and rank 0 runs
the evaluator.  The summary carries ``world``, ``rank`` and every rank's
``peak_bytes``.

It runs on the CUDA card unless ``--device cpu`` is given, and raises when
CUDA is absent.  ``main(argv)`` returns a summary dict (steps, times, the
restore report, the kernels' launches in training and in evaluation) for
callers that drive it in-process; its ``peak_bytes`` is the device memory
peak after the first step, whose cuDNN autotuning takes what is free.
"""

import argparse
import dataclasses
import logging
import os
import sys
import time
from types import SimpleNamespace

# run as a file, this directory comes first on sys.path, and
# scripts/profile.py would shadow the standard library's profile (torch
# imports it when a custom op first runs): the repository root replaces it
_HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.abspath(sys.path[0]) == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(_HERE))

KERNELS = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
           "group_leaders")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--output", default="output")
    ap.add_argument("--restore", type=int, default=None,
                    help="start from this checkpoint step of the run")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore the run's own checkpoints (no auto-resume; "
                         "cfg.pretrained's warm start still applies)")
    ap.add_argument("--max-iter", type=int, default=None,
                    help="override the config's max_iter")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override any ExperimentConfig field (repeatable); "
                         "values are parsed as Python literals")
    ap.add_argument("--cache-images", action="store_true",
                    help="mmap-cache decoded images in the split's "
                         ".decoded_cache (H*W*3 bytes of disk a frame)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="under torchrun: nccl (the default on cards, one "
                         "card a rank) or gloo (the CPU; ranks sharing a "
                         "card)")
    return ap.parse_args(argv)


def build_training(cfg, anchors, means, stds, device, param_dtype=None,
                   dist=None):
    """The model (seeded with ``cfg.rng_seed``), the freezing, the
    optimizer over the trainable parameters and the fused step, on
    ``device``.  Returns a namespace: model, optimizer, schedule, state
    (``TrainState``), step (``fused(state, raw)``), rois, rois_3d,
    n_frozen, train_bn, frozen_stats.

    ``dist``, a ``parallel.Dist`` with a process group: the step takes
    this rank's rows of the global batch and ``state.ddp`` is the model
    under ``DistributedDataParallel`` (``parallel.wrap_model``).

    ``param_dtype`` torch.float64 runs the model, the loss's inputs and the
    optimizer in f64 (the frames are preprocessed in f32 and cast): an
    exact reference for comparisons across devices or packages, where an
    f32 step's rounding can flip a ReLU at zero.  The snapshot evaluation
    takes f32 models only."""
    import numpy as np
    import torch

    from groomed_nms_torch.anchors import locate_anchors
    from groomed_nms_torch.losses.rpn_3d import UncertaintyState
    from groomed_nms_torch.models.rpn_3d import RPN3D
    from groomed_nms_torch.models.video import VideoConfig, VideoRPN3D
    from groomed_nms_torch.parallel import wrap_model
    from groomed_nms_torch.training.freeze import (all_stats_frozen,
                                                   apply_freeze,
                                                   build_freeze_labels,
                                                   frozen_stats_mask)
    from groomed_nms_torch.training.schedules import build_lr_schedule
    from groomed_nms_torch.training.trainer import (TrainState,
                                                    build_optimizer,
                                                    fuse_preprocess,
                                                    make_train_step,
                                                    make_video_train_step,
                                                    unused_parameters)
    from groomed_nms_torch.utils.weights import init_weights

    device = torch.device(device)
    param_dtype = param_dtype or torch.float32
    video = cfg.model == "kalman"
    rpn_cfg = cfg.rpn_config(anchors.shape[0])
    model = VideoRPN3D(VideoConfig(rpn=rpn_cfg)) if video else RPN3D(rpn_cfg)
    init_weights(model, torch.Generator().manual_seed(cfg.rng_seed))
    model = model.to(device, dtype=param_dtype,
                     memory_format=torch.channels_last)

    trainable, train_bn, frozen_stats, n_frozen = \
        list(model.parameters()), True, (), 0
    if cfg.freeze_blacklist or cfg.freeze_whitelist or cfg.freeze_bn:
        knobs = (cfg.freeze_blacklist, cfg.freeze_whitelist, cfg.freeze_bn)
        labels = build_freeze_labels(model, *knobs)
        trainable = apply_freeze(model, labels)
        n_frozen = len(labels) - len(trainable)
        mask = frozen_stats_mask(model, *knobs)
        # every BatchNorm frozen: eval mode, the reference's module.eval()
        train_bn = not all_stats_frozen(mask)
        frozen_stats = tuple(k for k, v in mask.items() if v)

    schedule = build_lr_schedule(cfg.lr, cfg.max_iter, cfg.lr_policy,
                                 cfg.lr * cfg.lr_target_factor, cfg.lr_steps,
                                 warmup_iters=cfg.warmup_iters)
    optimizer = build_optimizer(trainable, cfg.solver_type, schedule,
                                momentum=cfg.momentum,
                                weight_decay=cfg.weight_decay,
                                clip_value=cfg.grad_clip_value,
                                batch_skip=cfg.batch_skip)
    feat_hw = (cfg.crop_size[0] // cfg.feat_stride,
               cfg.crop_size[1] // cfg.feat_stride)
    rois = locate_anchors(anchors, feat_hw, cfg.feat_stride)
    rois_3d = anchors[rois[:, 4].astype(np.int64), 4:]

    def dev(x, dtype=param_dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else None
    make_step = make_video_train_step if video else make_train_step
    step = make_step(cfg.loss_config(), dev(rois), dev(rois_3d), dev(means),
                     dev(stds), compute_dtype, train_bn=train_bn,
                     frozen_stats=frozen_stats, dist=dist)
    fused = fuse_preprocess(step, dev(cfg.image_means, torch.float32),
                            dev(cfg.image_stds, torch.float32),
                            target_h=cfg.crop_size[0],
                            crop_w=cfg.crop_size[1],
                            distort_prob=cfg.distort_prob,
                            rng_seed=cfg.rng_seed,
                            out_dtype=None if param_dtype == torch.float32
                            else param_dtype, video=video, dist=dist)
    state = TrainState(model, optimizer, UncertaintyState.init(device))
    if dist is not None and dist.group is not None:
        state.ddp = wrap_model(model, dist, ignore=unused_parameters(
            model, cfg.loss_config()))
    return SimpleNamespace(model=model, optimizer=optimizer,
                           schedule=schedule, state=state, step=fused,
                           rois=rois, rois_3d=rois_3d, n_frozen=n_frozen,
                           train_bn=train_bn, frozen_stats=frozen_stats)


def host_tensors(loader, pin):
    """The loader's batches as ``(None, (images_u8, mirror, *GTBatch))`` CPU
    tensors, pinned when ``pin`` (``device_prefetch``'s input)."""
    import torch

    for hb in loader:
        arrays = (hb["images_u8"], hb["mirror"], *hb["gt"])
        ts = tuple(torch.from_numpy(a) for a in arrays)
        yield None, tuple(t.pin_memory() for t in ts) if pin else ts


def raw_batch(tensors):
    """``host_tensors``' tuple (on the device) -> the fused step's dict."""
    from groomed_nms_torch.losses.rpn_3d import GTBatch

    images_u8, mirror, *gt = tensors
    return {"images_u8": images_u8, "mirror": mirror,
            **dict(zip(GTBatch._fields, gt))}


def warm_start_video(model, cfg, out_dir, log):
    """Fill a ``VideoRPN3D`` from the single-frame (``_un``) run of
    ``cfg.pretrained`` (its head widened by a zero velocity channel) and
    its pose branch from the first ``pose_net_params.npz`` of
    ``<out_dir>_pose/`` and ``cfg.pretrained``, warning when there is none.
    Returns ``load_weights``' report with "step", "widened" (the tensors
    with a fresh velocity channel) and "pose" (the npz read, or None)."""
    from groomed_nms_torch.utils.video_weights import (load_pose_npz,
                                                       single_frame_state_dict)

    rpn_cfg = model.config.rpn
    sd, step, report = single_frame_state_dict(rpn_cfg, cfg.pretrained)
    model.rpn.load_state_dict(sd)
    candidates = [os.path.join(out_dir + "_pose", "pose_net_params.npz"),
                  os.path.join(cfg.pretrained, "pose_net_params.npz")]
    pose = next((p for p in candidates if os.path.exists(p)), None)
    if pose is None:
        log.warning("no trained pose branch found (looked in %s); pose_net "
                    "starts from random init", candidates)
    else:
        load_pose_npz(model.pose_net, pose)
    widened = ["rpn.head.weight", "rpn.head.bias"] \
        if rpn_cfg.predict_velocity else []
    log.info("warm-started from %s (iter %d; %d tensors fresh, %d of another "
             "shape, %d dropped; fresh: the velocity channel of %s); "
             "pose_net from %s", cfg.pretrained, step, len(report["fresh"]),
             len(report["mismatched"]), len(report["dropped"]), widened,
             pose)
    return dict(report, step=step, widened=widened, pose=pose)


def _launches():
    from groomed_nms_torch.ops import kernels
    return {n: getattr(kernels, n).launches for n in KERNELS}


def main(argv=None):
    args = parse_args(argv)

    import torch

    from groomed_nms_torch.parallel import close_distributed, init_distributed

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    ctx = init_distributed(args.dist_backend, args.device)
    try:
        return _train(args, ctx)
    finally:
        close_distributed(ctx)


def _train(args, ctx):
    """``main`` on this rank (``ctx``, a ``parallel.Dist``)."""
    import torch
    import torch.distributed

    from groomed_nms_torch.config import apply_overrides, load_config
    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.data.pipeline import (ClipRecordView,
                                                 TrainLoader,
                                                 VideoTrainLoader,
                                                 device_prefetch,
                                                 prepare_anchors,
                                                 resolve_stats_dir)
    from groomed_nms_torch.data.tracking import build_tracking_imdb
    from groomed_nms_torch.eval.tester import test_kitti_3d
    from groomed_nms_torch.parallel import barrier
    from groomed_nms_torch.training.checkpoint import (latest_checkpoint,
                                                       restore_train_state,
                                                       save_checkpoint)
    from groomed_nms_torch.training.stats import MetricsCSV, StatTracker

    device = ctx.device
    cuda = device.type == "cuda"
    lead = ctx.rank == 0

    def rank0_first(fn):
        """fn() on rank 0, then on the others once it is done (what rank 0
        writes to disk, the others read)."""
        if lead:
            out = fn()
        barrier(ctx)
        return out if lead else fn()

    cfg = apply_overrides(load_config(args.config), args.overrides)
    if args.max_iter:
        cfg = dataclasses.replace(cfg, max_iter=args.max_iter)
    is_video = cfg.model == "kalman"

    out_dir = os.path.join(args.output, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    # rank 0 logs (and writes train.log); the others say only what goes wrong
    logging.basicConfig(
        force=True, level=logging.INFO if lead else logging.WARNING,
        format="%(asctime)s %(message)s" if ctx.group is None
        else f"%(asctime)s [rank {ctx.rank}] %(message)s",
        handlers=[logging.StreamHandler()] + (
            [logging.FileHandler(os.path.join(out_dir, "train.log"))]
            if lead else []))
    log = logging.getLogger("train_torch")
    log.info("torch %s on %s%s", torch.__version__,
             torch.cuda.get_device_name(device) if cuda else "cpu",
             f", {ctx.world} ranks ({ctx.backend})" if ctx.group is not None
             else "")
    if lead:
        cfg.dump(os.path.join(out_dir, "conf.json"))

    root = os.path.join(args.data_root, cfg.dataset_train)
    if is_video:
        imdb = [ClipRecordView(r) for r in rank0_first(
            lambda: build_tracking_imdb(
                root, "training", use_3d_for_2d=cfg.use_3d_for_2d,
                cache_file=os.path.join(out_dir, "imdb.pkl"),
                im_ext=cfg.im_ext))]
    else:
        imdb = rank0_first(lambda: build_imdb(
            root, "training", use_3d_for_2d=cfg.use_3d_for_2d,
            cache_file=os.path.join(out_dir, "imdb.pkl"), im_ext=cfg.im_ext))
    log.info("imdb: %d images", len(imdb))

    stats_dir = resolve_stats_dir(cfg, out_dir)
    if stats_dir != out_dir:
        log.info("copy_stats: reusing anchors/statistics from %s", stats_dir)
    t0 = time.perf_counter()
    anchors, means, stds = rank0_first(lambda: prepare_anchors(
        cfg, imdb, cache_dir=stats_dir, device=device))
    anchors_s = time.perf_counter() - t0
    log.info("anchors: %s, means/stds ready in %.2f s", anchors.shape,
             anchors_s)

    run = build_training(cfg, anchors, means, stds, device, dist=ctx)
    state = run.state
    if run.n_frozen:
        log.info("freezing %d/%d param tensors", run.n_frozen,
                 len(list(run.model.parameters())))

    report = None
    if args.restore is not None:
        report = restore_train_state(out_dir, state, args.restore)
        log.info("restored iter %d", state.step)
    elif not args.fresh and latest_checkpoint(out_dir) is not None:
        report = restore_train_state(out_dir, state)
        log.info("auto-resumed own checkpoint at iter %d", state.step)
        if state.step >= cfg.max_iter:
            log.info("checkpoint already at max_iter=%d -- nothing to "
                     "train (pass --fresh to restart from scratch, "
                     "--max-iter to extend, or scripts/evaluate_torch.py "
                     "to evaluate)", cfg.max_iter)
    elif cfg.pretrained and latest_checkpoint(cfg.pretrained) is not None:
        if is_video:
            report = warm_start_video(run.model, cfg, out_dir, log)
        else:
            report = restore_train_state(cfg.pretrained, state,
                                         restore_optimizer=False)
            log.info("warm-started from %s (%d tensors fresh, %d of another "
                     "shape, %d dropped)", cfg.pretrained,
                     len(report["fresh"]), len(report["mismatched"]),
                     len(report["dropped"]))
        state.step = 0
    if cuda:
        torch.backends.cudnn.benchmark = True    # one input shape a size

    val_imdb = None
    val_root = os.path.join(args.data_root, cfg.dataset_test)

    def snapshot_eval(iteration):
        nonlocal val_imdb
        if is_video:
            log.info("snapshot eval skipped for the video model; use "
                     "scripts/test_kalman_torch.py")
            return None
        if val_imdb is None:
            val_imdb = build_imdb(val_root, "validation",
                                  use_3d_for_2d=cfg.use_3d_for_2d,
                                  cache_file=None, im_ext=cfg.im_ext)
            log.info("val imdb: %d images", len(val_imdb))
        results_dir = os.path.join(out_dir, "results",
                                   f"results_{iteration}")
        result = test_kitti_3d(
            cfg, run.model, run.rois, run.rois_3d, means, stds, val_imdb,
            results_dir, gt_dir=os.path.join(val_root, "validation",
                                             "label_2"),
            log_fn=log.info,
            raw_cache_dir=os.path.join(val_root, "validation",
                                       ".decoded_cache")
            if args.cache_images else None, dist=ctx)
        run.model.train(run.train_bn)
        return result

    start = state.step
    summary = dict(out_dir=out_dir, start_step=start, anchors_s=anchors_s,
                   restore=report, steps=0, train_s=0.0, host_wait_s=0.0,
                   step_end_s=[], eval_results={}, eval_s=0.0,
                   launches={"train": dict.fromkeys(KERNELS, 0),
                             "eval": dict.fromkeys(KERNELS, 0)},
                   batch_size=cfg.batch_size, peak_bytes=None,
                   world=ctx.world, rank=ctx.rank)
    if start >= cfg.max_iter:
        log.info("training done at iter %d", state.step)
        summary["step"] = state.step
        return summary

    cache_dir = os.path.join(root, "training", ".decoded_cache") \
        if args.cache_images else None
    loader = (VideoTrainLoader if is_video else TrainLoader)(
        imdb, cfg, seed=cfg.rng_seed, raw_cache_dir=cache_dir,
        rank=ctx.rank, world=ctx.world)
    tracker = StatTracker(cfg.max_iter, cfg.display, start_iter=start)
    metrics_csv = MetricsCSV(os.path.join(out_dir, "metrics.csv")) \
        if lead else None
    batches = device_prefetch(host_tensors(loader, pin=cuda), device)

    t_loop = time.perf_counter()
    outside = 0.0                  # checkpoint and evaluation time
    try:
        for it in range(start, cfg.max_iter):
            # host_wait: the time the loop waited for a batch (~0 when the
            # loader and the copies keep up)
            t0 = time.perf_counter()
            _, dev_tensors = next(batches)
            host_wait = time.perf_counter() - t0
            summary["host_wait_s"] += host_wait
            before = _launches()
            stats = run.step(state, raw_batch(dev_tensors))
            after = _launches()
            for n in KERNELS:
                summary["launches"]["train"][n] += after[n] - before[n]
            tracker.update(dict(stats, host_wait=host_wait))
            summary["steps"] += 1
            if cuda and summary["steps"] == 1:
                # the first step's cuDNN autotuning takes what is free
                torch.cuda.reset_peak_memory_stats(device)
            summary["step_end_s"].append(time.perf_counter() - t_loop
                                         - outside)

            if (it + 1) % cfg.display == 0:
                line, window = tracker.log_line_and_means(
                    it + 1, lr=run.schedule(it))
                log.info(line)
                if lead:
                    metrics_csv.append(it + 1, window)
                tracker.reset()
            if (it + 1) == cfg.max_iter:
                # stop the workers: the final evaluation gets the host
                batches.close()
                loader.close()
            if (it + 1) % cfg.snapshot_iter == 0 or (it + 1) == cfg.max_iter:
                if cuda:
                    torch.cuda.synchronize(device)
                t_out = time.perf_counter()
                summary["train_s"] = t_out - t_loop - outside
                path = save_checkpoint(out_dir, run.model, run.optimizer,
                                       state.step, un_state=state.un_state,
                                       dist=ctx)
                log.info("checkpoint -> %s", path)
                if cfg.do_test:
                    before = _launches()
                    t_eval = time.perf_counter()
                    summary["eval_results"][it + 1] = snapshot_eval(it + 1)
                    summary["eval_s"] += time.perf_counter() - t_eval
                    after = _launches()
                    for n in KERNELS:
                        summary["launches"]["eval"][n] += after[n] - before[n]
                outside += time.perf_counter() - t_out
    finally:
        batches.close()
        loader.close()
    if cuda:
        summary["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if ctx.group is not None:
        peaks = [None] * ctx.world
        torch.distributed.all_gather_object(peaks, summary["peak_bytes"],
                                            group=ctx.group)
        summary["peak_bytes_by_rank"] = peaks
    log.info("training done at iter %d", state.step)
    summary["step"] = state.step
    return summary


if __name__ == "__main__":
    main()
