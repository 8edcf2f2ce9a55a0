"""Train the video model's ego-pose branch with the PyTorch port.

Usage:
  python scripts/train_pose_torch.py --config kitti_3d_full \
      [--data-root data] [--output output] [--max-iter N] \
      [--set KEY=VALUE ...] [--cache-images] [--device cuda]

The port's twin of ``scripts/train_pose.py``: the tracking imdb's records
with a previous frame's ego pose ("10"), their pose statistics (saved as
``<output>/<name>_pose/pose_stats.npz``), the video model restored from
``<output>/<name>`` by ``load_video_variables`` (its own ``kalman``
checkpoint, else the single-frame ``cfg.pretrained`` run widened by the
velocity channel), and only ``pose_net`` trained: SGD with momentum on the
poly schedule, no weight decay, no clipping.  The model runs in eval mode,
so BatchNorm normalises by its running statistics while the pose branch
gets its gradients.  Each sample is a pair of frames (previous, current)
drawn from ``default_rng(cfg.rng_seed)`` in JAX's order; a mirrored sample
flips both frames and its target (``data/tracking.py::mirror_ego``).  The
loss is ``losses/pose.py::pose_loss`` on the denormalised pose.  At the end
``pose_net_params.npz`` is written in the JAX package's flat key layout
(``pose_feats/kernel``, ...), which ``load_pose_npz``,
``scripts/train_torch.py``'s warm start and JAX's
``assemble_video_variables`` read.

The model's anchor count comes from the detector run's ``anchors.npz``
(the run of ``<output>/<name>``, or the ``copy_stats`` run).  Where there is
none yet (this script runs before ``scripts/train_torch.py --config
kitti_3d_full``) it is learned over the tracking imdb by ``prepare_anchors``
and cached in ``<output>/<name>``, which is what ``scripts/train_torch.py``
would learn and then reads; the JAX script raises there instead.

It runs on the CUDA card unless ``--device cpu`` is given, and raises when
CUDA is absent.  ``main(argv)`` returns a summary dict (steps, times, the
per-step losses, the peak device memory after the first step, the trained
model).
"""

import argparse
import dataclasses
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--output", default="output")
    ap.add_argument("--max-iter", type=int, default=None,
                    help="override the config's max_iter")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override any ExperimentConfig field (repeatable); "
                         "values are parsed as Python literals")
    ap.add_argument("--cache-images", action="store_true",
                    help="mmap-cache decoded frames in the split's "
                         ".decoded_cache (shared with train_torch.py)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def compute_pose_stats(imdb):
    """Mean and std (floored at 1e-8) of the records' "10" ego poses; zeros
    and ones when none has one."""
    import numpy as np

    rows = [rec.egos["10"] for rec in imdb if "10" in rec.egos]
    if not rows:
        return np.zeros(6), np.ones(6)
    arr = np.asarray(rows, np.float64)
    return arr.mean(0), np.maximum(arr.std(0), 1e-8)


def pose_batches(imdb, cfg, pose_means, pose_stds, cache_dir, steps):
    """``steps`` host batches ``(frames [B, 2, H0, W0, 3] uint8 (previous,
    current), mirror [B] bool, targets [B, 6] f32)``, normalised targets,
    drawn as JAX's ``scripts/train_pose.py`` draws them."""
    import numpy as np

    from groomed_nms_torch.data.pipeline import load_image_cached
    from groomed_nms_torch.data.tracking import mirror_ego

    rs = np.random.default_rng(cfg.rng_seed)

    def frame(path):
        return load_image_cached(
            path, os.path.splitext(os.path.basename(path))[0], cache_dir)

    for _ in range(steps):
        idx = rs.integers(0, len(imdb), size=cfg.batch_size)
        clips, targets, mirrors = [], [], []
        for i in idx:
            rec = imdb[i]
            clips.append(np.stack([frame(p) for p in rec.image_paths[1::-1]]))
            mirror = rs.random() <= cfg.mirror_prob
            mirrors.append(mirror)
            ego = np.asarray(mirror_ego(rec.egos["10"]) if mirror
                             else rec.egos["10"])
            targets.append((ego - pose_means) / pose_stds)
        yield (np.stack(clips), np.asarray(mirrors, bool),
               np.stack(targets).astype(np.float32))


def build_pose_training(cfg, model, pose_means, pose_stds, device,
                        param_dtype=None):
    """The pose stage on ``device``: ``model`` (a ``VideoRPN3D`` with its
    weights) moved there in eval mode, every parameter but ``pose_net``'s
    frozen, SGD with momentum on the poly schedule over the rest (no weight
    decay, no clipping) and the fused step.  Returns a namespace: model,
    state (``TrainState``), step (``fused(state, raw)`` with raw
    ``{"images_u8", "mirror", "pose_tar"}``), n_trainable.

    ``param_dtype`` torch.float64 runs the model and the loss in f64 (the
    frames preprocessed in f32 and cast; ``PoseNet`` computes in f32, as
    flax's does): an exact reference for comparisons across devices or
    packages."""
    from types import SimpleNamespace

    import torch

    from groomed_nms_torch.losses.pose import pose_loss
    from groomed_nms_torch.training.schedules import build_lr_schedule
    from groomed_nms_torch.training.trainer import (TrainState,
                                                    build_optimizer,
                                                    fuse_preprocess)

    device = torch.device(device)
    param_dtype = param_dtype or torch.float32
    model = model.to(device, dtype=param_dtype,
                     memory_format=torch.channels_last).eval()
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith("pose_net."))
        if p.requires_grad:
            trainable.append(p)
    optimizer = build_optimizer(trainable, "sgd",
                                build_lr_schedule(cfg.lr, cfg.max_iter),
                                momentum=cfg.momentum, weight_decay=0.0,
                                clip_value=0.0)
    pm = torch.as_tensor(pose_means, dtype=param_dtype, device=device)
    ps = torch.as_tensor(pose_stds, dtype=param_dtype, device=device)
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else None

    def step(state, batch):
        amp = torch.autocast(device.type, dtype=compute_dtype,
                             enabled=compute_dtype is not None)
        with amp:
            out = state.model(batch["images"])
        loss, stats = pose_loss(out.poses[:, 0], batch["pose_tar"], pm, ps,
                                pose_lambda_t=cfg.pose_lambda_t,
                                pose_lambda_r=cfg.pose_lambda_r)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in stats.items()}

    fused = fuse_preprocess(
        step, torch.as_tensor(cfg.image_means, device=device),
        torch.as_tensor(cfg.image_stds, device=device),
        target_h=cfg.crop_size[0], crop_w=cfg.crop_size[1],
        out_dtype=None if param_dtype == torch.float32 else param_dtype,
        video=True)
    return SimpleNamespace(model=model,
                           state=TrainState(model, optimizer, None),
                           step=fused, n_trainable=len(trainable))


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from groomed_nms_torch.config import apply_overrides, load_config
    from groomed_nms_torch.data.pipeline import (ClipRecordView,
                                                 device_prefetch,
                                                 prepare_anchors,
                                                 resolve_stats_dir)
    from groomed_nms_torch.data.tracking import build_tracking_imdb
    from groomed_nms_torch.models.video import VideoConfig, VideoRPN3D
    from groomed_nms_torch.training.stats import StatTracker
    from groomed_nms_torch.utils.video_weights import (load_video_variables,
                                                       pose_npz_arrays)
    from groomed_nms_torch.utils.weights import init_weights

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    cfg = apply_overrides(load_config(args.config), args.overrides)
    if args.max_iter:
        cfg = dataclasses.replace(cfg, max_iter=args.max_iter)
    out_dir = os.path.join(args.output, cfg.name + "_pose")
    os.makedirs(out_dir, exist_ok=True)
    logging.basicConfig(
        force=True, level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("train_pose_torch")
    log.info("torch %s on %s", torch.__version__,
             torch.cuda.get_device_name(device) if cuda else "cpu")

    root = os.path.join(args.data_root, cfg.dataset_train)
    full = build_tracking_imdb(root, "training",
                               use_3d_for_2d=cfg.use_3d_for_2d,
                               im_ext=cfg.im_ext,
                               cache_file=os.path.join(out_dir, "imdb.pkl"))
    imdb = [r for r in full if "10" in r.egos]
    log.info("tracking imdb with poses: %d", len(imdb))
    if not imdb:
        raise ValueError(f"no training record under {root} has an ego pose")
    pose_means, pose_stds = compute_pose_stats(imdb)
    np.savez(os.path.join(out_dir, "pose_stats.npz"), means=pose_means,
             stds=pose_stds)

    main_out_dir = os.path.join(args.output, cfg.name)
    stats_dir = resolve_stats_dir(cfg, main_out_dir)
    if not os.path.exists(os.path.join(stats_dir, "anchors.npz")):
        log.info("no anchors.npz under %s: learning the detector run's "
                 "anchors over the tracking imdb", stats_dir)
    anchors, _, _ = prepare_anchors(cfg, [ClipRecordView(r) for r in full],
                                    cache_dir=stats_dir, device=device)

    model = VideoRPN3D(VideoConfig(rpn=cfg.rpn_config(anchors.shape[0])))
    init_weights(model, torch.Generator().manual_seed(cfg.rng_seed))
    load_video_variables(model, cfg, main_out_dir, log=log)
    run = build_pose_training(cfg, model, pose_means, pose_stds, device)
    model, state, fused = run.model, run.state, run.step
    log.info("training %d/%d param tensors (pose_net)", run.n_trainable,
             len(list(model.parameters())))

    cache_dir = os.path.join(root, "training", ".decoded_cache") \
        if args.cache_images else None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)

    def host_tensors():
        for arrays in pose_batches(imdb, cfg, pose_means, pose_stds,
                                   cache_dir, cfg.max_iter):
            ts = tuple(torch.from_numpy(a) for a in arrays)
            yield None, tuple(t.pin_memory() for t in ts) if cuda else ts

    tracker = StatTracker(cfg.max_iter, cfg.display)
    summary = dict(out_dir=out_dir, records=len(imdb), steps=0, train_s=0.0,
                   host_wait_s=0.0, step_end_s=[], losses=[],
                   batch_size=cfg.batch_size, peak_bytes=None, model=model)
    losses = []
    batches = device_prefetch(host_tensors(), device)
    t_loop = time.perf_counter()
    try:
        for it in range(cfg.max_iter):
            t0 = time.perf_counter()
            _, (frames, mirror, pose_tar) = next(batches)
            host_wait = time.perf_counter() - t0
            summary["host_wait_s"] += host_wait
            stats = fused(state, {"images_u8": frames, "mirror": mirror,
                                  "pose_tar": pose_tar})
            losses.append(stats["pose"])
            tracker.update(dict(stats, host_wait=host_wait))
            summary["steps"] += 1
            if cuda and summary["steps"] == 1:
                torch.cuda.reset_peak_memory_stats(device)
            summary["step_end_s"].append(time.perf_counter() - t_loop)
            if (it + 1) % cfg.display == 0:
                log.info(tracker.log_line(it + 1))
                tracker.reset()
    finally:
        batches.close()
    if cuda:
        torch.cuda.synchronize(device)
        summary["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    summary["train_s"] = time.perf_counter() - t_loop
    if losses:
        summary["losses"] = torch.stack(losses).cpu().tolist()
    np.savez(os.path.join(out_dir, "pose_net_params.npz"),
             **pose_npz_arrays(model.pose_net))
    log.info("pose training done; params -> pose_net_params.npz")
    return summary


if __name__ == "__main__":
    main()
