"""The serving entry point and the KITTI evaluation loop.

``make_infer`` is the counterpart of
``groomed_nms_tpu/eval/tester.py::_make_infer``: preprocess -> model ->
``im_detect_3d`` on one batch, all on the frames' device.

``test_kitti_3d`` is the counterpart of its ``test_kitti_3d``: run the model
over an imdb, write KITTI txt detections, run the C++ evaluator.  Frames of
one size go to the device in full batches (the last batch of a size padded
with zero frames, whose rows are dropped), or, with
``cfg.eval_single_program``, every frame is edge-padded into one max-size
plane and resampled by its own scale (``preprocess_images_dynamic``).  PNGs
decode in a pool of 8 threads into pinned host buffers; a worker thread
copies each batch to the card on its own stream (``device_prefetch``); the
detections come back through pinned buffers with an event per batch, and at
most 3 batches are in flight before the oldest is written.

``refine=True`` runs the hill-climb of ``inference.refine_detections`` on
each batch's final rows on the device, with each record's original-frame
P2, before the copy to the host.

Under a process group (``dist``) each rank runs its rows of every global
batch (``parallel.local_rows``: a batch of ``batch_size`` frames is split
over the ranks as JAX's mesh shards it), writes their txt files, and rank
0 runs the evaluator once every rank is done.  Left out of the JAX loop:
the per-model compiled-graph cache (PyTorch runs eagerly).  ``render > 0`` (matplotlib and Pillow) raises
``ValueError``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.augment import (pad_image_edge, preprocess_images,
                            preprocess_images_dynamic)
from ..inference import (clip_detections, im_detect_3d, refine_detections,
                         rpn_outputs_dict, write_kitti_detections)

MAX_IN_FLIGHT = 3                 # batches queued before the oldest is written
DECODE_THREADS = 8


def make_infer(model, dcfg, target_h, crop_w, compute_dtype=None):
    """Build ``infer(images_u8, means_img, stds_img, rois, rois_3d, p2,
    p2_inv, scale, bbox_means, bbox_stds, src_hw=None) -> (dets [B, K, 17],
    valid [B, K])``.

    ``images_u8`` [B, H0, W0, 3] uint8 on the model's device; the other
    arguments are tensors on the same device (see ``im_detect_3d``).  With
    ``src_hw`` [B, 2], each frame lies in the top-left corner of its plane
    at that size and is resampled by its own scale
    (``preprocess_images_dynamic``); without it the batch is one size.
    ``compute_dtype`` torch.bfloat16 runs the preprocess output and the
    model under bf16 autocast (BatchNorm statistics and the head's f32
    splits stay f32); None runs in f32.  The model is put in eval mode.
    """
    model.eval()

    @torch.inference_mode()
    def infer(images_u8, means_img, stds_img, rois, rois_3d, p2, p2_inv,
              scale, bbox_means, bbox_stds, src_hw=None):
        if src_hw is None:
            images = preprocess_images(images_u8, None, means_img, stds_img,
                                       target_h=target_h, crop_w=crop_w,
                                       out_dtype=compute_dtype)
        else:
            images = preprocess_images_dynamic(
                images_u8, src_hw, means_img, stds_img, target_h=target_h,
                crop_w=crop_w, out_dtype=compute_dtype)
        amp = (torch.autocast(images.device.type, dtype=compute_dtype)
               if compute_dtype is not None else contextlib.nullcontext())
        with amp:
            out = model(images)
        return im_detect_3d(rpn_outputs_dict(out), rois, rois_3d, p2, p2_inv,
                            scale, bbox_means, bbox_stds, dcfg)

    return infer


def _size_groups(imdb, single):
    """{(h0, w0): records}: one group per image size, or one max-size plane
    for every record in single-program mode."""
    groups = defaultdict(list)
    if single and imdb:
        groups[(max(r.im_h for r in imdb), max(r.im_w for r in imdb))] = \
            list(imdb)
    else:
        for rec in imdb:
            groups[(rec.im_h, rec.im_w)].append(rec)
    return groups


def test_kitti_3d(cfg, model, rois, rois_3d, bbox_means, bbox_stds, imdb,
                  results_dir, gt_dir=None, batch_size=None, log_fn=None,
                  skip_eval=False, render=0, refine=False, raw_cache_dir=None,
                  loop_stats=None, dist=None):
    """Run inference over ``imdb`` into ``results_dir``/data; evaluate when
    ``gt_dir`` exists.

    ``model`` is an ``RPN3D`` (or a ``FastEvalRPN3D``) on the device that
    runs the loop; ``cfg.compute_dtype`` "bfloat16" runs it under bf16
    autocast.  With ``raw_cache_dir``, decoded frames are cached there as
    ``.npy`` (``data.pipeline.load_image_cached``).  ``refine`` runs
    ``refine_detections`` on each batch's rows.  ``loop_stats``, a dict,
    receives the loop's ``images``, ``wall_s`` and, on a CUDA device,
    ``busy_s``: the time the card had a batch in flight, from CUDA events
    around each batch.  Returns the evaluator's AP dict
    (``evaluate_kitti_results_verbose``), or None when evaluation was
    skipped.

    ``dist``, a ``parallel.Dist``: this rank runs its rows of each batch
    (``batch_size`` must divide by the world) and the ranks wait for each
    other before rank 0 evaluates; the other ranks return None.
    """
    from ..data.pipeline import device_prefetch, load_image_cached
    from ..parallel.dist import barrier, local_rows
    from .kitti_eval import evaluate_kitti_results_verbose

    if render:
        raise ValueError("render > 0 needs matplotlib and Pillow, which the "
                         "port does not use (ROADMAP: left out of the eval "
                         "slice)")
    log_fn = log_fn or logging.getLogger(__name__).info
    batch_size = batch_size or cfg.test_batch_size
    rows = local_rows(batch_size, dist.rank, dist.world) \
        if dist is not None else slice(0, batch_size)
    local_b = rows.stop - rows.start
    os.makedirs(os.path.join(results_dir, "data"), exist_ok=True)
    if raw_cache_dir:
        os.makedirs(raw_cache_dir, exist_ok=True)

    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    single = bool(cfg.eval_single_program)
    crop_h, crop_w = cfg.crop_size
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else None
    infer = make_infer(model, cfg.detect_config(), crop_h, crop_w,
                       compute_dtype)

    means_img, stds_img, rois_d, rois_3d_d, means_d, stds_d = (
        torch.as_tensor(np.asarray(x, np.float32), device=device)
        for x in (cfg.image_means, cfg.image_stds, rois, rois_3d, bbox_means,
                  bbox_stds))
    lbls = list(cfg.lbls)

    def load_chunk(chunk, h0, w0):
        """One batch on the host: frames (pinned on a CUDA run; slots past
        the chunk zero), true sizes, P2 and its inverse, and the scale."""
        imgs_t = torch.empty((local_b, h0, w0, 3), dtype=torch.uint8,
                             pin_memory=cuda)
        imgs = imgs_t.numpy()
        imgs[len(chunk):] = 0
        hw = np.tile(np.array([[h0, w0]], np.float32), (local_b, 1))
        p2 = np.tile(np.eye(4, dtype=np.float32)[None], (local_b, 1, 1))

        def read(bi_rec):
            bi, rec = bi_rec
            arr = load_image_cached(rec.image_path, rec.id, raw_cache_dir)
            if arr.shape[:2] == (h0, w0):
                imgs[bi] = arr
            elif single and arr.shape[0] <= h0 and arr.shape[1] <= w0:
                # the dynamic resample reads only the true extent hw[bi]
                imgs[bi] = pad_image_edge(arr, h0, w0)
            else:
                # a static resize would scale the whole plane by crop/h0
                # while ``scale`` uses the true height: wrong boxes
                raise ValueError(
                    f"{rec.image_path}: decoded size {arr.shape[:2]} does "
                    f"not match the imdb metadata ({rec.im_h}, {rec.im_w})"
                    f" / batch plane ({h0}, {w0}) -- stale imdb cache? "
                    "Rebuild it or use eval_single_program for mixed sizes")
            hw[bi] = arr.shape[:2]
            p2[bi] = rec.p2

        with ThreadPoolExecutor(max_workers=DECODE_THREADS) as pool:
            list(pool.map(read, enumerate(chunk)))
        scale = (crop_h / hw[:, 0]).astype(np.float32)
        return (imgs_t, torch.from_numpy(hw), torch.from_numpy(p2),
                torch.from_numpy(np.linalg.inv(p2)), torch.from_numpy(scale))

    def chunk_iter():
        for (h0, w0), recs in _size_groups(imdb, single).items():
            for i in range(0, len(recs), batch_size):
                chunk = recs[i:i + batch_size][rows]
                if chunk:
                    yield chunk, load_chunk(chunk, h0, w0)

    t0 = time.perf_counter()
    n_done = 0
    spans = []                    # (start, end) CUDA events of each batch

    def flush(chunk, dets, valid, done):
        nonlocal n_done
        if done is not None:
            done.synchronize()
        dets, valid = dets.numpy(), valid.numpy()
        for bi, rec in enumerate(chunk):        # padding rows are dropped
            d = dets[bi]
            if cfg.clip_boxes:
                d = clip_detections(d, rec.im_w, rec.im_h)
            write_kitti_detections(
                os.path.join(results_dir, "data", rec.id + ".txt"),
                d, valid[bi], lbls, score_thres=cfg.score_thres)
        n_done += len(chunk)
        if n_done % 500 < len(chunk):
            dt = (time.perf_counter() - t0) / max(n_done, 1)
            log_fn(f"tested {n_done}/{len(imdb)}, "
                   f"{1.0 / max(dt, 1e-9):.1f} img/s")

    # a batch's results are read only when MAX_IN_FLIGHT later batches are
    # queued: reading at once would serialise decode, copy, compute and
    # readback batch by batch
    inflight = deque()
    for chunk, (imgs, hw, p2, p2_inv, scale) in device_prefetch(
            chunk_iter(), device):
        start = done = None
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        dets, valid = infer(imgs, means_img, stds_img, rois_d, rois_3d_d, p2,
                            p2_inv, scale, means_d, stds_d,
                            src_hw=hw if single else None)
        if refine:
            with torch.inference_mode():
                dets = refine_detections(dets, valid, p2, p2_inv)
        if cuda:
            dets_h = torch.empty(dets.shape, dtype=dets.dtype,
                                 pin_memory=True)
            valid_h = torch.empty(valid.shape, dtype=valid.dtype,
                                  pin_memory=True)
            dets_h.copy_(dets, non_blocking=True)
            valid_h.copy_(valid, non_blocking=True)
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            spans.append((start, done))
            dets, valid = dets_h, valid_h
        inflight.append((chunk, dets, valid, done))
        if len(inflight) > MAX_IN_FLIGHT:
            flush(*inflight.popleft())
    while inflight:
        flush(*inflight.popleft())

    wall = time.perf_counter() - t0
    busy = sum(s.elapsed_time(e) for s, e in spans) / 1e3
    log_fn(f"inference done: {n_done / max(wall, 1e-9):.1f} img/s "
           f"end-to-end over {n_done} images"
           + (f"; a batch in flight on the card {busy / wall:.1%} of the "
              "loop's wall" if cuda and wall > 0 else ""))
    if loop_stats is not None:
        loop_stats.update(images=n_done, wall_s=wall)
        if cuda:
            loop_stats["busy_s"] = busy
    if dist is not None:
        barrier(dist)
        if dist.rank != 0:
            return None
    if skip_eval or not gt_dir or not os.path.isdir(gt_dir):
        return None
    return evaluate_kitti_results_verbose(results_dir, gt_dir,
                                          fast_eval=cfg.fast_eval,
                                          log_fn=log_fn)
