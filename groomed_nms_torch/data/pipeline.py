"""Host-side data plumbing of training and evaluation (counterpart of
``groomed_nms_tpu/data/pipeline.py``).

* ``prepare_anchors`` learns the anchor priors and the bbox statistics of a
  training imdb, or reads them from the ``anchors.npz`` it cached;
  ``anchor_stat_widths``, ``resolve_stats_dir`` and ``load_anchors`` find
  and read that file for the evaluation and conversion entry points.
* ``load_image_cached`` decodes a frame (``data/png.py``) through an
  optional mmap cache of decoded arrays.
* ``TrainLoader`` samples weighted batches of one image size, decodes them
  in a thread pool and prefetches them from a worker thread.
* ``ClipRecordView`` gives a tracking record the still-image record's
  interface (``.gts`` the current frame's labels, velocities included), so
  ``prepare_anchors`` and the loaders take a tracking imdb;
  ``VideoTrainLoader`` is ``TrainLoader`` over clips of ``video_count``
  frames, oldest first.
* ``device_prefetch`` moves host batches to the device from a worker thread
  on a side CUDA stream.
"""

from __future__ import annotations

import glob
import logging
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..anchors import (compute_targets, generate_anchor_templates,
                       learn_anchor_priors, locate_anchors)
from ..parallel.dist import local_rows
from .augment import mirror_labels, scale_labels
from .imdb import balance_samples, class_indices, determine_ignores, \
    pad_gt_batch
from .png import read_png

log = logging.getLogger(__name__)


def _vel_pad(bbox_3d, has_vel):
    """Pad a 16-column bbox_3d to 17 with the -inf no-velocity sentinel
    when velocity training mixes records with and without tracks."""
    if has_vel and bbox_3d.shape[1] == 16:
        pad = np.full((bbox_3d.shape[0], 1), -np.inf, bbox_3d.dtype)
        return np.concatenate([bbox_3d, pad], axis=1)
    return bbox_3d


def _scaled_valid_gts(rec, cfg, use_trunc=False):
    """(gts scaled to the network's input, valid mask, scale) of one
    record, or None when it has no valid GT."""
    if not rec.gts or len(rec.gts.get("cls", [])) == 0:
        return None
    scale = cfg.test_scale / rec.im_h
    gts = scale_labels(rec.gts, scale)
    igns, rmvs = determine_ignores(gts, list(cfg.lbls), list(cfg.ilbls),
                                   cfg.min_gt_vis, cfg.min_gt_h,
                                   use_trunc=use_trunc)
    val = ~igns & ~rmvs
    if not val.any():
        return None
    return gts, val, scale


def anchor_stat_widths(cfg):
    """Expected ``anchors.npz`` column widths for this config's layout.

    anchors: [x1 y1 x2 y2 z w3d h3d l3d rotY (sin cos) (vel)];
    stats:   [dx dy dw dh | n3d transform columns].
    """
    a_cols = 9 + (2 if cfg.decomp_alpha else 0) + (1 if cfg.has_vel else 0)
    s_cols = 4 + (9 if cfg.decomp_alpha else 7) + (1 if cfg.has_vel else 0)
    return a_cols, s_cols


def resolve_stats_dir(cfg, out_dir):
    """Directory holding this config's ``anchors.npz`` (priors + stats).

    The ``copy_stats`` rule: when the config points at a pretrained run
    whose cached layout matches this config's column widths and ``out_dir``
    has no ``anchors.npz`` of its own, the pretrained run's stats are the
    ones the training stage used; otherwise ``out_dir``.
    """
    if getattr(cfg, "copy_stats", False) and getattr(cfg, "pretrained", None):
        cache = os.path.join(cfg.pretrained, "anchors.npz")
        if not os.path.exists(os.path.join(out_dir, "anchors.npz")) \
                and os.path.exists(cache):
            z = np.load(cache)
            a_cols, s_cols = anchor_stat_widths(cfg)
            if (z["anchors"].shape[1] == a_cols
                    and z["bbox_means"].shape[0] == s_cols):
                return cfg.pretrained
    return out_dir


def _padded_gts(rec, cfg, use_trunc):
    """(corners [G, 4], bbox_3d [G, K], labels [G]) f32 of one record's
    valid GTs at the network's input scale, or None."""
    sv = _scaled_valid_gts(rec, cfg, use_trunc=use_trunc)
    if sv is None:
        return None
    gts, val, _ = sv
    boxes = gts["bbox_full"][val].astype(np.float32)
    corners = np.stack([boxes[:, 0], boxes[:, 1],
                        boxes[:, 0] + boxes[:, 2] - 1,
                        boxes[:, 1] + boxes[:, 3] - 1], axis=1)
    lbl = class_indices({"cls": [c for c, v in zip(gts["cls"], val) if v]},
                        list(cfg.lbls))
    g3d = _vel_pad(gts["bbox_3d"], cfg.has_vel)[val].astype(np.float32)
    return corners, g3d, lbl


def prepare_anchors(cfg, imdb, cache_dir=None, device="cuda"):
    """Learn per-anchor 3D priors and the regression targets' mean/std over
    ``imdb``; returns (anchors [A, 9+2], bbox_means [13], bbox_stds [13])
    and caches them as ``cache_dir/anchors.npz``.

    A cached file of this config's widths (``anchor_stat_widths``) is
    returned as it is; one of other widths is learned again, or, with an
    empty imdb, raises ``ValueError``, as does an empty imdb with no file.

    Pass 1 matches every valid GT to its best template
    (``learn_anchor_priors``).  Pass 2 runs the loss's ``compute_targets``
    on ``device``, one image at a time, and copies each image's foreground
    rows (ascending anchor order) to the host, where they are summed in
    f64.  The two statistics passes filter differently, as the reference
    does: the mean pass ignores heavily truncated GTs (``use_trunc=True``),
    the std pass does not, and the std divides its squared sums by the mean
    pass's counts:
    ``std^2 = (sum_B x^2 - 2 m sum_B x + N_B m^2) / N_A`` with
    ``m = sum_A x / N_A``.  Each column counts its finite entries only.
    """
    cache = os.path.join(cache_dir, "anchors.npz") if cache_dir else None
    if cache and os.path.exists(cache):
        z = np.load(cache)
        a_cols, s_cols = anchor_stat_widths(cfg)
        if (z["anchors"].shape[1] == a_cols
                and z["bbox_means"].shape[0] == s_cols):
            return z["anchors"], z["bbox_means"], z["bbox_stds"]
        if not len(imdb):
            raise ValueError(
                f"cached {cache} has anchors/stats widths "
                f"{z['anchors'].shape[1]}/{z['bbox_means'].shape[0]}, "
                f"expected {a_cols}/{s_cols} for has_vel={cfg.has_vel} "
                f"decomp_alpha={cfg.decomp_alpha}; cannot recompute from an "
                "empty imdb")
        log.info("%s has widths of another layout: learning them again",
                 cache)
    elif not len(imdb):
        # priors learned from nothing would be all-zero boxes
        raise ValueError(
            f"no anchors.npz under {cache_dir!r} and the imdb is empty: "
            "anchor priors and bbox statistics are learned by "
            "prepare_anchors during training (scripts/train_torch.py); for "
            "copy_stats configs they live in the pretrained run's "
            "directory (see resolve_stats_dir)")

    templates = generate_anchor_templates(cfg.anchor_scales,
                                          cfg.anchor_ratios, cfg.feat_stride)

    # pass 1: every valid GT, re-centred at the anchor origin
    all_gts2d, all_gts3d = [], []
    for rec in imdb:
        sv = _scaled_valid_gts(rec, cfg)
        if sv is None:
            continue
        gts, val, _ = sv
        boxes = gts["bbox_full"][val]
        w, h = boxes[:, 2], boxes[:, 3]
        c = (cfg.feat_stride - 1) / 2.0
        all_gts2d.append(np.stack([c - w / 2, c - h / 2, c + w / 2,
                                   c + h / 2], axis=1))
        all_gts3d.append(_vel_pad(gts["bbox_3d"], cfg.has_vel)[val])
    gts2d = np.concatenate(all_gts2d, 0) if all_gts2d else np.zeros((0, 4))
    gts3d = np.concatenate(all_gts3d, 0) if all_gts3d else \
        np.zeros((0, 17 if cfg.has_vel else 16))
    anchors = learn_anchor_priors(templates, gts2d.astype(np.float32), gts3d,
                                  decomp_alpha=cfg.decomp_alpha,
                                  has_vel=cfg.has_vel)

    # pass 2: the loss's own target assignment on the device
    device = torch.device(device)
    feat_hw = (int(np.ceil(cfg.crop_size[0] / cfg.feat_stride)),
               int(np.ceil(cfg.crop_size[1] / cfg.feat_stride)))
    rois = locate_anchors(anchors, feat_hw, cfg.feat_stride)
    rois_d = torch.from_numpy(rois).to(device)
    rois_3d_d = torch.from_numpy(
        anchors[rois[:, 4].astype(np.int64), 4:]).to(device)
    n3d = (9 if cfg.decomp_alpha else 7) + (1 if cfg.has_vel else 0)
    ncols = 4 + n3d
    no_ign = torch.zeros((1, 0, 4), device=device)
    no_ign_valid = torch.zeros((1, 0), dtype=torch.bool, device=device)

    def fg_rows(padded):
        """The image's fg target rows, f64 on the host."""
        corners, g3d, lbl = (torch.from_numpy(x).to(device)[None]
                             for x in padded)
        tgt = compute_targets(
            rois_d, rois_3d_d, corners, g3d, lbl,
            torch.ones(lbl.shape, dtype=torch.bool, device=device),
            no_ign, no_ign_valid, fg_thresh=cfg.fg_thresh,
            ign_thresh=cfg.ign_thresh, bg_thresh_lo=cfg.bg_thresh_lo,
            bg_thresh_hi=cfg.bg_thresh_hi, best_thresh=cfg.best_thresh,
            decomp_alpha=cfg.decomp_alpha, has_vel=cfg.has_vel)
        rows = torch.cat([tgt.transforms_2d[0],
                          tgt.transforms_3d[0, :, :n3d]], dim=1)
        return rows[tgt.fg_mask[0]].cpu().numpy().astype(np.float64)

    cnt_a = np.zeros(ncols, np.float64)
    s_a = np.zeros(ncols, np.float64)
    cnt_b = np.zeros(ncols, np.float64)
    s_b = np.zeros(ncols, np.float64)
    sq_b = np.zeros(ncols, np.float64)
    for rec in imdb:
        gts = rec.gts if rec.gts else {}
        trunc = np.asarray(gts.get("trunc", np.zeros(0)))
        same = not (trunc > max(1 - cfg.min_gt_vis, 0)).any()
        pa = _padded_gts(rec, cfg, use_trunc=True)
        pb = pa if same else _padded_gts(rec, cfg, use_trunc=False)
        for padded, into_a, into_b in ((pa, True, pb is pa),
                                       (None if pb is pa else pb, False,
                                        True)):
            if padded is None:
                continue
            rows = fg_rows(padded)
            finite = np.isfinite(rows)
            vals = np.where(finite, rows, 0.0)
            if into_a:
                cnt_a += finite.sum(0)
                s_a += vals.sum(0)
            if into_b:
                cnt_b += finite.sum(0)
                s_b += vals.sum(0)
                sq_b += (vals ** 2).sum(0)

    if cnt_a.any():
        denom = cnt_a + 1e-10
        means = s_a / denom
        stds = np.sqrt(np.maximum(
            (sq_b - 2.0 * means * s_b + cnt_b * means ** 2) / denom, 1e-12))
    else:
        means, stds = np.zeros(ncols), np.ones(ncols)

    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(cache, anchors=anchors, bbox_means=means, bbox_stds=stds)
    return anchors, means, stds


def load_anchors(cfg, cache_dir):
    """(anchors, bbox_means, bbox_stds) from ``cache_dir/anchors.npz``, as a
    training run (``prepare_anchors``, ``scripts/train_torch.py``) wrote
    them; ``ValueError`` when the file is missing or of other widths."""
    return prepare_anchors(cfg, [], cache_dir)


def _newest_cached(cache_dir, key):
    """The cache entry ``<key>-<size>-<mtime_ns>.npy`` with the largest
    mtime_ns (compared as integers), or None."""
    best, best_t = None, -1
    for path in glob.glob(os.path.join(glob.escape(cache_dir),
                                       glob.escape(key) + "-*.npy")):
        parts = os.path.basename(path)[:-len(".npy")].rsplit("-", 2)
        if len(parts) != 3 or parts[0] != key:
            continue
        try:
            t = int(parts[2])
        except ValueError:
            continue
        if t > best_t:
            best, best_t = path, t
    return best


def load_image_cached(image_path, key, cache_dir=None):
    """Decode ``image_path`` to uint8 RGB [H, W, 3], via the raw mmap cache.

    With ``cache_dir``, the first read writes the decoded array as
    ``<key>-<size>-<mtime_ns>.npy`` and later reads mmap it.  The source
    file's size and mtime in the name mean a regenerated tree invalidates
    its cache (stale entries stay on disk and are not read).  A missing or
    torn entry is decoded again and rewritten.  When the source file is
    gone, the entry with the newest mtime_ns serves instead, with a warning
    on every such read; with no entry, ``FileNotFoundError``.
    """
    if cache_dir:
        try:
            st = os.stat(image_path)
        except FileNotFoundError:
            hit = _newest_cached(cache_dir, key)
            if hit is None:
                raise
            log.warning("%s is missing: serving the cached decode %s",
                        image_path, hit)
            return np.load(hit, mmap_mode="r")
        p = os.path.join(cache_dir,
                         f"{key}-{st.st_size}-{st.st_mtime_ns}.npy")
        try:
            return np.load(p, mmap_mode="r")
        except (FileNotFoundError, ValueError, EOFError):
            pass                        # miss or torn write: decode again
    arr = read_png(image_path)
    if cache_dir:
        tmp = p + f".tmp{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, p)          # atomic against concurrent decoders
        except OSError:
            log.warning("could not write the decode cache entry %s", p)
            if os.path.exists(tmp):
                os.remove(tmp)
    return arr


class TrainLoader:
    """Weighted-sampling batch loader with a prefetch thread.

    Each batch holds ``cfg.batch_size`` records of ONE image size (the
    device-side resize applies one scale to a batch): a size group is drawn
    by its share of the sampling mass (``balance_samples``), then the
    records within it by their weights.  The frames are decoded in
    ``decode_workers`` threads (``load_image_cached``, through the mmap
    cache when ``raw_cache_dir`` is given); then, record by record in index
    order, one draw decides the mirror, and the labels are mirrored and
    scaled on the host.  The draws come from ``np.random.default_rng(seed)``
    in the JAX loader's order (group, records, one mirror draw each), so
    the batches are the JAX loader's for the same seed and imdb.

    ``next()`` returns ``{"images_u8": [B, H0, W0, 3] uint8 (zero-padded to
    the batch's largest frame), "mirror": [B] bool, "gt": GTBatch}`` of
    numpy arrays.

    With ``world > 1`` the batch is rank ``rank``'s rows of the global
    batch of ``cfg.batch_size`` (``parallel.local_rows``; the batch size
    must divide by the world): every rank makes every draw of the global
    batch in the same order, so the ranks' streams stay in step, and
    decodes and labels only its own rows.  An exception in the worker is raised by ``next()``;
    ``close()`` stops the worker; ``pop_wait_stats()`` gives the time the
    consumer waited since the last call.
    """

    def __init__(self, imdb, cfg, seed=0, prefetch=4, decode_workers=8,
                 raw_cache_dir=None, rank=0, world=1):
        self.imdb = imdb
        self.cfg = cfg
        self._rows = local_rows(cfg.batch_size, rank, world)
        self._pool = ThreadPoolExecutor(max_workers=decode_workers)
        self._cache_dir = raw_cache_dir
        if raw_cache_dir:
            os.makedirs(raw_cache_dir, exist_ok=True)
        self._wait_s = 0.0
        self._wait_n = 0
        # a fixed bbox_3d width keeps the batch shapes static
        self._n3d_cols = 17 if getattr(cfg, "has_vel", False) else None
        self.rng = np.random.default_rng(seed)
        self.weights = balance_samples(imdb, list(cfg.lbls), list(cfg.ilbls),
                                       cfg.min_gt_vis, cfg.min_gt_h,
                                       cfg.fg_image_ratio,
                                       max_gt_h=cfg.max_gt_h,
                                       test_scale=cfg.test_scale)
        groups = {}                       # in the imdb's order of first sight
        for i, rec in enumerate(imdb):
            groups.setdefault((rec.im_h, rec.im_w), []).append(i)
        self._size_groups = [np.asarray(v) for v in groups.values()]
        group_w = np.array([self.weights[g].sum()
                            for g in self._size_groups])
        self._group_w = group_w / group_w.sum()
        self._q = queue.Queue(maxsize=prefetch)
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="TrainLoader")
        self._thread.start()

    def _sample_indices(self):
        """This rank's records of the next global batch and their mirror
        draws: the group, the global batch's records, then one mirror draw
        a record in index order."""
        gi = self.rng.choice(len(self._size_groups), p=self._group_w)
        group = self._size_groups[gi]
        gw = self.weights[group]
        idx = self.rng.choice(group, size=self.cfg.batch_size,
                              p=gw / gw.sum())
        mirrors = self.rng.random(len(idx)) <= self.cfg.mirror_prob
        return idx[self._rows], mirrors[self._rows]

    def _sample_labels(self, rec, frame, mirror):
        cfg = self.cfg
        gts = rec.gts
        if mirror and gts:
            gts = mirror_labels(gts, rec.p2_inv, frame.shape[1])
        scale = cfg.test_scale / frame.shape[0]
        if gts:
            gts = scale_labels(gts, scale)
        return gts, scale, mirror

    def _make_batch(self):
        cfg = self.cfg
        idx, draws = self._sample_indices()
        images = list(self._pool.map(
            lambda i: load_image_cached(self.imdb[i].image_path,
                                        self.imdb[i].id, self._cache_dir),
            idx))
        gts_list, p2s, scales, mirrors = [], [], [], []
        for i, img, mirror in zip(idx, images, draws):
            rec = self.imdb[i]
            gts, scale, mirror = self._sample_labels(rec, img, mirror)
            gts_list.append(gts)
            p2s.append(rec.p2)
            scales.append(scale)
            mirrors.append(mirror)
        h0 = max(im.shape[0] for im in images)
        w0 = max(im.shape[1] for im in images)
        img_arr = np.zeros((len(idx), h0, w0, 3), np.uint8)
        for bi, im in enumerate(images):
            img_arr[bi, :im.shape[0], :im.shape[1]] = im
        return self._finish_batch(img_arr, gts_list, p2s, scales, mirrors)

    def _finish_batch(self, img_arr, gts_list, p2s, scales, mirrors):
        cfg = self.cfg
        gt = pad_gt_batch(gts_list, p2s, scales, list(cfg.lbls),
                          list(cfg.ilbls), cfg.min_gt_vis, cfg.min_gt_h,
                          max_gts=cfg.max_gts, max_igns=cfg.max_igns,
                          n3d_cols=self._n3d_cols)
        return {"images_u8": img_arr, "mirror": np.asarray(mirrors, bool),
                "gt": gt}

    def _put(self, item):
        # a put that honours close(): a plain put would block the worker
        # forever once the consumer is gone
        while not self._stop:
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        while not self._stop:
            try:
                item = self._make_batch()
            except BaseException as e:     # raised in the consumer
                self._put(("error", e))
                return
            if not self._put(("batch", item)):
                return

    def close(self):
        """Stop the prefetch worker and the decode pool."""
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=False)

    def pop_wait_stats(self):
        """(seconds ``next()`` waited for a batch, batches taken) since the
        last call."""
        out = (self._wait_s, self._wait_n)
        self._wait_s, self._wait_n = 0.0, 0
        return out

    def __next__(self):
        t0 = time.perf_counter()
        kind, item = self._q.get()
        self._wait_s += time.perf_counter() - t0
        self._wait_n += 1
        if kind == "error":
            raise RuntimeError("TrainLoader worker failed") from item
        return item

    def __iter__(self):
        return self


class ClipRecordView:
    """A ``data/tracking.py::TrackingRecord`` with the still-image record's
    interface: ``.gts`` is the current frame's labels (``gts_frames[0]``,
    with the velocity column where the raw sequence has tracks), so
    ``prepare_anchors``, ``balance_samples`` and the loaders take a
    tracking imdb.  The current frame is index 0 of ``gts_frames`` and of
    ``image_paths`` (then prev 1, prev 2, ...), where a loaded clip puts it
    last."""

    def __init__(self, rec):
        self.rec = rec
        self.id = rec.id
        self.gts = rec.gts_frames[0] if rec.gts_frames else None
        self.scale = 1.0
        self.p2 = rec.p2
        self.p2_inv = rec.p2_inv
        self.im_h = rec.im_h
        self.im_w = rec.im_w
        self.image_paths = rec.image_paths


class VideoTrainLoader(TrainLoader):
    """``TrainLoader`` over clips, for the video model's training.

    The draws, the mirror and the labels are ``TrainLoader``'s, on the
    current frame (the loss supervises it alone); ``images_u8`` is
    [B, F, H0, W0, 3], F = ``n_frames`` (``cfg.video_count``), ordered
    oldest to current and zero-padded to the batch's largest frame; a
    mirrored sample flips every frame of its clip (``fuse_preprocess(...,
    video=True)``).  ``imdb`` is a tracking imdb; its records are wrapped in
    ``ClipRecordView`` unless they already have ``.gts``.

    One decode task a clip (its frames read in turn); the labels are
    sampled afterwards in index order, so the draws are the JAX loader's
    for a seed.  The decode cache's key is a frame's file stem, so a
    current frame ("000001") and a history frame ("000001_01") are
    distinct entries.
    """

    def __init__(self, imdb, cfg, seed=0, prefetch=4, n_frames=None,
                 decode_workers=8, raw_cache_dir=None, rank=0, world=1):
        self.n_frames = n_frames or max(1, cfg.video_count)
        views = [r if hasattr(r, "gts") else ClipRecordView(r) for r in imdb]
        super().__init__(views, cfg, seed=seed, prefetch=prefetch,
                         decode_workers=decode_workers,
                         raw_cache_dir=raw_cache_dir, rank=rank, world=world)

    def _make_batch(self):
        cfg = self.cfg
        idx, draws = self._sample_indices()
        clips = list(self._pool.map(
            lambda i: np.stack(self._load_clip(self.imdb[i])), idx))
        gts_list, p2s, scales, mirrors = [], [], [], []
        for i, clip, mirror in zip(idx, clips, draws):
            rec = self.imdb[i]
            gts, scale, mirror = self._sample_labels(rec, clip[-1], mirror)
            gts_list.append(gts)
            p2s.append(rec.p2)
            scales.append(scale)
            mirrors.append(mirror)
        h0 = max(c.shape[1] for c in clips)
        w0 = max(c.shape[2] for c in clips)
        img_arr = np.zeros((len(idx), self.n_frames, h0, w0, 3), np.uint8)
        for bi, c in enumerate(clips):
            img_arr[bi, :, :c.shape[1], :c.shape[2]] = c
        return self._finish_batch(img_arr, gts_list, p2s, scales, mirrors)

    def _load_frame(self, path):
        return load_image_cached(
            path, os.path.splitext(os.path.basename(path))[0],
            self._cache_dir)

    def _load_clip(self, rec):
        """``n_frames`` frames, oldest first.  The current frame must exist;
        a history frame that is missing, unreadable or of another size
        (a sequence's start has no prev 2), and one past a short
        ``image_paths``, is the nearest newer frame again: no apparent
        motion, as the -inf no-velocity label says."""
        paths = rec.image_paths[:self.n_frames]    # current, prev 1, ...
        cur = self._load_frame(paths[0])
        full = [cur]
        for k in range(1, self.n_frames):
            img = None
            if k < len(paths):
                try:
                    img = self._load_frame(paths[k])
                except (FileNotFoundError, OSError):
                    img = None
                if img is not None and img.shape != cur.shape:
                    img = None
            full.append(img if img is not None else full[k - 1])
        return full[::-1]


def device_prefetch(host_iter, device, depth=2):
    """Overlap the host-to-device copies with the device's work.

    ``host_iter`` yields ``(meta, tensors)``, a tuple of CPU tensors (pinned
    for an asynchronous copy).  A worker thread pulls the items and, on a
    CUDA device, issues their copies on its own stream, records an event
    after them and keeps up to ``depth`` items queued; this generator yields
    ``(meta, device tensors)`` after making the current stream wait for
    that event.  The device tensors are marked as used on the current
    stream (``record_stream``), so their memory is not reused before the
    work queued on it is done; a pinned source is not handed out again by
    PyTorch's host allocator before its copy has completed.  On the CPU the
    tensors pass through.

    Closing the generator (loop done, early break, an error) stops the
    worker; an exception in the worker is raised here.
    """
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q = queue.Queue(maxsize=depth)
    stop = object()
    cancelled = threading.Event()

    def put(item):
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def worker():
        try:
            for meta, host in host_iter:
                if cancelled.is_set():
                    return
                event = None
                if stream is not None:
                    with torch.cuda.stream(stream):
                        dev = tuple(t.to(device, non_blocking=True)
                                    for t in host)
                        event = torch.cuda.Event()
                        event.record(stream)
                else:
                    dev = tuple(host)
                put((meta, dev, event))
            put(stop)
        except BaseException as e:     # surface errors in the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True, name="device_prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, BaseException):
                raise item
            meta, dev, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for x in dev:
                    x.record_stream(current)
            yield meta, dev
    finally:
        cancelled.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join()
