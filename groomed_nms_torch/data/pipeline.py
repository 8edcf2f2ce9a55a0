"""Host-side data plumbing of the evaluation loop (counterpart of the
eval-side parts of ``groomed_nms_tpu/data/pipeline.py``).

* ``load_image_cached`` decodes a frame (``data/png.py``) through an
  optional mmap cache of decoded arrays.
* ``anchor_stat_widths``, ``resolve_stats_dir`` and ``load_anchors`` find
  and read the ``anchors.npz`` a training run wrote.  Learning the priors
  (``prepare_anchors``' other branch) waits for ROADMAP queue 1, item 5.
* ``device_prefetch`` moves host batches to the device from a worker thread
  on a side CUDA stream.

The train loader waits for ROADMAP queue 1, item 9.
"""

from __future__ import annotations

import glob
import logging
import os
import queue
import threading

import numpy as np
import torch

from .png import read_png

log = logging.getLogger(__name__)


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


def load_anchors(cfg, cache_dir):
    """(anchors [A, 9+2], bbox_means, bbox_stds) from
    ``cache_dir/anchors.npz``.

    Where the JAX package's ``prepare_anchors`` would learn the priors from
    an imdb (no file, or one of another layout), this raises ``ValueError``:
    learning them is ROADMAP queue 1, item 5.
    """
    cache = os.path.join(cache_dir, "anchors.npz")
    if not os.path.exists(cache):
        raise ValueError(
            f"no anchors.npz under {cache_dir!r}: anchor priors and bbox "
            "statistics come from the training run (for copy_stats configs, "
            "the pretrained run); the port cannot learn them yet (ROADMAP "
            "queue 1, item 5)")
    z = np.load(cache)
    a_cols, s_cols = anchor_stat_widths(cfg)
    if z["anchors"].shape[1] != a_cols or z["bbox_means"].shape[0] != s_cols:
        raise ValueError(
            f"{cache} has anchors/stats widths {z['anchors'].shape[1]}/"
            f"{z['bbox_means'].shape[0]}, expected {a_cols}/{s_cols} for "
            f"has_vel={cfg.has_vel} decomp_alpha={cfg.decomp_alpha}; "
            "recomputing them is ROADMAP queue 1, item 5")
    return z["anchors"], z["bbox_means"], z["bbox_stds"]


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
