"""Traffic of kind "serve": a closed loop of batches of uint8 frames
through the serving entry ``eval/tester.py::make_infer``.

A pool of frames is made from the seed in pinned host memory; batch i
takes the pool's batch i mod (pool / batch), copies it to the card,
runs ``infer`` and copies the rows and ``valid`` back into pinned host
buffers behind an event.  At most ``in_flight`` batches are outstanding: a
new one is submitted when the oldest's rows are on the host.  A batch's
latency runs from its submission (the frames' copy enqueued) to its rows on
the host.  After the window every batch's rows are compared with the plain
reference (``checks.serve_check``).  ``drive`` runs one cell of this kind.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import deque

import numpy as np

from . import inputs, program
from .common import percentile, reference_numerics


class Server:
    """The program's serving path for one configuration and seed, on
    ``device``; ``numerics`` are the configuration's (or a control's);
    ``ref`` is the configuration's plain reference."""

    def __init__(self, torch, cfg, traffic, ref, seed, device, numerics):
        from groomed_nms_torch.eval.tester import make_infer

        self.torch, self.cfg, self.traffic, self.seed = torch, cfg, traffic, seed
        self.device = device
        exp = cfg["experiment"]
        ecfg = program.experiment(cfg)
        self.ref = ref
        model = program.model(torch, cfg, ecfg, ref, seed, device)
        self.model = model
        crop_h, crop_w = exp["crop_size"]
        self.infer = make_infer(model, ecfg.detect_config(), crop_h,
                                crop_w, numerics["dtype"])
        b, src_hw = traffic["batch"], tuple(traffic["src_hw"])
        self.batch = b
        self.n_sets = traffic["pool_frames"] // b
        pool = inputs.frames(seed, 2, self.n_sets * b, src_hw)
        self.pool = [pool[i * b:(i + 1) * b] for i in range(self.n_sets)]
        anch = inputs.anchors(exp, cfg["model"]["num_anchors"], seed)
        stride = exp["feat_stride"]
        rois, rois_3d = inputs.grid_rois(
            anch, (crop_h // stride, crop_w // stride), stride)
        means, stds = inputs.target_stats(torch, ref, cfg, seed, rois,
                                          rois_3d, device)
        p2 = np.tile(inputs.KITTI_P2, (b, 1, 1))
        scale = np.full((b,), crop_h / src_hw[0])
        dev = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(x), dtype=dt, device=device)
        self.host = {"rois": rois, "rois_3d": rois_3d, "p2": p2,
                     "p2_inv": np.linalg.inv(inputs.KITTI_P2), "scale": scale,
                     "means": means, "stds": stds}
        self.args = (dev(exp["image_means"]), dev(exp["image_stds"]),
                     dev(rois), dev(rois_3d), dev(p2),
                     dev(np.tile(self.host["p2_inv"], (b, 1, 1))),
                     dev(scale), dev(means), dev(stds))
        k = exp["nms_topN_post"]
        self.shapes = {"b": b, "r": rois.shape[0],
                       "per": len(exp["lbls"]) + 1 + 14,
                       "elem_bytes": 2 if numerics["dtype"] is not None else 4,
                       "accept": bool(exp["predict_acceptance_prob"]),
                       "nms_n": exp["nms_topN_pre"], "post": k}
        slots = traffic["in_flight"] + 1
        self.cuda = device.type == "cuda"
        pin = (lambda t: t.pin_memory()) if self.cuda else (lambda t: t)
        self.rows = [pin(torch.empty((b, k, 17))) for _ in range(slots)]
        self.valid = [pin(torch.empty((b, k), dtype=torch.bool))
                      for _ in range(slots)]
        self.free = deque(range(slots))

    def submit(self, i, span=contextlib.nullcontext):
        """Enqueue batch i: frames to the card, ``infer``, rows back."""
        torch = self.torch
        with span("copy"):
            frames = self.pool[i % self.n_sets].to(self.device,
                                                   non_blocking=True)
        dets, valid = self.infer(frames, *self.args)
        slot = self.free.popleft()
        self.rows[slot].copy_(dets, non_blocking=True)
        self.valid[slot].copy_(valid, non_blocking=True)
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        return slot, ev

    def collect(self, slot, ev):
        if ev is not None:
            ev.synchronize()
        out = (self.rows[slot].numpy().copy(), self.valid[slot].numpy().copy())
        self.free.append(slot)
        return out

    def run(self, n=None, seconds=None, span=None, keep=True):
        """Run ``n`` batches or for ``seconds``; returns a dict: latencies
        (s), enqueue times (s), the batches done in the window, their rows
        (when ``keep``), the window's seconds."""
        span = span or (lambda name: contextlib.nullcontext())
        depth = self.traffic["in_flight"]
        pending, lat, enq, out = deque(), [], [], []
        done_in_window = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds if seconds is not None else None
        i = 0

        def retire():
            nonlocal done_in_window
            j, ts, slot, ev = pending.popleft()
            with span("wait rows"):
                rows = self.collect(slot, ev)
            now = time.perf_counter()
            lat.append(now - ts)
            if t_end is None or now <= t_end:
                done_in_window += 1
            if keep:
                out.append((j, rows))

        while (n is None or i < n) and (t_end is None
                                        or time.perf_counter() < t_end):
            ts = time.perf_counter()
            with span("submit"):
                slot, ev = self.submit(i, span)
            enq.append(time.perf_counter() - ts)
            pending.append((i, ts, slot, ev))
            i += 1
            if len(pending) >= depth:
                retire()
        while pending:
            retire()
        return {"latency": lat, "enqueue": enq, "done": done_in_window,
                "submitted": i, "rows": out,
                "window_s": seconds if seconds is not None
                else time.perf_counter() - t0}



def model_events(torch, model):
    """CUDA events around every forward of ``model`` while ``rec["on"]``."""
    rec = {"on": False, "pairs": []}

    def pre(mod, args):
        if rec["on"]:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["pairs"].append([ev, None])

    def post(mod, args, out):
        if rec["on"] and rec["pairs"]:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["pairs"][-1][1] = ev

    model.register_forward_pre_hook(pre)
    model.register_forward_hook(post)
    return rec


def drive(torch, cfg, traffic, ref, seed, seconds, trace, device, num,
          t_start, readings):
    """A serving cell: set-up, the window, the traced batches, the check.
    The memory peak is the window's: the allocator's peak is reset when
    the window opens."""
    from . import trace as tracing
    from .checks import serve_check
    from .flops import forward_flops

    cuda = device.type == "cuda"
    server = Server(torch, cfg, traffic, ref, seed, device, num)
    rec = model_events(torch, server.model) if trace and cuda else None
    server.run(n=traffic["warmup_batches"], keep=False)
    if cuda:
        torch.cuda.synchronize()
    values = {"setup_s": time.perf_counter() - t_start}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if rec:
        rec["on"] = True
    res = server.run(seconds=seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    values["img_per_s"] = res["done"] * server.batch / res["window_s"]
    values["batch_ms_p95"] = percentile(res["latency"], 95) * 1e3
    if trace:
        readings["enqueue_s"] = res["enqueue"]
        readings["shapes"] = server.shapes
        if rec:
            rec["on"] = False
            torch.cuda.synchronize()
            readings["events_ms"] = {"model": [
                a.elapsed_time(z) for a, z in rec["pairs"] if z]}
        if cuda:
            k = traffic["trace_units"]

            def body(sp):
                server.run(n=2, keep=False, span=sp)
                with sp("window"):
                    server.run(n=k, keep=False, span=sp)

            readings["trace"] = tracing.reduce(tracing.profile(torch, body))
            readings["units"] = k
            readings["flops_per_unit"] = forward_flops(ref, cfg, server.batch)
    server.model = server.infer = None
    if cuda:
        torch.cuda.empty_cache()
    reference_numerics(torch)
    t_check = time.perf_counter()
    row_err, pick_gap, n, col = serve_check(server, res["rows"])
    print(f"serve check: {n} batches in {time.perf_counter() - t_check:.1f}"
          f" s, the largest row error in column {col}", file=sys.stderr)
    return {"values": values, "peak": peak, "attempted": res["submitted"],
            "failed": res["submitted"] - len(res["rows"]),
            "checked": {"row_err": row_err, "pick_gap": pick_gap}}
