"""Traffic of kind "train": training steps through
``training/trainer.py::fuse_preprocess(make_train_step(...))``, fed by
``data/pipeline.py::device_prefetch``, as ``scripts/train_torch.py`` builds
them.  ``drive`` runs one cell of this kind.

A pool of host batches is made from the seed (uint8 frames, mirror flags,
``gts_per_image`` ground truths an image, pinned) and cycled; the prefetch
thread copies each to the card on its own stream.  Set-up builds the step
and its state once and drives it through its first ``check_steps`` steps on
distinct batches, reading each step's loss, the first step's loss terms
and, for each step, the gradients as autograd left them (before the
optimizer) and the parameters after it; the window goes on with the same
object and reads nothing back.  After the window ``train_check`` judges
those steps: the plain reference follows them, and SGD's rule is applied
to the program's own gradients and state for each.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from . import inputs, program
from .common import reference_numerics

# the BatchNorm buffers among the reference's weights: not trained
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
KEYS = ("images_u8", "mirror", "gts_2d", "gts_3d", "gt_labels", "gt_valid",
        "ign_2d", "ign_valid", "p2", "scale")


class Trainer:
    def __init__(self, torch, cfg, traffic, ref, seed, device, numerics,
                 recorder=None):
        from groomed_nms_torch.losses.rpn_3d import UncertaintyState
        from groomed_nms_torch.training.schedules import build_lr_schedule
        from groomed_nms_torch.training.trainer import (TrainState,
                                                         build_optimizer,
                                                         fuse_preprocess,
                                                         make_train_step)

        self.torch, self.cfg, self.traffic, self.seed = torch, cfg, traffic, seed
        self.device = device
        exp = self.exp = cfg["experiment"]
        ecfg = program.experiment(cfg)
        self.ref = ref
        model = program.model(torch, cfg, ecfg, ref, seed, device)
        schedule = build_lr_schedule(
            ecfg.lr, ecfg.max_iter, ecfg.lr_policy,
            ecfg.lr * ecfg.lr_target_factor, ecfg.lr_steps,
            warmup_iters=ecfg.warmup_iters)
        optimizer = build_optimizer(
            list(model.parameters()), ecfg.solver_type, schedule,
            momentum=ecfg.momentum, weight_decay=ecfg.weight_decay,
            clip_value=ecfg.grad_clip_value, batch_skip=ecfg.batch_skip)
        crop_h, crop_w = exp["crop_size"]
        stride = exp["feat_stride"]
        anch = inputs.anchors(exp, cfg["model"]["num_anchors"], seed)
        rois, rois_3d = inputs.grid_rois(
            anch, (crop_h // stride, crop_w // stride), stride)
        dev = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x), dtype=torch.float32, device=device)
        means, stds = inputs.target_stats(torch, ref, cfg, seed, rois,
                                          rois_3d, device)
        step = make_train_step(ecfg.loss_config(), dev(rois), dev(rois_3d),
                               dev(means), dev(stds),
                               numerics["dtype"],
                               on_stage=recorder.mark if recorder else None)
        self.recorder = recorder
        self.step = fuse_preprocess(
            step, dev(exp["image_means"]), dev(exp["image_stds"]),
            target_h=crop_h, crop_w=crop_w, distort_prob=exp["distort_prob"],
            rng_seed=exp["rng_seed"])
        self.state = TrainState(model, optimizer,
                                UncertaintyState.init(device))
        b, src_hw = traffic["batch"], tuple(traffic["src_hw"])
        self.batch = b
        n = traffic["pool_batches"]
        pool = inputs.frames(seed, 10, n * b, src_hw)
        cuda = device.type == "cuda"
        self.pool = []
        for i in range(n):
            gt = inputs.ground_truth(seed, 100 + i, b, exp, (crop_h, crop_w),
                                     src_hw, traffic["gts_per_image"])
            gt["mirror"] = inputs.mirror_flags(seed, 200 + i, b,
                                               exp["mirror_prob"])
            host = {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in
                    gt.items()}
            host["images_u8"] = pool[i * b:(i + 1) * b]
            self.pool.append(tuple(
                host[k].pin_memory() if cuda and not host[k].is_pinned()
                else host[k] for k in KEYS))
        self.shapes = {"b": b, "r": rois.shape[0]}
        self.feed = None

    def _host_iter(self):
        i = 0
        while True:
            yield i, self.pool[i % len(self.pool)]
            i += 1

    def start_feed(self):
        from groomed_nms_torch.data.pipeline import device_prefetch
        self.feed = device_prefetch(self._host_iter(), self.device,
                                    depth=self.traffic["prefetch_depth"])

    def close(self):
        if self.feed is not None:
            self.feed.close()
            self.feed = None

    def one_step(self, span=None):
        span = span or (lambda name: contextlib.nullcontext())
        with span("prefetch wait"):
            _, dev = next(self.feed)
        if self.recorder is not None:
            self.recorder.begin()
        with span("step"):
            return self.step(self.state, dict(zip(KEYS, dev)))

    def check_steps(self):
        """The set-up's first ``check_steps`` steps, through the window's
        own call: each step's loss, the first step's loss terms, and on the
        host the parameters before the first step and after each, and each
        step's
        gradients as autograd left them, before the optimizer clipped them
        (a parameter without one: zeros, as the optimizer counts it)."""
        torch = self.torch
        params = dict(self.state.model.named_parameters())
        grads = {}

        def keep(name):
            return lambda p: grads.__setitem__(name, p.grad.detach().clone())

        def host(d):
            return {n: t.detach().to("cpu", copy=True) for n, t in d.items()}

        hooks = [p.register_post_accumulate_grad_hook(keep(n))
                 for n, p in params.items()]
        out = {"params": [host(params)], "grads": [], "losses": []}
        try:
            for t in range(self.traffic["check_steps"]):
                grads.clear()
                stats = self.one_step()
                out["losses"].append(float(stats["total"]))
                if t == 0:
                    out["terms1"] = {k: float(v) for k, v in stats.items()}
                out["grads"].append(host({
                    n: grads.get(n, torch.zeros_like(p))
                    for n, p in params.items()}))
                out["params"].append(host(params))
        finally:
            for h in hooks:
                h.remove()
        grads.clear()
        return out

    def run(self, seconds=None, n=None, span=None):
        torch = self.torch
        t0 = time.perf_counter()
        t_end = t0 + seconds if seconds is not None else None
        k, stats = 0, None
        while (n is None or k < n) and (t_end is None
                                        or time.perf_counter() < t_end):
            stats = self.one_step(span)
            k += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return {"steps": k, "window_s": time.perf_counter() - t0,
                "last_loss": None if stats is None else stats["total"]}

    def free(self):
        self.close()
        del self.state, self.step


def poly_lr(exp, step):
    """The config's poly learning rate (power 0.9) at ``step``, in f32."""
    if exp["lr_policy"] != "poly" or exp["warmup_iters"]:
        raise NotImplementedError("the reference follows the poly policy")
    f = np.float32
    lr, target = f(exp["lr"]), f(exp["lr"] * exp["lr_target_factor"])
    frac = np.clip(f(step) / f(exp["max_iter"]), f(0), f(1))
    return float(f(target + (lr - target) * (f(1) - frac) ** f(0.9)))


def reference_steps(torch, cfg, ref, seed, device, batches, dtype=None):
    """The plain reference's first steps, one a batch of ``batches`` (host
    tensors in ``KEYS`` order), from the weights it makes from ``seed``,
    in ``dtype`` (f32 when None): SGD with momentum, weight decay, the
    element-wise clip and the poly learning rate, as the configuration sets
    them.  Returns {"losses", "terms1", "grad1" (the first gradient as the
    optimizer takes it: clipped, with the decay), "change1" (the
    parameters' change in the first step), "change" (over all steps)}, the
    tensors on the host."""
    dtype = dtype or torch.float32
    exp = cfg["experiment"]
    crop_h, crop_w = exp["crop_size"]
    stride = exp["feat_stride"]
    anch = inputs.anchors(exp, cfg["model"]["num_anchors"], seed)
    rois, rois_3d = inputs.grid_rois(
        anch, (crop_h // stride, crop_w // stride), stride)
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,  # noqa: E731
                                  device=device)
    means, stds = inputs.target_stats(torch, ref, cfg, seed, rois, rois_3d,
                                      device)
    rois, rois_3d, means, stds = f(rois), f(rois_3d), f(means), f(stds)
    p = {n: w.to(dtype) if w.is_floating_point() else w for n, w in
         ref.make_weights(ref.param_spec(cfg), seed, device).items()}
    names = [n for n in p if not n.endswith(BUFFERS)]
    for n in names:
        p[n].requires_grad_(True)
    p0 = {n: p[n].detach().clone() for n in names}
    mom, wd, clip = (exp["momentum"], exp["weight_decay"],
                     exp["grad_clip_value"])
    buf = {n: torch.zeros_like(p[n]) for n in names}
    out = {"losses": []}
    for t, batch in enumerate(batches):
        b = dict(zip(KEYS, (x.to(device) for x in batch)))
        x = ref.resize_normalize(b["images_u8"], b["mirror"],
                                 exp["image_means"], exp["image_stds"],
                                 crop_h, crop_w).to(dtype)
        head, _ = ref.rpn_forward(p, x, cfg["model"], train=True)
        loss, terms = ref.train_loss(head, rois, rois_3d, b, means, stds, exp)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        out["losses"].append(float(loss.detach()))
        if t == 0:
            out["terms1"] = {k: float(v.detach()) for k, v in terms.items()}
        del x, head, loss, terms
        with torch.no_grad():
            for n, g in zip(names, grads):
                buf[n].mul_(mom).add_(g.clamp(-clip, clip) + wd * p[n])
                p[n].sub_(poly_lr(exp, t) * buf[n])
            if t == 0:
                out["grad1"] = {n: buf[n].to("cpu", copy=True)
                                for n in names}
                out["change1"] = {n: (p[n] - p0[n]).cpu() for n in names}
        del grads
    out["change"] = {n: (p[n] - p0[n]).detach().cpu() for n in names}
    return out


def sgd_rule_gap(first, exp, skip):
    """The worst leaf's gap, over the checked steps, between the program's
    change of the parameters and SGD's rule applied to its own gradients
    and parameters, in f64: buf_t = momentum buf_{t-1} + clip(g_t) + wd
    p_{t-1} and p_t = p_{t-1} - lr(t-1) buf_t, rounded to the parameters'
    type, with the configuration's momentum, weight decay, clip and poly
    learning rate.  An element within one unit in the last place of its
    parameter agrees: the program's f32 arithmetic rounds the update before
    it adds it.  Leaves in ``skip`` are left out."""
    from .checks import leaf_diff_gaps, ulp

    mom, wd, clip = (exp["momentum"], exp["weight_decay"],
                     exp["grad_clip_value"])
    ps, worst, buf = first["params"], 0.0, None
    for t, g in enumerate(first["grads"]):
        p0, p1 = ps[t], ps[t + 1]
        step = {n: g[n].double().clamp(-clip, clip) + wd * p0[n].double()
                for n in g}
        buf = step if buf is None else {n: mom * buf[n] + step[n] for n in g}
        lr = poly_lr(exp, t)
        want = {n: (p0[n].double() - lr * v).to(p0[n].dtype).double()
                - p0[n].double() for n, v in buf.items()}
        gaps = leaf_diff_gaps({n: p1[n].double() - p0[n].double() for n in g},
                              want, skip, slack={n: ulp(p1[n]) for n in g})
        worst = max(worst, max(gaps.values()))
    return worst


def train_check(torch, cfg, ref, seed, device, first, pool):
    """(numbers, details) of the program's first steps ``first``
    (``Trainer.check_steps``): the plain reference follows them on the
    same batches from the same weights (``reference_steps``), and SGD's
    rule is applied to the program's own gradients for each of them
    (``sgd_rule_gap``).  Leaf gaps are of norms, each over the larger of
    the reference's norm of that leaf and of the median leaf, leaving out
    the leaves whose first reference gradient is under a thousandth of the
    median leaf's.  ``details`` keeps the reference's steps."""
    from .checks import leaf_gaps, small_leaves

    exp = cfg["experiment"]
    if exp["solver_type"] != "sgd" or exp["batch_skip"] != 1:
        raise NotImplementedError("the reference steps SGD, one batch an "
                                  "update")
    n = len(first["losses"])
    r = reference_steps(torch, cfg, ref, seed, device, pool[:n])
    skip = small_leaves(r["grad1"])
    wd, clip = exp["weight_decay"], exp["grad_clip_value"]
    ps = first["params"]
    grad1 = {k: g.clamp(-clip, clip) + wd * ps[0][k]
             for k, g in first["grads"][0].items()}
    terms = first["terms1"]
    numbers = {
        "terms1_gap": max(abs(terms[k] - v) / (abs(v) or 1.0)
                          for k, v in r["terms1"].items()),
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(first["losses"], r["losses"])),
        "grad1_gap": max(leaf_gaps(grad1, r["grad1"], skip).values()),
        "change_gap": max(leaf_gaps({k: ps[n][k] - ps[0][k]
                                     for k in r["change"]},
                                    r["change"], skip).values()),
        "sgd_rule_gap": sgd_rule_gap(first, exp, skip)}
    return numbers, {"reference": r, "skip": skip}


class StageRecorder:
    """CUDA events at a train step's start and at its ``on_stage`` hooks."""

    def __init__(self, torch):
        self.torch, self.on, self.steps = torch, False, []

    def _event(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def begin(self):
        if self.on:
            self.steps.append({"start": self._event()})

    def mark(self, stage):
        if self.on and self.steps:
            self.steps[-1][stage] = self._event()

    def ms(self):
        self.torch.cuda.synchronize()
        out = {"fwd": [], "loss": [], "bwd": []}
        for s in self.steps:
            out["fwd"].append(s["start"].elapsed_time(s["forward"]))
            out["loss"].append(s["forward"].elapsed_time(s["loss"]))
            out["bwd"].append(s["loss"].elapsed_time(s["optimizer"]))
        return out


def drive(torch, cfg, traffic, ref, seed, seconds, trace, device, num,
          t_start, readings):
    """A training cell: set-up with the checked first steps, the window,
    the traced steps, the check.  The memory peak is the window's."""
    import math

    from . import trace as tracing
    from .flops import forward_flops

    cuda = device.type == "cuda"
    rec = StageRecorder(torch) if trace and cuda else None
    trainer = Trainer(torch, cfg, traffic, ref, seed, device, num, rec)
    trainer.start_feed()
    first = trainer.check_steps()
    if cuda:
        torch.cuda.synchronize()
    values = {"setup_s": time.perf_counter() - t_start}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if rec:
        rec.on = True
    res = trainer.run(seconds=seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    values["step_ms"] = res["window_s"] / max(res["steps"], 1) * 1e3
    values["peak_mem_gib"] = peak / 2**30
    last = None if res["last_loss"] is None else float(res["last_loss"])
    if trace:
        readings["shapes"] = trainer.shapes
        if rec:
            rec.on = False
            readings["events_ms"] = rec.ms()
        if cuda:
            k = traffic["trace_units"]

            def body(sp):
                trainer.run(n=1, span=sp)
                with sp("window"):
                    trainer.run(n=k, span=sp)

            readings["trace"] = tracing.reduce(tracing.profile(torch, body))
            readings["units"] = k
            readings["flops_per_unit"] = 3 * forward_flops(ref, cfg,
                                                           trainer.batch)
    pool = trainer.pool
    trainer.free()
    del trainer
    if cuda:
        torch.cuda.empty_cache()
    reference_numerics(torch)
    t_check = time.perf_counter()
    checked, details = train_check(torch, cfg, ref, seed, device, first, pool)
    print(f"train check in {time.perf_counter() - t_check:.1f} s: {checked}",
          file=sys.stderr)
    return {"values": values, "peak": peak, "attempted": res["steps"],
            "failed": 0 if last is not None and math.isfinite(last) else 1,
            "checked": checked,
            "details": {**details, "first": first, "pool": pool}}
