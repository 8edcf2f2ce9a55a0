"""The optimizer, the train state and the train step (counterpart of
``groomed_nms_tpu/training/trainer.py``).

* ``build_optimizer``: the reference's solvers in optax's order -- clip
  each gradient element to [-clip, clip], add ``weight_decay * param``,
  then the solver's direction (SGD momentum ``buf = g + momentum * buf``;
  Adam / Adamax with b1 0.9, b2 0.999, eps 1e-8 and bias correction, as
  ``optax.scale_by_adam`` / ``scale_by_adamax`` compute them), then
  ``param -= lr(step) * direction`` with the step count starting at 0.
  With ``batch_skip = k > 1`` the gradients accumulate as a running SUM
  clipped after every micro-step, and every k-th micro-step applies the
  update to that sum with the LR of the global iteration,
  ``lr(a * k + k - 1)`` for the a-th update (the reference's
  ``loss_backprop`` / ``adjust_lr``).
* ``make_train_step``: forward (BatchNorm in train mode unless every
  statistic is frozen; frozen statistics kept through the step; bf16
  autocast when asked), ``rpn_3d_loss`` in f32, backward, optimizer step.
  ``make_video_train_step`` is the same step for ``VideoRPN3D`` on clips,
  the loss on each clip's current frame.
* ``fuse_preprocess``: uint8 frames (or clips) + mirror flags -> the step,
  with the photometric jitter keyed by the step (``jitter_draws``).

Data parallelism (``parallel.dist``): with ``dist``, a ``Dist`` of world W,
each process holds its rows of the global batch and the step computes what
one process computes on the whole batch (JAX's ``shard_train_step``): the
model runs as ``TrainState.ddp`` (``wrap_model``: BatchNorm on the global
batch's statistics, gradients averaged over the ranks), the loss is this
rank's share of the global loss scaled by W (``rpn_3d_loss(dist=...)``),
so the averaged gradient is the global loss's, and the jitter is drawn
for the global batch.  With ``batch_skip > 1`` every micro-step's gradient
is reduced before the optimizer clips the running sum (no ``no_sync``):
the clip is element-wise and nonlinear, so the sum it clips must already be
the global one.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..data.augment import (PhotometricDraws, photometric_draws,
                            preprocess_images, preprocess_images_train)
from ..losses.rpn_3d import (GTBatch, LossConfig, UncertaintyState,
                             accept_head_trained, rpn_3d_loss)
from ..parallel.dist import local_rows
from ..utils.spans import span

SOLVERS = ("sgd", "adam", "adamax")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class ClippedOptimizer:
    """SGD with momentum, Adam or Adamax, with weight decay, element-wise
    gradient clipping and clipped-sum gradient accumulation; see the
    module docstring.

    ``step()`` reads each parameter's ``.grad`` (a parameter without one
    counts as a zero gradient, as JAX's gradient of an unused parameter is)
    and returns True when it updated the parameters.  The per-parameter
    updates run as ``torch._foreach_*`` ops, one launch per op and list.
    Parameters left out of ``params`` (frozen ones) get no update at all.
    """

    def __init__(self, params, lr_schedule, *, solver_type="sgd",
                 momentum=0.9, weight_decay=0.0005, clip_value=1.0,
                 batch_skip=1):
        if solver_type not in SOLVERS:
            raise NotImplementedError(
                f"solver_type={solver_type!r}; known: {SOLVERS}")
        self.params = [p for p in params]
        self.lr_schedule = lr_schedule if callable(lr_schedule) \
            else (lambda step: lr_schedule)
        self.solver_type = solver_type
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_value = clip_value
        self.batch_skip = int(batch_skip) if batch_skip else 1
        self.count = 0                  # applied updates
        self.mini_step = 0              # micro-steps (batch_skip > 1)
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        if solver_type == "sgd":
            self.trace = zeros()
        else:
            self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if self.batch_skip > 1 else None

    def _buffers(self):
        return {"trace": self.trace} if self.solver_type == "sgd" \
            else {"mu": self.mu, "nu": self.nu}

    def state_dict(self):
        """The solver, the update counts and the moment (and accumulation)
        buffers, in parameter order."""
        return {"solver_type": self.solver_type, "count": self.count,
                "mini_step": self.mini_step, **self._buffers(),
                "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Raises ``ValueError`` when ``state`` is of another solver or
        another parameter list (count or shapes), changing nothing."""
        if state.get("solver_type", "sgd") != self.solver_type:
            raise ValueError(f"optimizer state of solver "
                             f"{state.get('solver_type')!r}, this one is "
                             f"{self.solver_type!r}")
        pairs = [(self._buffers()[k], state[k]) for k in self._buffers()]
        if self.acc is not None and state["acc"] is not None:
            pairs.append((self.acc, state["acc"]))
        for mine, theirs in pairs:
            if len(mine) != len(theirs) or any(
                    a.shape != b.shape for a, b in zip(mine, theirs)):
                raise ValueError("optimizer state of another parameter list")
        for mine, theirs in pairs:
            torch._foreach_copy_(mine, theirs)
        self.count, self.mini_step = state["count"], state["mini_step"]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _clip(self, tensors):
        if self.clip_value:
            torch._foreach_clamp_min_(tensors, -self.clip_value)
            torch._foreach_clamp_max_(tensors, self.clip_value)

    def _direction(self, grads):
        """The solver's update direction (before ``-lr``) for ``grads``."""
        if self.solver_type == "sgd":
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, grads)
            return self.trace
        # optax: EMA = (1 - decay) * g + decay * state; bias correction
        # 1 - decay ** count in f32, count counting this update
        t = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** t)
        torch._foreach_mul_(self.mu, ADAM_B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - ADAM_B1))
        if self.solver_type == "adam":
            bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** t)
            torch._foreach_mul_(self.nu, ADAM_B2)
            torch._foreach_add_(self.nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - ADAM_B2))
            denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
            torch._foreach_add_(denom, ADAM_EPS)
        else:                           # adamax: the infinity moment
            self.nu = torch._foreach_maximum(
                torch._foreach_add(torch._foreach_abs(grads), ADAM_EPS),
                torch._foreach_mul(self.nu, ADAM_B2))
            denom = self.nu
        return torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        k = self.batch_skip
        if k > 1:
            torch._foreach_add_(self.acc, grads)
            self._clip(self.acc)
            self.mini_step += 1
            if self.mini_step % k:
                return False
            grads = self.acc
            lr = self.lr_schedule(self.count * k + k - 1)
        else:
            self._clip(grads)
            lr = self.lr_schedule(self.count)
        if self.weight_decay:
            torch._foreach_add_(grads, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, self._direction(grads), alpha=-lr)
        if k > 1:
            torch._foreach_zero_(self.acc)
        self.count += 1
        return True


def build_optimizer(params, solver_type="sgd", lr_schedule=None,
                    momentum=0.9, weight_decay=0.0005, clip_value=1.0,
                    batch_skip=1):
    """The reference's optimizer over ``params`` (the trainable ones);
    ``lr_schedule`` is a function of the update count
    (``training.schedules``) or a float.  ``solver_type`` is "sgd", "adam"
    or "adamax"."""
    return ClippedOptimizer(params, lr_schedule, solver_type=solver_type,
                            momentum=momentum, weight_decay=weight_decay,
                            clip_value=clip_value, batch_skip=batch_skip)


@dataclass
class TrainState:
    """What a train step updates in place: the model (parameters and
    BatchNorm statistics), the optimizer, the self-balancing lambda and the
    step count.  ``ddp``, when set, is ``model`` wrapped by
    ``parallel.wrap_model``: the step runs its forward through it."""

    model: torch.nn.Module
    optimizer: Any
    un_state: UncertaintyState
    step: int = 0
    ddp: Any = None


def unused_parameters(model, loss_cfg):
    """The names of ``model``'s trainable parameters that the loss's
    gradient does not reach (``parallel.wrap_model``'s ``ignore``): the
    video model's pose branch (its step's loss reads the current frames
    only) and an acceptance head the loss does not read
    (``accept_head_trained``).  Their gradient is None in every step."""
    video = hasattr(model, "pose_net")
    rpn = model.rpn if video else model
    prefixes = ("pose_net.",) if video else ()
    if not accept_head_trained(
            loss_cfg, rpn.config.acceptance_prob_mode == "classify"):
        prefixes += tuple(f"{'rpn.' if video else ''}{name}."
                          for name, _ in rpn.named_children()
                          if name.startswith("accept"))
    return [name for name, p in model.named_parameters()
            if p.requires_grad and name.startswith(prefixes)]


def make_train_step(loss_cfg: LossConfig, rois, rois_3d, bbox_means,
                    bbox_stds, compute_dtype=None, on_stage=None,
                    train_bn=True, frozen_stats=(), dist=None):
    """Build ``train_step(state, batch) -> stats``.

    ``batch`` holds 'images' [B, 3, H, W] (normalised, on the model's
    device) and the ``GTBatch`` fields as tensors on the same device.  The
    model runs in train mode (BatchNorm on batch statistics, updating its
    running ones), under ``torch.autocast`` in ``compute_dtype`` when one is
    given (parameters and BatchNorm stay f32); the loss runs in f32 outside
    autocast.  The step updates ``state`` in place and returns the loss's
    stats dict of 0-dim tensors (nothing is read back to the host).
    ``on_stage``, when given, is called with "forward", "loss", "backward"
    and "optimizer" as each stage has been issued (a timer's hook).  A step
    is the program's span ``step`` (``utils/spans.py``), over the model's
    spans, ``loss``, ``backward`` and ``optimizer``.

    Freezing (``training/freeze.py``): ``train_bn=False`` runs the model in
    eval mode, BatchNorm normalising by its running statistics and leaving
    them as they are (every statistic frozen); ``frozen_stats``, names of
    ``running_mean`` / ``running_var`` buffers, keeps those unchanged
    through a train-mode step while the rest update.

    ``dist`` (a ``parallel.Dist``): the batch is this rank's rows of the
    global batch; the stats are the global batch's (module docstring).
    """
    def extract(out, batch):
        return {"cls": out.cls, "prob": out.prob, "bbox_2d": out.bbox_2d,
                "bbox_3d": out.bbox_3d, "accept_prob": out.accept_prob,
                "accept_cls": out.accept_cls,
                "uncertainty": out.uncertainty}

    return _make_step(loss_cfg, rois, rois_3d, bbox_means, bbox_stds,
                      compute_dtype, on_stage, train_bn, frozen_stats,
                      extract, dist)


def make_video_train_step(loss_cfg: LossConfig, rois, rois_3d, bbox_means,
                          bbox_stds, compute_dtype=None, on_stage=None,
                          train_bn=True, frozen_stats=(), dist=None):
    """``make_train_step`` for ``models/video.py::VideoRPN3D``.

    ``batch['images']`` is a clip [B, F, 3, H, W], frame F-1 the current
    one; the ``GTBatch`` fields label the current frame (``gts_3d`` with the
    velocity column 16 for the ``has_vel`` term).  The model runs on the
    B*F frames at once, so BatchNorm's batch statistics are over all of
    them; the loss reads each clip's current frame only, as JAX's
    ``make_video_train_step`` does (the pose branch trains in
    ``scripts/train_pose_torch.py``).
    """
    def extract(out, batch):
        b, f = batch["images"].shape[:2]

        def last_frame(x):
            return None if x is None else x.unflatten(0, (b, f))[:, -1]

        fo = out.frame_outputs                            # leading B*F
        return {"cls": last_frame(fo.cls), "prob": last_frame(fo.prob),
                "bbox_2d": last_frame(fo.bbox_2d),
                "bbox_3d": last_frame(fo.bbox_3d),
                "accept_prob": last_frame(fo.accept_prob),
                "accept_cls": last_frame(fo.accept_cls),
                "uncertainty": last_frame(fo.uncertainty)}

    return _make_step(loss_cfg, rois, rois_3d, bbox_means, bbox_stds,
                      compute_dtype, on_stage, train_bn, frozen_stats,
                      extract, dist)


def _make_step(loss_cfg, rois, rois_3d, bbox_means, bbox_stds, compute_dtype,
               on_stage, train_bn, frozen_stats, extract, dist):
    """The step body ``make_train_step`` and ``make_video_train_step``
    share; ``extract(out, batch)`` maps the model's output to the loss's
    outputs dict."""
    mark = on_stage if on_stage is not None else (lambda stage: None)
    frozen_stats = tuple(frozen_stats)
    world = dist.world if dist is not None and dist.active else 1

    def train_step(state: TrainState, batch):
        with span("step"):
            return _step(state, batch)

    def _step(state, batch):
        model = state.model
        model.train(train_bn)
        images = batch["images"]
        amp = (torch.autocast(images.device.type, dtype=compute_dtype)
               if compute_dtype is not None else contextlib.nullcontext())
        pinned = None
        if train_bn and frozen_stats:
            buffers = dict(model.named_buffers())
            pinned = [buffers[k] for k in frozen_stats]
            saved = [b.clone() for b in pinned]
        with amp:
            out = (model if state.ddp is None else state.ddp)(images)
        if pinned is not None:
            with torch.no_grad():
                torch._foreach_copy_(pinned, saved)
        mark("forward")
        gt = GTBatch(*(batch[name] for name in GTBatch._fields))
        with span("loss"):
            loss, stats, state.un_state = rpn_3d_loss(
                extract(out, batch), rois, rois_3d, gt, bbox_means,
                bbox_stds, state.un_state, loss_cfg, dist=dist)
        mark("loss")
        with span("backward"):
            state.optimizer.zero_grad()
            (loss * world if world > 1 else loss).backward()
            for name, p in getattr(state.ddp, "ignored_params", {}).items():
                if p.grad is not None:
                    raise RuntimeError(
                        f"{name} is in DDP's ignore list (unused_parameters) "
                        "but the loss reached it: its gradient would not be "
                        "reduced over the ranks")
        mark("backward")
        with span("optimizer"):
            state.optimizer.step()
        mark("optimizer")
        state.step += 1
        return {k: v.detach() for k, v in stats.items()}

    return train_step


def jitter_draws(rng_seed, step, b, distort_prob):
    """The photometric jitter's draws of train step ``step``, from a CPU
    generator seeded with ``(rng_seed + 1, step)`` mixed into one 32-bit
    seed (the CPU generator keeps 32 bits of its seed): a function of the
    seed and the step alone, so a resumed run draws what an uninterrupted
    one does (JAX folds the step into ``PRNGKey(rng_seed + 1)``; the streams
    differ, their keying is the same)."""
    seed = np.random.SeedSequence([rng_seed + 1, int(step)]).generate_state(1)
    gen = torch.Generator().manual_seed(int(seed[0]))
    return photometric_draws(gen, b, distort_prob)


def fuse_preprocess(step_fn, image_means, image_stds, *, target_h, crop_w,
                    distort_prob=0.0, rng_seed=0, out_dtype=None, video=False,
                    dist=None):
    """Fold the device-side preprocess into the step: the returned
    ``fused(state, raw)`` takes the loader's batch, ``{'images_u8': [B, H0,
    W0, 3] uint8, 'mirror': [B] bool, **GTBatch fields}``, resizes, crops or
    pads, flips and normalises the frames (in f32, then cast to
    ``out_dtype`` when given), and runs ``step_fn``.  ``image_means`` /
    ``image_stds`` are 3-vectors on the frames' device.

    With ``distort_prob > 0`` the frames get the photometric jitter of
    ``preprocess_images_train`` with the draws ``jitter_draws`` makes for
    ``rng_seed`` and ``state.step``, drawn on the CPU and copied to the
    frames' device without blocking.

    With ``video`` the frames are clips [B, F, H0, W0, 3]
    (``VideoTrainLoader``): preprocessed as B*F frames with each sample's
    mirror flag repeated for its F frames (a mirrored sample flips its
    whole clip), then shaped [B, F, 3, H, W].  Clips are not jittered, as
    in JAX.

    With ``dist`` the frames are this rank's rows of the global batch: the
    jitter is drawn for the global batch and the rank takes its rows
    (``local_rows``), so each frame gets the draw one process gives it.
    The preprocess is the program's span ``preprocess`` (``utils/spans.py``).
    """
    world = dist.world if dist is not None and dist.active else 1

    def fused(state, raw):
        with span("preprocess"):
            images = _images(state, raw)
        gt = {k: v for k, v in raw.items() if k not in ("images_u8", "mirror")}
        return step_fn(state, dict(images=images, **gt))

    def _images(state, raw):
        u8, mirror = raw["images_u8"], raw["mirror"]
        if video:
            b, f = u8.shape[:2]
            images = preprocess_images(
                u8.flatten(0, 1), mirror.repeat_interleave(f), image_means,
                image_stds, target_h=target_h, crop_w=crop_w,
                out_dtype=out_dtype).unflatten(0, (b, f))
        elif distort_prob > 0:
            draws = jitter_draws(rng_seed, state.step, u8.shape[0] * world,
                                 distort_prob)
            if world > 1:
                rows = local_rows(u8.shape[0] * world, dist.rank, world)
                draws = PhotometricDraws(*(t[rows] for t in draws))
            if u8.is_cuda:
                draws = PhotometricDraws(*(t.pin_memory() for t in draws))
            images = preprocess_images_train(
                u8, mirror, image_means, image_stds,
                draws.to(u8.device, non_blocking=True), target_h=target_h,
                crop_w=crop_w, distort_prob=distort_prob,
                out_dtype=out_dtype)
        else:
            images = preprocess_images(u8, mirror, image_means, image_stds,
                                       target_h=target_h, crop_w=crop_w,
                                       out_dtype=out_dtype)
        return images

    return fused
