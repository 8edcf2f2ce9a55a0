"""The optimizer, the train state and the train step (counterpart of
``groomed_nms_tpu/training/trainer.py``).

* ``build_optimizer``: SGD in the reference's order -- clip each gradient
  element to [-clip, clip], add ``weight_decay * param``, momentum
  ``buf = g + momentum * buf``, then ``param -= lr(step) * buf`` with the
  step count starting at 0 (optax's ``clip``, ``add_decayed_weights``,
  ``trace``, ``scale_by_learning_rate``).  With ``batch_skip = k > 1`` the
  gradients accumulate as a running SUM clipped after every micro-step, and
  every k-th micro-step applies the update to that sum with the LR of the
  global iteration, ``lr(a * k + k - 1)`` for the a-th update (the
  reference's ``loss_backprop`` / ``adjust_lr``).
* ``make_train_step``: forward (BatchNorm in train mode, bf16 autocast when
  asked), ``rpn_3d_loss`` in f32, backward, optimizer step.
* ``fuse_preprocess``: uint8 frames + mirror flags -> the step.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import torch

from ..data.augment import preprocess_images
from ..losses.rpn_3d import GTBatch, LossConfig, UncertaintyState, rpn_3d_loss


class ClippedSGD:
    """SGD with momentum, weight decay, element-wise gradient clipping and
    clipped-sum gradient accumulation; see the module docstring.

    ``step()`` reads each parameter's ``.grad`` (a parameter without one
    counts as a zero gradient, as JAX's gradient of an unused parameter is)
    and returns True when it updated the parameters.  The per-parameter
    updates run as ``torch._foreach_*`` ops, one launch per op and list.
    """

    def __init__(self, params, lr_schedule, *, momentum=0.9,
                 weight_decay=0.0005, clip_value=1.0, batch_skip=1):
        self.params = [p for p in params]
        self.lr_schedule = lr_schedule if callable(lr_schedule) \
            else (lambda step: lr_schedule)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_value = clip_value
        self.batch_skip = int(batch_skip) if batch_skip else 1
        self.count = 0                  # applied updates
        self.mini_step = 0              # micro-steps (batch_skip > 1)
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] \
            if self.batch_skip > 1 else None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _clip(self, tensors):
        if self.clip_value:
            torch._foreach_clamp_min_(tensors, -self.clip_value)
            torch._foreach_clamp_max_(tensors, self.clip_value)

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
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        torch._foreach_add_(self.params, self.trace, alpha=-lr)
        if k > 1:
            torch._foreach_zero_(self.acc)
        self.count += 1
        return True


def build_optimizer(params, solver_type="sgd", lr_schedule=None,
                    momentum=0.9, weight_decay=0.0005, clip_value=1.0,
                    batch_skip=1):
    """The reference's optimizer over ``params``; ``lr_schedule`` is a
    function of the update count (``training.schedules``) or a float.
    Only "sgd" is ported."""
    if solver_type != "sgd":
        raise NotImplementedError(
            f"solver_type={solver_type!r} is not ported to groomed_nms_torch "
            "(ROADMAP.md, queue 1); every shipped config uses 'sgd'")
    return ClippedSGD(params, lr_schedule, momentum=momentum,
                      weight_decay=weight_decay, clip_value=clip_value,
                      batch_skip=batch_skip)


@dataclass
class TrainState:
    """What a train step updates in place: the model (parameters and
    BatchNorm statistics), the optimizer, the self-balancing lambda and the
    step count."""

    model: torch.nn.Module
    optimizer: Any
    un_state: UncertaintyState
    step: int = 0


def make_train_step(loss_cfg: LossConfig, rois, rois_3d, bbox_means,
                    bbox_stds, compute_dtype=None, on_stage=None):
    """Build ``train_step(state, batch) -> stats``.

    ``batch`` holds 'images' [B, 3, H, W] (normalised, on the model's
    device) and the ``GTBatch`` fields as tensors on the same device.  The
    model runs in train mode (BatchNorm on batch statistics, updating its
    running ones), under ``torch.autocast`` in ``compute_dtype`` when one is
    given (parameters and BatchNorm stay f32); the loss runs in f32 outside
    autocast.  The step updates ``state`` in place and returns the loss's
    stats dict of 0-dim tensors (nothing is read back to the host).
    ``on_stage``, when given, is called with "forward", "loss", "backward"
    and "optimizer" as each stage has been issued (a timer's hook).
    """
    mark = on_stage if on_stage is not None else (lambda stage: None)

    def train_step(state: TrainState, batch):
        model = state.model
        model.train()
        images = batch["images"]
        amp = (torch.autocast(images.device.type, dtype=compute_dtype)
               if compute_dtype is not None else contextlib.nullcontext())
        with amp:
            out = model(images)
        mark("forward")
        outputs = {"cls": out.cls, "prob": out.prob, "bbox_2d": out.bbox_2d,
                   "bbox_3d": out.bbox_3d, "accept_prob": out.accept_prob,
                   "accept_cls": out.accept_cls}
        gt = GTBatch(*(batch[name] for name in GTBatch._fields))
        loss, stats, state.un_state = rpn_3d_loss(
            outputs, rois, rois_3d, gt, bbox_means, bbox_stds,
            state.un_state, loss_cfg)
        mark("loss")
        state.optimizer.zero_grad()
        loss.backward()
        mark("backward")
        state.optimizer.step()
        mark("optimizer")
        state.step += 1
        return {k: v.detach() for k, v in stats.items()}

    return train_step


def fuse_preprocess(step_fn, image_means, image_stds, *, target_h, crop_w,
                    distort_prob=0.0):
    """Fold the device-side preprocess into the step: the returned
    ``fused(state, raw)`` takes the loader's batch, ``{'images_u8': [B, H0,
    W0, 3] uint8, 'mirror': [B] bool, **GTBatch fields}``, resizes, crops or
    pads, flips and normalises the frames, and runs ``step_fn``.
    ``image_means`` / ``image_stds`` are 3-vectors on the frames' device.
    Photometric jitter (``distort_prob > 0``) is not ported.
    """
    if distort_prob > 0:
        raise NotImplementedError(
            "distort_prob > 0 (photometric jitter) is not ported to "
            "groomed_nms_torch (ROADMAP.md, queue 1)")

    def fused(state, raw):
        images = preprocess_images(raw["images_u8"], raw["mirror"],
                                   image_means, image_stds,
                                   target_h=target_h, crop_w=crop_w)
        gt = {k: v for k, v in raw.items() if k not in ("images_u8", "mirror")}
        return step_fn(state, dict(images=images, **gt))

    return fused
