"""Faults planted under the timed path, to show that ``correct`` catches
them: the tests plant each at a tiny size on the CPU, ``calibrate.py
--fault`` at a cell's own size on the card.

* ``altered_row``: one served row's depth scaled by 1.01 where it is made.
* ``half_batch_served``: the rows of the second half of each batch
  replaced by those of the first half.
* ``half_batch_trained``: the loss taken over the first half of the batch
  only, its mean over those images.
* ``state_unchanged``: the optimizer's step leaves the parameters as they
  were.
* ``momentum_dropped``: the optimizer built with momentum 0, so that only
  the steps after the first differ.
"""

from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = ("altered_row", "half_batch_served", "half_batch_trained",
          "state_unchanged", "momentum_dropped")


def _rows(fn):
    import groomed_nms_torch.eval.tester as tester
    orig = tester.im_detect_3d

    def broken(*a, **k):
        dets, valid = orig(*a, **k)
        return fn(dets.clone()), valid

    return mock.patch.object(tester, "im_detect_3d", broken)


def _alter(dets):
    dets[0, 0, 15] *= 1.01
    return dets


def _halve(dets):
    h = dets.shape[0] // 2
    dets[h:] = dets[:h]
    return dets


def _half_loss():
    import groomed_nms_torch.training.trainer as trainer
    from groomed_nms_torch.losses.rpn_3d import GTBatch
    orig = trainer.rpn_3d_loss

    def half(outputs, rois, rois_3d, gt, *a, **k):
        h = gt.gts_2d.shape[0] // 2
        out = {n: None if v is None else v[:h] for n, v in outputs.items()}
        return orig(out, rois, rois_3d, GTBatch(*(t[:h] for t in gt)),
                    *a, **k)

    return mock.patch.object(trainer, "rpn_3d_loss", half)


def plant(name):
    """A context manager with the fault ``name`` planted (None: none)."""
    if name is None:
        return contextlib.nullcontext()
    if name == "altered_row":
        return _rows(_alter)
    if name == "half_batch_served":
        return _rows(_halve)
    if name == "half_batch_trained":
        return _half_loss()
    if name == "state_unchanged":
        import groomed_nms_torch.training.trainer as trainer
        return mock.patch.object(trainer.ClippedOptimizer, "step",
                                 lambda self: True)
    if name == "momentum_dropped":
        import groomed_nms_torch.training.trainer as trainer
        orig = trainer.build_optimizer
        return mock.patch.object(
            trainer, "build_optimizer",
            lambda *a, **k: orig(*a, **{**k, "momentum": 0.0}))
    raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
