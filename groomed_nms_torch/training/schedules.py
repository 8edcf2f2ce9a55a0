"""Learning-rate policies: poly (power 0.9), step decay, optional warmup
(counterpart of ``groomed_nms_tpu/training/schedules.py``).

A schedule is a function of the step index, computed in f32 as the JAX
schedule is, returned as a Python float for the optimizer's update.
"""

from __future__ import annotations

import numpy as np


def build_lr_schedule(lr, max_iter, policy="poly", lr_target=None,
                      lr_steps=None, power=0.9, warmup_iters=0,
                      warmup_factor=0.1):
    """Returns schedule(step) -> lr.

    poly: lr_target + (lr - lr_target) * (1 - step/max_iter)^power
    step: lr * 0.1^(number of lr_steps fractions passed)
    Warmup ramps linearly from warmup_factor*lr over warmup_iters.
    """
    if policy not in ("poly", "step"):
        raise NotImplementedError(policy)
    if lr_target is None:
        lr_target = lr * 1e-5

    def schedule(step):
        step = np.float32(step)
        if policy == "poly":
            frac = np.clip(step / np.float32(max_iter), 0.0, 1.0)
            base = lr_target + (lr - lr_target) * (1.0 - frac) ** power
        else:
            drops = np.float32(sum(step >= s * max_iter
                                   for s in (lr_steps or [])))
            base = lr * np.float32(0.1) ** drops
        if warmup_iters > 0 and step < warmup_iters:
            ramp = np.clip(step / np.float32(warmup_iters), 0.0, 1.0)
            base = base * (warmup_factor + (1.0 - warmup_factor) * ramp)
        return float(np.float32(base))

    return schedule
