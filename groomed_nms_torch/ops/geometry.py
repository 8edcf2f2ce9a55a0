"""Orientation conversions (counterpart of ``groomed_nms_tpu/ops/geometry.py``).

KITTI camera frame: X right, Y down, Z forward.
"""

from __future__ import annotations

import math

import torch


def snap_to_pi(theta):
    """Wrap angles into (-pi, pi].

    ``torch.remainder`` is the floored modulo (result takes the divisor's
    sign), like ``jnp.mod``; ``torch.fmod`` would keep the dividend's sign.
    The modulo maps +pi to -pi, so -pi is moved back to +pi.
    """
    wrapped = torch.remainder(theta + math.pi, 2 * math.pi) - math.pi
    return torch.where(wrapped <= -math.pi, wrapped + 2 * math.pi, wrapped)


def alpha_to_rot_y(alpha, z3d, x3d):
    """Observation angle alpha -> global yaw rotY."""
    return snap_to_pi(alpha + torch.atan2(-z3d, x3d) + 0.5 * math.pi)


def rot_y_to_alpha(ry3d, z3d, x3d):
    """Global yaw rotY -> observation angle alpha."""
    return snap_to_pi(ry3d - torch.atan2(-z3d, x3d) - 0.5 * math.pi)
