"""Cuboid corners and orientation conversions (counterpart of
``groomed_nms_tpu/ops/geometry.py``).

KITTI camera frame: X right, Y down, Z forward.  Corner numbering is the
reference's ``iou_3d_convention``: corners 2, 3, 6, 7 are the bottom face.
"""

from __future__ import annotations

import math

import torch


# unit-cube corner offsets: l3d along X on corners 1, 3, 5, 6, h3d along Y
# on 2, 3, 6, 7, w3d along Z on 4, 5, 6, 7
_SIGNS_X = (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0, 1.0, -1.0)
_SIGNS_Y = (-1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0)
_SIGNS_Z = (-1.0, -1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0)


def get_corners_of_cuboid(x3d, y3d, z3d, w3d, h3d, l3d, ry3d):
    """Corners [..., 3, 8] of cuboids rotated by ``ry3d`` about camera Y:
    l3d spans X, h3d spans Y, w3d spans Z, then R_y and the translation."""
    def signs(values):
        # non-blocking: a blocking copy to the card would wait for it
        return torch.tensor(values, dtype=x3d.dtype).to(x3d.device,
                                                         non_blocking=True)

    lx = 0.5 * l3d[..., None] * signs(_SIGNS_X)
    ly = 0.5 * h3d[..., None] * signs(_SIGNS_Y)
    lz = 0.5 * w3d[..., None] * signs(_SIGNS_Z)
    c, s = torch.cos(ry3d)[..., None], torch.sin(ry3d)[..., None]
    gx = c * lx + s * lz + x3d[..., None]
    gy = ly + y3d[..., None]
    gz = -s * lx + c * lz + z3d[..., None]
    return torch.stack([gx, gy, gz], dim=-2)


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
