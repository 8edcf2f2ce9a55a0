"""Cuboid corners, camera projection and orientation conversions
(counterpart of ``groomed_nms_tpu/ops/geometry.py``).

KITTI camera frame: X right, Y down, Z forward.  Corner numbering is the
reference's ``iou_3d_convention``: corners 2, 3, 6, 7 are the bottom face.
"""

from __future__ import annotations

import math

import torch


# unit-cube corner offsets: l3d along X on corners 1, 3, 5, 6, h3d along Y
# on 2, 3, 6, 7, w3d along Z on 4, 5, 6, 7
_CORNER_SIGNS = ((-1.0, 1.0, -1.0, 1.0, -1.0, 1.0, 1.0, -1.0),
                 (-1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0),
                 (-1.0, -1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0))
_corner_signs_cache = {}


def _corner_signs(device, dtype):
    """The [3, 8] corner signs as a constant of ``device`` and ``dtype``,
    copied there once: a copy on every call would queue a host-to-device
    transfer in loops that run the corners many times (the hill-climb, the
    tracker) and stand in the way of capturing them in a CUDA graph."""
    key = (device, dtype)
    signs = _corner_signs_cache.get(key)
    if signs is None:
        # non-blocking: a blocking copy to the card would wait for it
        signs = torch.tensor(_CORNER_SIGNS, dtype=dtype).to(
            device, non_blocking=True)
        if type(signs) is torch.Tensor:     # not a tracer's fake tensor
            _corner_signs_cache[key] = signs
    return signs


def get_corners_of_cuboid(x3d, y3d, z3d, w3d, h3d, l3d, ry3d):
    """Corners [..., 3, 8] of cuboids rotated by ``ry3d`` about camera Y:
    l3d spans X, h3d spans Y, w3d spans Z, then R_y and the translation.
    The arguments broadcast against each other."""
    sx, sy, sz = _corner_signs(x3d.device, x3d.dtype)
    lx = 0.5 * l3d[..., None] * sx
    ly = 0.5 * h3d[..., None] * sy
    lz = 0.5 * w3d[..., None] * sz
    c, s = torch.cos(ry3d)[..., None], torch.sin(ry3d)[..., None]
    gx = c * lx + s * lz + x3d[..., None]
    gy = ly + y3d[..., None]
    gz = -s * lx + c * lz + z3d[..., None]
    return torch.stack(torch.broadcast_tensors(gx, gy, gz), dim=-2)


def backproject_2d_points(p2_inv, x2d, y2d, z2d):
    """Lift image points (u, v) at depth z back to the camera frame:
    ``P2^-1 @ [u z, v z, z, 1]``, with ``p2_inv`` [..., 4, 4] broadcast
    over the points' leading axes as ``project_3d_points`` broadcasts P2
    ([4, 4] for points [N], [B, 4, 4] for points [B, N]).  Returns
    (x3d, y3d, z3d).  Products and a sum, so no TF32 matmul can enter."""
    pts = torch.stack([x2d * z2d, y2d * z2d, z2d, torch.ones_like(z2d)],
                      dim=-1)
    cam = (p2_inv.unsqueeze(-3) * pts[..., None, :]).sum(-1)
    return cam[..., 0], cam[..., 1], cam[..., 2]


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


def project_3d_points(p2, points_3d):
    """Project camera-frame points [..., 3, N] through a 4x4 ``p2``
    (broadcast over leading axes) -> [..., 3, N] of (u, v, z); the
    homogeneous divide is skipped where |z| <= 1e-2.  The contraction is
    written as products and a sum, so no TF32 matmul can enter."""
    pts4 = torch.cat([points_3d, torch.ones_like(points_3d[..., :1, :])],
                     dim=-2)
    proj = (p2[..., :, :, None] * pts4[..., None, :, :]).sum(-2)
    z = proj[..., 2:3, :]
    far = z.abs() > 1e-2
    uv = torch.where(far, proj[..., :2, :] / torch.where(far, z, 1.0),
                     proj[..., :2, :])
    return torch.cat([uv, z], dim=-2)


def project_3d_box(p2, x3d, y3d, z3d, w3d, h3d, l3d, ry3d):
    """[..., 4] = [x1, y1, x2, y2]: the 2D box enclosing a cuboid's eight
    projected corners."""
    proj = project_3d_points(p2, get_corners_of_cuboid(x3d, y3d, z3d, w3d,
                                                       h3d, l3d, ry3d))
    u, v = proj[..., 0, :], proj[..., 1, :]
    return torch.stack([u.amin(-1), v.amin(-1), u.amax(-1), v.amax(-1)],
                       dim=-1)
