"""Post-hoc depth and yaw refinement by 2D-3D projection consistency
(counterpart of ``groomed_nms_tpu/ops/refine.py``).

``hill_climb`` is a coordinate descent on (z, ry) for every box at once,
with a fixed budget of iterations: each iteration tries z -/+ its step, then
ry -/+ its step, takes the better candidate when it raises the overlap
between the 2D box and the projected cuboid by more than ``min_ol_dif``, and
halves the step when neither does.  Every step is a discrete choice, so the
candidates are computed with the same expressions the update uses.  The two
candidates of a direction are evaluated in one pass (stacked on a leading
axis); there is no host read inside the loop.

Boxes are ``[..., K]`` with a P2 of ``[..., 4, 4]`` for the leading axes:
``[4, 4]`` for ``[K]``, ``[B, 4, 4]`` for ``[B, K]`` (JAX maps the same
function over images).
"""

from __future__ import annotations

import torch

from .boxes import xywh_to_corners
from .geometry import (backproject_2d_points, get_corners_of_cuboid,
                       project_3d_points, snap_to_pi)
from .iou import elementwise_iou


def _consistency(p2, p2_inv, corners_box, x2d, y2d, z2d, w3d, h3d, l3d,
                 ry3d):
    """``projection_consistency`` on a box already in corner form; the box
    arguments broadcast (a leading candidate axis included)."""
    x3d, y3d, z3d = backproject_2d_points(p2_inv, x2d, y2d, z2d)
    corners = get_corners_of_cuboid(x3d, y3d, z3d, w3d, h3d, l3d, ry3d)
    proj = project_3d_points(p2.unsqueeze(-3), corners)
    invalid = (proj[..., 2, :] <= 0).any(-1)
    u, v = proj[..., 0, :], proj[..., 1, :]
    proj_box = torch.stack([u.amin(-1), v.amin(-1), u.amax(-1), v.amax(-1)],
                           dim=-1)
    ol = elementwise_iou(corners_box, proj_box)
    return torch.nan_to_num(ol, nan=0.0), invalid


def projection_consistency(p2, p2_inv, box_2d, x2d, y2d, z2d, w3d, h3d, l3d,
                           ry3d):
    """IoU between a 2D box ``box_2d`` [..., 4] as [x, y, w, h] and the
    projection of the 3D box decoded from its projected centre (x2d, y2d)
    at depth z2d.  Returns (overlap [...], invalid [...]): invalid when a
    cuboid corner falls behind the camera; a NaN overlap reads 0."""
    return _consistency(p2, p2_inv, xywh_to_corners(box_2d), x2d, y2d, z2d,
                        w3d, h3d, l3d, ry3d)


def _climb_step(val, step, ol, ol_c, inv_c, lim, min_ol_dif):
    """One direction of one iteration: the candidates ``val -/+ step``
    scored ``ol_c`` [2, ...] -> (val, ol, step) after the move or the
    halving."""
    ol_n, ol_p = ol_c
    inv_n, inv_p = inv_c
    go_p = ((ol_p - ol) > min_ol_dif) & (ol_p > ol_n) & ~inv_p
    go_n = ~go_p & ((ol_n - ol) > min_ol_dif) & ~inv_n
    active = step > lim
    up, down = active & go_p, active & go_n
    val = torch.where(up, val + step, torch.where(down, val - step, val))
    ol = torch.where(up, ol_p, torch.where(down, ol_n, ol))
    step = torch.where(active & ~(go_p | go_n), step * 0.5, step)
    return val, ol, step


def hill_climb(p2, p2_inv, box_2d, x2d, y2d, z2d, w3d, h3d, l3d, ry3d, *,
               step_z_init=1.0, step_r_init=0.3, z_lim=0.01, r_lim=0.01,
               min_ol_dif=0.0, max_steps=24):
    """Batched coordinate descent on (z, ry); box arguments [..., K].

    Returns (z2d refined, ry3d refined, overlap).  Boxes whose starting
    projection is invalid keep their inputs; the refined yaw is wrapped
    into (-pi, pi].
    """
    corners_box = xywh_to_corners(box_2d)

    def consistency(z, r):
        return _consistency(p2, p2_inv, corners_box, x2d, y2d, z, w3d, h3d,
                            l3d, r)

    ol0, invalid0 = consistency(z2d, ry3d)
    z, r, ol = z2d, ry3d, ol0
    sz = torch.full_like(z2d, step_z_init)
    sr = torch.full_like(z2d, step_r_init)
    for _ in range(max_steps):
        ol_c, inv_c = consistency(torch.stack([z - sz, z + sz]), r)
        z, ol, sz = _climb_step(z, sz, ol, ol_c, inv_c, z_lim, min_ol_dif)
        ol_c, inv_c = consistency(z, torch.stack([r - sr, r + sr]))
        r, ol, sr = _climb_step(r, sr, ol, ol_c, inv_c, r_lim, min_ol_dif)
    z_out = torch.where(invalid0, z2d, z)
    r_out = snap_to_pi(torch.where(invalid0, ry3d, r))
    ol_out = torch.where(invalid0, ol0, ol)
    return z_out, r_out, ol_out
