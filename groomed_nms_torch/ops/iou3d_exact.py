"""Exact rotated-BEV and 3D IoU on the host, numpy (the port's copy of
``groomed_nms_tpu/ops/iou3d_exact.py``).

The footprints' intersection is Sutherland-Hodgman convex clipping, the
arithmetic of the C++ evaluator (``eval/kitti_eval.cpp``): scalar, not
differentiable, the oracle for ``ops/iou.py::iou3d_approximate`` and for
analyses.
"""

from __future__ import annotations

import math

import numpy as np


def _poly_area(p):
    x, z = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(z, -1)) - np.dot(z, np.roll(x, -1)))


def _clip(poly, a, b):
    """Clip polygon by the half-plane left of a->b (CCW clipper edge)."""
    out = []
    n = len(poly)
    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        sc = (b[0] - a[0]) * (cur[1] - a[1]) - (b[1] - a[1]) * (cur[0] - a[0])
        sn = (b[0] - a[0]) * (nxt[1] - a[1]) - (b[1] - a[1]) * (nxt[0] - a[0])
        if sc >= 0:
            out.append(cur)
        if (sc > 0 > sn) or (sc < 0 < sn):
            t = sc / (sc - sn)
            out.append(cur + t * (nxt - cur))
    return out


def _convex_intersection_area(pa, pb):
    poly = [np.asarray(p, np.float64) for p in pa]
    for i in range(len(pb)):
        if not poly:
            return 0.0
        poly = _clip(poly, np.asarray(pb[i]), np.asarray(pb[(i + 1) % len(pb)]))
    return _poly_area(np.asarray(poly)) if len(poly) >= 3 else 0.0


def bev_footprint(x3d, z3d, w3d, l3d, ry3d):
    """CCW rotated footprint corners [(x, z) x 4]."""
    c, s = math.cos(ry3d), math.sin(ry3d)
    lx = 0.5 * l3d * np.array([-1, 1, 1, -1])
    wz = 0.5 * w3d * np.array([-1, -1, 1, 1])
    xs = c * lx + s * wz + x3d
    zs = -s * lx + c * wz + z3d
    pts = np.stack([xs, zs], axis=1)
    # ensure CCW
    if _signed_area(pts) < 0:
        pts = pts[::-1]
    return pts


def _signed_area(p):
    x, z = p[:, 0], p[:, 1]
    return 0.5 * (np.dot(x, np.roll(z, -1)) - np.dot(z, np.roll(x, -1)))


def iou_bev_exact(box_a, box_b):
    """Exact rotated BEV IoU. box = (x3d, z3d, w3d, l3d, ry3d)."""
    pa = bev_footprint(*box_a)
    pb = bev_footprint(*box_b)
    inter = _convex_intersection_area(pa, pb)
    ua = _poly_area(pa) + _poly_area(pb) - inter
    return inter / max(ua, 1e-12)


def iou3d_exact(box_a, box_b):
    """Exact 3D IoU. box = (x3d, y3d, z3d, w3d, h3d, l3d, ry3d).

    y3d is the cuboid *center* (imdb convention); vertical overlap spans
    [y - h/2, y + h/2].
    """
    xa, ya, za, wa, ha, la, ra = box_a
    xb, yb, zb, wb, hb, lb, rb = box_b
    pa = bev_footprint(xa, za, wa, la, ra)
    pb = bev_footprint(xb, zb, wb, lb, rb)
    inter_bev = _convex_intersection_area(pa, pb)
    y_ov = max(0.0, min(ya + ha / 2, yb + hb / 2)
               - max(ya - ha / 2, yb - hb / 2))
    inter = inter_bev * y_ov
    union = wa * ha * la + wb * hb * lb - inter
    return inter / max(union, 1e-12)
