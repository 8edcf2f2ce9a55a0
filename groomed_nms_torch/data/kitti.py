"""KITTI file parsers (host-side numpy, run once per dataset build).

A copy of ``groomed_nms_tpu/data/kitti.py`` (the JAX package's
``data/__init__.py`` imports JAX, so the port keeps its own):

* ``read_kitti_calib`` -- P2 as a 4x4 (row 3 = [0,0,0,1]).
* ``read_kitti_poses`` -- an odometry pose file as a list of 4x4 matrices.
* ``read_kitti_label`` -- parses label rows into a struct-of-arrays dict;
  re-centers cy3d by -h/2, recomputes alpha from rotY, optionally regenerates
  the 2D box from the projected 3D cuboid (``use_3d_for_2d``), and computes
  the decomposed-alpha targets (alpha_sin, alpha_cos, axis_lbl, head_lbl).

The ``bbox_3d`` row layout (16 cols) is the contract consumed by the loss
and anchor-prior code:
  [cx, cy, cz2d, w3d, h3d, l3d, alpha, cx3d, cy3d, cz3d, rotY, elev,
   alpha_sin, alpha_cos, axis_lbl, head_lbl]
"""

from __future__ import annotations

import math

import numpy as np


def read_kitti_calib(path):
    """Parse the P2 projection matrix from a KITTI calib file -> [4, 4]."""
    p2 = None
    with open(path) as f:
        for line in f:
            if line.startswith("P2:") or line.startswith("P2 "):
                vals = [float(v) for v in line.split()[1:13]]
                p2 = np.zeros((4, 4), np.float64)
                p2[:3, :] = np.array(vals).reshape(3, 4)
                p2[3, 3] = 1.0
    if p2 is None:
        raise ValueError(f"no P2 entry in {path}")
    return p2


def read_kitti_poses(path):
    """Parse a KITTI odometry pose file -> list of 4x4 matrices."""
    poses = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) != 12:
                continue
            p = np.zeros((4, 4), np.float64)
            p[:3, :] = np.array(vals).reshape(3, 4)
            p[3, 3] = 1.0
            poses.append(p)
    return poses


def _snap(theta, lo, hi):
    period = hi - lo
    while theta > hi:
        theta -= period
    while theta <= lo:
        theta += period
    return theta


def rot_y_to_alpha(ry3d, z3d, x3d):
    """Scalar rotY -> alpha (reference lib/util.py:657-679)."""
    alpha = ry3d - math.atan2(-z3d, x3d) - 0.5 * math.pi
    return _snap(alpha, -math.pi, math.pi)


def decompose_alpha(alpha):
    """(alpha_sin, alpha_cos, axis_lbl, head_lbl) for one observation angle.

    Reference lib/imdb_util.py:838-862: ``alpha_sin`` wrapped to
    (-pi/2, pi/2], ``alpha_cos`` to (-pi, 0]; ``axis_lbl`` = 1 when
    |sin| < |cos| (more horizontal -> regress sin); ``head_lbl`` = 1 when the
    wrapped angle needs a +pi flip to recover alpha.
    """
    alpha_sin = _snap(alpha, -math.pi / 2, math.pi / 2)
    alpha_cos = _snap(alpha, -math.pi, 0.0)
    axis_lbl = float(abs(math.sin(alpha)) < abs(math.cos(alpha)))
    branch = alpha_sin if axis_lbl == 1 else alpha_cos
    flipped = _snap(branch + math.pi, -math.pi, math.pi)
    head_lbl = float(abs(flipped - alpha) < abs(branch - alpha))
    return alpha_sin, alpha_cos, axis_lbl, head_lbl


def _project_cuboid_verts(p2, cx, cy, cz, w3d, h3d, l3d, ry):
    """Project the 8 cuboid corners; returns (verts [8, 2], depths [8])."""
    c, s = math.cos(ry), math.sin(ry)
    xs = 0.5 * l3d * np.array([-1, 1, -1, 1, -1, 1, 1, -1], np.float64)
    ys = 0.5 * h3d * np.array([-1, -1, 1, 1, -1, -1, 1, 1], np.float64)
    zs = 0.5 * w3d * np.array([-1, -1, -1, -1, 1, 1, 1, 1], np.float64)
    gx = c * xs + s * zs + cx
    gy = ys + cy
    gz = -s * xs + c * zs + cz
    pts = np.stack([gx, gy, gz, np.ones(8)], axis=0)
    proj = p2 @ pts
    depths = proj[2]
    safe = np.where(np.abs(depths) > 1e-8, depths, 1.0)
    verts = (proj[:2] / safe).T
    return verts, depths


def read_kitti_label(path, p2, use_3d_for_2d=False):
    """Parse one label file into a struct-of-arrays dict.

    Returns dict with keys:
      cls [N] object class strings; trunc, occ, visibility [N];
      ign [N] bool (3D box behind camera when regenerating 2D from 3D);
      alpha, rotY [N]; bbox_full [N, 4] (x, y, w, h);
      bbox_3d [N, 16] (layout in module docstring); center_3d [N, 3];
      track [N] int (-1 when absent).
    """
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 15:
                continue
            try:
                vals = [float(v) for v in parts[1:15]]
            except ValueError:
                continue
            rows.append((parts[0], vals,
                         int(parts[15]) if len(parts) > 15 and
                         parts[15].lstrip("-").isdigit() else -1))

    n = len(rows)
    out = {
        "cls": np.array([r[0] for r in rows], dtype=object),
        "trunc": np.zeros(n), "occ": np.zeros(n), "visibility": np.zeros(n),
        "ign": np.zeros(n, bool), "alpha": np.zeros(n), "rotY": np.zeros(n),
        "bbox_full": np.zeros((n, 4)), "bbox_3d": np.zeros((n, 16)),
        "center_3d": np.zeros((n, 3)),
        "track": np.array([r[2] for r in rows], dtype=np.int64).reshape(n),
    }

    for i, (_, v, _) in enumerate(rows):
        trunc, occ = v[0], v[1]
        x, y, x2, y2 = v[3], v[4], v[5], v[6]
        h3d, w3d, l3d = v[7], v[8], v[9]
        cx3d, cy3d, cz3d, rot_y = v[10], v[11], v[12], v[13]

        elevation = cy3d
        cy3d -= h3d / 2.0              # bottom -> center (imdb convention)
        width, height = x2 - x + 1, y2 - y + 1
        ign = False

        if use_3d_for_2d and h3d > 0 and w3d > 0 and l3d > 0:
            verts, depths = _project_cuboid_verts(p2, cx3d, cy3d, cz3d,
                                                  w3d, h3d, l3d, rot_y)
            if np.any(depths <= 0):
                ign = True
            else:
                x, y = verts[:, 0].min(), verts[:, 1].min()
                x2, y2 = verts[:, 0].max(), verts[:, 1].max()
                width, height = x2 - x + 1, y2 - y + 1

        coord3d = p2 @ np.array([cx3d, cy3d, cz3d, 1.0])
        cz2d = coord3d[2]
        cx2d = coord3d[0] / cz2d
        cy2d = coord3d[1] / cz2d

        vis = {0: 1.0, 1: 0.66, 2: 0.33}.get(int(occ), 0.0)
        rot_y = _snap(rot_y, -math.pi, math.pi)
        alpha = rot_y_to_alpha(rot_y, cz3d, cx3d)
        a_sin, a_cos, axis_lbl, head_lbl = decompose_alpha(alpha)

        out["trunc"][i] = trunc
        out["occ"][i] = occ
        out["visibility"][i] = vis
        out["ign"][i] = ign
        out["alpha"][i] = alpha
        out["rotY"][i] = rot_y
        out["bbox_full"][i] = [x, y, width, height]
        out["bbox_3d"][i] = [cx2d, cy2d, cz2d, w3d, h3d, l3d, alpha,
                             cx3d, cy3d, cz3d, rot_y, elevation,
                             a_sin, a_cos, axis_lbl, head_lbl]
        out["center_3d"][i] = [cx3d, cy3d, cz3d]
    return out
