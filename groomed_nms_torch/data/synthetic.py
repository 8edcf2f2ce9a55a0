"""Synthetic KITTI tree generator at real resolution, still images only.

The port's copy of ``groomed_nms_tpu/data/synthetic.py::make_synthetic_kitti``
with its helpers: the same RNG stream gives the same labels and calib files,
byte for byte, and the same pixels, written by ``data/png.py`` instead of
Pillow (the GPU machine has none).  The video tree waits for the video
slice.

Geometry is exact: the 2D box is the projection of the 3D cuboid's eight
corners through the generated P2, so 2D evidence, 3D labels and calibration
are mutually consistent.
"""

from __future__ import annotations

import os

import numpy as np

from .png import read_png, write_png

# KITTI camera-2 intrinsics (magnitudes of the real devkit calibration)
_FX, _FY = 721.5377, 721.5377
_CX, _CY = 609.5593, 172.8540
_TX, _TY, _TZ = 44.85728, 0.2163791, 0.002745884

CLASS_DIMS = {  # h3d, w3d, l3d means (KITTI label conventions, meters)
    "Car": (1.53, 1.63, 3.88),
    "Pedestrian": (1.76, 0.66, 0.84),
    "Cyclist": (1.74, 0.60, 1.76),
    "Van": (2.21, 1.90, 5.08),
}
CLASS_COLOR = {  # paint family so classes are visually separable
    "Car": (200, 60, 60),
    "Pedestrian": (60, 200, 60),
    "Cyclist": (60, 60, 220),
    "Van": (200, 160, 40),
}


def kitti_p2(im_w=1242, im_h=375):
    """P2 with principal point scaled to the requested resolution."""
    sx, sy = im_w / 1242.0, im_h / 375.0
    return np.array([
        [_FX * sx, 0.0, _CX * sx, _TX * sx],
        [0.0, _FY * sy, _CY * sy, _TY * sy],
        [0.0, 0.0, 1.0, _TZ],
    ], np.float64)


def _project_cuboid(p2, x3d, y3d, z3d, w3d, h3d, l3d, ry):
    """2D AABB of the 3D box's 8 corners (y3d = box BOTTOM, KITTI labels).

    Same corner/rotation construction as
    ops/geometry.py::get_corners_of_cuboid + project_3d_box, with the
    label-space bottom-anchored y (center = y3d - h3d/2).
    """
    c, s = np.cos(ry), np.sin(ry)
    xs = np.array([l3d, l3d, -l3d, -l3d, l3d, l3d, -l3d, -l3d]) / 2.0
    ys = np.array([0, 0, 0, 0, -h3d, -h3d, -h3d, -h3d])
    zs = np.array([w3d, -w3d, -w3d, w3d, w3d, -w3d, -w3d, w3d]) / 2.0
    cx = c * xs + s * zs + x3d
    cz = -s * xs + c * zs + z3d
    cy = ys + y3d
    pts = p2 @ np.stack([cx, cy, cz, np.ones(8)])
    u, v = pts[0] / pts[2], pts[1] / pts[2]
    return u.min(), v.min(), u.max(), v.max()


def _paint(img, x1, y1, x2, y2, color, rng, depth):
    """Fill the box with a depth-shaded class color + texture so the net
    has brightness AND scale cues tied to z3d."""
    xi1, yi1 = int(max(x1, 0)), int(max(y1, 0))
    xi2 = int(min(x2, img.shape[1] - 1))
    yi2 = int(min(y2, img.shape[0] - 1))
    if xi2 <= xi1 or yi2 <= yi1:
        return
    shade = np.clip(1.25 - depth / 60.0, 0.45, 1.25)
    base = np.clip(np.asarray(color, np.float64) * shade, 0, 255)
    patch = base[None, None] + rng.normal(0, 10, (yi2 - yi1, xi2 - xi1, 3))
    img[yi1:yi2, xi1:xi2] = np.clip(patch, 0, 255).astype(np.uint8)


def _background(rng, im_h, im_w):
    """Sky->road vertical gradient + mild noise (compresses well as PNG)."""
    t = np.linspace(0.0, 1.0, im_h)[:, None, None]
    sky = np.array([120.0, 140.0, 165.0])
    road = np.array([85.0, 85.0, 88.0])
    img = sky * (1 - t) + road * t + rng.normal(0, 6, (im_h, im_w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def make_synthetic_kitti(root, split, n_images, im_h=375, im_w=1242, seed=0,
                         max_objects=6, classes=("Car",), progress=None):
    """Write ``n_images`` KITTI records under ``root/split/{image_2,calib,
    label_2}``.

    Each record holds 1..max_objects projection-consistent objects (plus an
    occasional Van as ignore-class material and a DontCare strip), with
    truncation computed from the actual image-plane clipping so
    determine_ignores (reference lib/imdb_util.py:852-876) sees realistic
    values.
    """
    rng = np.random.default_rng(seed)
    for sub in ("image_2", "calib", "label_2"):
        os.makedirs(os.path.join(root, split, sub), exist_ok=True)
    p2 = kitti_p2(im_w, im_h)
    cal_line = "P2: " + " ".join(f"{v:.12e}" for v in p2.reshape(-1)) + "\n"

    def draw_world():
        n = int(rng.integers(1, max_objects + 1))
        objs = []
        for _ in range(n):
            cls = classes[int(rng.integers(0, len(classes)))]
            h3, w3, l3 = CLASS_DIMS[cls]
            h3 *= rng.uniform(0.85, 1.15)
            w3 *= rng.uniform(0.85, 1.15)
            l3 *= rng.uniform(0.85, 1.15)
            z = rng.uniform(6.0, 48.0)
            x = rng.uniform(-0.05 * z - 6.0, 0.05 * z + 6.0)
            y = 1.65 + rng.normal(0, 0.05)  # box bottom on the ground plane
            ry = rng.uniform(-np.pi, np.pi)
            objs.append([cls, x, y, z, w3, h3, l3, ry])
        if rng.random() < 0.3:  # ignore-class material
            h3, w3, l3 = CLASS_DIMS["Van"]
            objs.append(["Van", rng.uniform(-6, 6), 1.65,
                         rng.uniform(10, 40), w3, h3, l3,
                         rng.uniform(-np.pi, np.pi)])
        return objs

    for i in range(n_images):
        iid = f"{i:06d}"
        world = draw_world()
        img = _background(rng, im_h, im_w)
        lines = []
        # far-to-near paint order = near objects occlude far ones
        for cls, x, y, z, w3, h3, l3, ry in sorted(
                world, key=lambda o: -o[3]):
            x1, y1, x2, y2 = _project_cuboid(p2, x, y, z, w3, h3, l3, ry)
            cx1, cy1 = max(x1, 0.0), max(y1, 0.0)
            cx2, cy2 = min(x2, im_w - 1.0), min(y2, im_h - 1.0)
            if cx2 - cx1 < 8 or cy2 - cy1 < 8:
                continue  # fully/too clipped: unusable evidence
            area = (x2 - x1) * (y2 - y1)
            trunc = 1.0 - (cx2 - cx1) * (cy2 - cy1) / max(area, 1e-6)
            _paint(img, cx1, cy1, cx2, cy2, CLASS_COLOR[cls], rng, z)
            alpha = ry - np.arctan2(x, z)
            alpha = (alpha + np.pi) % (2 * np.pi) - np.pi
            lines.append(
                f"{cls} {trunc:.2f} 0 {alpha:.2f} "
                f"{cx1:.2f} {cy1:.2f} {cx2:.2f} {cy2:.2f} "
                f"{h3:.2f} {w3:.2f} {l3:.2f} "
                f"{x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
        if rng.random() < 0.25:  # DontCare strip (distant clutter)
            dx = rng.uniform(0, im_w - 60)
            lines.append(f"DontCare -1 -1 -10 {dx:.2f} "
                         f"{im_h * 0.42:.2f} {dx + 50:.2f} "
                         f"{im_h * 0.50:.2f} -1 -1 -1 -1000 -1000 -1000 -10")
        write_png(os.path.join(root, split, "image_2", iid + ".png"), img)
        with open(os.path.join(root, split, "calib", iid + ".txt"),
                  "w") as f:
            f.write(cal_line)
        with open(os.path.join(root, split, "label_2", iid + ".txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
        if progress and (i + 1) % 50 == 0:
            progress(i + 1, n_images)


def crop_to_sizes(root, split, sizes):
    """Crop frame i of a written split to ``sizes[i % len(sizes)]`` (h, w)
    from its top-left corner, which keeps its P2 valid: a split of mixed
    image sizes, as KITTI's val split is.  Labels are left as they are."""
    image_dir = os.path.join(root, split, "image_2")
    for i, name in enumerate(sorted(os.listdir(image_dir))):
        h, w = sizes[i % len(sizes)]
        path = os.path.join(image_dir, name)
        img = read_png(path)
        if img.shape[:2] != (h, w):
            if h > img.shape[0] or w > img.shape[1]:
                raise ValueError(f"{path}: cannot crop {img.shape[:2]} to "
                                 f"{(h, w)}")
            write_png(path, img[:h, :w])
