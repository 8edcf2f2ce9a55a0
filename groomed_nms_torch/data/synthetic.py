"""Synthetic KITTI trees at real resolution (still images and video), and
synthetic tracker input.

The port's copy of ``groomed_nms_tpu/data/synthetic.py``
(``make_synthetic_kitti``, ``make_synthetic_kitti_video``) with its helpers:
the same RNG stream gives the same labels, calib, pose and mapping files,
byte for byte, and the same pixels, written by ``data/png.py`` instead of
Pillow (the GPU machine has none).  ``make_synthetic_track_clip`` (the
port's own) makes a clip's measurements for the tracker's checks.

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


# ---------------------------------------------------------------------------
# video / tracking tree
# ---------------------------------------------------------------------------

def _rot_y(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def make_synthetic_kitti_video(root, n_train=200, n_val=50, n_prev=3,
                               im_h=375, im_w=1242, seed=0, progress=None):
    """Write a synthetic KITTI *tracking* tree at real resolution.

    Produces the reference's video layout (data/tracking.py docstring;
    reference lib/imdb_util.py:318-420): ``<split>/{image_2, calib,
    label_2, prev_2}``, ``devkit/mapping/{train_mapping,train_rand}.txt``,
    and ``raw_extra/<seq>/{pose.txt, label_2/}`` with per-frame track-id
    labels, so ``build_tracking_imdb`` derives egos and GT velocities
    through its own pose/velocity math.

    One continuous "drive" per split: the ego camera advances ~1.1 m/frame
    with a slow yaw wander past parked and moving cars whose world motion
    is constant-velocity along their heading -- consecutive records
    overlap in time (record i's prev_1 frame IS record i-1's current
    frame), exactly like the real raw-drive mapping.  Record ids are
    global across splits (training 0..n_train-1, validation onward)
    because train_rand.txt is indexed by ``int(image_id)``.

    Geometry conventions verified against data/tracking.py: poses are
    cam->world with yaw-only rotation ``R_t = euler-y(theta_t)`` and
    ground-plane translation, so a world point maps to the camera as
    ``R_t^T (X_w - T_t)`` and a world heading ``ry_w`` appears as
    ``ry_c = ry_w - theta_t``; parked cars therefore get GT velocity ~0
    and movers their world speed, THROUGH compute_track_velocity.
    """
    rng = np.random.default_rng(seed)
    p2 = kitti_p2(im_w, im_h)
    cal_line = "P2: " + " ".join(f"{v:.12e}" for v in p2.reshape(-1)) + "\n"
    os.makedirs(os.path.join(root, "devkit", "mapping"), exist_ok=True)
    mapping_lines, rand_ids = [], []
    gid = 0

    for split, n_records in (("training", n_train), ("validation", n_val)):
        split_dir = os.path.join(root, split)
        for sub in ("image_2", "calib", "label_2", "prev_2"):
            os.makedirs(os.path.join(split_dir, sub), exist_ok=True)
        seq = f"2011_09_26_drive_{9000 + len(mapping_lines):04d}_sync"
        raw_dir = os.path.join(root, "raw_extra", seq)
        os.makedirs(os.path.join(raw_dir, "label_2"), exist_ok=True)

        n_frames = n_records + n_prev
        # ego trajectory: smooth yaw wander + ~1.1 m/frame forward
        thetas = np.cumsum(rng.normal(0.0, 0.004, n_frames))
        speeds = rng.uniform(0.9, 1.3, n_frames)
        pos = np.zeros((n_frames, 3))
        for t in range(1, n_frames):
            d = _rot_y(thetas[t - 1]) @ np.array([0.0, 0.0, speeds[t - 1]])
            pos[t] = pos[t - 1] + d
        road_len = float(pos[:, 2].max()) + 60.0

        # world objects: [cls, track_id, x0, z0, ry_w, speed, dims, color]
        objs = []
        tid = 0
        for _ in range(int(road_len / 7.0)):              # parked cars
            h3, w3, l3 = CLASS_DIMS["Car"]
            objs.append(dict(
                tid=tid, x0=float(rng.choice([-1, 1]) * rng.uniform(3.5, 8)),
                z0=float(rng.uniform(4.0, road_len)),
                ry=float(rng.choice([-np.pi / 2, np.pi / 2])
                         + rng.normal(0, 0.1)),
                speed=0.0,
                dims=(h3 * rng.uniform(0.9, 1.1), w3 * rng.uniform(0.9, 1.1),
                      l3 * rng.uniform(0.9, 1.1))))
            tid += 1
        for _ in range(max(2, n_records // 12)):          # movers
            h3, w3, l3 = CLASS_DIMS["Car"]
            toward = bool(rng.random() < 0.4)
            objs.append(dict(
                tid=tid, x0=float(rng.choice([-1, 1]) * rng.uniform(1.2, 3)),
                z0=float(rng.uniform(8.0, road_len)),
                ry=float((np.pi / 2 if toward else -np.pi / 2)
                         + rng.normal(0, 0.05)),
                speed=float(rng.uniform(0.3, 1.6)),
                dims=(h3, w3, l3)))
            tid += 1

        def frame_objects(t):
            """Visible objects at frame t in the camera frame."""
            rt, tt = _rot_y(thetas[t]), pos[t]
            out = []
            for o in objs:
                d = np.array([np.cos(o["ry"]), 0.0, -np.sin(o["ry"])])
                xw = np.array([o["x0"], 1.65, o["z0"]]) \
                    + o["speed"] * t * d
                xc = rt.T @ (xw - tt)
                if not (4.5 < xc[2] < 52.0):
                    continue
                out.append((o, float(xc[0]), float(xc[1]), float(xc[2]),
                            float(o["ry"] - thetas[t])))
            return out

        def render(t):
            """(image, 16-col raw label rows, 15-col still rows)."""
            img = _background(rng, im_h, im_w)
            raw_rows, still_rows = [], []
            vis = frame_objects(t)
            for o, x, y, z, ry in sorted(vis, key=lambda v: -v[3]):
                h3, w3, l3 = o["dims"]
                x1, y1, x2, y2 = _project_cuboid(p2, x, y, z, w3, h3, l3, ry)
                cx1, cy1 = max(x1, 0.0), max(y1, 0.0)
                cx2 = min(x2, im_w - 1.0)
                cy2 = min(y2, im_h - 1.0)
                if cx2 - cx1 < 10 or cy2 - cy1 < 10:
                    continue
                trunc = 1.0 - (cx2 - cx1) * (cy2 - cy1) / max(
                    (x2 - x1) * (y2 - y1), 1e-6)
                _paint(img, cx1, cy1, cx2, cy2, CLASS_COLOR["Car"], rng, z)
                alpha = ry - np.arctan2(x, z)
                alpha = (alpha + np.pi) % (2 * np.pi) - np.pi
                row = (f"Car {trunc:.2f} 0 {alpha:.2f} "
                       f"{cx1:.2f} {cy1:.2f} {cx2:.2f} {cy2:.2f} "
                       f"{h3:.2f} {w3:.2f} {l3:.2f} "
                       f"{x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
                still_rows.append(row)
                raw_rows.append(row + f" {o['tid']}")
            return img, raw_rows, still_rows

        # pose.txt: cam->world 3x4 rows for every frame
        with open(os.path.join(raw_dir, "pose.txt"), "w") as f:
            for t in range(n_frames):
                m = np.eye(4)
                m[:3, :3] = _rot_y(thetas[t])
                m[:3, 3] = pos[t]
                f.write(" ".join(f"{v:.9e}" for v in m[:3].reshape(-1))
                        + "\n")

        frames = {}
        for t in range(n_frames):
            img, raw_rows, still_rows = render(t)
            frames[t] = (img, still_rows)
            with open(os.path.join(raw_dir, "label_2", f"{t:06d}.txt"),
                      "w") as f:
                f.write("\n".join(raw_rows) + "\n")
            if progress and (t + 1) % 50 == 0:
                progress(t + 1, n_frames)

        for i in range(n_records):
            iid = f"{gid:06d}"
            fi = i + n_prev
            img, still_rows = frames[fi]
            write_png(os.path.join(split_dir, "image_2", iid + ".png"), img)
            for k in range(1, n_prev + 1):
                write_png(os.path.join(split_dir, "prev_2",
                                       f"{iid}_{k:02d}.png"),
                          frames[fi - k][0])
            with open(os.path.join(split_dir, "calib", iid + ".txt"),
                      "w") as f:
                f.write(cal_line)
            with open(os.path.join(split_dir, "label_2", iid + ".txt"),
                      "w") as f:
                f.write("\n".join(still_rows) + "\n")
            mapping_lines.append(f"2011_09_26 {seq} {fi:010d}")
            rand_ids.append(len(mapping_lines))   # 1-based, in gid order
            gid += 1

    with open(os.path.join(root, "devkit", "mapping",
                           "train_mapping.txt"), "w") as f:
        f.write("\n".join(mapping_lines) + "\n")
    with open(os.path.join(root, "devkit", "mapping", "train_rand.txt"),
              "w") as f:
        f.write(",".join(str(v) for v in rand_ids) + "\n")


def make_synthetic_track_clip(seed, n_frames=6, m=16, n_objects=9,
                              kill_frame=3, p2=None):
    """Tracker input of a clip (numpy f64): measurements of moving objects
    seen by a moving camera, in ``models/kalman.py``'s 16-column layout.

    Each frame's objects are the last frame's moved by the ego pose (as
    ``project_ego`` moves tracks) and by their speed along their heading;
    measurements are them plus noise, their 2D boxes the projected cuboids
    (``p2`` [3 or 4, 4], default ``kitti_p2()``).  A quarter of them are
    missed after frame 0; object 0 is seen with low confidence (its track
    spawns and dies); at ``kill_frame`` every measurement is shifted 15 m
    aside, so nothing associates and every track dies and respawns; slots
    ``n_objects..m`` hold invalid junk.  Returns (meas [F, m, 16], valid
    [F, m] bool, poses [F, 6]; row 0 of the poses is zero)."""
    rs = np.random.default_rng(seed)
    p2 = kitti_p2() if p2 is None else np.asarray(p2)[:3]
    n = n_objects
    obj = np.stack([rs.uniform(-8, 8, n), rs.uniform(1.2, 1.8, n),
                    rs.uniform(8, 35, n), rs.uniform(1.5, 1.9, n),
                    rs.uniform(1.4, 1.7, n), rs.uniform(3.5, 4.5, n),
                    rs.uniform(-3, 3, n), (rs.random(n) < 0.5) * 1.0,
                    rs.uniform(0, 0.6, n)], -1)
    meas = np.zeros((n_frames, m, 16))
    valid = np.zeros((n_frames, m), bool)
    poses = np.zeros((n_frames, 6))
    for f in range(n_frames):
        if f:
            pose = np.array([rs.normal(0, 0.05), 0, rs.normal(-0.5, 0.1),
                             0, rs.normal(0, 0.02), 0])
            poses[f] = pose
            obj[:, :3] = obj[:, :3] @ _rot_y(pose[4]).T + pose[:3]
            obj[:, 6] += pose[4]
            ry = obj[:, 6] + np.pi * (obj[:, 7] >= 0.5)
            obj[:, 0] += obj[:, 8] * np.cos(ry)
            obj[:, 2] -= obj[:, 8] * np.sin(ry)
        seen = rs.random(n) >= 0.25 if f else np.ones(n, bool)
        for i in np.flatnonzero(seen):
            s = obj[i, :8] + rs.normal(0, 0.03, 8) * [1, 1, 1, 0, 0, 0, .1, 0]
            if f == kill_frame:
                s[0] += 15.0
            x, y, z, w3, h3, l3, theta = s[:7]
            box = _project_cuboid(p2, x, y + h3 / 2, z, w3, h3, l3, theta)
            score, un = (0.3, 0.1) if i == 0 else (rs.uniform(0.7, 1),
                                                   rs.uniform(0.5, 1))
            meas[f, i] = [*box, score, 1, *s, un, obj[i, 8]]
            valid[f, i] = True
        meas[f, n:] = rs.uniform(0, 50, (m - n, 16))
    return meas, valid, poses
