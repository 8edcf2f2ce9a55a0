"""KITTI video/tracking dataset: raw-sequence mapping, ego poses, velocity.

A copy of ``groomed_nms_tpu/data/tracking.py`` (host-side numpy), with the
image size read by ``data/png.py::png_size`` instead of Pillow.  It is the
counterpart of the reference's ``kitti_tracking`` imdb path
(lib/imdb_util.py:179-397) + pose helpers (lib/core.py:1004-1022,
lib/util.py:516-627):

* ``read_train_mapping`` / ``read_train_rand`` -- detection-train image id
  -> (raw drive sequence, raw frame index);
* ``compute_rel_pose`` / ``euler2mat`` / ``mat2euler`` -- relative ego pose
  between two 4x4 odometry poses as (tx, ty, tz, rx, ry, rz);
* ``compute_track_velocity`` -- per-object planar speed between consecutive
  frames, matched by track id in the ego-compensated frame; unmatched
  objects get -inf (the loss masks these);
* ``TrackingRecord`` / ``build_tracking_imdb`` -- one record per training
  image with up-to-3 previous frame paths, 6 pairwise relative poses, and
  per-frame ground truth with velocities appended as bbox_3d column 16.
"""

from __future__ import annotations

import math
import os
import pickle
import re
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .kitti import read_kitti_calib, read_kitti_label, read_kitti_poses
from .png import png_size


# ---------------------------------------------------------------------------
# euler <-> matrix (z-y-x convention, matching the reference lib/util.py)
# ---------------------------------------------------------------------------

def euler2mat(rx, ry, rz):
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def mat2euler(m):
    """Inverse of euler2mat for proper rotations (reference lib/util.py:606)."""
    sy = math.sqrt(m[0, 0] ** 2 + m[1, 0] ** 2)
    if sy > 1e-6:
        rx = math.atan2(m[2, 1], m[2, 2])
        ry = math.atan2(-m[2, 0], sy)
        rz = math.atan2(m[1, 0], m[0, 0])
    else:
        rx = math.atan2(-m[1, 2], m[1, 1])
        ry = math.atan2(-m[2, 0], sy)
        rz = 0.0
    return rx, ry, rz


def compute_rel_pose(pose_pre, pose):
    """Relative ego motion pose_pre -> pose (reference lib/core.py:1004)."""
    rel = np.linalg.inv(pose) @ pose_pre
    rx, ry, rz = mat2euler(rel[:3, :3])
    return (rel[0, 3], rel[1, 3], rel[2, 3], rx, ry, rz)


def inverse_rel_pose(pose_pre, pose_rel):
    return pose_pre @ np.linalg.inv(pose_rel)


def mirror_ego(ego):
    """Mirror a relative ego pose for a horizontal image flip.

    Reference ``ego_mirror`` (lib/util.py:411-426): negate the lateral
    translation and the yaw/roll rotations, snapping the angles to
    (-pi, pi].  Used wherever pose targets accompany mirrored frames
    (reference RandomMirror, lib/augmentations.py:290-295).
    """
    dx, dy, dz, rx, ry, rz = (float(v) for v in ego)
    dx, ry, rz = -dx, -ry, -rz
    while ry > math.pi:
        ry -= 2 * math.pi
    while ry < -math.pi:
        ry += 2 * math.pi
    while rz > math.pi:
        rz -= 2 * math.pi
    while rz < -math.pi:
        rz += 2 * math.pi
    return (dx, dy, dz, rx, ry, rz)


# ---------------------------------------------------------------------------
# mapping files
# ---------------------------------------------------------------------------

def read_train_mapping(path):
    """train_mapping.txt rows -> [(raw_sequence, raw_frame_id), ...]."""
    mapping = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                mapping.append((parts[1], parts[2]))
    return mapping


def read_train_rand(path):
    """train_rand.txt -> list of 1-based indices into the mapping."""
    with open(path) as f:
        return [int(p) for p in re.findall(r"\d+", f.read())]


def map_image_to_raw(image_id, mapping, rand_map):
    """Detection image id -> (raw_sequence, raw_frame) via the devkit maps."""
    return mapping[rand_map[int(image_id)] - 1]


# ---------------------------------------------------------------------------
# velocity + imdb
# ---------------------------------------------------------------------------

def compute_track_velocity(ego, gts_prev, gts_cur):
    """Append planar speed (col 16) to gts_cur's bbox_3d rows.

    Matches objects between frames by track id; moves the previous center
    into the current ego frame before differencing (reference
    lib/imdb_util.py:38-75).  Unmatched -> -inf.
    """
    if not gts_cur or len(gts_cur.get("cls", [])) == 0:
        return gts_cur
    pose = np.eye(4)
    pose[:3, :3] = euler2mat(ego[3], ego[4], ego[5])
    pose[:3, 3] = ego[:3]

    n = len(gts_cur["cls"])
    vel = np.full(n, -np.inf)
    prev_tracks = gts_prev.get("track", np.zeros(0, np.int64)) \
        if gts_prev else np.zeros(0, np.int64)
    for i in range(n):
        tid = gts_cur["track"][i]
        if tid < 0:
            continue
        match = np.flatnonzero(prev_tracks == tid)
        if match.size == 0:
            continue
        j = match[0]
        c1 = np.append(gts_prev["center_3d"][j], 1.0)
        c1 = pose @ c1
        dx = gts_cur["center_3d"][i][0] - c1[0]
        dz = gts_cur["center_3d"][i][2] - c1[2]
        vel[i] = math.sqrt(dx * dx + dz * dz)

    out = dict(gts_cur)
    out["vel"] = vel
    out["bbox_3d"] = np.concatenate(
        [gts_cur["bbox_3d"], vel[:, None]], axis=1)
    return out


@dataclass
class TrackingRecord:
    id: str
    image_paths: List[str]          # [cur, prev1, prev2, prev3]
    p2: np.ndarray
    p2_inv: np.ndarray
    im_h: int
    im_w: int
    raw_seq: str = ""
    raw_frame: int = -1
    has_track: bool = False
    # 6 pairwise relative poses keyed like the reference: 32 31 30 21 20 10
    egos: dict = field(default_factory=dict)
    gts_frames: List[Optional[dict]] = field(default_factory=list)  # cur..-3


def build_tracking_imdb(root, split="training", n_prev=3, use_3d_for_2d=True,
                        cache_file=None, im_ext=".png"):
    """Build the video imdb from a KITTI split + raw_extra sequences.

    Expects the reference's layout: ``<root>/<split>/{image_2, calib,
    label_2, prev_2}``, ``<root>/devkit/mapping/{train_mapping, train_rand}``,
    ``<root>/raw_extra/<seq>/{pose.txt, label_2/}``, and ``train.txt`` /
    ``val.txt`` id lists.
    """
    meta = {"root": os.path.abspath(root), "split": split, "n_prev": n_prev,
            "use_3d_for_2d": use_3d_for_2d, "im_ext": im_ext}
    if cache_file and os.path.exists(cache_file):
        with open(cache_file, "rb") as f:
            cached = pickle.load(f)
        if isinstance(cached, dict) and cached.get("meta") == meta:
            return cached["imdb"]
        # legacy list format or argument mismatch: rebuild

    split_dir = os.path.join(root, split)
    image_dir = os.path.join(split_dir, "image_2")
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(image_dir)
                 if f.endswith(im_ext))

    mapping_file = os.path.join(root, "devkit", "mapping",
                                "train_mapping.txt")
    rand_file = os.path.join(root, "devkit", "mapping", "train_rand.txt")
    has_mapping = os.path.exists(mapping_file) and os.path.exists(rand_file)
    mapping = read_train_mapping(mapping_file) if has_mapping else []
    rand_map = read_train_rand(rand_file) if has_mapping else []

    imdb = []
    for iid in ids:
        p2 = read_kitti_calib(os.path.join(split_dir, "calib", iid + ".txt"))
        cur = os.path.join(image_dir, iid + im_ext)
        prevs = [os.path.join(split_dir, "prev_2", f"{iid}_{k:02d}{im_ext}")
                 for k in range(1, n_prev + 1)]
        h, w = png_size(cur)

        rec = TrackingRecord(id=iid, image_paths=[cur] + prevs, p2=p2,
                             p2_inv=np.linalg.inv(p2), im_h=h, im_w=w)

        label = os.path.join(split_dir, "label_2", iid + ".txt")
        if os.path.exists(label):
            rec.gts_frames = [read_kitti_label(label, p2, use_3d_for_2d)]

        if has_mapping:
            raw_seq, raw_frame = map_image_to_raw(iid, mapping, rand_map)
            rec.raw_seq, rec.raw_frame = raw_seq, int(raw_frame)
            raw_dir = os.path.join(root, "raw_extra", raw_seq)
            pose_file = os.path.join(raw_dir, "pose.txt")
            fi = rec.raw_frame
            if os.path.exists(pose_file) and fi - n_prev >= 0:
                poses = read_kitti_poses(pose_file)
                egos = {}
                for a in range(n_prev, 0, -1):
                    for b in range(a - 1, -1, -1):
                        egos[f"{a}{b}"] = compute_rel_pose(poses[fi - a],
                                                           poses[fi - b])
                rec.egos = egos

                track_dir = os.path.join(raw_dir, "label_2")
                if os.path.isdir(track_dir):
                    rec.has_track = True
                    frames = []
                    for k in range(0, n_prev + 1):
                        fp = os.path.join(track_dir,
                                          f"{fi - k:06d}.txt")
                        frames.append(read_kitti_label(fp, p2, use_3d_for_2d)
                                      if os.path.exists(fp) else None)
                    # velocities, newest pairs first (reference L378-380)
                    for k in range(n_prev):
                        ego_key = f"{k + 1}{k}"
                        if frames[k] is not None and ego_key in rec.egos:
                            frames[k] = compute_track_velocity(
                                rec.egos[ego_key], frames[k + 1], frames[k])
                    rec.gts_frames = frames
        imdb.append(rec)

    if cache_file:
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        with open(cache_file, "wb") as f:
            pickle.dump({"meta": meta, "imdb": imdb}, f)
    return imdb
