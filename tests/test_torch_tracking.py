"""The tracking data of the video slice, JAX vs the PyTorch port, on the
CPU: the pose math, the velocities, the mapping parsers, the pose reader,
``make_synthetic_kitti_video`` (the port's PNG writer against Pillow's) and
``build_tracking_imdb`` over both trees.

Tolerances: everything is host-side f64 numpy in both packages, the same
formulas, so values are held exactly equal, save the pose math at rtol
1e-12 (``math`` against the same ``math``; kept as a tolerance only
against a libm that differs between two interpreters: none here).
"""

import dataclasses
import filecmp
import math
import os

import numpy as np
import pytest

from groomed_nms_tpu.data import kitti as jkitti
from groomed_nms_tpu.data import synthetic as jsynth
from groomed_nms_tpu.data import tracking as jtrack

from groomed_nms_torch.data import kitti as tkitti
from groomed_nms_torch.data import synthetic as tsynth
from groomed_nms_torch.data import tracking as ttrack
from groomed_nms_torch.data.png import read_png

N_TRAIN, N_VAL, H, W = 3, 4, 64, 200


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same video tree written by each package's writer."""
    out = {}
    for name, mod in (("jax", jsynth), ("torch", tsynth)):
        root = str(tmp_path_factory.mktemp(name))
        mod.make_synthetic_kitti_video(root, n_train=N_TRAIN, n_val=N_VAL,
                                       im_h=H, im_w=W, seed=3)
        out[name] = root
    return out


def test_pose_math_matches_jax():
    rs = np.random.default_rng(0)
    for _ in range(20):
        rx, ry, rz = rs.uniform(-3, 3, 3)
        np.testing.assert_allclose(ttrack.euler2mat(rx, ry, rz),
                                   jtrack.euler2mat(rx, ry, rz), rtol=1e-12)
        m = jtrack.euler2mat(rx, ry, rz)
        assert ttrack.mat2euler(m) == jtrack.mat2euler(m)
        ego = rs.normal(0, 1, 6)
        ego[3:] = rs.uniform(-7, 7, 3)            # wraps in mirror_ego
        assert ttrack.mirror_ego(ego) == jtrack.mirror_ego(ego)
    gimbal = jtrack.euler2mat(0.3, math.pi / 2, 0.2)   # the sy ~ 0 branch
    assert ttrack.mat2euler(gimbal) == jtrack.mat2euler(gimbal)
    p0, p1 = np.eye(4), np.eye(4)
    p0[:3, :3], p0[:3, 3] = jtrack.euler2mat(0.01, 0.2, -0.03), [1, 0, 5]
    p1[:3, :3], p1[:3, 3] = jtrack.euler2mat(-0.02, 0.25, 0.01), [1.2, 0, 6]
    assert ttrack.compute_rel_pose(p0, p1) == jtrack.compute_rel_pose(p0, p1)
    np.testing.assert_array_equal(ttrack.inverse_rel_pose(p0, p1),
                                  jtrack.inverse_rel_pose(p0, p1))


def test_track_velocity_matches_jax():
    rs = np.random.default_rng(1)
    n = 6

    def gts(tracks):
        return {"cls": np.array(["Car"] * len(tracks), object),
                "track": np.asarray(tracks, np.int64),
                "center_3d": rs.uniform(-10, 30, (len(tracks), 3)),
                "bbox_3d": rs.uniform(0, 5, (len(tracks), 16))}

    prev, cur = gts([4, 2, 9, 7, 1, 3]), gts([1, 2, 3, -1, 5, 9])
    ego = (0.1, 0.0, 1.1, 0.01, 0.02, -0.01)
    got = ttrack.compute_track_velocity(ego, prev, cur)
    ref = jtrack.compute_track_velocity(ego, prev, cur)
    np.testing.assert_array_equal(got["vel"], ref["vel"])
    np.testing.assert_array_equal(got["bbox_3d"], ref["bbox_3d"])
    assert np.isinf(got["vel"]).sum() == 2 and got["bbox_3d"].shape == (n, 17)
    # no previous frame, and an empty current frame
    np.testing.assert_array_equal(
        ttrack.compute_track_velocity(ego, None, cur)["vel"],
        jtrack.compute_track_velocity(ego, None, cur)["vel"])
    assert ttrack.compute_track_velocity(ego, prev, {}) == {}


def test_video_tree_writers_and_parsers_match_jax(trees):
    """Every text file of the two trees identical, every image's pixels;
    the mapping parsers and the pose reader agree on them."""
    j, t = trees["jax"], trees["torch"]
    files = sorted(os.path.relpath(os.path.join(d, f), j)
                   for d, _, fs in os.walk(j) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), t)
                           for d, _, fs in os.walk(t) for f in fs)
    from PIL import Image
    n_png = 0
    for rel in files:
        if rel.endswith(".png"):
            with Image.open(os.path.join(j, rel)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(t, rel)),
                                              np.asarray(im.convert("RGB")))
            n_png += 1
        else:
            assert filecmp.cmp(os.path.join(j, rel), os.path.join(t, rel),
                               shallow=False), rel
    assert n_png == (N_TRAIN + N_VAL) * 4

    mapping = os.path.join(t, "devkit", "mapping")
    m = ttrack.read_train_mapping(os.path.join(mapping, "train_mapping.txt"))
    r = ttrack.read_train_rand(os.path.join(mapping, "train_rand.txt"))
    assert m == jtrack.read_train_mapping(
        os.path.join(mapping, "train_mapping.txt"))
    assert r == jtrack.read_train_rand(os.path.join(mapping, "train_rand.txt"))
    assert len(m) == len(r) == N_TRAIN + N_VAL
    assert ttrack.map_image_to_raw("000004", m, r) == \
        jtrack.map_image_to_raw("000004", m, r)
    raw = os.path.join(t, "raw_extra")
    for seq in sorted(os.listdir(raw)):
        pose_file = os.path.join(raw, seq, "pose.txt")
        got = tkitti.read_kitti_poses(pose_file)
        ref = jkitti.read_kitti_poses(pose_file)
        assert len(got) == len(ref) > 0
        for g, w in zip(got, ref):
            np.testing.assert_array_equal(g, w)


def _assert_records_equal(got, ref, root_got, root_ref):
    assert len(got) == len(ref) > 0
    for g, w in zip(got, ref):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert [os.path.relpath(p, root_got) for p in gd.pop("image_paths")] \
            == [os.path.relpath(p, root_ref) for p in wd.pop("image_paths")]
        gf, wf = gd.pop("gts_frames"), wd.pop("gts_frames")
        for k in ("p2", "p2_inv"):
            np.testing.assert_array_equal(gd.pop(k), wd.pop(k))
        assert gd == wd
        assert len(gf) == len(wf)
        for a, b in zip(gf, wf):
            assert (a is None) == (b is None)
            if a is not None:
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("split", ["training", "validation"])
def test_build_tracking_imdb_matches_jax(trees, split, tmp_path):
    """Records, egos and per-frame ground truth with velocities equal, over
    either package's tree; the port's cache is keyed as JAX's (a record
    list cached under other arguments is rebuilt)."""
    j, t = trees["jax"], trees["torch"]
    ref = jtrack.build_tracking_imdb(j, split)
    for root in (j, t):
        _assert_records_equal(ttrack.build_tracking_imdb(root, split), ref,
                              root, j)
    vel = [f["vel"] for r in ref for f in r.gts_frames
           if f is not None and "vel" in f]
    assert vel and all(np.isfinite(v).any() for v in vel)
    assert all(r.has_track and len(r.egos) == 6 for r in ref)

    cache = str(tmp_path / "imdb.pkl")
    first = ttrack.build_tracking_imdb(t, split, cache_file=cache)
    again = ttrack.build_tracking_imdb(t, split, cache_file=cache)
    _assert_records_equal(again, first, t, t)
    other = ttrack.build_tracking_imdb(t, split, n_prev=2, cache_file=cache)
    assert len(other[0].image_paths) == 3
