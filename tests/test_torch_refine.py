"""The ``--refine`` slice, JAX vs the PyTorch port, on the CPU: the box and
geometry helpers, ``projection_consistency``, ``hill_climb``,
``refine_detections`` and ``test_kitti_3d(refine=True)``.

Tolerances: the helpers exactly (the same f32 or f64 operations);
``projection_consistency``, ``hill_climb`` and ``refine_detections`` in f64
(``jax.enable_x64``) with the same invalid rows and every number within
1e-9 of 1 + |x|: every climb step is a discrete choice (``> 0``, ``ol_p >
ol_n``), which one rounding can flip, so the climb is held where a rounding
is ~1e-16.  In f32 the agreement is reported, not held.  The end-to-end
rows at the eval slice's rule (1e-3 + 1e-4 |x|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu import config as jax_config
from groomed_nms_tpu import inference as jax_inf
from groomed_nms_tpu.data.imdb import build_imdb as jax_build_imdb
from groomed_nms_tpu.eval import tester as jax_tester
from groomed_nms_tpu.ops import boxes as jax_boxes
from groomed_nms_tpu.ops import geometry as jax_geometry
from groomed_nms_tpu.ops import refine as jax_refine

from groomed_nms_torch import config, inference
from groomed_nms_torch.data.imdb import build_imdb
from groomed_nms_torch.eval import tester
from groomed_nms_torch.ops import boxes, geometry, refine
from test_torch_eval import (NUM_ANCHORS, TXT_ATOL, TXT_RTOL, _anchors,
                             _rois, _tree, read_rows)
from torch_port_common import tiny_models

TOL = 1e-9                      # of 1 + |x|, f64

P2 = np.eye(4)
P2[0, 0] = P2[1, 1] = 700.0
P2[0, 2], P2[1, 2] = 600.0, 180.0


def _close(got, want):
    """max |got - want| / (1 + |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def _kitti_p2(rs, b):
    """[b, 4, 4] KITTI-like P2s (a translation column, focal lengths apart)
    and their inverses, f64."""
    p2 = np.tile(np.eye(4), (b, 1, 1))
    p2[:, 0, 0] = rs.uniform(690, 730, b)
    p2[:, 1, 1] = p2[:, 0, 0]
    p2[:, 0, 2], p2[:, 1, 2] = rs.uniform(590, 620, b), rs.uniform(170, 185, b)
    p2[:, 0, 3], p2[:, 1, 3] = rs.uniform(40, 50, b), rs.uniform(-0.5, 0.5, b)
    p2[:, 2, 3] = 0.003
    return p2, np.linalg.inv(p2)


def _dets(rs, b, k):
    """[b, k, 17] detection rows of plausible sizes, their projected centres
    near the 2D boxes, some rows close to the camera (invalid projections)
    and some boxes degenerate (NaN overlaps)."""
    d = np.zeros((b, k, 17))
    c = rs.uniform([0, 100], [1200, 300], (b, k, 2))
    wh = rs.uniform(20, 200, (b, k, 2))
    d[..., :2], d[..., 2:4] = c - wh / 2, c + wh / 2
    d[..., 4] = rs.uniform(0, 1, (b, k))
    d[..., 5] = rs.integers(1, 4, (b, k))
    d[..., 6:8] = c + rs.normal(0, 8, (b, k, 2))
    d[..., 8] = rs.uniform(4, 60, (b, k))
    d[:, :3, 8] = rs.uniform(0.5, 2.0, (b, 3))     # corners behind the camera
    d[..., 9:12] = rs.uniform([1.4, 1.4, 3.0], [1.9, 1.8, 4.5], (b, k, 3))
    d[..., 16] = rs.uniform(-np.pi, np.pi, (b, k))
    d[:, 3, 2:4] = d[:, 3, 0:2] - 1                # zero-area box
    return d


def test_box_and_backprojection_helpers_match_jax():
    rs = np.random.default_rng(0)
    b = rs.uniform(0, 500, (3, 7, 4)).astype(np.float32)
    for ours, theirs in ((boxes.xywh_to_corners, jax_boxes.xywh_to_corners),
                         (boxes.corners_to_xywh, jax_boxes.corners_to_xywh)):
        np.testing.assert_array_equal(ours(torch.from_numpy(b)).numpy(),
                                      np.asarray(theirs(b)))
    # integer pixels, depths and a P2^-1 of small integers: every product and
    # sum is exact, so the two contractions agree bit for bit whatever their
    # order; on random values in f64 to 1e-12
    p_inv = rs.integers(-4, 5, (4, 4)).astype(np.float64)
    x, y, z = (rs.integers(-300, 300, 50).astype(np.float64) for _ in "xyz")
    got = geometry.backproject_2d_points(*(torch.from_numpy(a) for a in
                                           (p_inv, x, y, z)))
    with jax.enable_x64(True):
        want = jax_geometry.backproject_2d_points(p_inv, x, y, z)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        _, p_inv = _kitti_p2(rs, 1)
        x, y, z = rs.uniform(0, 1200, 50), rs.uniform(0, 370, 50), \
            rs.uniform(2, 80, 50)
        got = geometry.backproject_2d_points(*(torch.from_numpy(a) for a in
                                               (p_inv[0], x, y, z)))
        want = jax_geometry.backproject_2d_points(p_inv[0], x, y, z)
        assert max(_close(g.numpy(), w) for g, w in zip(got, want)) <= 1e-12
    # per-image P2^-1 [B, 4, 4] against points [B, N]
    p2, p2i = _kitti_p2(rs, 3)
    xb, yb, zb = (rs.uniform(1, 100, (3, 5)) for _ in "xyz")
    got = geometry.backproject_2d_points(*(torch.from_numpy(a) for a in
                                           (p2i, xb, yb, zb)))
    for i in range(3):
        cam = p2i[i] @ np.stack([xb[i] * zb[i], yb[i] * zb[i], zb[i],
                                 np.ones(5)])
        for g, w in zip(got, cam[:3]):
            np.testing.assert_allclose(g[i].numpy(), w, rtol=1e-12)


def test_corner_signs_are_cached_and_unchanged():
    """``get_corners_of_cuboid`` keeps its signs as one constant per device
    and dtype (no copy a call), with the same corners as JAX's."""
    rs = np.random.default_rng(1)
    args = [rs.uniform(1, 5, (4, 6)) for _ in range(7)]
    c1 = geometry.get_corners_of_cuboid(*(torch.from_numpy(a) for a in args))
    signs = geometry._corner_signs(torch.device("cpu"), torch.float64)
    geometry.get_corners_of_cuboid(*(torch.from_numpy(a) for a in args))
    assert geometry._corner_signs(torch.device("cpu"), torch.float64) \
        is signs
    with jax.enable_x64(True):
        want = jax_geometry.get_corners_of_cuboid(*args)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(want))

    # a tracer's fake signs are not kept: eager calls after an export of
    # the corners still get real ones
    class Corners(torch.nn.Module):
        def forward(self, x):
            return geometry.get_corners_of_cuboid(*x.unbind(-1))

    x = torch.from_numpy(np.stack(args, -1)).float()
    geometry._corner_signs_cache.pop((torch.device("cpu"), torch.float32),
                                     None)
    exported = torch.export.export(Corners(), (x,)).module()
    assert torch.equal(exported(x), Corners()(x))


def _climb_args(rs, b, k):
    d = _dets(rs, b, k)
    p2, p2i = _kitti_p2(rs, b)
    box = np.stack([d[..., 0], d[..., 1], d[..., 2] - d[..., 0] + 1,
                    d[..., 3] - d[..., 1] + 1], -1)
    cols = [d[..., i] for i in (6, 7, 8, 9, 10, 11, 16)]
    return p2, p2i, box, cols


def test_projection_consistency_matches_jax_in_f64():
    rs = np.random.default_rng(2)
    p2, p2i, box, cols = _climb_args(rs, 2, 30)
    got = refine.projection_consistency(
        torch.from_numpy(p2), torch.from_numpy(p2i), torch.from_numpy(box),
        *(torch.from_numpy(c) for c in cols))
    with jax.enable_x64(True):
        want = [jax_refine.projection_consistency(
            p2[i], p2i[i], box[i], *(c[i] for c in cols)) for i in range(2)]
    ol, inv = got[0].numpy(), got[1].numpy()
    ol_j = np.stack([np.asarray(w[0]) for w in want])
    inv_j = np.stack([np.asarray(w[1]) for w in want])
    np.testing.assert_array_equal(inv, inv_j)
    assert inv.any() and not inv.all()
    assert _close(ol, ol_j) <= TOL
    assert (ol == 0).any(), "no NaN overlap read as 0"


def test_projection_consistency_perfect_box():
    """A 2D box made from the true cuboid: overlap ~ 1, valid."""
    x3d, y3d, z3d, w3, h3, l3, ry = 1.0, 1.2, 20.0, 1.6, 1.5, 3.9, 0.4
    t = lambda *v: torch.tensor(v, dtype=torch.float64)
    box = geometry.project_3d_box(torch.from_numpy(P2), *t(x3d, y3d, z3d, w3,
                                                         h3, l3, ry))
    proj = P2 @ np.array([x3d, y3d, z3d, 1.0])
    ol, invalid = refine.projection_consistency(
        torch.from_numpy(P2), torch.from_numpy(np.linalg.inv(P2)),
        boxes.corners_to_xywh(box)[None], t(proj[0] / proj[2]),
        t(proj[1] / proj[2]), t(proj[2]), t(w3), t(h3), t(l3), t(ry))
    assert float(ol[0]) > 0.99 and not bool(invalid[0])


def test_hill_climb_recovers_depth():
    """A depth 4 m off: the climb raises the overlap and moves z back."""
    x3d, y3d, z3d, w3, h3, l3, ry = 1.0, 1.2, 20.0, 1.6, 1.5, 3.9, 0.4
    t = lambda *v: torch.tensor(v, dtype=torch.float64)
    box = boxes.corners_to_xywh(geometry.project_3d_box(
        torch.from_numpy(P2), *t(x3d, y3d, z3d, w3, h3, l3, ry)))[None]
    proj = P2 @ np.array([x3d, y3d, z3d, 1.0])
    p2, p2i = torch.from_numpy(P2), torch.from_numpy(np.linalg.inv(P2))
    args = (t(proj[0] / proj[2]), t(proj[1] / proj[2]))
    dims = (t(w3), t(h3), t(l3), t(ry))
    z_wrong = t(proj[2] + 4.0)
    before, _ = refine.projection_consistency(p2, p2i, box, *args, z_wrong,
                                              *dims)
    z_ref, _, after = refine.hill_climb(p2, p2i, box, *args, z_wrong, *dims,
                                        step_z_init=2.0, step_r_init=0.0)
    assert float(after[0]) > float(before[0]) + 0.05
    assert abs(float(z_ref[0]) - proj[2]) < 3.0


@pytest.mark.parametrize("kw", [{}, dict(step_z_init=2.0, step_r_init=0.0,
                                         max_steps=10, min_ol_dif=0.01)])
def test_hill_climb_matches_jax_in_f64(kw):
    """The batched climb on [B, K] with per-image P2 against JAX's per-image
    climb: the same steps taken, so z, ry and the overlap agree to f64
    rounding; rows with an invalid start keep their inputs."""
    rs = np.random.default_rng(3)
    b, k = 3, 24
    p2, p2i, box, cols = _climb_args(rs, b, k)
    got = refine.hill_climb(
        torch.from_numpy(p2), torch.from_numpy(p2i), torch.from_numpy(box),
        *(torch.from_numpy(c) for c in cols), **kw)
    with jax.enable_x64(True):
        want = [jax_refine.hill_climb(p2[i], p2i[i], box[i],
                                      *(c[i] for c in cols), **kw)
                for i in range(b)]
    for j, name in enumerate(("z", "ry", "overlap")):
        w = np.stack([np.asarray(x[j]) for x in want])
        assert _close(got[j].numpy(), w) <= TOL, name
    z0 = cols[2]
    assert (got[0].numpy() != z0).any(), "no box moved"
    _, inv = refine.projection_consistency(
        torch.from_numpy(p2), torch.from_numpy(p2i), torch.from_numpy(box),
        *(torch.from_numpy(c) for c in cols))
    np.testing.assert_array_equal(got[0].numpy()[inv.numpy()],
                                  z0[inv.numpy()])


def test_refine_detections_matches_jax_in_f64():
    """``refine_detections`` [B, K, 17] against JAX's: the same rows keep
    their inputs, and z, alpha, the camera centre and ry within TOL in f64;
    in f32 the agreement is printed (reported, not held)."""
    rs = np.random.default_rng(4)
    b, k = 3, 40
    d = _dets(rs, b, k)
    p2, p2i = _kitti_p2(rs, b)
    valid = rs.uniform(size=(b, k)) > 0.2
    got = inference.refine_detections(
        torch.from_numpy(d), torch.from_numpy(valid), torch.from_numpy(p2),
        torch.from_numpy(p2i)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jax_inf.refine_detections(d, valid, p2, p2i))
    np.testing.assert_array_equal(got == d, want == d)
    assert _close(got, want) <= TOL
    moved = (got[..., 8] != d[..., 8])
    assert moved.sum() > k and not moved[~valid].any()
    f32 = [np.asarray(a, np.float32) for a in (d, p2, p2i)]
    got32 = inference.refine_detections(
        torch.from_numpy(f32[0]), torch.from_numpy(valid),
        torch.from_numpy(f32[1]), torch.from_numpy(f32[2])).numpy()
    want32 = np.asarray(jax_inf.refine_detections(f32[0], valid, f32[1],
                                                  f32[2]))
    err = np.abs(got32 - want32) / (1 + np.abs(want32))
    print(f"f32 (reported): max err / (1 + |x|) {err.max():.3e}; "
          f"{int((err.max(-1) > 1e-4).sum())} of {b * k} rows past 1e-4")


def test_refine_detections_never_degrades_and_keeps_masked_rows():
    """Depth-perturbed detections of true cuboids: the overlap never drops,
    each valid row's depth moves toward the truth, the camera centre is
    re-derived from the refined depth, masked rows keep their inputs."""
    rs = np.random.default_rng(5)
    b, k = 2, 4
    p2 = np.eye(4)
    p2[0, 0] = p2[1, 1] = 400.0
    p2[0, 2], p2[1, 2] = 320.0, 96.0
    p2b = np.tile(p2[None], (b, 1, 1))
    p2i = np.linalg.inv(p2b)
    dets = np.zeros((b, k, 17))
    valid = np.ones((b, k), bool)
    valid[1, 3] = False
    z_true = rs.uniform(12, 30, (b, k))
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    for bi in range(b):
        for ki in range(k):
            x3, y3, w3, h3, l3 = rs.uniform(-6, 6), 1.0, 1.6, 1.5, 3.9
            ry, z3 = rs.uniform(-np.pi, np.pi), z_true[bi, ki]
            dets[bi, ki, :4] = geometry.project_3d_box(
                torch.from_numpy(p2), *map(t, (x3, y3 - h3 / 2, z3, w3, h3,
                                               l3, ry))).numpy()
            u = p2[0, 0] * x3 / z3 + p2[0, 2]
            v = p2[1, 1] * (y3 - h3 / 2) / z3 + p2[1, 2]
            z_bad = z3 * rs.uniform(1.15, 1.35)
            cam = p2i[bi] @ np.array([u * z_bad, v * z_bad, z_bad, 1.0])
            dets[bi, ki, 4:12] = [0.9, 1.0, u, v, z_bad, w3, h3, l3]
            dets[bi, ki, 12] = float(geometry.rot_y_to_alpha(
                t(ry), t(cam[2]), t(cam[0])))
            dets[bi, ki, 13:16] = cam[:3]
            dets[bi, ki, 16] = ry
    out = inference.refine_detections(
        torch.from_numpy(dets), torch.from_numpy(valid),
        torch.from_numpy(p2b), torch.from_numpy(p2i)).numpy()

    def overlap(d):
        return refine.projection_consistency(
            torch.from_numpy(p2b), torch.from_numpy(p2i),
            boxes.corners_to_xywh(torch.from_numpy(d[..., :4])),
            *(torch.from_numpy(d[..., i]) for i in (6, 7, 8, 9, 10, 11, 16))
        )[0].numpy()

    assert (overlap(out) >= overlap(dets) - 1e-12).all()
    np.testing.assert_array_equal(out[~valid], dets[~valid])
    err_before = np.abs(dets[..., 8] - z_true)[valid]
    err_after = np.abs(out[..., 8] - z_true)[valid]
    assert (err_after < err_before).all()
    cam = np.einsum("bij,bkj->bki", p2i, np.stack(
        [out[..., 6] * out[..., 8], out[..., 7] * out[..., 8], out[..., 8],
         np.ones((b, k))], -1))
    np.testing.assert_allclose(out[..., 13:16], cam[..., :3], rtol=1e-12)


# the txt columns (after the class) that the refinement rewrites: alpha, x3d,
# y3d, z3d and ry3d
REFINED_TXT_COLS = [2, 10, 11, 12, 13]


@pytest.mark.parametrize("single", [False, True])
def test_kitti_3d_refine_matches_jax(tmp_path, monkeypatch, single):
    """``test_kitti_3d(refine=True)``, grouped and single-program, against
    JAX's tester with ``refine=True``: the same files, rows and classes, and
    every row at the eval slice's rule, except rows whose f32 climb took
    another step than JAX's (a comparison within a rounding of its
    threshold).  Those are listed, their other columns held to the rule,
    and their refinement from the port's own f32 inputs shown equal to
    JAX's in f64.  Refinement moves rows."""
    split = str(tmp_path / "kitti")
    _tree(split)
    rs = np.random.default_rng(0)
    priors = _anchors(rs)
    rois, rois_3d = _rois(priors)
    bbox_means = rs.normal(0, 0.1, 13).astype(np.float32)
    bbox_stds = rs.uniform(0.5, 1.5, 13).astype(np.float32)
    jmodel, variables, tmodel = tiny_models(
        seed=1, num_anchors=NUM_ANCHORS, predict_acceptance_prob=True)
    jcfg = jax_config.load_config("tiny_synthetic").replace(
        eval_single_program=single)
    tcfg = dataclasses.replace(config.load_config("tiny_synthetic"),
                               eval_single_program=single)
    jdir, tdir, plain = (str(tmp_path / n) for n in ("jax", "torch", "plain"))
    jax_tester.test_kitti_3d(
        jcfg, jmodel, variables["params"], variables["batch_stats"], rois,
        rois_3d, bbox_means, bbox_stds, jax_build_imdb(split, "validation"),
        jdir, batch_size=2, skip_eval=True, refine=True)
    imdb = build_imdb(split, "validation")
    tester.test_kitti_3d(tcfg, tmodel, rois, rois_3d, bbox_means, bbox_stds,
                         imdb, plain, batch_size=2, skip_eval=True)
    inputs = []                   # each batch's (dets, valid, p2, p2_inv)

    def recorded(*args):
        inputs.append([a.numpy().copy() for a in args])
        return inference.refine_detections(*args)

    monkeypatch.setattr(tester, "refine_detections", recorded)
    tester.test_kitti_3d(tcfg, tmodel, rois, rois_3d, bbox_means, bbox_stds,
                         imdb, tdir, batch_size=2, skip_eval=True,
                         refine=True)

    # each written row's batch, image and detection row, in writing order
    where = {}
    chunks = [recs[i:i + 2] for recs in tester._size_groups(imdb, single)
              .values() for i in range(0, len(recs), 2)]
    assert len(chunks) == len(inputs)
    for (dets, valid, p2, p2_inv), chunk in zip(inputs, chunks):
        for bi, rec in enumerate(chunk):
            cls = dets[bi, :, 5] - 1
            where[rec.id + ".txt"] = [
                (dets[bi, i], p2[bi], p2_inv[bi])
                for i in range(dets.shape[1])
                if valid[bi, i] and 0 <= cls[i] < len(tcfg.lbls)
                and dets[bi, i, 4] > tcfg.score_thres]
    got, want = read_rows(tdir), read_rows(jdir)
    assert sorted(got) == sorted(want) == sorted(where)
    other = [i for i in range(15) if i not in REFINED_TXT_COLS]
    n, stepped = 0, []
    for name, rows in want.items():
        assert len(got[name]) == len(rows) == len(where[name]), name
        for j, ((cls_g, v_g), (cls_w, v_w)) in enumerate(zip(got[name],
                                                             rows)):
            assert cls_g == cls_w, name
            n += 1
            if np.allclose(v_g, v_w, rtol=TXT_RTOL, atol=TXT_ATOL):
                continue
            np.testing.assert_allclose(v_g[other], v_w[other], rtol=TXT_RTOL,
                                       atol=TXT_ATOL, err_msg=name)
            stepped.append((name, j))
            det, p2, p2_inv = (np.asarray(a, np.float64)[None]
                               for a in where[name][j])
            det = det[None]
            ours = inference.refine_detections(
                torch.from_numpy(det), torch.ones(1, 1, dtype=torch.bool),
                torch.from_numpy(p2), torch.from_numpy(p2_inv)).numpy()
            with jax.enable_x64(True):
                theirs = np.asarray(jax_inf.refine_detections(
                    det, np.ones((1, 1), bool), p2, p2_inv))
            assert _close(ours, theirs) <= TOL, (name, j)
    print(f"{len(stepped)} of {n} rows took another f32 climb step than "
          f"JAX's (equal in f64): {stepped}")
    assert n >= 5, "no detections written: the comparison checks nothing"
    assert len(stepped) <= n // 4, stepped
    assert read_rows(plain).keys() == got.keys()
    assert any(not np.array_equal(a[1], c[1])
               for name, r in got.items()
               for a, c in zip(r, read_rows(plain)[name])), \
        "refine moved no row"


def test_detect_batch_matches_jax():
    """``detect_batch`` (the model's forward in eval mode, then
    ``im_detect_3d``) on a preprocessed batch against JAX's, at the
    still-image slice's rule (``test_torch_inference.py``)."""
    from groomed_nms_tpu.config import load_config as jax_load_config
    from groomed_nms_tpu.data.augment import preprocess_images as jax_pre

    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.data.augment import preprocess_images
    from test_torch_inference import CROP_HW, _slice_inputs

    jmodel, variables, tmodel = tiny_models(seed=3,
                                            predict_acceptance_prob=True)
    tmodel.train()
    x = _slice_inputs(np.random.default_rng(3), 2)
    keys = ("rois", "rois_3d", "p2", "p2_inv", "scale", "bbox_means",
            "bbox_stds")
    images = jax_pre(jnp.asarray(x["images_u8"]), jnp.zeros(2, bool),
                     x["means_img"], x["stds_img"], target_h=CROP_HW[0],
                     crop_w=CROP_HW[1])
    jcfg = jax_load_config("groomed_nms").detect_config()
    jd, jv = jax.jit(lambda v, im, *a: jax_inf.detect_batch(
        jmodel.apply, v, im, *a, jcfg))(
        variables, images, *(jnp.asarray(x[k]) for k in keys))
    timages = preprocess_images(torch.from_numpy(x["images_u8"]), None,
                                x["means_img"], x["stds_img"],
                                target_h=CROP_HW[0], crop_w=CROP_HW[1])
    td, tv = inference.detect_batch(
        tmodel, timages, *(torch.from_numpy(x[k]) for k in keys),
        load_config("groomed_nms").detect_config())
    assert not tmodel.training and not td.requires_grad
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.sum() >= 20
    np.testing.assert_allclose(td.numpy()[tv.numpy()],
                               np.asarray(jd)[np.asarray(jv)], rtol=1e-4,
                               atol=1e-3)
