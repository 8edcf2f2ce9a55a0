"""The library ops and losses no entry point calls, JAX vs the PyTorch port,
on the CPU: greedy NMS on K2, soft-NMS, the host NMS oracles, RoIAlign, the
exact 3D IoU, anchor clustering, RankNet and the hand-gradient MSE.

Tolerances: keep masks and kept indices identical; soft-NMS scores within
1e-6 (f32; the same decays, the exp's rounding may differ); RoIAlign values
and gradients within 1e-5 (f32 sums in other orders); the exact IoU within
1e-12 (the same f64 arithmetic, a numpy copy); clustered anchors within 1e-9
(f64); RankNet and the MSE, values and gradients within 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu import anchors as jax_anchors
from groomed_nms_tpu.data.imdb import build_imdb as jax_build_imdb
from groomed_nms_tpu.losses.custom_loss import custom_mse as jax_custom_mse
from groomed_nms_tpu.losses.ranknet import ranknet_loss as jax_ranknet
from groomed_nms_tpu.ops import iou3d_exact as jax_iou3d
from groomed_nms_tpu.ops import nms as jax_nms
from groomed_nms_tpu.ops.roi_align import roi_align as jax_roi_align

from groomed_nms_torch import anchors
from groomed_nms_torch.data.imdb import build_imdb
from groomed_nms_torch.data.synthetic import make_synthetic_kitti
from groomed_nms_torch.losses import ranknet_loss
from groomed_nms_torch.losses.custom_loss import custom_mse
from groomed_nms_torch.ops import iou3d_exact, nms
from groomed_nms_torch.ops.geometry import get_corners_of_cuboid
from groomed_nms_torch.ops.iou import iou3d_approximate
from groomed_nms_torch.ops.roi_align import roi_align


def _random_dets(rng, n=60, span=60.0):
    xy = rng.uniform(0, span, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 25, (n, 2))],
                           1).astype(np.float32)
    return boxes, rng.uniform(0.01, 1.0, n).astype(np.float32)


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,padded", [(60, False), (200, False), (40, True)])
def test_greedy_nms_on_k2_matches_jax_and_the_oracles(n, padded):
    """``greedy_nms`` (K2's plain version on the CPU) against JAX's, the
    numpy oracle and the C++ oracle: the same kept set; padded rows never
    kept."""
    for seed in range(4):
        rng = np.random.default_rng(seed)
        boxes, scores = _random_dets(rng, n)
        scores[rng.integers(0, n, 3)] = scores[0]          # ties
        mask = np.ones(n, bool)
        if padded:
            mask[n // 2:] = False
        keep = nms.greedy_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(mask)).numpy()
        want = np.asarray(jax_nms.greedy_nms(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask),
            nms_threshold=0.4, shift=1.0))
        np.testing.assert_array_equal(keep, want)
        assert not keep[~mask].any()
        dets = np.hstack([boxes, scores[:, None]])[mask]
        for oracle in (nms.greedy_nms_numpy, nms.greedy_nms_cpp):
            kept = oracle(dets, 0.4, shift=1.0)
            np.testing.assert_array_equal(
                kept, jax_nms.greedy_nms_numpy(dets, 0.4, shift=1.0))
            assert set(kept.tolist()) == set(np.flatnonzero(keep).tolist())


def test_greedy_nms_oracles_match_jax_with_shift_0():
    rng = np.random.default_rng(9)
    boxes, scores = _random_dets(rng, 80)
    dets = np.hstack([boxes, scores[:, None]])
    want = jax_nms.greedy_nms_numpy(dets, 0.5, shift=0.0)
    np.testing.assert_array_equal(nms.greedy_nms_numpy(dets, 0.5, 0.0), want)
    np.testing.assert_array_equal(nms.greedy_nms_cpp(dets, 0.5, 0.0),
                                  jax_nms.greedy_nms_cpp(dets, 0.5, 0.0))
    assert nms.greedy_nms_cpp(dets, 0.5, 0.0).dtype == np.int64


@pytest.mark.parametrize("method", ["linear", "gaussian", "hard"])
@pytest.mark.parametrize("n", [40, 200])
def test_soft_nms_matches_jax(method, n):
    """keep identical and scores within 1e-6, with a valid mask, and with
    JAX's removal rule exercised (some boxes decayed below the threshold,
    some kept though decayed)."""
    rng = np.random.default_rng(n)
    boxes, scores = _random_dets(rng, n, span=40.0)
    mask = rng.uniform(size=n) > 0.1
    kw = dict(nms_threshold=0.3, sigma=0.5, method=method,
              score_threshold=0.05)
    got_s, got_k = nms.soft_nms(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(mask), **kw)
    want_s, want_k = jax_nms.soft_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(mask), **kw)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-6)
    keep = got_k.numpy()
    assert keep.any() and (mask & ~keep).any()
    assert not keep[~mask].any()


def test_soft_nms_hard_is_greedy_and_gaussian_decays():
    for seed in range(4):
        boxes, scores = _random_dets(np.random.default_rng(seed), 40)
        _, keep = nms.soft_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores), method="hard")
        want = nms.greedy_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores))
        assert torch.equal(keep, want)
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                         dtype=torch.float32)
    new, keep = nms.soft_nms(boxes, torch.tensor([0.9, 0.8, 0.7]),
                             method="gaussian", sigma=0.5)
    assert new[0] == 0.9 and new[1] < 0.8 and abs(new[2] - 0.7) < 1e-6
    assert keep.all()
    with pytest.raises(ValueError, match="method"):
        nms.soft_nms(boxes, torch.ones(3), method="cubic")


def test_top_k_after_nms_matches_jax():
    rng = np.random.default_rng(4)
    dets = np.hstack([rng.uniform(0, 50, (30, 4)),
                      rng.uniform(0, 1, (30, 1))]).astype(np.float32)
    dets[5, 4] = dets[7, 4]                               # a tie
    keep = rng.uniform(size=30) > 0.3
    for top_n, thr in ((10, None), (30, 0.5), (3, 0.99)):
        np.testing.assert_array_equal(
            nms.top_k_after_nms(dets, keep, top_n, thr),
            jax_nms.top_k_after_nms(dets, keep, top_n, thr))
    out = nms.top_k_after_nms(dets, keep, 2)
    assert out.shape == (2, 5) and out[0, 4] >= out[1, 4]


# ---------------------------------------------------------------------------
# RoIAlign
# ---------------------------------------------------------------------------

def _roi_case(seed, h=12, w=20, c=3, n=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(h, w, c)).astype(np.float32)
    xy = rng.uniform(-4, [w * 2, h * 2], (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0.3, 16, (n, 2))],
                          1).astype(np.float32)
    rois[0] = [-6, -6, 50, 40]               # past every edge: clamped
    return feats, rois


@pytest.mark.parametrize("reduction", ["avg", "max"])
@pytest.mark.parametrize("kw", [dict(output_size=(2, 2)),
                                dict(output_size=(3, 4), spatial_scale=0.5,
                                     sampling_ratio=3)])
def test_roi_align_matches_jax_with_gradients(reduction, kw):
    feats, rois = _roi_case(0)
    kw = dict(kw, reduction=reduction)
    cot = np.random.default_rng(1).normal(
        size=(rois.shape[0], *kw["output_size"], feats.shape[-1])).astype(
        np.float32)
    want = np.asarray(jax_roi_align(jnp.asarray(feats), jnp.asarray(rois),
                                    **kw))
    gf, gr = jax.grad(lambda f, r: (jax_roi_align(f, r, **kw) * cot).sum(),
                      argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(rois))
    f_t = torch.from_numpy(feats).requires_grad_()
    r_t = torch.from_numpy(rois).requires_grad_()
    got = roi_align(f_t, r_t, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(gf), atol=1e-5)
    np.testing.assert_allclose(r_t.grad.numpy(), np.asarray(gr), atol=1e-5)
    assert np.abs(f_t.grad.numpy()).sum() > 0


def test_roi_align_constant_map_and_max_over_avg():
    out = roi_align(torch.full((16, 16, 3), 5.0),
                    torch.tensor([[2.0, 2.0, 10.0, 10.0]]),
                    output_size=(4, 4))
    assert out.shape == (1, 4, 4, 3)
    torch.testing.assert_close(out, torch.full_like(out, 5.0))
    feats, rois = _roi_case(2)
    feats, rois = torch.from_numpy(feats), torch.from_numpy(rois)
    avg = roi_align(feats, rois, output_size=(2, 2))
    mx = roi_align(feats, rois, output_size=(2, 2), reduction="max")
    assert (mx >= avg - 1e-6).all()
    with pytest.raises(ValueError, match="reduction"):
        roi_align(feats, rois, reduction="sum")


# ---------------------------------------------------------------------------
# exact 3D IoU
# ---------------------------------------------------------------------------

def test_iou3d_exact_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        a = (rng.uniform(-5, 5), rng.uniform(0, 2), rng.uniform(10, 30),
             *rng.uniform([1.4, 1.4, 3.0], [2.0, 1.8, 4.5]),
             rng.uniform(-np.pi, np.pi))
        b = tuple(np.array(a) + np.concatenate(
            [rng.uniform(-1.5, 1.5, 3), rng.uniform(-0.3, 0.3, 3),
             rng.uniform(-1, 1, 1)]))
        assert abs(iou3d_exact.iou3d_exact(a, b)
                   - jax_iou3d.iou3d_exact(a, b)) <= 1e-12
        bev = lambda box: (box[0], box[2], box[3], box[5], box[6])
        assert abs(iou3d_exact.iou_bev_exact(bev(a), bev(b))
                   - jax_iou3d.iou_bev_exact(bev(a), bev(b))) <= 1e-12
        np.testing.assert_allclose(iou3d_exact.bev_footprint(*bev(a)),
                                   jax_iou3d.bev_footprint(*bev(a)),
                                   rtol=0, atol=1e-12)


def test_iou3d_exact_known_cases():
    box = (1.0, 1.5, 20.0, 1.6, 1.5, 3.9, 0.3)
    assert iou3d_exact.iou3d_exact(box, box) == pytest.approx(1.0, abs=1e-9)
    far = (50.0, 1.5, 20.0, 1.6, 1.5, 3.9, 0.0)
    assert iou3d_exact.iou3d_exact(box, far) == 0.0
    a = (0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0)
    b = (0.5, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0)
    assert iou3d_exact.iou3d_exact(a, b) == pytest.approx(0.5 / 1.5, abs=1e-9)
    inter = 2 * (math.sqrt(2) - 1)              # the 45-degree octagon
    rot = (0.0, 0.0, 0.0, 1.0, 1.0, 1.0, math.pi / 4)
    assert iou3d_exact.iou3d_exact(a, rot) == pytest.approx(
        inter / (2 - inter), abs=1e-9)


def test_iou3d_approximate_equals_exact_for_axis_aligned_boxes():
    rng = np.random.default_rng(0)
    for _ in range(20):
        x, z = rng.uniform(-5, 5, 2)
        a = (x, 1.5, 20.0 + z, 1.6, 1.5, 3.9, 0.0)
        b = (x + rng.uniform(-1, 1), 1.5, 20.0 + z + rng.uniform(-1, 1), 1.6,
             1.5, 3.9, 0.0)
        ca, cb = (get_corners_of_cuboid(*(torch.tensor([v], dtype=torch.float64)
                                          for v in box)) for box in (a, b))
        _, approx = iou3d_approximate(ca, cb, pairwise=False)
        assert abs(float(approx[0]) - iou3d_exact.iou3d_exact(a, b)) <= 1e-9


# ---------------------------------------------------------------------------
# anchor clustering
# ---------------------------------------------------------------------------

def _cluster_gts(rng, stride):
    rows = []
    for mode_wh, mode_z in (((40, 30), 20.0), ((200, 120), 5.0)):
        for _ in range(100):
            w, h = rng.normal(mode_wh, (2, 2))
            b3 = np.zeros(16)
            b3[2] = rng.normal(mode_z, 0.5)
            b3[3:6] = rng.normal([1.6, 1.5, 3.9], 0.1)
            b3[6] = rng.uniform(-0.5, 0.5)
            b3[10] = rng.uniform(-3, 3)               # rotY: not a prior
            rows.append(np.concatenate([anchors.anchor_center(w, h, stride),
                                        b3]))
    return np.stack(rows)


def test_cluster_anchors_matches_jax():
    """Two GT size modes pull two seed anchors onto their means: the port
    against JAX in f64 within 1e-9, the 3D columns from GT columns 6..10
    (alpha, not rotY), the decomp-alpha columns untouched; an anchor no GT
    prefers raises."""
    rng = np.random.default_rng(0)
    stride = 16
    gts = _cluster_gts(rng, stride)
    seeds = np.zeros((2, 11))
    seeds[0, :4] = anchors.anchor_center(50, 35, stride)
    seeds[1, :4] = anchors.anchor_center(180, 110, stride)
    seeds[:, 9:] = [[0.1, 0.2], [0.3, 0.4]]
    out = anchors.cluster_anchors(seeds, gts, stride)
    want = jax_anchors.cluster_anchors(seeds, gts, stride)
    assert out.dtype == np.float64 and out.shape == (2, 11)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(out[:, 4], [20.0, 5.0], atol=0.5)
    np.testing.assert_array_equal(out[:, 9:], seeds[:, 9:])
    assert np.abs(out[:, 8]).max() < 0.5            # alpha's range
    w_out, h_out = out[:, 2] - out[:, 0], out[:, 3] - out[:, 1]
    np.testing.assert_allclose([w_out[0], h_out[0]], [40, 30], atol=6)
    np.testing.assert_allclose([w_out[1], h_out[1]], [200, 120], atol=12)
    far = np.zeros((3, 9))
    far[:2] = seeds[:, :9]
    far[2, :4] = anchors.anchor_center(1000, 900, stride)
    with pytest.raises(ValueError, match="Non-used anchor #2 found"):
        anchors.cluster_anchors(far, gts, stride)
    np.testing.assert_array_equal(
        anchors.cluster_anchors(seeds, np.zeros((0, 20)), stride), seeds)
    np.testing.assert_array_equal(
        anchors._np_iou_corners(gts[:7, :4], gts[3:20, :4]),
        jax_anchors._np_iou_corners(gts[:7, :4], gts[3:20, :4]))


def test_normalized_gts_for_clustering_matches_jax(tmp_path):
    root = str(tmp_path / "kitti")
    make_synthetic_kitti(root, "training", 6, im_h=96, im_w=320, seed=4,
                         classes=("Car", "Pedestrian", "Cyclist"))
    kw = dict(feat_stride=16, test_scale=96, lbls=["Car"],
              ilbls=["Van", "ignore"])
    got = anchors.normalized_gts_for_clustering(build_imdb(root, "training"),
                                                **kw)
    want = jax_anchors.normalized_gts_for_clustering(
        jax_build_imdb(root, "training"), **kw)
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got[:, 3] - got[:, 1]) >= 0).all()


# ---------------------------------------------------------------------------
# RankNet and the hand-gradient MSE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_by_diff", [False, True])
def test_ranknet_loss_matches_jax_with_gradients(weight_by_diff):
    rng = np.random.default_rng(3)
    s = rng.normal(0, 2, 24).astype(np.float32)
    rel = rng.integers(0, 4, 24).astype(np.float32)
    mask = rng.uniform(size=24) > 0.2
    fn = lambda x: jax_ranknet(x, jnp.asarray(rel), jnp.asarray(mask),
                               weight_by_diff=weight_by_diff)
    want, g_want = jax.value_and_grad(fn)(jnp.asarray(s))
    s_t = torch.from_numpy(s).requires_grad_()
    got = ranknet_loss(s_t, torch.from_numpy(rel), torch.from_numpy(mask),
                       weight_by_diff=weight_by_diff)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(g_want),
                               rtol=1e-6, atol=1e-6)


def test_ranknet_prefers_the_right_order_and_ignores_padding():
    rel = torch.tensor([2.0, 1.0, 0.0])
    good = ranknet_loss(torch.tensor([2.0, 1.0, 0.0]), rel)
    assert good < ranknet_loss(torch.tensor([0.0, 1.0, 2.0]), rel)
    padded = ranknet_loss(torch.tensor([2.0, 1.0, 0.0, 9.0]),
                          torch.tensor([2.0, 1.0, 0.0, 5.0]),
                          torch.tensor([True, True, True, False]))
    torch.testing.assert_close(padded, good, rtol=0, atol=1e-6)
    assert ranknet_loss(torch.ones(3), torch.ones(3)) == 0


@pytest.mark.parametrize("w", [1.0, 2.5])
def test_custom_mse_matches_jax_and_autograd(w):
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(4, 16)).astype(np.float32)
    tar = rng.normal(size=(4, 16)).astype(np.float32)
    want, g_want = jax.value_and_grad(
        lambda p: jax_custom_mse(p, jnp.asarray(tar), w))(jnp.asarray(pred))
    p_t = torch.from_numpy(pred).requires_grad_()
    t_t = torch.from_numpy(tar).requires_grad_()
    got = custom_mse(p_t, t_t, w)
    (got * 3.0).backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p_t.grad.numpy(), 3.0 * np.asarray(g_want),
                               rtol=1e-6, atol=1e-7)
    assert t_t.grad is None                   # no gradient to the target
    p2 = torch.from_numpy(pred).requires_grad_()
    (w * ((p2 - torch.from_numpy(tar)) ** 2).mean() * 3.0).backward()
    torch.testing.assert_close(p_t.grad, p2.grad, rtol=1e-6, atol=1e-7)
