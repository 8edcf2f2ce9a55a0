"""The port's loss path against JAX: geometry and IoU helpers, target
assignment, the AP loss and ``rpn_3d_loss`` on shared head tensors.

The JAX loss is compiled once per config (value and gradient together); the
port runs its CPU path, K3 through its plain version.  Tolerances: helpers
and targets at rtol 1e-5 / atol 1e-5 (the same f32 formulas); every stats
term at rtol 1e-4, atol 1e-6; gradients with respect to every head tensor
at rtol 1e-3, atol 1e-5 (sums over the batch in other orders, and the AP
loss's [N, N] products).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu import anchors as janchors
from groomed_nms_tpu.config import load_config as jax_load_config
from groomed_nms_tpu.losses import aploss as japloss
from groomed_nms_tpu.losses import rpn_3d as jloss
from groomed_nms_tpu.ops import boxes as jboxes
from groomed_nms_tpu.ops import geometry as jgeom
from groomed_nms_tpu.ops import iou as jiou

from groomed_nms_torch import anchors as tanchors
from groomed_nms_torch.config import load_config
from groomed_nms_torch.losses import rpn_3d as tloss
from groomed_nms_torch.losses.aploss import ap_loss
from groomed_nms_torch.ops import boxes as tboxes
from groomed_nms_torch.ops import geometry as tgeom
from groomed_nms_torch.ops import iou as tiou

HELPER_RTOL, HELPER_ATOL = 1e-5, 1e-5
STATS_RTOL, STATS_ATOL = 1e-4, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5

B, FH, FW, A = 2, 4, 8, 6                   # the tiny_setup shapes
R = FH * FW * A


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=HELPER_RTOL, atol=HELPER_ATOL, **kw):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               **kw)


def _cuboids(rs, shape):
    return [rs.uniform(-8, 8, shape), rs.uniform(0.5, 2, shape),
            rs.uniform(10, 40, shape), rs.uniform(1, 2.5, shape),
            rs.uniform(1, 2, shape), rs.uniform(2, 5, shape),
            rs.uniform(-3.1, 3.1, shape)]


# ---------------------------------------------------------------------------
# geometry and IoU helpers
# ---------------------------------------------------------------------------

def test_corners_and_3d_iou_match_jax():
    rs = np.random.default_rng(0)
    ca = [a.astype(np.float32) for a in _cuboids(rs, (2, 30))]
    cb = [a.astype(np.float32) for a in _cuboids(rs, (2, 20))]
    ca[0][:, :5] = cb[0][:, :5] + 0.4                  # overlapping pairs
    ca[2][:, :5] = cb[2][:, :5] - 0.3
    ja, jb = (jgeom.get_corners_of_cuboid(*map(jnp.asarray, c))
              for c in (ca, cb))
    ta, tb = (tgeom.get_corners_of_cuboid(*map(_t, c)) for c in (ca, cb))
    _close(ta, ja)
    _close(tiou.aabb_volume(ta), jiou.aabb_volume(ja), rtol=1e-5)
    _close(tiou.bev_boxes_from_corners(ta), jiou.bev_boxes_from_corners(ja))
    for generalized in (False, True):
        got = tiou.iou3d_approximate(ta, tb, pairwise=True,
                                     generalized=generalized)
        for i in range(2):
            ref = jiou.iou3d_approximate(ja[i], jb[i], pairwise=True,
                                         generalized=generalized)
            for g, r in zip(got, ref):
                _close(g[i], r)
        got = tiou.iou3d_approximate(ta[:, :20], tb, pairwise=False,
                                     generalized=generalized)
        ref = jiou.iou3d_approximate(ja[:, :20].reshape(-1, 3, 8),
                                     jb.reshape(-1, 3, 8), pairwise=False,
                                     generalized=generalized)
        for g, r in zip(got, ref):
            _close(g.reshape(-1), r)


def test_2d_iou_helpers_match_jax():
    rs = np.random.default_rng(1)
    a = rs.uniform(0, 100, (40, 4)).astype(np.float32)
    a[:, 2:] = a[:, :2] + rs.uniform(5, 50, (40, 2)).astype(np.float32)
    b = a[::-1] + rs.normal(0, 5, a.shape).astype(np.float32)
    for fn in ("pairwise_iou", "pairwise_iou_ign", "pairwise_intersect"):
        _close(getattr(tiou, fn)(_t(a), _t(b)),
               getattr(jiou, fn)(jnp.asarray(a), jnp.asarray(b)))
    for fn in ("elementwise_iou", "elementwise_intersect"):
        _close(getattr(tiou, fn)(_t(a), _t(b)),
               getattr(jiou, fn)(jnp.asarray(a), jnp.asarray(b)))
    # batched pairwise: a leading axis
    _close(tiou.pairwise_iou(_t(np.stack([a, b])), _t(np.stack([b, a])))[1],
           jiou.pairwise_iou(jnp.asarray(b), jnp.asarray(a)))


@pytest.mark.parametrize("decomp_alpha,has_vel,vel_col", [
    (True, False, False), (False, False, False), (True, True, True),
    (True, True, False)])
def test_box_transforms_match_jax(decomp_alpha, has_vel, vel_col):
    rs = np.random.default_rng(2)
    ex = rs.uniform(0, 100, (30, 4)).astype(np.float32)
    ex[:, 2:] = ex[:, :2] + rs.uniform(10, 60, (30, 2)).astype(np.float32)
    gt = ex + rs.normal(0, 4, ex.shape).astype(np.float32)
    prior = rs.uniform(1, 3, (30, 8 if has_vel else 7)).astype(np.float32)
    gt3 = rs.uniform(0.5, 3, (30, 17 if vel_col else 16)).astype(np.float32)
    _close(tboxes.bbox_transform(_t(ex), _t(gt)),
           jboxes.bbox_transform(jnp.asarray(ex), jnp.asarray(gt)))
    got = tboxes.bbox_transform_3d(_t(ex), _t(prior), _t(gt3),
                                   decomp_alpha=decomp_alpha, has_vel=has_vel)
    ref = jboxes.bbox_transform_3d(jnp.asarray(ex), jnp.asarray(prior),
                                   jnp.asarray(gt3), decomp_alpha=decomp_alpha,
                                   has_vel=has_vel)
    _close(got, ref)
    if has_vel:
        with pytest.raises(ValueError, match="8-column"):
            tboxes.bbox_transform_3d(_t(ex), _t(prior[:, :7]), _t(gt3),
                                     decomp_alpha=True, has_vel=True)


# ---------------------------------------------------------------------------
# target assignment
# ---------------------------------------------------------------------------

def _rois():
    rs = np.random.default_rng(0)
    templates = janchors.generate_anchor_templates([16, 32], [0.5, 1.0, 1.5],
                                                   16)
    priors = np.concatenate(
        [templates, np.abs(rs.normal(size=(A, 7))).astype(np.float32) + 1.0],
        axis=1)
    priors[:, 4] = 30.0                          # the GTs' depth and size
    priors[:, 5:8] += np.array([1.6, 1.5, 3.9], np.float32) - priors[:, 5:8]
    rois = janchors.locate_anchors(priors, (FH, FW), 16)
    return rois, priors[rois[:, 4].astype(np.int64), 4:]


def _gt_batch(seed, n_gt=(6, 5), ign=(0, 0)):
    """numpy GTBatch fields at the tiny image size (64 x 128): ``n_gt`` valid
    GTs and ``ign`` ignore regions per image, axis/head labels random.  Each
    GT sits near an anchor centre with about an anchor's size, so a few
    anchors are foreground for it and GrooMeD-NMS forms groups; the 3D
    centres back-project the 2D centres at depth 30, so predictions near a
    GT overlap it in 3D too and the after-NMS targets are not empty."""
    rs = np.random.default_rng(seed)
    g, i = 7, 2
    gts_2d = np.zeros((B, g, 4), np.float32)
    gts_3d = np.zeros((B, g, 16), np.float32)
    gt_valid = np.zeros((B, g), bool)
    ign_2d = np.zeros((B, i, 4), np.float32)
    for bi in range(B):
        for gi in range(n_gt[bi]):
            cx = 16 * rs.integers(1, FW // 2 + 1) + 7.5 + rs.normal(0, 2)
            cy = 16 * rs.integers(1, FH - 1) + 7.5 + rs.normal(0, 2)
            w = rs.choice([8, 16, 24, 32, 48]) * rs.uniform(0.9, 1.1)
            h = rs.choice([16, 32]) * rs.uniform(0.9, 1.1)
            gts_2d[bi, gi] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            gts_3d[bi, gi] = [cx, cy, 30.0, 1.6, 1.5, 3.9, rs.uniform(-3, 3),
                              (cx - 64) * 30 / 700, (cy - 32) * 30 / 700, 30.0,
                              rs.uniform(-0.5, 0.5), 0.1, 0.2, -0.9,
                              rs.integers(0, 2), rs.integers(0, 2)]
            gt_valid[bi, gi] = True
        for ii in range(ign[bi]):
            x1, y1 = rs.uniform(0, 100), rs.uniform(0, 40)
            ign_2d[bi, ii] = [x1, y1, x1 + 30, y1 + 20]
    ign_valid = np.zeros((B, i), bool)
    for bi in range(B):
        ign_valid[bi, :ign[bi]] = True
    p2 = np.tile(np.eye(4, dtype=np.float32)[None], (B, 1, 1))
    p2[:, 0, 0] = p2[:, 1, 1] = 700.0
    p2[:, 0, 2], p2[:, 1, 2] = 64.0, 32.0
    return dict(gts_2d=gts_2d, gts_3d=gts_3d,
                gt_labels=rs.integers(1, 4, (B, g)).astype(np.float32),
                gt_valid=gt_valid, ign_2d=ign_2d, ign_valid=ign_valid, p2=p2,
                scale=np.full((B,), 1.0, np.float32))


TARGET_KW = dict(fg_thresh=0.5, ign_thresh=0.5, bg_thresh_lo=0.0,
                 bg_thresh_hi=0.5, best_thresh=0.35)


@pytest.mark.parametrize("n_gt,ign", [((3, 3), (0, 0)), ((4, 0), (1, 2)),
                                      ((0, 2), (0, 1)), ((0, 0), (0, 0))])
def test_compute_targets_match_jax(n_gt, ign):
    rois, rois_3d = _rois()
    gt = _gt_batch(5, n_gt, ign)
    gt["gts_3d"][0, 0, 15] = -np.inf           # a non-finite GT entry
    fields = ("gts_2d", "gts_3d", "gt_labels", "gt_valid", "ign_2d",
              "ign_valid")
    ref = jax.vmap(lambda *a: janchors.compute_targets(
        jnp.asarray(rois), jnp.asarray(rois_3d), *a, **TARGET_KW))(
        *(jnp.asarray(gt[f]) for f in fields))
    got = tanchors.compute_targets(_t(rois), _t(rois_3d),
                                   *(_t(gt[f]) for f in fields), **TARGET_KW)
    for name in tanchors.Targets._fields:
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        if g.dtype in (torch.bool, torch.int64):
            fg = np.asarray(ref.fg_mask)
            if name == "gt_index":              # meaningful on fg rows only
                g, r = g.numpy()[fg], r[fg]
            np.testing.assert_array_equal(np.asarray(g), r, err_msg=name)
        else:
            _close(g, r, err_msg=name)


# ---------------------------------------------------------------------------
# AP loss
# ---------------------------------------------------------------------------

def test_ap_loss_value_and_gradient_match_jax():
    rs = np.random.default_rng(3)
    n = 64
    logits = rs.normal(size=(4, n)).astype(np.float32)
    logits[0, 10:14] = logits[0, 9]                    # ties
    targets = rs.choice([1.0, 0.0, -1.0], size=(4, n),
                        p=[0.2, 0.6, 0.2]).astype(np.float32)
    targets[2] = np.where(targets[2] == 1, 0.0, targets[2])   # no positive
    cot = rs.normal(size=4).astype(np.float32)
    lt = _t(logits).requires_grad_()
    val = ap_loss(lt, _t(targets))
    (val * _t(cot)).sum().backward()
    for i in range(4):
        ref_val, ref_vjp = jax.vjp(
            lambda x: japloss.ap_loss(x, jnp.asarray(targets[i])),
            jnp.asarray(logits[i]))
        _close(val[i], ref_val, rtol=STATS_RTOL, atol=STATS_ATOL)
        _close(lt.grad[i], ref_vjp(jnp.float32(cot[i]))[0], rtol=GRAD_RTOL,
               atol=GRAD_ATOL)
    assert val[2].item() == 0.0 and not lt.grad[2].any()


# ---------------------------------------------------------------------------
# rpn_3d_loss on shared head tensors
# ---------------------------------------------------------------------------

CONFIGS = [
    ("groomed_nms", {}),
    ("groomed_nms", {"acceptance_prob_lambda": 0.5}),   # likelihood, fg
    ("kitti_3d_warmup", {}),
    ("groomed_nms_sigmoidal", {}),
    ("groomed_nms_soft_nms_0_5", {}),
    ("groomed_nms_no_group", {}),
    ("groomed_nms_group_no_mask", {}),
    ("groomed_nms_cross_entropy", {}),
    ("groomed_nms_no_rankwise_AP", {}),
    # the shipped acceptance_{all,overlaps} configs set lambda 0, which
    # skips the branch they select; a lambda runs it
    ("groomed_nms_acceptance_all", {"acceptance_prob_lambda": 0.5}),
    ("groomed_nms_acceptance_overlaps", {"acceptance_prob_lambda": 0.5}),
    ("groomed_nms_acceptance_classify", {}),
    ("groomed_nms_threshold_0_5", {}),
    ("groomed_nms", {"overlap_in_nms": "3d"}),
    ("groomed_nms", {"overlap_in_nms": "2d_3d"}),
]


def _heads(seed, cfg):
    """Raw head tensors (numpy): class logits, 2D deltas, 3D deltas with the
    axis/head logits, and the acceptance logits (one per classifier in
    classify mode)."""
    rs = np.random.default_rng(seed)
    heads = {"cls": rs.normal(0, 1.5, (B, R, 4)),
             "bbox_2d": rs.normal(0, 0.1, (B, R, 4)),
             "bbox_3d": rs.normal(0, 0.2, (B, R, 10))}
    if cfg.predict_acceptance_prob:
        bins = cfg.acceptance_prob_classify_bins - 1 \
            if cfg.acceptance_prob_mode == "classify" else 1
        heads["accept"] = rs.normal(0, 1.5, (B, R, bins))
    return {k: v.astype(np.float32) for k, v in heads.items()}


def _outputs(xp, heads, classify):
    """The model's split of the head tensors, in numpy-like ``xp``."""
    if xp is jnp:
        softmax, sigmoid, cat = jax.nn.softmax, jax.nn.sigmoid, \
            jnp.concatenate
    else:
        softmax, sigmoid, cat = torch.softmax, torch.sigmoid, torch.cat
    b3 = heads["bbox_3d"]
    out = {"cls": heads["cls"], "prob": softmax(heads["cls"], -1),
           "bbox_2d": heads["bbox_2d"],
           "bbox_3d": cat([b3[..., :8], sigmoid(b3[..., 8:10])], -1)}
    if "accept" in heads:
        if classify:
            out["accept_cls"] = sigmoid(heads["accept"])
        else:
            out["accept_prob"] = sigmoid(heads["accept"][..., 0])
    return out


def _run_both(name, overrides, gt_seed=7, n_gt=(6, 5), ign=(1, 0)):
    jcfg = dataclasses.replace(jax_load_config(name).loss_config(),
                               **overrides)
    tcfg = dataclasses.replace(load_config(name).loss_config(), **overrides)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    rois, rois_3d = _rois()
    gt = _gt_batch(gt_seed, n_gt, ign)
    heads = _heads(11, tcfg)
    classify = tcfg.acceptance_prob_mode == "classify"
    means = np.zeros(13, np.float32)
    stds = np.ones(13, np.float32)
    un = (np.float32(0.7), np.int32(3))

    def jax_loss(h):
        loss, stats, new_un = jloss.rpn_3d_loss(
            _outputs(jnp, h, classify), jnp.asarray(rois),
            jnp.asarray(rois_3d), jloss.GTBatch(**{
                k: jnp.asarray(v) for k, v in gt.items()}),
            jnp.asarray(means), jnp.asarray(stds),
            jloss.UncertaintyState(jnp.asarray(un[0]), jnp.asarray(un[1])),
            jcfg)
        return loss, (stats, new_un)

    (_, (jstats, jun)), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))({k: jnp.asarray(v) for k, v in heads.items()})

    th = {k: _t(v).requires_grad_() for k, v in heads.items()}
    loss, tstats, tun = tloss.rpn_3d_loss(
        _outputs(torch, th, classify), _t(rois), _t(rois_3d),
        tloss.GTBatch(**{k: _t(v) for k, v in gt.items()}), _t(means),
        _t(stds), tloss.UncertaintyState(_t(un[0]), _t(un[1])), tcfg)
    loss.backward()
    return (jstats, jun, jgrads), (tstats, tun, {k: v.grad for k, v in
                                                 th.items()})


@pytest.mark.parametrize("name,overrides", CONFIGS,
                         ids=[n + "".join(f"-{v}" for v in o.values())
                              for n, o in CONFIGS])
def test_rpn_3d_loss_matches_jax(name, overrides):
    (jstats, jun, jgrads), (tstats, tun, tgrads) = _run_both(name, overrides)
    assert set(tstats) == set(jstats)
    assert float(jstats["fg_num"]) > 0
    for k in jstats:
        _close(tstats[k], jstats[k], rtol=STATS_RTOL, atol=STATS_ATOL,
               err_msg=k)
    _close(tun.lam, jun.lam, rtol=STATS_RTOL, atol=STATS_ATOL)
    assert int(tun.n) == int(jun.n)
    for k in jgrads:
        assert tgrads[k] is not None, k
        assert torch.isfinite(tgrads[k]).all(), k
        _close(tgrads[k], jgrads[k], rtol=GRAD_RTOL, atol=GRAD_ATOL,
               err_msg=k)


def test_rpn_3d_loss_image_without_gt_has_finite_gradients():
    (jstats, _, jgrads), (tstats, _, tgrads) = _run_both(
        "groomed_nms", {"acceptance_prob_lambda": 0.5}, n_gt=(0, 6),
        ign=(0, 0))
    for k in jstats:
        _close(tstats[k], jstats[k], rtol=STATS_RTOL, atol=STATS_ATOL,
               err_msg=k)
    for k, g in tgrads.items():
        assert torch.isfinite(g).all(), k
        _close(g, jgrads[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("overrides", [
    {"has_un": True}, {"has_vel": True},
    {"predict_acceptance_prob": True, "acceptance_prob_lambda": 0.1,
     "acceptance_prob_mode": "rank"},
    {"predict_acceptance_prob": True, "acceptance_prob_lambda": 0.1,
     "acceptance_prob_mode": "regress"},
    {"focal_loss": 2.0}, {"weigh_3D_regression_loss_by_gt_iou3d": True},
    {"use_nms_in_loss": True, "after_nms_loss_mode": "regress"},
])
def test_unported_branches_raise(overrides):
    cfg = tloss.LossConfig(**overrides)
    with pytest.raises(NotImplementedError, match=next(iter(
            k for k in overrides if k not in (
                "predict_acceptance_prob", "acceptance_prob_lambda",
                "use_nms_in_loss")))):
        tloss.rpn_3d_loss({}, None, None, None, None, None, None, cfg)
