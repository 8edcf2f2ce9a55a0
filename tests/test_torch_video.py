"""The video model's test path, JAX vs the PyTorch port, on the CPU: the
projection helpers, each tracker function, multi-frame rollouts, PoseNet
and VideoRPN3D with flax weights carried by ``from_flax``, the
measurements (K1 and K2 through their plain versions), the composed clip
and ``scripts/test_kalman_torch.py`` as a subprocess.

Tolerances.  The tracker has discrete points (the association thresholds,
``z > 1``, ``un > K_M``), so its comparisons run in f64 in both packages
(``jax.enable_x64``): ``valid``, ``ids`` and ``next_id`` identical, ``X``,
``C``, ``A``, ``box2d`` and ``un`` within rtol 1e-8, atol 1e-8 (the same
formulas summed in other orders, and another LU).  The projection helpers
in f32 at rtol 1e-5, atol 1e-3 px.  The forward in f32 at atol 1e-4 (as
``test_torch_model.py``).  The measurements in f32: the kept sets
identical, the kept rows within rtol 1e-5, atol 1e-4.  KITTI rows of the
composed clip: the same files, rows and classes, every number within
1e-3 + 1e-4 |x| (as ``test_torch_eval.py``).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu import inference as jinf
from groomed_nms_tpu.data.augment import preprocess_images as jax_preprocess
from groomed_nms_tpu.models import kalman as jk
from groomed_nms_tpu.models import video as jv
from groomed_nms_tpu.models.densenet import tiny_densenet_config as jax_tiny
from groomed_nms_tpu.models.rpn_3d import RPNConfig as JaxRPNConfig
from groomed_nms_tpu.models.rpn_3d import RPNOutputs as JaxRPNOutputs
from groomed_nms_tpu.ops import geometry as jgeom
from groomed_nms_tpu.utils import torch_weights as jweights

from groomed_nms_torch import inference as tinf
from groomed_nms_torch.data.augment import preprocess_images
from groomed_nms_torch.data.synthetic import (kitti_p2,
                                              make_synthetic_track_clip)
from groomed_nms_torch.models import kalman as tk
from groomed_nms_torch.models import video as tv
from groomed_nms_torch.models.densenet import tiny_densenet_config
from groomed_nms_torch.models.rpn_3d import RPNConfig, RPNOutputs
from groomed_nms_torch.ops import geometry as tgeom
from groomed_nms_torch.utils import video_weights as tvw
from groomed_nms_torch.utils.weights import from_flax
from test_torch_eval import assert_same_rows, read_rows
from torch_port_common import _perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_RTOL, F64_ATOL = 1e-8, 1e-8
FIELDS = ("valid", "ids", "next_id", "X", "C", "A", "box2d", "un")
P2 = np.concatenate([kitti_p2(), [[0.0, 0.0, 0.0, 1.0]]])   # 1242x375


def _t(x):
    return torch.from_numpy(np.array(x))


# the JAX tracker functions, jitted: one compile each instead of a dispatch
# (and a compile) per operation
J = {name: jax.jit(getattr(jk, name), static_argnums=static) for name, static
     in (("project_ego", ()), ("forecast_tracks", ()),
         ("_greedy_match", (2, 3)), ("associate_tracks", ()),
         ("update_tracks", ()), ("add_unused_measurements", ()))}
J["video_track"] = jax.jit(jv.video_track, static_argnums=4)
J["extract_measurements"] = jax.jit(jv.extract_measurements,
                                    static_argnums=7)


def _jax_tracks(tr):
    return jk.Tracks(**{f: jnp.asarray(getattr(tr, f).numpy())
                        for f in FIELDS})


def _assert_tracks(got, ref, where=""):
    """The port's Tracks against JAX's (f64): masks and ids identical, every
    slot's numbers within F64_RTOL / F64_ATOL."""
    for f in FIELDS:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        if f in ("valid", "ids", "next_id"):
            np.testing.assert_array_equal(g, r, err_msg=f"{where} {f}")
        else:
            np.testing.assert_allclose(g, r, rtol=F64_RTOL, atol=F64_ATOL,
                                       err_msg=f"{where} {f}")


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------

def test_projection_helpers_match_jax():
    rs = np.random.default_rng(0)
    n = 40
    cub = [rs.uniform(-10, 10, n), rs.uniform(0.5, 2, n),
           rs.uniform(-2, 40, n), rs.uniform(1, 2, n), rs.uniform(1, 2, n),
           rs.uniform(3, 5, n), rs.uniform(-3.1, 3.1, n)]
    cub[2][:5] = [0.001, -0.004, 0.5, 1e-3, 2.0]     # the |z| <= 1e-2 branch
    cub = [c.astype(np.float32) for c in cub]
    p2 = P2.astype(np.float32)
    pts = rs.uniform(-5, 30, (3, 3, 8)).astype(np.float32)
    pts[0, 2, :3] = [0.0, 5e-3, -5e-3]
    np.testing.assert_allclose(
        tgeom.project_3d_points(_t(p2), _t(pts)).numpy(),
        np.asarray(jgeom.project_3d_points(jnp.asarray(p2),
                                           jnp.asarray(pts))),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        tgeom.project_3d_box(_t(p2), *map(_t, cub)).numpy(),
        np.asarray(jgeom.project_3d_box(jnp.asarray(p2),
                                        *map(jnp.asarray, cub))),
        rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# the tracker, f64
# ---------------------------------------------------------------------------

def _states(rs, t):
    """Random f64 track states (numpy): a quarter of the slots empty."""
    x = np.stack([rs.uniform(-10, 10, t), rs.uniform(0.5, 2, t),
                  rs.uniform(2, 40, t), rs.uniform(1.4, 2, t),
                  rs.uniform(1.3, 1.8, t), rs.uniform(3, 5, t),
                  rs.uniform(-3.1, 3.1, t), rs.uniform(0, 1, t),
                  rs.uniform(0, 2, t)], -1)
    m = rs.normal(0, 0.3, (t, 9, 9))
    c = m @ m.transpose(0, 2, 1) + np.eye(9)
    return x, c


def _random_tracks(rs, t):
    x, c = _states(rs, t)
    valid = rs.random(t) < 0.75
    a = np.asarray(jk.make_transition_matrix(jnp.asarray(x[:, 6]),
                                             jnp.asarray(x[:, 7])))
    box = np.asarray(jgeom.project_3d_box(jnp.asarray(P2),
                                          *jnp.asarray(x[:, :7].T)))
    box2d = np.concatenate([box, rs.uniform(0.5, 1, (t, 1)),
                            np.ones((t, 1))], -1)
    return tk.Tracks(valid=_t(valid),
                     ids=_t(np.where(valid, np.arange(t), -1).astype(
                         np.int32)),
                     next_id=_t(np.int32(t)), X=_t(x), C=_t(c), A=_t(a),
                     box2d=_t(box2d), un=_t(rs.uniform(0.1, 0.9, t)))


def _meas_near(rs, x, m, n_valid):
    """[m, 16] f64 measurements: the first rows near track states ``x``
    (distance matches, then IoU-only matches), the rest new objects."""
    rows = np.zeros((m, 16))
    for i in range(m):
        k = i % len(x)
        if i < len(x) // 2:
            s = x[k, :8] + rs.normal(0, 0.05, 8) * [1, 1, 1, .1, .1, .1, .1, 0]
        elif i < len(x):
            s = x[k, :8] + np.array([0.9, 0, 0.6, 0, 0, 0, 0, 0])
        else:
            s = np.array([rs.uniform(-10, 10), 1.5, rs.uniform(5, 40), 1.6,
                          1.5, 3.9, rs.uniform(-3, 3), rs.uniform(0, 1)])
        box = np.asarray(jgeom.project_3d_box(jnp.asarray(P2),
                                              *jnp.asarray(s[:7])))
        rows[i] = [*box, rs.uniform(0.6, 1), 1, *s, rs.uniform(0.2, 1),
                   rs.uniform(0, 1)]
    valid = np.zeros(m, bool)
    valid[rs.permutation(m)[:n_valid]] = True
    return rows, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_tracker_functions_match_jax(seed):
    """Each function on random states: the transition and covariance
    builders, the ego projection, the forecast, the greedy matcher in both
    directions, the association, the update and the spawn."""
    rs = np.random.default_rng(seed)
    t, m = 12, 10
    with jax.enable_x64(True):
        theta, head = rs.uniform(-3, 3, t), rs.uniform(0, 1, t)
        np.testing.assert_allclose(
            tk.make_transition_matrix(_t(theta), _t(head)).numpy(),
            jk.make_transition_matrix(jnp.asarray(theta), jnp.asarray(head)),
            rtol=F64_RTOL, atol=F64_ATOL)
        vals = rs.uniform(0, 1, t)
        for kw in (dict(), dict(n_diag=9), dict(size=8)):
            np.testing.assert_array_equal(
                tk.make_covariance(_t(vals), **kw).numpy(),
                jk.make_covariance(jnp.asarray(vals), **kw))

        tr = _random_tracks(rs, t)
        pose = rs.normal(0, [0.3, 0.05, 0.8, 0.01, 0.05, 0.01])
        p2 = _t(P2)
        ego = tk.project_ego(tr, _t(pose), p2)
        _assert_tracks(ego, J["project_ego"](_jax_tracks(tr), jnp.asarray(pose),
                                           jnp.asarray(P2)), "ego")
        fc = tk.forecast_tracks(ego, p2)
        _assert_tracks(fc, J["forecast_tracks"](_jax_tracks(ego),
                                              jnp.asarray(P2)), "forecast")

        meas, mvalid = _meas_near(rs, fc.X.numpy(), m, 8)
        cost = rs.uniform(0, 1, (t, m))
        cost[2, 3] = cost[5, 1] = cost.min()              # a tie
        ok = rs.random((t, m)) < 0.8
        mt0 = np.where(rs.random(t) < 0.2, rs.integers(0, m, t), -1)
        um0 = rs.random(m) < 0.2
        for minimize, thresh in ((True, 0.5), (False, 0.35)):
            got = tk._greedy_match(_t(cost), _t(ok), thresh, minimize,
                                   _t(mt0.astype(np.int32)), _t(um0))
            ref = J["_greedy_match"](jnp.asarray(cost), jnp.asarray(ok),
                                   thresh, minimize,
                                   jnp.asarray(mt0.astype(np.int32)),
                                   jnp.asarray(um0))
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))

        match_t, used_m = tk.associate_tracks(fc, _t(meas), _t(mvalid))
        jmatch, jused = J["associate_tracks"](_jax_tracks(fc),
                                            jnp.asarray(meas),
                                            jnp.asarray(mvalid))
        np.testing.assert_array_equal(match_t.numpy(), np.asarray(jmatch))
        np.testing.assert_array_equal(used_m.numpy(), np.asarray(jused))
        assert (match_t >= 0).sum() >= 3 and (~used_m & _t(mvalid)).any()

        up = tk.update_tracks(fc, _t(meas), _t(mvalid), match_t)
        _assert_tracks(up, J["update_tracks"](_jax_tracks(fc),
                                            jnp.asarray(meas),
                                            jnp.asarray(mvalid), jmatch),
                       "update")
        sp = tk.add_unused_measurements(up, _t(meas), _t(mvalid), used_m)
        _assert_tracks(sp, J["add_unused_measurements"](
            _jax_tracks(up), jnp.asarray(meas), jnp.asarray(mvalid), jused),
            "spawn")
        # more free slots than measurements, and fewer
        for tt in (3, 40):
            small = tk.Tracks.empty(tt, dtype=torch.float64)
            _assert_tracks(
                tk.add_unused_measurements(small, _t(meas), _t(mvalid),
                                           used_m),
                J["add_unused_measurements"](jk.Tracks.empty(tt),
                                           jnp.asarray(meas),
                                           jnp.asarray(mvalid), jused),
                f"spawn into {tt}")


def test_video_track_rollouts_match_jax():
    """Two clips (``make_synthetic_track_clip``) through ``video_track``
    against JAX's scan, frame by frame: matches, misses, the low-confidence
    death, ego motion, the zero-association frame that kills every
    track."""
    cfg = tv.VideoConfig(max_tracks=24, max_measurements=16)
    jcfg = jv.VideoConfig(max_tracks=24, max_measurements=16)
    for seed in (3, 4):
        meas, valid, poses = make_synthetic_track_clip(seed, p2=P2)
        with jax.enable_x64(True):
            jfinal, jsnaps = J["video_track"](
                jnp.asarray(meas), jnp.asarray(valid), jnp.asarray(poses),
                jnp.asarray(P2), jcfg)
            final, snaps = tv.video_track(_t(meas), _t(valid), _t(poses),
                                          _t(P2), cfg)
            for f, snap in enumerate(snaps):
                _assert_tracks(snap, jax.tree_util.tree_map(
                    lambda a, f=f: a[f], jsnaps), f"seed {seed} frame {f}")
            _assert_tracks(final, jfinal, f"seed {seed} final")
        n_valid = [int(s.valid.sum()) for s in snaps]
        ids = [set(s.ids[s.valid].tolist()) for s in snaps]
        assert n_valid[3] == int(valid[3].sum()), n_valid    # all respawned
        assert not ids[3] & ids[2], "the kill frame kept a track"
        assert len(ids[1] & ids[2]) >= 4, "too few tracks carried"
        assert 0 not in ids[1], "the low-confidence track lived"


# ---------------------------------------------------------------------------
# PoseNet, VideoRPN3D and the measurements
# ---------------------------------------------------------------------------

TINY_RPN = dict(num_classes=4, num_anchors=4, prop_features=32)


@functools.cache
def _video_models(seed=0, vel=True):
    """(jax model, flax variables as numpy, port model) of a tiny video
    model with the uncertainty (and velocity) channel."""
    jcfg = jv.VideoConfig(rpn=JaxRPNConfig(
        **TINY_RPN, predict_uncertainty=True, predict_velocity=vel,
        backbone=jax_tiny()), max_measurements=16, max_tracks=24)
    jmodel = jv.VideoRPN3D(jcfg)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2, 64, 128, 3)),
        train=False)
    rs = np.random.default_rng(seed)
    variables = {"params": _perturb(variables["params"], rs),
                 "batch_stats": _perturb(variables["batch_stats"], rs)}
    tcfg = tv.VideoConfig(rpn=RPNConfig(
        **TINY_RPN, predict_uncertainty=True, predict_velocity=vel,
        backbone=tiny_densenet_config()), max_measurements=16, max_tracks=24)
    tmodel = tv.VideoRPN3D(tcfg)
    tmodel.load_state_dict(from_flax(variables["params"],
                                     variables["batch_stats"]))
    return jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("frames", [1, 3])
def test_video_forward_matches_jax(frames):
    """The whole tree maps through ``from_flax`` (a strict load); the frame
    outputs, the trunk features and the poses agree."""
    jmodel, variables, tmodel = _video_models()
    x = np.random.default_rng(1).normal(size=(2, frames, 64, 128, 3)) \
        .astype(np.float32)
    jout = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        tout = tmodel(_t(x).permute(0, 1, 4, 2, 3))
    assert tout.poses.shape == jout.poses.shape == (2, frames - 1, 6)
    np.testing.assert_allclose(tout.poses.numpy(), jout.poses, atol=1e-4)
    np.testing.assert_allclose(tout.trunk_feats.permute(0, 1, 3, 4, 2)
                               .numpy(), jout.trunk_feats, atol=1e-4)
    np.testing.assert_allclose(tout.frame_outputs.fused_raw.numpy(),
                               jout.frame_outputs.fused_raw, atol=1e-4)
    # PoseNet alone, on one pair
    feats = np.random.default_rng(2).normal(size=(2, 4, 8, 2 * 32)) \
        .astype(np.float32)
    jpose = jk.PoseNet().apply({"params": variables["params"]["pose_net"]},
                               jnp.asarray(feats))
    with torch.no_grad():
        tpose = tmodel.pose_net(_t(feats).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tpose.numpy(), jpose, rtol=1e-5, atol=1e-5)


def _jax_outputs(fused, c, n3d):
    """JAX RPNOutputs split from the fused head tensor, as the JAX model
    splits it."""
    fused = jnp.asarray(fused)
    cls = fused[..., :c]
    b3 = fused[..., c + 4:c + 4 + n3d]
    b3 = jnp.concatenate([b3[..., :8], jax.nn.sigmoid(b3[..., 8:10]),
                          b3[..., 10:]], -1)
    return JaxRPNOutputs(cls=cls, prob=jax.nn.softmax(cls, -1),
                         bbox_2d=fused[..., c:c + 4], bbox_3d=b3,
                         feat_hw=(4, 8),
                         uncertainty=jax.nn.sigmoid(fused[..., -1]),
                         fused_raw=fused)


def _rois(rs, a=4, fh=4, fw=8, vel=True):
    """(rois [R, 5], rois_3d [R, 7 or 8]) of ``a`` anchors on an fh x fw
    map at stride 16."""
    from groomed_nms_torch.anchors import generate_anchor_templates, \
        locate_anchors
    templates = generate_anchor_templates([16, 32], [0.5, 1.0], 16)[:a]
    priors = np.concatenate(
        [templates, np.abs(rs.normal(size=(a, 8 if vel else 7))) + 1.0], 1)
    priors[:, 4] = 20.0
    rois = locate_anchors(priors.astype(np.float32), (fh, fw), 16)
    return rois, priors[rois[:, 4].astype(np.int64), 4:].astype(np.float32)


def _measurement_inputs(seed, f=3, vel=True):
    rs = np.random.default_rng(seed)
    rois, rois_3d = _rois(rs, vel=vel)
    r, c = rois.shape[0], 4
    n3d = 11 if vel else 10
    fused = rs.normal(0, 0.4, (f, r, c + 4 + n3d + 1)).astype(np.float32)
    # confident rows in pairs of anchors at one position (they overlap,
    # so K2 suppresses some), 14 a frame: two of the 16 slots are padding
    conf = np.concatenate([np.arange(0, r, 20), np.arange(1, r, 20)])
    fused[:, conf, 1] += 3.0
    fused[..., 4:8] *= 0.3                     # boxes near their anchors
    p2 = np.tile(P2.astype(np.float32)[None], (f, 1, 1))
    scale = np.full((f,), 0.5, np.float32)
    ns = 13 + (1 if vel else 0)
    means = rs.normal(0, 0.1, ns).astype(np.float32)
    stds = rs.uniform(0.5, 1.5, ns).astype(np.float32)
    return dict(fused=fused, rois=rois, rois_3d=rois_3d, p2=p2, scale=scale,
                means=means, stds=stds, c=c, n3d=n3d)


@pytest.mark.parametrize("vel", [True, False])
def test_extract_measurements_matches_jax(vel):
    """K1 scores, the top 16 rows, their decode and K2 (plain versions on
    the CPU) against JAX's decode of every anchor, gather and greedy NMS:
    the same kept set, the kept rows within tolerance, some rows
    suppressed."""
    d = _measurement_inputs(5, vel=vel)
    jcfg = jv.VideoConfig(max_measurements=16, score_thres=0.4)
    tcfg = tv.VideoConfig(max_measurements=16, score_thres=0.4)
    jmeas, jkeep = J["extract_measurements"](
        _jax_outputs(d["fused"], d["c"], d["n3d"]), jnp.asarray(d["rois"]),
        jnp.asarray(d["rois_3d"]), jnp.asarray(d["p2"]),
        jnp.asarray(d["scale"]), d["means"], d["stds"], jcfg)
    out = RPNOutputs(fused_raw=_t(d["fused"]), feat_hw=(4, 8),
                     num_classes=d["c"], n_box3d=d["n3d"])
    meas, keep = tv.extract_measurements(
        out, _t(d["rois"]), _t(d["rois_3d"]), _t(d["p2"]), _t(d["scale"]),
        _t(d["means"]), _t(d["stds"]), tcfg)
    jkeep, jmeas = np.asarray(jkeep), np.asarray(jmeas)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert 2 <= jkeep.sum(1).min() and jkeep.sum() < 3 * 16
    np.testing.assert_allclose(meas.numpy()[jkeep], jmeas[jkeep], rtol=1e-5,
                               atol=1e-4)
    if vel:
        assert (jmeas[jkeep][:, 15] > 0).any()


# ---------------------------------------------------------------------------
# the composed clip and the script
# ---------------------------------------------------------------------------

def _clip_rows(tmp_path, name, fn):
    d = tmp_path / name / "data"
    d.mkdir(parents=True)
    fn(str(d / "000000.txt"))
    return read_rows(str(tmp_path / name))


def test_composed_clip_matches_jax(tmp_path):
    """Frames -> preprocess -> VideoRPN3D -> measurements -> denormalised
    poses -> tracker -> KITTI rows, the composition of
    ``scripts/test_kalman.py`` against the port's, f32 as shipped, on a
    4-frame clip with a lowered score threshold: the same rows."""
    jmodel, variables, tmodel = _video_models(seed=3)
    rs = np.random.default_rng(4)
    frames = rs.integers(0, 255, (4, 48, 160, 3)).astype(np.uint8)
    rois, rois_3d = _rois(rs)
    means = rs.normal(0, 0.1, 14).astype(np.float32)
    stds = rs.uniform(0.5, 1.5, 14).astype(np.float32)
    pose_means = rs.normal(0, 0.1, 6).astype(np.float32)
    pose_stds = rs.uniform(0.5, 1.5, 6).astype(np.float32)
    p2 = (P2 * [[0.125], [0.125], [1], [1]]).astype(np.float32)
    img_m, img_s = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    thr = dict(score_thres=0.25, max_measurements=16, max_tracks=24)
    jcfg = dataclasses.replace(jmodel.config, **thr)
    tcfg = dataclasses.replace(tmodel.config, **thr)
    scale = 64 / 48

    @jax.jit
    def jax_clip(frames):
        x = jax_preprocess(frames, jnp.zeros((4,), bool), jnp.asarray(img_m),
                           jnp.asarray(img_s), target_h=64, crop_w=128)
        out = jmodel.apply(variables, x[None], train=False)
        meas, valid = jv.extract_measurements(
            out.frame_outputs, jnp.asarray(rois), jnp.asarray(rois_3d),
            jnp.tile(jnp.asarray(p2)[None], (4, 1, 1)),
            jnp.full((4,), scale), means, stds, jcfg)
        poses = jnp.concatenate([jnp.zeros((1, 6)), out.poses[0] * pose_stds
                                 + pose_means])
        return jv.video_track(meas, valid, poses, jnp.asarray(p2), jcfg)[0], \
            valid

    jfinal, jvalid = jax_clip(jnp.asarray(frames))

    with torch.no_grad():
        tx = preprocess_images(_t(frames), None, img_m, img_s, target_h=64,
                               crop_w=128)
        tout = tmodel(tx[None])
        meas, valid = tv.extract_measurements(
            tout.frame_outputs, _t(rois), _t(rois_3d),
            _t(p2).expand(4, 4, 4), torch.full((4,), scale), _t(means),
            _t(stds), tcfg)
        poses = torch.cat([torch.zeros((1, 6)), tout.poses[0] * _t(pose_stds)
                           + _t(pose_means)])
        final, _ = tv.video_track(meas, valid, poses, _t(p2), tcfg)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    got = _clip_rows(tmp_path, "torch", lambda p: tinf.write_kitti_tracks(
        p, final, score_thres=0.05))
    want = _clip_rows(tmp_path, "jax", lambda p: jinf.write_kitti_tracks(
        p, jfinal, score_thres=0.05))
    assert assert_same_rows(got, want) >= 3, "too few rows to compare"


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "groomed_nms_tpu",
            "PIL")
_RUNNER = f"""
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {_BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
script = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(script, run_name="__main__")
bad = sorted(k for k in sys.modules if k.split(".")[0] in {_BLOCKED!r})
assert not bad, bad
"""


def test_test_kalman_torch_script_on_the_cpu(tmp_path):
    """``scripts/test_kalman_torch.py --device cpu`` as a subprocess with
    JAX, the JAX package and Pillow unimportable, on a synthetic tracking
    tree of 3 validation clips: a pretrained ``_un`` checkpoint widened by
    the velocity channel, a pose branch from a JAX-layout npz, a track
    file per clip with rows, the evaluator run."""
    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.data.synthetic import make_synthetic_kitti_video
    from groomed_nms_torch.models.rpn_3d import RPN3D
    from groomed_nms_torch.training.checkpoint import save_checkpoint
    from groomed_nms_torch.utils.weights import init_weights

    data = tmp_path / "data"
    make_synthetic_kitti_video(str(data / "kitti_split1"), n_train=1,
                               n_val=3, im_h=96, im_w=320, seed=0)
    cfg = load_config("tiny_video_synthetic")
    rs = np.random.default_rng(0)
    from groomed_nms_torch.anchors import generate_anchor_templates
    templates = generate_anchor_templates([16, 32], [0.5, 1.0], 16)
    priors = np.concatenate([templates, np.abs(rs.normal(size=(4, 8))) + 1],
                            1)
    priors[:, 4] = 20.0
    run = tmp_path / "out" / "tiny_video_synthetic"
    run.mkdir(parents=True)
    np.savez(run / "anchors.npz", anchors=priors, bbox_means=np.zeros(14),
             bbox_stds=np.ones(14))
    un_cfg = dataclasses.replace(cfg.rpn_config(4), predict_velocity=False)
    un = RPN3D(un_cfg)
    init_weights(un, torch.Generator().manual_seed(1))
    pre = str(tmp_path / "out" / "tiny_un")
    save_checkpoint(pre, un, step=7)
    pose = {"pose_feats/kernel": rs.normal(0, 0.01, (3, 3, 64, 512)),
            "pose_feats/bias": rs.normal(0, 0.1, 512),
            "pose/kernel": rs.normal(0, 0.1, (1, 1, 512, 6)),
            "pose/bias": rs.normal(0, 0.1, 6)}
    (tmp_path / "out" / "tiny_video_synthetic_pose").mkdir()
    np.savez(tmp_path / "out" / "tiny_video_synthetic_pose" /
             "pose_net_params.npz",
             **{k: v.astype(np.float32) for k, v in pose.items()})
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER,
         os.path.join(ROOT, "scripts", "test_kalman_torch.py"), "--config",
         "tiny_video_synthetic", "--data-root", str(data), "--output",
         str(tmp_path / "out"), "--device", "cpu", "--set",
         f"pretrained={pre!r}", "--set", "score_thres=0.05"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"single-frame weights warm-started from {pre} (iter 7)" \
        in proc.stderr
    results = run / "results" / "results_kalman"
    rows = read_rows(str(results))
    assert sorted(rows) == ["000001.txt", "000002.txt", "000003.txt"]
    assert sum(len(v) for v in rows.values()) > 0
    assert "3 clips, 12 frames" in proc.stderr
    assert "car detection AP|R40" in proc.stderr


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_video_weight_loaders_match_jax(tmp_path):
    """The velocity widening against JAX's (through ``from_flax``); a JAX
    pose npz of flax paths fills the port's pose branch; the loading rule:
    a ``kalman`` checkpoint restores the whole model, random weights
    warn."""
    import logging

    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.training.checkpoint import save_checkpoint
    from groomed_nms_torch.utils.weights import init_weights

    jmodel, variables, tmodel = _video_models(seed=5, vel=False)
    rpn_params = variables["params"]["rpn"]
    wide = jweights.widen_fused_head_for_velocity(rpn_params, 4, 4)
    got = tvw.widen_fused_head_for_velocity(
        from_flax(rpn_params), num_anchors=4, num_classes=4)
    ref = from_flax(wide)
    for k in ("head.weight", "head.bias"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())
    assert got["head.bias"].shape[0] == 4 * (4 + 4 + 11 + 1)

    pose = {f"{m}/{leaf}": np.asarray(v) for m, sub in
            variables["params"]["pose_net"].items() for leaf, v in sub.items()}
    np.savez(tmp_path / "pose_net_params.npz", **pose)
    def fresh_model(seed):
        model = tv.VideoRPN3D(tmodel.config)
        return init_weights(model, torch.Generator().manual_seed(seed))

    fresh = fresh_model(6)
    loaded = tvw.load_pose_npz(fresh.pose_net,
                               str(tmp_path / "pose_net_params.npz"))
    assert len(loaded) == 6
    for k, v in tmodel.pose_net.state_dict().items():
        assert torch.equal(fresh.pose_net.state_dict()[k], v), k

    cfg = dataclasses.replace(load_config("tiny_video_synthetic"),
                              pretrained=None)
    out = str(tmp_path / "kalman")
    save_checkpoint(out, tmodel, step=3)
    other = fresh_model(7)
    means, stds, step = tvw.load_video_variables(other, cfg, out)
    assert step == 3 and (means == 0).all() and (stds == 1).all()
    for k, v in tmodel.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("video_weights_test")
    log.addHandler(handler)
    tvw.load_video_variables(other, cfg, str(tmp_path / "empty"), log=log)
    assert any(r.levelno == logging.WARNING and "random weights" in
               r.getMessage() for r in records)
