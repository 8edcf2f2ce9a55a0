"""The video stage's training, JAX vs the PyTorch port, on the CPU: the
``has_vel`` loss, the clip loader, the clip preprocess, two video train
steps, the pose loss, the fused-track loss, freezing by flax path on the
video model, the pose stage's batches and step against
``scripts/train_pose.py``'s own, and the entry points
(``scripts/train_pose_torch.py``, then ``scripts/train_torch.py`` on a
``kalman`` config).

Tolerances: the ``has_vel`` loss at the loss tests' (``test_torch_loss.py``:
stats rtol 1e-4, atol 1e-6; gradients rtol 1e-3, atol 1e-5); the clip
loader's batches bit for bit; the clip preprocess within 1e-6 (the same f32
resize); two video train steps of the tiny model, both packages in f64 (the
loss in f32 in both), every parameter and running statistic within 1e-5 of
its tensor's largest magnitude and the loss's stats at rtol 1e-6 (atol
1e-7); the pose loss's value and gradients at rtol 1e-6; the pose stage's
batches bit for bit, and two of its steps in f64 (``PoseNet`` in f32 in
both) with the loss's stats at rtol 1e-6 and each ``pose_net`` update
within 1e-5 of its largest magnitude; the fused-track
loss's value and its gradient with respect to the poses in f64 within 1e-8
(the tracker's f64 tolerance in ``test_torch_video.py``); the anchors and
statistics of a tracking tree at ``test_torch_train_data.py``'s rule; the
freeze sets and the pose statistics exactly.
"""

import ast
import dataclasses
import importlib.util
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from groomed_nms_tpu import config as jax_config
from groomed_nms_tpu.data import pipeline as jax_pipeline
from groomed_nms_tpu.data.augment import \
    preprocess_images as jax_preprocess
from groomed_nms_tpu.data.tracking import build_tracking_imdb as jax_tracking
from groomed_nms_tpu.data.tracking import mirror_ego as jax_mirror_ego
from groomed_nms_tpu.losses.fused_track import fused_track_loss as jax_ftl
from groomed_nms_tpu.losses.pose import pose_loss as jax_pose_loss
from groomed_nms_tpu.losses.rpn_3d import UncertaintyState as JaxUnState
from groomed_nms_tpu.models import video as jv
from groomed_nms_tpu.models.densenet import tiny_densenet_config as jax_tiny
from groomed_nms_tpu.models.rpn_3d import RPNConfig as JaxRPNConfig
from groomed_nms_tpu.training import build_lr_schedule as jax_schedule
from groomed_nms_tpu.training import build_optimizer as jax_optimizer
from groomed_nms_tpu.training import freeze as jax_freeze
from groomed_nms_tpu.training.trainer import TrainState as JaxTrainState
from groomed_nms_tpu.training.trainer import fuse_preprocess as jax_fuse
from groomed_nms_tpu.training.trainer import \
    make_video_train_step as jax_video_step
from groomed_nms_tpu.utils.torch_weights import \
    assemble_video_variables as jax_assemble

from groomed_nms_torch.config import load_config
from groomed_nms_torch.data import pipeline
from groomed_nms_torch.data.synthetic import (kitti_p2,
                                              make_synthetic_kitti_video,
                                              make_synthetic_track_clip)
from groomed_nms_torch.data.tracking import build_tracking_imdb
from groomed_nms_torch.losses.fused_track import fused_track_loss
from groomed_nms_torch.losses.pose import pose_loss
from groomed_nms_torch.losses.rpn_3d import UncertaintyState
from groomed_nms_torch.models import video as tv
from groomed_nms_torch.models.densenet import tiny_densenet_config
from groomed_nms_torch.models.rpn_3d import RPN3D, RPNConfig
from groomed_nms_torch.training import freeze
from groomed_nms_torch.training.checkpoint import save_checkpoint
from groomed_nms_torch.training.schedules import build_lr_schedule
from groomed_nms_torch.training.trainer import (TrainState, build_optimizer,
                                                fuse_preprocess,
                                                make_video_train_step)
from groomed_nms_torch.utils.video_weights import load_pose_npz
from groomed_nms_torch.utils.weights import (flax_names, from_flax,
                                             init_weights)
from test_torch_loss import (_assert_matches, _gt_batch, _run_both,
                             assert_vel_stats)
from test_torch_train_data import assert_stats_close
from test_torch_video import _RUNNER, TINY_RPN
from test_torch_video import _rois as video_rois
from torch_port_common import _perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_REL, STATS_RTOL, STATS_ATOL = 1e-5, 1e-6, 1e-7
POSE_RTOL = 1e-6
TRACK_TOL = 1e-8
# records whose first history frame is deleted from the tree
MISSING_PREV = ("000001", "000004")


def _t(x):
    return torch.from_numpy(np.array(x))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clip_tree(tmp_path_factory):
    """A synthetic tracking tree: 8 training records at 96x320 (ego poses
    and track velocities from the raw sequence), one validation record;
    two records lose their first history frame."""
    data = tmp_path_factory.mktemp("video") / "data"
    root = str(data / "kitti_split1")
    make_synthetic_kitti_video(root, n_train=8, n_val=1, im_h=96, im_w=320,
                               seed=5)
    for iid in MISSING_PREV:
        os.remove(os.path.join(root, "training", "prev_2", f"{iid}_01.png"))
    return str(data), root


# ---------------------------------------------------------------------------
# the has_vel loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [
    {}, {"weigh_3D_regression_loss_by_gt_iou3d": True}])
def test_has_vel_loss_matches_jax(overrides):
    """``kitti_3d_full``'s loss (the velocity term beside the ``_un``
    stage's uncertainty weighting), as shipped and with the GT-IoU3D
    weighting, on GTs whose velocities are finite, -inf and absent on the
    background: value and every head gradient against ``jax.grad``."""
    ref, got = _run_both("kitti_3d_full", overrides)
    _assert_matches(ref, got)
    assert_vel_stats(got[0])


# ---------------------------------------------------------------------------
# the clip loader and the clip preprocess
# ---------------------------------------------------------------------------

def test_video_train_loader_matches_jax(clip_tree, tmp_path):
    """Three batches for one seed bit for bit (clips, mirror flags, every
    GT field), with clips whose history frame is missing (filled with the
    current frame); the port read through its decode cache, whose entries
    keep current and history frames apart."""
    _, root = clip_tree
    tcfg = load_config("tiny_video_synthetic")
    jcfg = jax_config.load_config("tiny_video_synthetic")
    ours = build_tracking_imdb(root, "training")
    theirs = jax_tracking(root, "training")
    cache = str(tmp_path / "cache")
    got_loader = pipeline.VideoTrainLoader(ours, tcfg, seed=3, prefetch=1,
                                           raw_cache_dir=cache)
    want_loader = jax_pipeline.VideoTrainLoader(theirs, jcfg, seed=3,
                                                prefetch=1)
    try:
        got = [next(got_loader) for _ in range(3)]
        want = [next(want_loader) for _ in range(3)]
    finally:
        got_loader.close()
        want_loader.close()
    for g, w in zip(got, want):
        assert g["images_u8"].shape == (2, 2, 96, 320, 3)
        np.testing.assert_array_equal(g["images_u8"], w["images_u8"])
        np.testing.assert_array_equal(g["mirror"], w["mirror"])
        for name, a, b in zip(w["gt"]._fields, g["gt"], w["gt"]):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    clips = np.concatenate([g["images_u8"] for g in got])
    still = [bool((c[0] == c[1]).all()) for c in clips]
    assert any(still) and not all(still), still
    assert np.isfinite(np.concatenate([g["gt"].gts_3d[..., 16]
                                       for g in got])).any()
    keys = {f.rsplit("-", 2)[0] for f in os.listdir(cache)}
    assert any("_" in k for k in keys) and any("_" not in k for k in keys)
    views = [pipeline.ClipRecordView(r) for r in ours]
    assert views[0].gts is ours[0].gts_frames[0]
    assert views[0].image_paths[0].endswith("000000.png")


def test_fuse_preprocess_video_matches_jax():
    """Clips preprocessed as frames, a mirrored sample's every frame
    flipped, shaped [B, F, 3, H, W]: within 1e-6 of JAX's [B, F, H, W, 3]."""
    u8 = np.random.default_rng(2).integers(0, 256, (2, 3, 48, 160, 3)) \
        .astype(np.uint8)
    mirror = np.array([True, False])
    means, stds = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    seen = {}

    def capture(state, batch):
        seen[state] = batch["images"]

    kw = dict(target_h=64, crop_w=128, video=True)
    jax_fuse(capture, means, stds, **kw)("jax", {
        "images_u8": jnp.asarray(u8), "mirror": jnp.asarray(mirror)})
    fuse_preprocess(capture, torch.tensor(means), torch.tensor(stds), **kw)(
        "torch", {"images_u8": _t(u8), "mirror": _t(mirror)})
    got, want = seen["torch"], np.asarray(seen["jax"])
    assert got.shape == (2, 3, 3, 64, 128)
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want,
                               rtol=0, atol=1e-6)
    for f in range(3):                      # the whole clip flipped
        np.testing.assert_allclose(got[0, f].numpy(), fuse_preprocess(
            lambda s, b: b["images"], torch.tensor(means), torch.tensor(stds),
            target_h=64, crop_w=128)(None, {
                "images_u8": _t(u8[0, f][None, :, ::-1].copy()),
                "mirror": torch.tensor([False])})[0].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# two video train steps, f64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def video_variables():
    """Flax variables (numpy) of the tiny video model with the uncertainty
    and velocity channels, BatchNorm perturbed, the head at a tenth of its
    init (box deltas of a few tenths, as the loss tests' heads)."""
    jmodel = jv.VideoRPN3D(jv.VideoConfig(rpn=JaxRPNConfig(
        **TINY_RPN, predict_uncertainty=True, predict_velocity=True,
        backbone=jax_tiny())))
    variables = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(11), jnp.zeros((1, 2, 64, 128, 3)), train=False)
    rs = np.random.default_rng(11)
    params = _perturb(variables["params"], rs)
    params["rpn"]["head"]["kernel"] *= np.float32(0.1)
    return {"params": params,
            "batch_stats": _perturb(variables["batch_stats"], rs)}


def _port_video_model():
    return tv.VideoRPN3D(tv.VideoConfig(rpn=RPNConfig(
        **TINY_RPN, predict_uncertainty=True, predict_velocity=True,
        backbone=tiny_densenet_config())))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("whitelist", [("backbone",), None])
def test_video_train_steps_match_jax_in_f64(video_variables, whitelist):
    """Two ``make_video_train_step`` steps of the tiny video model with
    ``kitti_3d_full``'s loss on 2 clips of 2 frames, both packages in f64:
    with ``freeze_whitelist=("backbone",)`` (as shipped: every BatchNorm is
    the backbone's, so the model runs in eval mode) and without freezing
    (BatchNorm's batch statistics over all 4 frames).  Frozen tensors stay
    bit for bit; the velocity channel's weights move."""
    variables = video_variables
    jcfg = jax_config.load_config("kitti_3d_full").loss_config()
    tcfg = load_config("kitti_3d_full").loss_config()
    rois, rois_3d = video_rois(np.random.default_rng(3))
    gt = _gt_batch(7, vel=True)
    x = np.random.default_rng(5).normal(size=(2, 2, 64, 128, 3))
    means = np.zeros(14)
    stds = np.ones(14)
    means[13], stds[13] = 0.1, 0.7
    sched = (0.01, 100)

    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if np.asarray(a).dtype.kind == "f" else jnp.asarray(a), t)
        jmodel = jv.VideoRPN3D(jv.VideoConfig(rpn=JaxRPNConfig(
            **TINY_RPN, predict_uncertainty=True, predict_velocity=True,
            backbone=jax_tiny(jnp.float64))))
        params, bstats = cast(variables["params"]), \
            cast(variables["batch_stats"])
        tx = jax_optimizer("sgd", jax_schedule(*sched))
        mask, train_bn = None, True
        if whitelist:
            tx = jax_freeze.wrap_with_freeze(tx, jax_freeze.build_freeze_labels(
                params, None, whitelist))
            mask = jax_freeze.frozen_stats_mask(bstats, None, whitelist)
            train_bn = not jax_freeze.all_stats_frozen(mask)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=bstats,
            opt_state=tx.init(params), un_state=cast(JaxUnState.init()),
            tx=tx, apply_fn=jmodel.apply)
        step = jax.jit(jax_video_step(jcfg, cast(rois), cast(rois_3d),
                                      cast(means), cast(stds),
                                      train_bn=train_bn,
                                      frozen_stats_mask=mask))
        batch = cast({"images": x, **gt})
        ref = []
        for _ in range(2):
            state, stats = step(state, batch)
            ref.append((from_flax(jax.device_get(state.params),
                                  jax.device_get(state.batch_stats)),
                        {k: float(v) for k, v in stats.items()}))

    model = _port_video_model()
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    model.double()
    trainable, frozen_stats, t_train_bn = list(model.parameters()), (), True
    if whitelist:
        trainable = freeze.apply_freeze(model, freeze.build_freeze_labels(
            model, None, whitelist))
        smask = freeze.frozen_stats_mask(model, None, whitelist)
        t_train_bn = not freeze.all_stats_frozen(smask)
        frozen_stats = tuple(k for k, v in smask.items() if v)
    assert t_train_bn == train_bn == (whitelist is None)
    f64 = lambda a: _t(a).double() if np.asarray(a).dtype.kind == "f" \
        else _t(a)
    tstate = TrainState(model, build_optimizer(
        trainable, "sgd", build_lr_schedule(*sched)), UncertaintyState.init())
    tstep = make_video_train_step(tcfg, f64(rois), f64(rois_3d), f64(means),
                                  f64(stds), train_bn=t_train_bn,
                                  frozen_stats=frozen_stats)
    tbatch = {"images": f64(x).permute(0, 1, 4, 2, 3),
              **{k: f64(v) for k, v in gt.items()}}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i, (params, jstats) in enumerate(ref):
        tstats = {k: float(v) for k, v in tstep(tstate, tbatch).items()}
        assert set(tstats) - {"vel", "vel_num"} == set(jstats)
        assert jstats["fg_num"] > 0 and tstats["vel_num"] > 0
        for k in jstats:
            np.testing.assert_allclose(tstats[k], jstats[k], rtol=STATS_RTOL,
                                       atol=STATS_ATOL,
                                       err_msg=f"step {i}: {k}")
        got = model.state_dict()
        for k, r in params.items():
            if k.endswith("num_batches_tracked"):
                continue
            err = (got[k] - r.double()).abs().max().item()
            assert err <= PARAM_REL * r.abs().max().item(), \
                f"step {i}: {k} off by {err:.3e}"
    after = model.state_dict()
    for k, v in after.items():
        if k.startswith("rpn.backbone.") and not k.endswith("tracked"):
            assert torch.equal(v, before[k]) == bool(whitelist), k
    per = model.config.rpn.per_anchor
    vel = slice(4 + 4 + 10, None, per)       # each anchor's vel channel
    assert not torch.equal(after["rpn.head.weight"][vel],
                           before["rpn.head.weight"][vel])


def test_freeze_whitelist_backbone_matches_jax(video_variables):
    """``freeze_whitelist=("backbone",)`` on the video model freezes the
    tensors JAX's ``build_freeze_labels`` freezes on the flax tree:
    ``rpn/backbone/...`` and nothing else; likewise the statistics."""
    model = _port_video_model()
    names = flax_names(model)
    labels = jax_freeze.build_freeze_labels(video_variables["params"], None,
                                            ("backbone",))
    want = {p for p, lbl in _flat(labels) if lbl == "freeze"}
    got = {names[k][1] for k, v in freeze.build_freeze_labels(
        model, None, ("backbone",)).items() if v == "freeze"}
    assert got == want and got
    assert all(p.startswith("rpn/backbone/") for p in got)
    assert {names[k][1] for k in names if names[k][0] == "params"} - got \
        >= {"rpn/head/kernel", "pose_net/pose_feats/kernel"}
    smask = jax_freeze.frozen_stats_mask(video_variables["batch_stats"],
                                         None, ("backbone",))
    want_s = {p for p, m in _flat(smask) if m}
    got_s = {names[k][1] for k, v in freeze.frozen_stats_mask(
        model, None, ("backbone",)).items() if v}
    assert got_s == want_s and got_s


# ---------------------------------------------------------------------------
# the pose and fused-track losses
# ---------------------------------------------------------------------------

def test_pose_loss_matches_jax():
    rs = np.random.default_rng(4)
    pred, tar = (rs.normal(size=(5, 6)).astype(np.float32) for _ in "ab")
    means = rs.normal(0, 0.1, 6)
    stds = rs.uniform(0.01, 2, 6)
    kw = dict(pose_lambda_t=1.0, pose_lambda_r=40.0)

    def jfn(p):
        return jax_pose_loss(p, jnp.asarray(tar), means, stds, **kw)

    (jval, jstats), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(pred))
    tp = _t(pred).requires_grad_()
    val, stats = pose_loss(tp, _t(tar), _t(means).float(), _t(stds).float(),
                           **kw)
    val.backward()
    assert set(stats) == set(jstats) == {"pose", "t_err", "r_err"}
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]),
                                   rtol=POSE_RTOL, err_msg=k)
    np.testing.assert_allclose(tp.grad.numpy(), jgrad, rtol=POSE_RTOL)


def _track_setup_oracle():
    """tests/test_video.py's setup: two cars seen over 3 frames by a camera
    moving 1 m a frame, their boxes projected through a 200 px camera."""
    p2 = np.eye(4)
    p2[0, 0] = p2[1, 1] = 200.0
    p2[0, 2], p2[1, 2] = 96.0, 32.0
    f, m = 3, 2
    meas = np.zeros((f, m, 16))
    centers0 = np.array([[1.0, 0.5, 20.0], [-2.0, 0.5, 15.0]])
    for fi in range(f):
        c = centers0.copy()
        c[:, 2] -= fi
        for gi in range(m):
            x, y, z = c[gi]
            u, v = 200 * x / z + 96, 200 * y / z + 32
            bw = 200 * 1.7 / z
            meas[fi, gi, :6] = [u - bw / 2, v - bw / 2, u + bw / 2,
                                v + bw / 2, 0.9, 1.0]
            meas[fi, gi, 6:14] = [x, y, z, 1.7, 1.5, 4.0, 0.1, 0.0]
            meas[fi, gi, 14] = 0.9
    gts = centers0.copy()
    gts[:, 2] -= f - 1
    poses = np.zeros((f, 6))
    poses[1:, 2] = 2.0                       # a wrong forward motion
    return (poses, meas, np.ones((f, m), bool), gts, np.ones(m, bool), p2,
            dict(max_tracks=8))


def _track_setup_clip():
    """A 5-frame synthetic clip (``make_synthetic_track_clip``: ego
    motion, misses, a low-confidence track, frame 2's measurements moved
    aside); the GTs are frame 4's objects, two of them left out."""
    p2 = np.concatenate([kitti_p2(), [[0.0, 0.0, 0.0, 1.0]]])
    meas, valid, poses = make_synthetic_track_clip(7, n_frames=5, m=16,
                                                   kill_frame=2, p2=p2)
    rs = np.random.default_rng(7)
    gts = meas[4, :9, 6:9] + rs.normal(0, 0.3, (9, 3))
    gt_valid = np.ones(9, bool)
    gt_valid[[2, 5]] = False
    poses = poses + rs.normal(0, 0.05, poses.shape)
    return (poses, meas, valid, gts, gt_valid, p2, dict(max_tracks=24))


@pytest.mark.parametrize("setup", [_track_setup_oracle, _track_setup_clip])
def test_fused_track_loss_matches_jax(setup):
    """Value, matched count and d/d``poses_dn`` in f64 against JAX's
    ``jax.value_and_grad``: the gradient nonzero, zero on row 0, finite.
    The configs' ``match_dist`` (0.35) is not the tracker's default
    (0.5): both losses use the default."""
    poses, meas, valid, gts, gt_valid, p2, kw = setup()
    jcfg = jv.VideoConfig(match_dist=0.35, **kw)
    tcfg = tv.VideoConfig(match_dist=0.35, **kw)
    with jax.enable_x64(True):
        (jval, jn), jgrad = jax.jit(jax.value_and_grad(
            lambda p: jax_ftl(p, jnp.asarray(meas), jnp.asarray(valid),
                              jnp.asarray(gts), jnp.asarray(gt_valid),
                              jnp.asarray(p2), jcfg), has_aux=True))(
            jnp.asarray(poses))
    tp = _t(poses).requires_grad_()
    val, n = fused_track_loss(tp, _t(meas), _t(valid), _t(gts), _t(gt_valid),
                              _t(p2), tcfg)
    val.backward()
    assert int(n) == int(jn) > 0
    np.testing.assert_allclose(val.item(), float(jval), rtol=TRACK_TOL,
                               atol=TRACK_TOL)
    g = tp.grad.numpy()
    assert np.isfinite(g).all() and (g[0] == 0).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, np.asarray(jgrad), rtol=TRACK_TOL,
                               atol=TRACK_TOL)


# ---------------------------------------------------------------------------
# the pose stage: its batches and its step against scripts/train_pose.py
# ---------------------------------------------------------------------------

def _jax_pose_script(**closure):
    """The functions JAX's ``scripts/train_pose.py`` defines inside
    ``main()`` (``_frame``, ``step``, ``host_batches``), compiled from the
    script's own source with ``closure`` as the names they read from
    ``main``'s scope."""
    path = os.path.join(ROOT, "scripts", "train_pose.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef)]
    ns = dict(closure)
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return SimpleNamespace(**{n.name: ns[n.name] for n in defs})


@pytest.fixture(scope="module")
def pose_tree(tmp_path_factory):
    """A synthetic tracking tree of 8 training records at 96x320, every
    history frame present; both packages' records with a "10" ego and
    JAX's ``compute_pose_stats`` over them."""
    root = str(tmp_path_factory.mktemp("pose") / "kitti_split1")
    make_synthetic_kitti_video(root, n_train=8, n_val=1, im_h=96, im_w=320,
                               seed=9)
    ours = [r for r in build_tracking_imdb(root, "training")
            if "10" in r.egos]
    theirs = [r for r in jax_tracking(root, "training") if "10" in r.egos]
    return ours, theirs, _script("train_pose").compute_pose_stats(theirs)


def test_pose_batches_match_jax(pose_tree, tmp_path):
    """``train_pose_torch.pose_batches`` against ``host_batches`` of JAX's
    ``scripts/train_pose.py`` for one seed, bit for bit: the draws, the
    frame pairs in (previous, current) order, the mirror draw and the
    mirrored, normalised targets; the port read through its decode
    cache."""
    ours, theirs, (pm, ps) = pose_tree
    tcfg = dataclasses.replace(load_config("tiny_video_synthetic"),
                               max_iter=4)
    jcfg = jax_config.load_config("tiny_video_synthetic").replace(max_iter=4)
    jax_script = _jax_pose_script(
        cfg=jcfg, rs=np.random.default_rng(jcfg.rng_seed), imdb=theirs,
        np=np, os=os, jax=jax, mirror_ego=jax_mirror_ego,
        load_image_cached=jax_pipeline.load_image_cached, cache_dir=None,
        pose_means=pm, pose_stds=ps)
    want = list(jax_script.host_batches())
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    got = list(_script("train_pose_torch").pose_batches(ours, tcfg, pm, ps,
                                                        cache, 4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[0].shape == (2, 2, 96, 320, 3)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    mirrors = np.concatenate([g[1] for g in got])
    assert mirrors.any() and not mirrors.all(), mirrors


def test_pose_steps_match_jax_in_f64(pose_tree, video_variables):
    """Two steps of ``train_pose_torch.build_pose_training`` against the
    ``step`` of JAX's ``scripts/train_pose.py`` (its optimizer built as its
    ``main`` builds it), the tiny video model in f64 in both packages
    (``PoseNet`` computes in f32 in both), on the pose batches: the loss's
    stats at rtol 1e-6 and each ``pose_net`` tensor's update within 1e-5
    of the update's largest magnitude (``conf``'s bias, whose gradient is
    zero since the softmax over positions ignores a constant, moves by
    rounding alone); every other tensor bit for bit (the model in eval
    mode, gradients into ``pose_net`` alone)."""
    ours, theirs, (pm, ps) = pose_tree
    tcfg = load_config("tiny_video_synthetic")
    jcfg = jax_config.load_config("tiny_video_synthetic")
    batches = list(_script("train_pose_torch").pose_batches(
        ours, tcfg, pm, ps, None, 2))
    variables = video_variables
    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if np.asarray(a).dtype.kind == "f" else jnp.asarray(a), t)
        jmodel = jv.VideoRPN3D(jv.VideoConfig(rpn=JaxRPNConfig(
            **TINY_RPN, predict_uncertainty=True, predict_velocity=True,
            backbone=jax_tiny(jnp.float64))))
        params = cast(variables["params"])
        tx = jax_freeze.wrap_with_freeze(
            optax.sgd(jax_schedule(jcfg.lr, jcfg.max_iter),
                      momentum=jcfg.momentum),
            jax_freeze.freeze_mask(params, trainable_substrings=("pose_net",)))
        opt_state = tx.init(params)
        js = _jax_pose_script(
            jax=jax, jnp=jnp, optax=optax, np=np, os=os, cfg=jcfg,
            model=jmodel, tx=tx, batch_stats=cast(variables["batch_stats"]),
            preprocess_images=jax_preprocess, pose_loss=jax_pose_loss,
            pose_means=pm, pose_stds=ps,
            means_img=jnp.asarray(jcfg.image_means),
            stds_img=jnp.asarray(jcfg.image_stds))
        ref = [from_flax(jax.device_get(params))]
        jstats = []
        for frames, mirror, tar in batches:
            params, opt_state, _, stats = js.step(params, opt_state, frames,
                                                  mirror, tar)
            ref.append(from_flax(jax.device_get(params)))
            jstats.append({k: float(v) for k, v in stats.items()})

    model = _port_video_model()
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    run = _script("train_pose_torch").build_pose_training(
        tcfg, model, pm, ps, "cpu", param_dtype=torch.float64)
    got = [{k: v.clone() for k, v in run.model.state_dict().items()}]
    for (frames, mirror, tar), want in zip(batches, jstats):
        stats = run.step(run.state, {"images_u8": _t(frames),
                                     "mirror": _t(mirror),
                                     "pose_tar": _t(tar)})
        assert set(stats) == set(want)
        for k in want:
            np.testing.assert_allclose(float(stats[k]), want[k],
                                       rtol=STATS_RTOL, err_msg=k)
        got.append({k: v.clone() for k, v in run.model.state_dict().items()})
    assert run.state.step == 2 and not run.model.training
    for i in (1, 2):
        for k, r in ref[i].items():
            if k.endswith("num_batches_tracked"):
                continue
            d_got, d_ref = got[i][k] - got[0][k], r.double() - ref[0][k]
            if not k.startswith("pose_net."):
                assert torch.equal(got[i][k], got[0][k]), k
                assert not d_ref.any(), k
                continue
            if k == "pose_net.conf.bias":     # a zero gradient, rounded
                assert max(d_got.abs().max(), d_ref.abs().max()) <= 1e-9, k
                continue
            assert d_ref.abs().max() > 0, k
            err = (d_got - d_ref).abs().max().item()
            assert err <= PARAM_REL * d_ref.abs().max().item(), \
                f"step {i}: {k} off by {err:.3e}"


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_pose_then_video_stage_on_the_cpu(clip_tree, tmp_path,
                                          video_variables):
    """The video recipe on the tiny model.  Without a card both scripts
    refuse to run unless given ``--device cpu``.  A ``_un`` run (a
    checkpoint, and an ``anchors.npz`` without the velocity column, which
    ``copy_stats`` turns down); ``scripts/train_pose_torch.py`` as a
    subprocess with JAX unimportable: it learns the detector run's anchors
    and 14-column statistics over the tracking tree (against JAX's
    ``prepare_anchors``), 2 steps, ``pose_stats.npz`` JAX's
    ``compute_pose_stats``; the pose npz read by ``load_pose_npz`` and by
    JAX's ``assemble_video_variables``); then ``scripts/train_torch.py``
    warm-started from both (only the head's velocity channel fresh), 2
    steps, and run again to 4, resuming and continuing ``metrics.csv``."""
    data, root = clip_tree
    out = tmp_path / "out"
    run = out / "tiny_video_synthetic"
    if not torch.cuda.is_available():         # both default to the card
        for name in ("train_pose_torch", "train_torch"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                _script(name).main(["--config", "kitti_3d_full",
                                    "--data-root", data, "--output",
                                    str(out)])
    tcfg = load_config("tiny_video_synthetic")
    jcfg = jax_config.load_config("tiny_video_synthetic")
    ours = build_tracking_imdb(root, "training")
    theirs = jax_tracking(root, "training")
    wa, wm, ws = jax_pipeline.prepare_anchors(
        jcfg, [jax_pipeline.ClipRecordView(r) for r in theirs],
        cache_dir=str(tmp_path / "j"))

    # the _un run: its checkpoint, and its anchors.npz without the velocity
    # column, which copy_stats must turn down
    pre = str(out / "tiny_un")
    ucfg = dataclasses.replace(tcfg, has_vel=False)
    ua, um, _ = pipeline.prepare_anchors(
        ucfg, [pipeline.ClipRecordView(r) for r in ours], cache_dir=pre,
        device="cpu")
    assert ua.shape == (wa.shape[0], 11) and um.shape == (13,)
    un = RPN3D(dataclasses.replace(tcfg.rpn_config(ua.shape[0]),
                                   predict_velocity=False))
    init_weights(un, torch.Generator().manual_seed(1))
    save_checkpoint(pre, un, step=7)
    sets = ["--set", f"pretrained={pre!r}", "--set", "copy_stats=True"]

    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER,
         os.path.join(ROOT, "scripts", "train_pose_torch.py"), "--config",
         "tiny_video_synthetic", "--data-root", data, "--output", str(out),
         "--device", "cpu", *sets],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"no anchors.npz under {run}: learning" in proc.stderr
    assert f"single-frame weights warm-started from {pre} (iter 7)" \
        in proc.stderr
    with np.load(run / "anchors.npz") as z:
        a, m, s = z["anchors"], z["bbox_means"], z["bbox_stds"]
    assert a.shape[1] == 12 and m.shape == s.shape == (14,)
    assert m[13] != 0 and s[13] != 1        # velocity statistics learned
    np.testing.assert_allclose(a, wa, rtol=0, atol=1e-6 * np.abs(wa).max())
    assert_stats_close((m, s), (wm, ws))
    assert "iter: 2, " in proc.stderr and "pose: " in proc.stderr
    pose_dir = out / "tiny_video_synthetic_pose"
    jstats = _script("train_pose").compute_pose_stats(
        [r for r in theirs if "10" in r.egos])
    z = np.load(pose_dir / "pose_stats.npz")
    np.testing.assert_array_equal(z["means"], jstats[0])
    np.testing.assert_array_equal(z["stds"], jstats[1])

    npz = str(pose_dir / "pose_net_params.npz")
    with np.load(npz) as zp:
        arrays = {k: zp[k] for k in zp.files}
    assert sorted(arrays) == sorted(
        f"{mod}/{leaf}" for mod in ("pose_feats", "pose", "conf")
        for leaf in ("kernel", "bias"))
    model = _port_video_model()
    init_weights(model, torch.Generator().manual_seed(tcfg.rng_seed))
    fresh = {k: v.clone() for k, v in model.pose_net.state_dict().items()}
    assert len(load_pose_npz(model.pose_net, npz)) == 6
    nested = {}
    for path, v in arrays.items():
        mod, leaf = path.split("/")
        nested.setdefault(mod, {})[leaf] = v
    for k, v in from_flax(nested).items():
        assert torch.equal(model.pose_net.state_dict()[k], v), k
    assert any(not torch.equal(fresh[k], v)
               for k, v in model.pose_net.state_dict().items())
    jmodel = jv.VideoRPN3D(jv.VideoConfig(rpn=JaxRPNConfig(
        **TINY_RPN, predict_uncertainty=True, predict_velocity=True,
        backbone=jax_tiny())))
    sf = SimpleNamespace(params=video_variables["params"]["rpn"],
                         batch_stats=video_variables["batch_stats"]["rpn"])
    filled = jax_assemble(jmodel, sf, npz)["params"]["pose_net"]
    for path, v in _flat(filled):
        np.testing.assert_array_equal(np.asarray(v), arrays[path])

    script = _script("train_torch")
    base = ["--config", "tiny_video_synthetic", "--data-root", data,
            "--output", str(out), "--device", "cpu", *sets]
    first = script.main([*base, "--max-iter", "2"])
    rep = first["restore"]
    assert rep["fresh"] == rep["mismatched"] == rep["dropped"] == []
    assert rep["widened"] == ["rpn.head.weight", "rpn.head.bias"]
    assert rep["pose"] == os.path.join(str(run) + "_pose",
                                       "pose_net_params.npz")
    assert rep["step"] == 7 and first["step"] == 2
    with open(run / "train.log") as f:
        log_text = f.read()
    assert f"warm-started from {pre} (iter 7; 0 tensors fresh, 0 of another " \
        "shape, 0 dropped; fresh: the velocity channel of " \
        "['rpn.head.weight', 'rpn.head.bias'])" in log_text
    assert "freezing 62/72 param tensors" in log_text
    assert "copy_stats: reusing" not in log_text
    assert first["launches"]["train"] == dict.fromkeys(
        first["launches"]["train"], 0)

    again = script.main([*base, "--max-iter", "4"])
    assert again["start_step"] == 2 and again["step"] == 4
    with open(run / "train.log") as f:
        assert "auto-resumed own checkpoint at iter 2" in f.read()
    with open(run / "metrics.csv") as f:
        rows = [r.split(",") for r in f.read().splitlines()]
    head = rows[0]
    assert {"vel", "vel_num", "bbox_3d"} <= set(head)
    assert [r[0] for r in rows[1:]] == ["1", "2", "3", "4"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    assert all(float(r[head.index("vel_num")]) > 0 for r in rows[1:])
