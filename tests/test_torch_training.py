"""The port's training runtime against JAX: the LR schedule, the optimizer,
BatchNorm's train-mode statistics, the whole train step of the tiny model,
and GrooMeD-NMS at test time.

Tolerances: the schedule exactly (both compute it in f32); the optimizer's
parameters at rtol 1e-6, atol 1e-7 (the same f32 updates, a multiply-add
fused or not); running variances at rtol 1e-5 and running means at 1e-5 of
each tensor's largest magnitude; the train step's loss and
stats at rtol 1e-4 (atol 1e-6), its parameters and running statistics after
each step at 1e-5 of each tensor's largest magnitude (two f32 steps of a
network summed in other orders) from JAX's f64 step, and from its f32 step
beyond JAX f32's own distance from f64; the test-time decode's valid masks
identical and its rows at rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from groomed_nms_tpu.config import load_config as jax_load_config
from groomed_nms_tpu import inference as jax_inf
from groomed_nms_tpu.losses.rpn_3d import UncertaintyState as JaxUnState
from groomed_nms_tpu.models import RPN3D as JaxRPN3D, RPNConfig as JaxRPNConfig
from groomed_nms_tpu.models.densenet import tiny_densenet_config as jax_tiny
from groomed_nms_tpu.training import build_lr_schedule as jax_schedule
from groomed_nms_tpu.training import build_optimizer as jax_optimizer
from groomed_nms_tpu.training import make_train_step as jax_make_train_step
from groomed_nms_tpu.training.trainer import TrainState as JaxTrainState

from groomed_nms_torch import inference
from groomed_nms_torch.config import load_config
from groomed_nms_torch.losses.rpn_3d import UncertaintyState
from groomed_nms_torch.training.schedules import build_lr_schedule
from groomed_nms_torch.training.trainer import (TrainState, build_optimizer,
                                                fuse_preprocess,
                                                make_train_step)
from groomed_nms_torch.utils.weights import from_flax
from test_torch_loss import _gt_batch, _rois
from torch_port_common import TINY, tiny_models, to_np

STEP_STATS_RTOL, STEP_STATS_ATOL = 1e-4, 1e-6
STEP_PARAM_REL = 1e-5
BN_RTOL = 1e-5


@pytest.mark.parametrize("kw", [
    dict(policy="poly"), dict(policy="poly", warmup_iters=100),
    dict(policy="step", lr_steps=[0.3, 0.6]),
    dict(policy="step", lr_steps=[0.5], warmup_iters=30, warmup_factor=0.2),
])
def test_lr_schedule_matches_jax(kw):
    ours, theirs = build_lr_schedule(0.004, 1000, **kw), \
        jax_schedule(0.004, 1000, **kw)
    for step in (0, 1, 29, 30, 99, 100, 299, 300, 500, 600, 999, 1000, 1500):
        assert ours(step) == float(theirs(step)), step


@pytest.mark.parametrize("batch_skip", [1, 2])
def test_optimizer_matches_optax_chain(batch_skip):
    """Three updates (3 * batch_skip micro-steps) on a small tree, with
    gradients large enough for the clip to bite."""
    rs = np.random.default_rng(batch_skip)
    shapes = {"w": (5, 3), "b": (3,), "k": (2, 2, 4)}
    params = {k: rs.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    sched = (0.004, 100)
    tx = jax_optimizer("sgd", jax_schedule(*sched), momentum=0.9,
                       weight_decay=0.0005, clip_value=1.0,
                       batch_skip=batch_skip)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in params.items()}
    opt = build_optimizer(t_params.values(), "sgd", build_lr_schedule(*sched),
                          momentum=0.9, weight_decay=0.0005, clip_value=1.0,
                          batch_skip=batch_skip)
    for _ in range(3 * batch_skip):
        grads = {k: rs.normal(0, 1.5, s).astype(np.float32)
                 for k, s in shapes.items()}
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in
                                      grads.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(t_params[k].detach().numpy(),
                                       np.asarray(j_params[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert opt.count == 3


def test_unported_solver_raises():
    with pytest.raises(NotImplementedError, match="adam"):
        build_optimizer([torch.nn.Parameter(torch.zeros(1))], "adam", 0.1)


def _images(seed, b=2, h=64, w=128):
    return np.random.default_rng(seed).normal(size=(b, h, w, 3)).astype(
        np.float32)


def _running_stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def test_batchnorm_train_mode_updates_like_flax():
    """One train-mode forward: every running mean and variance as flax's
    (the EMA of the BIASED batch variance), and the same outputs."""
    jmodel, variables, tmodel = tiny_models(seed=3,
                                            predict_acceptance_prob=True)
    x = _images(3)
    jout, mutated = jax.jit(lambda v, im: jmodel.apply(
        v, im, train=True, mutable=["batch_stats"]))(variables,
                                                    jnp.asarray(x))
    tmodel.train()
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = _running_stats(from_flax(variables["params"],
                                   mutated["batch_stats"]))
    got = _running_stats(tmodel.state_dict())
    assert set(got) == set(ref) and len(got) == 2 * 21     # 21 BatchNorms
    for k in ref:
        r = ref[k].numpy()
        err = np.abs(got[k].numpy() - r)
        if k.endswith("running_var"):
            assert (err / r).max() <= BN_RTOL, k
        else:
            # a batch mean near 0 is a sum that cancels: relative to the
            # channel's own value it carries the inputs' f32 rounding
            # (conv sums in other orders), so it is held to the tensor's max
            assert err.max() <= BN_RTOL * np.abs(r).max(), k
    np.testing.assert_allclose(to_np(tout.fused_raw),
                               np.asarray(jout.fused_raw), atol=1e-4)
    # the deepest blocks see 2 x 4 x 8 = 64 values a channel: torch's own
    # unbiased update would be 64/63 times the batch variance, far outside
    before = from_flax(variables["params"], variables["batch_stats"])
    k = "backbone.denseblock4_layer2.norm2.running_var"
    batch_var = (ref[k] - 0.9 * before[k]) / 0.1
    unbiased = 0.9 * before[k] + 0.1 * batch_var * 64 / 63
    assert ((unbiased - ref[k]).abs() / ref[k]).max() > 10 * BN_RTOL


def test_batchnorm_eval_mode_is_unchanged():
    _, _, tmodel = tiny_models(seed=4)
    x = torch.from_numpy(_images(4)).permute(0, 3, 1, 2)
    ref = torch.nn.BatchNorm2d.forward
    for m in tmodel.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            with torch.no_grad():
                h = torch.randn(2, m.num_features, 3, 5)
                assert torch.equal(m(h), ref(m, h))
    before = _running_stats(tmodel.state_dict())
    with torch.no_grad():
        tmodel(x)
    after = _running_stats(tmodel.state_dict())
    assert all(torch.equal(before[k], after[k]) for k in before)


# ---------------------------------------------------------------------------
# the whole train step against JAX make_train_step
# ---------------------------------------------------------------------------

def _jax_train_steps(variables, rois, rois_3d, gt, x, means, stds, sched,
                     dtype):
    """Two JAX ``make_train_step`` steps of the tiny model in ``dtype``;
    returns [(state_dict-named params and statistics, stats, un lambda)]."""
    cast = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype) if np.asarray(a).dtype == np.float32
        else jnp.asarray(a), t)
    jmodel = JaxRPN3D(JaxRPNConfig(backbone=jax_tiny(dtype), **TINY,
                                   predict_acceptance_prob=True))
    tx = jax_optimizer("sgd", jax_schedule(*sched))
    params = cast(variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=cast(variables["batch_stats"]),
        opt_state=tx.init(params), un_state=cast(JaxUnState.init()),
        tx=tx, apply_fn=jmodel.apply)
    step = jax.jit(jax_make_train_step(
        jax_load_config("groomed_nms").loss_config(), cast(rois),
        cast(rois_3d), cast(means), cast(stds)))
    batch = cast({"images": x, **gt})
    out = []
    for _ in range(2):
        state, stats = step(state, batch)
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
        out.append((from_flax(np_tree(state.params),
                              np_tree(state.batch_stats)),
                    {k: float(v) for k, v in stats.items()},
                    float(state.un_state.lam)))
    return out


def test_train_step_matches_jax_over_two_steps():
    """Two f32 steps of the tiny model with the groomed_nms loss (GrooMeD-NMS
    in the loss through K3's plain version, the after-NMS AP loss) against
    JAX ``make_train_step`` in f32, and against the same JAX step in f64.

    The f64 step is the exact reference: train-mode BatchNorm's backward
    cancels in the stem, and there JAX's f32 step is itself up to 4e-5 of a
    tensor's max off its f64 step while the port's f32 step stays within
    2e-6.  So every tensor is held to the f64 step at the tolerance, and to
    the f32 step at the tolerance plus JAX f32's own distance from f64."""
    _, variables, tmodel = tiny_models(seed=5, predict_acceptance_prob=True)
    # the head's 1x1 kernel at a tenth of its random init: box deltas of a
    # few tenths, as the loss tests' heads have, so that predictions lie
    # near their anchors and the after-NMS targets are not empty.  At full
    # scale the deltas reach 2.7, predicted boxes barely touch their GTs and
    # -log(IoU2D) multiplies the forward's f32 rounding by 1 / IoU.
    variables["params"]["head"]["kernel"] *= np.float32(0.1)
    tmodel.load_state_dict(from_flax(variables["params"],
                                     variables["batch_stats"]))
    rois, rois_3d = _rois()
    gt = _gt_batch(7)
    x = _images(5)
    means, stds = np.zeros(13, np.float32), np.ones(13, np.float32)
    sched = (0.01, 100)
    args = (variables, rois, rois_3d, gt, x, means, stds, sched)
    ref32 = _jax_train_steps(*args, jnp.float32)
    with jax.enable_x64(True):
        ref64 = _jax_train_steps(*args, jnp.float64)

    tstate = TrainState(tmodel, build_optimizer(
        tmodel.parameters(), "sgd", build_lr_schedule(*sched)),
        UncertaintyState.init())
    tstep = make_train_step(load_config("groomed_nms").loss_config(),
                            torch.from_numpy(rois), torch.from_numpy(rois_3d),
                            torch.from_numpy(means), torch.from_numpy(stds))
    tbatch = {"images": torch.from_numpy(x).permute(0, 3, 1, 2),
              **{k: torch.from_numpy(v) for k, v in gt.items()}}

    for step, ((p32, s32, lam32), (p64, s64, _)) in enumerate(
            zip(ref32, ref64)):
        tstats = {k: float(v) for k, v in tstep(tstate, tbatch).items()}
        assert set(tstats) == set(s32)
        assert s32["fg_num"] > 0 and s32["after_nms"] > 0
        for ref in (s32, s64):
            for k in ref:
                np.testing.assert_allclose(
                    tstats[k], ref[k], rtol=STEP_STATS_RTOL,
                    atol=STEP_STATS_ATOL, err_msg=f"step {step}: {k}")
        got = tmodel.state_dict()
        for k, r64 in p64.items():
            if k.endswith("num_batches_tracked"):
                continue
            g, r64, r32 = got[k].numpy(), r64.numpy(), p32[k].numpy()
            tol = STEP_PARAM_REL * np.abs(r64).max()
            err64 = np.abs(g - r64).max()
            err32 = np.abs(g - r32).max()
            own32 = np.abs(r32 - r64).max()
            assert err64 <= tol, f"step {step}: {k} off f64 by {err64:.3e}"
            assert err32 <= tol + own32, \
                f"step {step}: {k} off f32 by {err32:.3e} (JAX f32 {own32:.3e})"
        assert tstate.step == step + 1
        np.testing.assert_allclose(float(tstate.un_state.lam), lam32,
                                   rtol=1e-4)


def test_fuse_preprocess_feeds_the_step():
    seen = {}

    def step(state, batch):
        seen.update(batch)
        return {"total": torch.zeros(())}

    u8 = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 48, 96, 3)).astype(np.uint8))
    fused = fuse_preprocess(step, torch.tensor([0.485, 0.456, 0.406]),
                            torch.tensor([0.229, 0.224, 0.225]), target_h=64,
                            crop_w=128)
    fused(None, {"images_u8": u8, "mirror": torch.tensor([True, False]),
                 "gts_2d": torch.zeros(2, 1, 4)})
    assert seen["images"].shape == (2, 3, 64, 128)
    assert torch.equal(seen["images"][0], seen["images"][0])
    assert set(seen) == {"images", "gts_2d"}
    with pytest.raises(NotImplementedError, match="distort_prob"):
        fuse_preprocess(step, None, None, target_h=64, crop_w=128,
                        distort_prob=0.5)


# ---------------------------------------------------------------------------
# GrooMeD-NMS at test time
# ---------------------------------------------------------------------------

def _dets(rs, b, r):
    """[B, R, 17] detection rows (clustered boxes, plausible 3D columns)
    and [B, R] scores."""
    d = np.zeros((b, r, 17), np.float32)
    centers = rs.uniform([0, 0], [1200, 350], (40, 2))
    c = centers[rs.integers(0, 40, (b, r))] + rs.normal(0, 8, (b, r, 2))
    wh = rs.uniform(20, 120, (b, r, 2))
    d[..., :2], d[..., 2:4] = c - wh / 2, c + wh / 2
    d[..., 4] = rs.uniform(0, 1, (b, r))
    d[..., 5] = rs.integers(1, 4, (b, r))
    d[..., 9:12] = rs.uniform(1, 4, (b, r, 3))
    d[..., 13] = (c[..., 0] - 600) / 30
    d[..., 14] = rs.uniform(1, 2, (b, r))
    d[..., 15] = rs.uniform(10, 40, (b, r))
    d[..., 16] = rs.uniform(-3, 3, (b, r))
    scores = rs.uniform(0.05, 1, (b, r)).astype(np.float32)
    return d, scores


@pytest.mark.parametrize("overlap", ["2d", "3d", "2d_3d"])
def test_groomed_nms_at_test_matches_jax(overlap):
    rs = np.random.default_rng(8)
    dets, scores = _dets(rs, 2, 700)
    jcfg = dataclasses.replace(
        jax_load_config("groomed_nms").replace(
            use_differentiable_nms_at_test=True).detect_config(),
        overlap_in_nms=overlap)
    tcfg = dataclasses.replace(
        dataclasses.replace(load_config("groomed_nms"),
                            use_differentiable_nms_at_test=True
                            ).detect_config(),
        overlap_in_nms=overlap)
    assert tcfg.diff_nms_boxes == 512 and tcfg.use_differentiable_nms
    jd, jv = jax_inf.nms_and_topk(jnp.asarray(dets), jnp.asarray(scores),
                                  jcfg)
    td, tv = inference.nms_and_topk(torch.from_numpy(dets),
                                    torch.from_numpy(scores), tcfg)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.any()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=0)
