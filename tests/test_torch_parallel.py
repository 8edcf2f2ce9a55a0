"""Data parallelism of the port (``groomed_nms_torch/parallel``) on the CPU,
ranks joined by gloo through a ``file://`` store.

Held to one process on the global batch (``torch_parallel_cases``): the
train step of 4 ranks on 2 rows each in f64, BatchNorm perturbed, two steps
of each case -- ``tests/test_parallel.py::_setup``'s warm-up loss, the
dryrun's GrooMeD loss with acceptance, ``bbox_un_dynamic`` and
``distort_prob=0.5`` through the fused preprocess, ``batch_skip=2`` over two
micro-steps, ``rank_boxes_of_all_images_at_once``, the acceptance ``rank``
mode (both AP losses over the whole batch) and the video step with
``has_vel`` -- parameters within 1e-9 of each tensor's largest magnitude,
running statistics identical on every rank, stats at rtol 1e-6 (atol
1e-9): the loss runs in f32 at any model dtype (the head's outputs are
cast, as JAX's), and its sums taken in another order differ by f32
roundings.  The reference runs on one thread, as each rank does.  Held to JAX: the 4-rank f32 step against JAX's 8-device
``shard_train_step`` on ``_setup``'s inputs (weights through ``from_flax``)
at ``test_torch_training.py``'s tolerances (stats rtol 1e-4 / atol 1e-6
against the f32 and f64 JAX steps, each tensor within 1e-5 of its largest
magnitude of the f64 step and within that plus JAX f32's own distance from
f64 of the f32 step, running variances at rtol 1e-5); ``FlaxBatchNorm2d``'s
global statistics and backward against flax's ``BatchNorm`` on the whole
batch (rtol 1e-5 of each tensor's largest magnitude, f32); each rank's
loader rows against the rows of JAX's global batch, bit for bit.  And the
entry points: ``train_torch.py`` and ``evaluate_torch.py`` under torchrun
with 2 ranks, whose rows equal one process's, and ``dryrun_multichip(4)``.

Each world size is spawned once; the ranks import no jax (the JAX side runs
here).
"""

import dataclasses
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu.data import pipeline as jax_pipeline
from groomed_nms_tpu.losses import LossConfig as JaxLossConfig
from groomed_nms_tpu.models import RPN3D as JaxRPN3D, RPNConfig as JaxRPNConfig
from groomed_nms_tpu.models.densenet import tiny_densenet_config as jax_tiny
from groomed_nms_tpu.parallel import create_mesh, shard_batch, \
    shard_train_step
from groomed_nms_tpu.training import build_lr_schedule as jax_schedule
from groomed_nms_tpu.training import build_optimizer as jax_optimizer
from groomed_nms_tpu.training import make_train_step as jax_make_train_step
from groomed_nms_tpu.training.trainer import TrainState as JaxTrainState

from groomed_nms_torch import anchors as t_anchors
from groomed_nms_torch.data import pipeline
from groomed_nms_torch.data.synthetic import make_synthetic_kitti
from groomed_nms_torch.parallel import Dist, global_counts, local_rows, spawn
from groomed_nms_torch.parallel import dist as pdist
from groomed_nms_torch.parallel import dryrun
from groomed_nms_torch.utils.weights import from_flax
from test_parallel import _setup
from test_torch_eval import assert_same_rows, read_rows
from test_torch_train_data import _batches, _cfgs, _imdbs, tree  # noqa: F401
from test_torch_loss import CONFIGS, _gt_batch, _heads, _rois
from torch_parallel_cases import (batchnorm_case, build_model, loss_case,
                                  rank_cases, run_case, single_process)
from torch_port_common import _perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, GLOBAL_B = 4, 8
PARAM_REL, STATS_RTOL, STATS_ATOL = 1e-9, 1e-6, 1e-9
JAX_STATS_RTOL, JAX_STATS_ATOL, JAX_PARAM_REL, BN_RTOL = 1e-4, 1e-6, 1e-5, \
    1e-5
CASES = ("warmup", "groomed", "batch_skip", "all_images", "video")
# test_torch_loss's configurations and the video stage's (has_vel)
LOSS_CONFIGS = CONFIGS + [("kitti_3d_full", {})]
LOSS_GRAD_REL = 1e-6


def _perturbed(model, seed):
    """``model``'s state_dict as numpy: seeded weights, BatchNorm
    perturbed (``dryrun.perturb_batchnorm``)."""
    return {k: v.numpy().copy() for k, v in
            dryrun.perturb_batchnorm(model, seed).state_dict().items()}


def _warmup_inputs():
    """``_setup(8)``'s JAX state, step and batch, its anchors (the same
    draws of ``default_rng(0)``) and its weights with BatchNorm perturbed
    and the head's 1x1 kernel at a tenth of its random init: box deltas of
    a few tenths, so that predictions lie near their anchors (at full
    scale -log(IoU2D) multiplies the forward's f32 rounding by 1 / IoU and
    one f32 process is 5e-5 of a tensor's max off the f64 step, as
    ``test_torch_training.py`` found)."""
    state, step_fn, batch = _setup(batch_size=GLOBAL_B)
    rng = np.random.default_rng(0)
    templates = np.abs(rng.normal(size=(4, 4))).astype(np.float32)
    templates[:, 2:] += templates[:, :2] + 16.0
    priors = np.concatenate(
        [templates, np.abs(rng.normal(size=(4, 7))).astype(np.float32) + 1.0],
        axis=1)
    rois = t_anchors.locate_anchors(priors, (2, 4), 16)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    rs = np.random.default_rng(11)
    params = _perturb(np_tree(state.params), rs)
    stats = _perturb(np_tree(state.batch_stats), rs)
    params["head"]["kernel"] *= np.float32(0.1)
    return dict(state=state, step_fn=step_fn, batch=batch, rois=rois,
                rois_3d=priors[rois[:, 4].astype(np.int64), 4:],
                params=params, stats=stats)


def _cases(warm):
    """{name: (case, dtype name)} of the 4-rank run."""
    sd_warm = {k: v.numpy() for k, v in from_flax(warm["params"],
                                                  warm["stats"]).items()}
    warmup = dict(rpn=dict(num_classes=4, num_anchors=4, prop_features=32),
                  video=False, sd=sd_warm,
                  loss=dict(max_nms_boxes=16, max_ap_boxes=32), lr=0.01,
                  rois=warm["rois"], rois_3d=warm["rois_3d"],
                  means=np.zeros(13), stds=np.ones(13), fused=None,
                  batch=warm["batch"], steps=2)
    setup = dryrun._setup(GLOBAL_B)
    rois = setup["rois"]
    rpn = dict(num_classes=4, num_anchors=dryrun.NUM_ANCHORS,
               prop_features=64, predict_acceptance_prob=True)
    loss = dict(use_nms_in_loss=True, predict_acceptance_prob=True,
                use_acceptance_prob_in_regression_loss=True,
                bbox_un_dynamic=True, max_nms_boxes=32, max_ap_boxes=64)
    fused = dict(target_h=dryrun.B_H, crop_w=dryrun.B_W, distort_prob=0.5,
                 rng_seed=0)
    groomed = dict(rpn=rpn, video=False, loss=loss, lr=0.004, rois=rois,
                   rois_3d=setup["priors"][rois[:, 4].astype(np.int64), 4:],
                   means=np.zeros(13), stds=np.ones(13), fused=fused,
                   batch=setup["batch"], steps=2)
    groomed["sd"] = _perturbed(build_model(groomed), 3)
    priors_v = np.concatenate([setup["priors"], np.full(
        (dryrun.NUM_ANCHORS, 1), 0.5, np.float32)], axis=1)
    vbatch = dict(setup["batch"])
    vbatch["images_u8"] = np.repeat(vbatch["images_u8"], 2, axis=0).reshape(
        GLOBAL_B, 2, dryrun.SRC_H, dryrun.SRC_W, 3)
    vel = np.where(vbatch["gt_valid"][..., None], 0.5, -np.inf)
    vbatch["gts_3d"] = np.concatenate(
        [vbatch["gts_3d"], vel.astype(np.float32)], axis=2)
    video = dict(rpn=dict(num_classes=4, num_anchors=dryrun.NUM_ANCHORS,
                          prop_features=64, predict_velocity=True,
                          predict_uncertainty=True),
                 video=True, lr=0.004,
                 loss=dict(has_vel=True, has_un=True, bbox_un_dynamic=True,
                           max_nms_boxes=32, max_ap_boxes=64),
                 rois=rois, rois_3d=priors_v[rois[:, 4].astype(np.int64), 4:],
                 means=np.zeros(14), stds=np.ones(14),
                 fused=dict(target_h=dryrun.B_H, crop_w=dryrun.B_W,
                            video=True), batch=vbatch, steps=2)
    video["sd"] = _perturbed(build_model(video), 4)
    cases = {
        "warmup": warmup,
        "groomed": groomed,
        "batch_skip": dict(warmup, batch_skip=2),
        # a beta that lets every GT's best box be a target: the after-NMS
        # AP loss over the whole batch then has positives and a gradient
        "all_images": dict(groomed, loss=dict(
            loss, rank_boxes_of_all_images_at_once=True,
            best_target_box_beta=-1.0)),
        "video": video,
    }
    out = {k: (v, "float64") for k, v in cases.items()}
    out["jax_f32"] = (warmup, "float32")
    return out


def _bn_spec():
    rs = np.random.default_rng(5)
    c = 6
    return dict(x=(rs.normal(size=(GLOBAL_B, c, 3, 5)) * 2 + 0.5).astype(
                    np.float32),
                weight=rs.uniform(0.5, 1.5, c).astype(np.float32),
                bias=rs.normal(0, 0.3, c).astype(np.float32),
                cot=rs.normal(size=(GLOBAL_B, c, 3, 5)).astype(np.float32))


def _loss_specs():
    """``test_torch_loss``'s inputs for each of LOSS_CONFIGS on a global
    batch of 4 images (two of its GT batches and head draws)."""
    from groomed_nms_torch.config import load_config

    specs = []
    for name, overrides in LOSS_CONFIGS:
        cfg = dataclasses.replace(load_config(name).loss_config(),
                                  **overrides)
        vel = cfg.has_vel
        rois, rois_3d = _rois(vel)
        gts = [_gt_batch(seed, (6, 5), (1, 0), vel) for seed in (7, 8)]
        heads = [_heads(seed, cfg) for seed in (11, 12)]
        means = np.zeros(13 + vel, np.float32)
        stds = np.ones(13 + vel, np.float32)
        if vel:
            means[13], stds[13] = 0.1, 0.7
        specs.append(dict(
            cfg=dataclasses.asdict(cfg), rois=rois, rois_3d=rois_3d,
            gt={k: np.concatenate([g[k] for g in gts]) for k in gts[0]},
            heads={k: np.concatenate([h[k] for h in heads])
                   for k in heads[0]},
            means=means, stds=stds, un=(0.7, 3)))
    return specs


@pytest.fixture(scope="module")
def run():
    """The 4-rank run of every case (one spawn) and its inputs."""
    warm = _warmup_inputs()
    cases = _cases(warm)
    bn_spec = _bn_spec()
    loss_specs = _loss_specs()
    ranks = spawn(rank_cases, WORLD, cases, bn_spec, loss_specs)
    return dict(warm=warm, cases=cases, bn_spec=bn_spec, ranks=ranks,
                loss_specs=loss_specs)


def _max_rel(got, ref):
    """max over tensors of max |got - ref| / max |ref| (float tensors)."""
    worst, key = 0.0, None
    for k, r in ref.items():
        if not r.is_floating_point() or r.abs().max() == 0:
            continue
        e = ((got[k] - r).abs().max() / r.abs().max()).item()
        if e > worst:
            worst, key = e, k
    return worst, key


@pytest.mark.parametrize("name", CASES)
def test_step_matches_one_process_on_the_global_batch(run, name):
    case, _ = run["cases"][name]
    ref = single_process(run_case, case, torch.float64)
    ranks = [r[name] for r in run["ranks"]]
    for r in ranks[1:]:
        for k, v in ranks[0]["sd"].items():
            assert torch.equal(r["sd"][k], v), f"ranks differ at {k}"
        assert r["stats"] == ranks[0]["stats"] and r["lam"] == ranks[0]["lam"]
    got = ranks[0]
    worst, key = _max_rel(got["sd"], ref["sd"])
    assert worst <= PARAM_REL, f"{key} off by {worst:.3e} of its max"
    moved, _ = _max_rel(got["sd"], {k: torch.from_numpy(np.asarray(v))
                                    .double() for k, v in case["sd"].items()})
    assert moved > 1e-6, "the steps changed nothing: the check is empty"
    for step, (g, w) in enumerate(zip(got["stats"], ref["stats"])):
        assert set(g) == set(w)
        assert w["fg_num"] > 0, "no foreground: the loss checks nothing"
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=STATS_RTOL,
                                       atol=STATS_ATOL,
                                       err_msg=f"step {step}: {k}")
    np.testing.assert_allclose(got["lam"], ref["lam"], rtol=STATS_RTOL)
    if name == "all_images":
        assert ref["stats"][-1]["after_nms"] > 0
    if name == "video":
        assert ref["stats"][-1]["vel_num"] > 0


@pytest.mark.parametrize("i", range(len(LOSS_CONFIGS)),
                         ids=[n + "".join(f"-{v}" for v in o.values())
                              for n, o in LOSS_CONFIGS])
def test_loss_matches_one_process_on_the_global_batch(run, i):
    """``rpn_3d_loss`` of 4 ranks (one image each) against one process on
    the 4 images, in every configuration of ``test_torch_loss``: the
    stats, the lambda, and the gradient of each head tensor (each rank's
    rows from its share of the loss) within LOSS_GRAD_REL of its largest
    magnitude (f32; the global factors summed in other orders)."""
    ref = single_process(loss_case, run["loss_specs"][i])
    assert ref["stats"]["fg_num"] > 0
    ranks = [r["losses"][i] for r in run["ranks"]]
    for r in ranks[1:]:
        assert r["stats"] == ranks[0]["stats"] and r["lam"] == ranks[0]["lam"]
    for k, w in ref["stats"].items():
        np.testing.assert_allclose(ranks[0]["stats"][k], w, rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=k)
    np.testing.assert_allclose(ranks[0]["lam"], ref["lam"], rtol=STATS_RTOL,
                               atol=STATS_ATOL)
    assert ranks[0]["n"] == ref["n"]
    for k, w in ref["grads"].items():
        g = torch.cat([r["grads"][k] for r in ranks])
        assert torch.isfinite(g).all(), k
        err = (g - w).abs().max().item()
        assert err <= LOSS_GRAD_REL * w.abs().max().item(), \
            f"{k} off by {err:.3e} (max {w.abs().max().item():.3e})"


def _jax_steps(warm, dtype):
    """Two steps of JAX's 8-device ``shard_train_step`` on ``_setup``'s
    inputs with the perturbed weights, in ``dtype``."""
    cast = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype) if np.asarray(a).dtype == np.float32
        else jnp.asarray(a), t)
    model = JaxRPN3D(JaxRPNConfig(num_classes=4, num_anchors=4,
                                  prop_features=32, backbone=jax_tiny(dtype)))
    tx = jax_optimizer("sgd", jax_schedule(0.01, 100), batch_skip=1)
    params = cast(warm["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=cast(warm["stats"]), opt_state=tx.init(params),
        un_state=cast(warm["state"].un_state), tx=tx, apply_fn=model.apply)
    step_fn = jax_make_train_step(
        JaxLossConfig(max_nms_boxes=16, max_ap_boxes=32),
        cast(warm["rois"]), cast(warm["rois_3d"]), cast(np.zeros(13,
                                                                 np.float32)),
        cast(np.ones(13, np.float32)))
    mesh = create_mesh(jax.devices()[:8])
    step = shard_train_step(step_fn, mesh)
    out = []
    with mesh:
        batch = shard_batch(mesh, cast(warm["batch"]))
        for _ in range(2):
            state, stats = step(state, batch)
            np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
            out.append((from_flax(np_tree(state.params),
                                  np_tree(state.batch_stats)),
                        {k: float(v) for k, v in stats.items()}))
    return out


def test_step_matches_jax_sharded_step(run):
    """The port's 4-rank f32 step against JAX's 8-device sharded step
    (two steps; the rule of ``test_torch_training.py``)."""
    if len(jax.devices()) < 8:
        pytest.fail("needs the virtual 8-device mesh (tests/conftest.py)")
    ref32 = _jax_steps(run["warm"], jnp.float32)
    with jax.enable_x64(True):
        ref64 = _jax_steps(run["warm"], jnp.float64)
    got = run["ranks"][0]["jax_f32"]
    for r in run["ranks"][1:]:
        assert all(torch.equal(r["jax_f32"]["sd"][k], v)
                   for k, v in got["sd"].items())
    (p32, s32), (p64, s64) = ref32[-1], ref64[-1]
    for step, ((_, j32), (_, j64)) in enumerate(zip(ref32, ref64)):
        assert j32["fg_num"] > 0
        for ref in (j32, j64):
            for k in ref:
                np.testing.assert_allclose(
                    got["stats"][step][k], ref[k], rtol=JAX_STATS_RTOL,
                    atol=JAX_STATS_ATOL, err_msg=f"step {step}: {k}")
    for k, r64 in p64.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, r64, r32 = got["sd"][k].numpy(), r64.numpy(), p32[k].numpy()
        tol = JAX_PARAM_REL * np.abs(r64).max()
        err64, err32 = np.abs(g - r64).max(), np.abs(g - r32).max()
        own32 = np.abs(r32 - r64).max()
        assert err64 <= tol, f"{k} off JAX f64 by {err64:.3e}"
        assert err32 <= tol + own32, f"{k} off JAX f32 by {err32:.3e}"
        if k.endswith("running_var"):
            np.testing.assert_allclose(g, r64, rtol=BN_RTOL, err_msg=k)


def test_batchnorm_global_statistics_match_flax(run):
    """Forward, input and affine gradients and running statistics of the
    4 ranks' ``FlaxBatchNorm2d`` against flax's ``BatchNorm`` on the whole
    batch; one process's global path (no group) is the local one."""
    spec = run["bn_spec"]
    x = jnp.asarray(spec["x"].transpose(0, 2, 3, 1))
    cot = jnp.asarray(spec["cot"].transpose(0, 2, 3, 1))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    c = x.shape[-1]
    params = {"scale": jnp.asarray(spec["weight"]),
              "bias": jnp.asarray(spec["bias"])}
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def fwd(p, x):
        return bn.apply({"params": p, "batch_stats": stats}, x,
                        mutable=["batch_stats"])

    y, new = fwd(params, x)
    _, vjp = jax.vjp(lambda p, x: fwd(p, x)[0], params, x)
    dp, dx = vjp(cot)
    ranks = [r["batchnorm"] for r in run["ranks"]]
    to = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    checks = {
        "y": (np.concatenate([r["y"].numpy() for r in ranks]), to(y)),
        "dx": (np.concatenate([r["dx"].numpy() for r in ranks]), to(dx)),
        "dweight": (sum(r["dweight"].numpy() for r in ranks),
                    np.asarray(dp["scale"])),
        "dbias": (sum(r["dbias"].numpy() for r in ranks),
                  np.asarray(dp["bias"])),
        "mean": (ranks[0]["mean"].numpy(),
                 np.asarray(new["batch_stats"]["mean"])),
        "var": (ranks[0]["var"].numpy(),
                np.asarray(new["batch_stats"]["var"])),
    }
    for k, (g, w) in checks.items():
        err = np.abs(g - w).max()
        assert err <= BN_RTOL * np.abs(w).max(), f"{k} off by {err:.3e}"
    for r in ranks[1:]:
        assert torch.equal(r["mean"], ranks[0]["mean"])
        assert torch.equal(r["var"], ranks[0]["var"])
    local = batchnorm_case(spec, Dist())
    np.testing.assert_allclose(local["y"].numpy(), checks["y"][1],
                               atol=BN_RTOL * np.abs(checks["y"][1]).max())


def test_global_counts_and_rank_slices(monkeypatch):
    """``local_rows`` gives contiguous blocks and refuses an uneven split;
    ``global_counts`` in one process hands back what it was given; nccl with
    more ranks than cards on a host is refused with the way out named."""
    assert [local_rows(8, r, 4) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        local_rows(8, 0, 3)
    a, b = torch.tensor(3), torch.tensor([1.5, 2.0])
    for ctx in (None, Dist()):
        got = global_counts(ctx, a, b)
        assert got[0] is a and got[1] is b
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="gloo to let ranks share a card"):
        pdist._rank_device("cuda", 1, 2, "nccl")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        pdist.init_distributed("mpi", "cpu", rank=0, world=1,
                               init_method="file:///nonexistent")


def test_an_ignored_parameter_the_loss_reaches_raises(tmp_path,
                                                     monkeypatch):
    """A parameter on DDP's ignore list that the loss reaches stops the
    step, named, where DDP would leave its gradient unreduced and the
    ranks would step apart (a one-rank gloo group in this process)."""
    ctx = pdist.init_distributed("gloo", "cpu", rank=0, world=1,
                                 init_method=f"file://{tmp_path / 'store'}")
    wrap = pdist.wrap_model
    monkeypatch.setattr(pdist, "wrap_model",
                        lambda m, d: wrap(m, d, ignore=["head.weight"]))
    try:
        setup = dryrun._setup(1)
        state, fused = dryrun._still(setup, "cpu", ctx, distort_prob=0.0)
        assert list(state.ddp.ignored_params) == ["head.weight"]
        with pytest.raises(RuntimeError,
                           match="head.weight is in DDP's ignore list"):
            fused(state, dryrun._tensors(setup["batch"], slice(None), "cpu"))
    finally:
        pdist.close_distributed(ctx)


def test_loader_rows_are_the_global_batch_rows(tree):  # noqa: F811
    """Rank r of 4 gets rows 2r..2r+1 of JAX's global batch of 8, five
    batches in a row (the ranks' draws stay in step); a batch of 8 over 3
    ranks is refused."""
    (ours, theirs), (tcfg, jcfg) = _imdbs(tree), _cfgs(mirror_prob=0.5,
                                                       batch_size=GLOBAL_B)
    want = _batches(jax_pipeline.TrainLoader(theirs, jcfg, seed=3,
                                             prefetch=2), 5)
    for r in range(WORLD):
        got = _batches(pipeline.TrainLoader(ours, tcfg, seed=3, prefetch=2,
                                            rank=r, world=WORLD), 5)
        rows = local_rows(GLOBAL_B, r, WORLD)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["images_u8"],
                                          w["images_u8"][rows])
            np.testing.assert_array_equal(g["mirror"], w["mirror"][rows])
            for name, a, b in zip(w["gt"]._fields, g["gt"], w["gt"]):
                np.testing.assert_array_equal(a, np.asarray(b)[rows],
                                              err_msg=name)
    with pytest.raises(ValueError, match="does not split"):
        pipeline.TrainLoader(ours, tcfg, seed=3, rank=0, world=3)


def _torchrun(script, *args, nproc=2):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}",
         os.path.join(ROOT, "scripts", script), *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))


def test_entry_points_under_torchrun(tmp_path):
    """``train_torch.py`` with 2 gloo ranks: one checkpoint, the log and
    metrics from rank 0, the snapshot evaluation sharded (a txt file a
    val frame); then ``evaluate_torch.py`` with 2 ranks writes the rows one
    process writes from the same checkpoint."""
    data = tmp_path / "data"
    root = str(data / "kitti_split1")
    make_synthetic_kitti(root, "training", 6, im_h=96, im_w=320, seed=6,
                         classes=("Car", "Pedestrian", "Cyclist"))
    make_synthetic_kitti(root, "validation", 3, im_h=96, im_w=320, seed=7,
                         classes=("Car", "Pedestrian", "Cyclist"))
    out = str(tmp_path / "out")
    base = ["--config", "tiny_synthetic", "--data-root", str(data),
            "--output", out, "--device", "cpu", "--dist-backend", "gloo",
            "--set", "score_thres=0.0"]
    train = _torchrun("train_torch.py", *base)
    assert train.returncode == 0, train.stderr[-3000:]
    run_dir = os.path.join(out, "tiny_synthetic")
    assert os.listdir(os.path.join(run_dir, "weights")) == ["checkpoint_4.pt"]
    with open(os.path.join(run_dir, "train.log")) as f:
        log_text = f.read()
    assert "2 ranks (gloo)" in log_text and "iter: 4, " in log_text
    assert "car detection AP|R40" in log_text
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        assert [r.split(",")[0] for r in f.read().splitlines()] == \
            ["iter", "2", "4"]
    assert sorted(os.listdir(os.path.join(run_dir, "results", "results_4",
                                          "data"))) == \
        [f"{i:06d}.txt" for i in range(3)]

    ev = ["--config", "tiny_synthetic", "--data-root", str(data),
          "--output", out, "--device", "cpu", "--restore", "4",
          "--skip-eval", "--set", "score_thres=0.0"]
    res = os.path.join(run_dir, "results", "results_4")
    sharded = _torchrun("evaluate_torch.py", *ev, "--dist-backend", "gloo")
    assert sharded.returncode == 0, sharded.stderr[-3000:]
    two = read_rows(res)
    one = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "evaluate_torch.py"),
         *ev], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert one.returncode == 0, one.stderr[-3000:]
    assert assert_same_rows(two, read_rows(res)) >= 3


def test_dryrun_multichip_4(capsys):
    out = dryrun.dryrun_multichip(4)
    printed = capsys.readouterr().out
    for line in ("still-image loss=", "1-vs-4 grad parity",
                 "video loss=", "sharded eval wrote 4 txts"):
        assert f"dryrun_multichip(4) OK: {line}" in printed, printed
    assert out["max_param_delta"] < dryrun.PARAM_ATOL
    assert out["backend"] == "gloo"
