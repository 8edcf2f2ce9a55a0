"""The loop half of the training slice, JAX vs the PyTorch port, on the CPU:
freezing, the Adam/Adamax solvers, the stats line and CSV, checkpoints and
the warm start across configs, three steps of the train loop, and
``scripts/train_torch.py`` run as a subprocess with JAX and the JAX package
unimportable.

Tolerances: the freeze labels and the warm start's fresh tensors as sets,
exactly; frozen parameters and pinned statistics bit for bit unchanged;
every tensor after two freezing steps (f32) and after three loop steps
(f64, see ``test_three_loop_steps_match_jax``) within 1e-4 of its largest
magnitude from JAX's run (the rule of ``chip_smoke.py``'s card-vs-CPU step:
convolutions and their gradients summed in other orders); Adam and Adamax against optax at rtol 1e-6,
atol 1e-7 (as SGD in ``test_torch_training.py``); the log line and the CSV
text identical.
"""

import dataclasses
import importlib.util
import itertools
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from groomed_nms_tpu import config as jax_config
from groomed_nms_tpu.data.imdb import build_imdb as jax_build_imdb
from groomed_nms_tpu.data.pipeline import TrainLoader as JaxTrainLoader
from groomed_nms_tpu.models import RPN3D as JaxRPN3D
from groomed_nms_tpu.training import build_lr_schedule as jax_schedule
from groomed_nms_tpu.training import build_optimizer as jax_optimizer
from groomed_nms_tpu.training import checkpoint as jax_checkpoint
from groomed_nms_tpu.training import create_train_state
from groomed_nms_tpu.training import freeze as jax_freeze
from groomed_nms_tpu.training import make_train_step as jax_make_train_step
from groomed_nms_tpu.training import stats as jax_stats
from groomed_nms_tpu.training.trainer import fuse_preprocess as jax_fuse

from groomed_nms_torch import config
from groomed_nms_torch.data.imdb import build_imdb
from groomed_nms_torch.data.pipeline import TrainLoader, prepare_anchors
from groomed_nms_torch.data.synthetic import make_synthetic_kitti
from groomed_nms_torch.losses.rpn_3d import UncertaintyState
from groomed_nms_torch.models.rpn_3d import RPN3D
from groomed_nms_torch.training import checkpoint, freeze, stats
from groomed_nms_torch.training.schedules import build_lr_schedule
from groomed_nms_torch.training.trainer import (TrainState, build_optimizer,
                                                make_train_step)
from groomed_nms_torch.utils.weights import from_flax, init_weights
from test_torch_loss import _gt_batch, _rois
from torch_port_common import tiny_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_REL = 1e-4
CLASSES = ("Car", "Pedestrian", "Cyclist")


def _train_torch():
    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "scripts", "train_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _marked(tree, frozen_paths, prefix=()):
    """``tree`` with each leaf 1 where its flax path is in
    ``frozen_paths``, else 0."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _marked(v, frozen_paths, prefix + (k,))
        else:
            hit = "/".join(prefix + (k,)) in frozen_paths
            out[k] = np.full(np.shape(v), float(hit), np.float32)
    return out


def _paths(tree, pred, prefix=()):
    """Flax paths of the leaves of ``tree`` where ``pred(leaf)``."""
    out = set()
    for k, v in tree.items():
        if hasattr(v, "items"):
            out |= _paths(v, pred, prefix + (k,))
        elif pred(v):
            out.add("/".join(prefix + (k,)))
    return out


def _as_torch_keys(params, batch_stats, frozen_paths):
    """The state_dict keys of the flax leaves in ``frozen_paths``, mapped by
    ``from_flax`` itself (each leaf marked, converted, read back)."""
    sd = from_flax(_marked(params, frozen_paths),
                   _marked(batch_stats, frozen_paths))
    return {k for k, v in sd.items()
            if v.is_floating_point() and v.numel() and bool((v == 1).all())}


# ---------------------------------------------------------------------------
# freezing
# ---------------------------------------------------------------------------

FREEZE_CASES = {
    "blacklist": dict(freeze_blacklist=("head", "accept")),
    "whitelist": dict(freeze_whitelist=("denseblock1",)),
    "freeze_bn": dict(freeze_bn=True),
}


def _images(seed, b=2, h=64, w=128):
    return np.random.default_rng(seed).normal(size=(b, h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("case", sorted(FREEZE_CASES))
def test_freezing_matches_jax(case):
    """The same parameters and statistics frozen as JAX's labels and mask,
    read through from_flax; then two steps of the port: the frozen
    parameters and pinned statistics unchanged bit for bit, the rest moved.
    The whitelist case is JAX's ``test_partial_bn_stats_freeze`` (BatchNorm
    in train mode with denseblock1's statistics pinned): there JAX takes
    the same two steps and every tensor is held at JAX's values."""
    knobs = FREEZE_CASES[case]
    jmodel, variables, tmodel = tiny_models(seed=11,
                                            predict_acceptance_prob=True)
    params, bs = variables["params"], variables["batch_stats"]
    jlabels = jax_freeze.build_freeze_labels(params, **knobs)
    jmask = jax_freeze.frozen_stats_mask(bs, **knobs)
    frozen_j = _as_torch_keys(params, bs, _paths(jlabels,
                                                 lambda v: v == "freeze"))
    pinned_j = _as_torch_keys(params, bs, _paths(jmask, bool))
    labels = freeze.build_freeze_labels(tmodel, **knobs)
    mask = freeze.frozen_stats_mask(tmodel, **knobs)
    frozen_t = {k for k, v in labels.items() if v == "freeze"}
    pinned_t = {k for k, v in mask.items() if v}
    assert frozen_t == {k for k in frozen_j if k in labels}
    assert pinned_t == pinned_j
    assert frozen_t and len(frozen_t) < len(labels)
    train_bn = not freeze.all_stats_frozen(mask)
    assert train_bn == (not jax_freeze.all_stats_frozen(jmask))
    assert train_bn == (case == "whitelist")

    lcfg = config.load_config("kitti_3d_warmup").loss_config()
    jlcfg = jax_config.load_config("kitti_3d_warmup").loss_config()
    rois, rois_3d = _rois()
    gt = _gt_batch(12)
    x = _images(12)
    means, stds = np.zeros(13, np.float32), np.ones(13, np.float32)
    ref = {}
    if train_bn:
        tx = jax_freeze.wrap_with_freeze(
            jax_optimizer("sgd", jax_schedule(0.01, 100)), jlabels)
        jstate = create_train_state(jmodel, (1, 64, 64, 3), tx)
        jstate = jstate.replace(params=params, batch_stats=bs,
                                opt_state=tx.init(params))
        jstep = jax.jit(jax_make_train_step(
            jlcfg, jnp.asarray(rois), jnp.asarray(rois_3d), means, stds,
            train_bn=train_bn, frozen_stats_mask=jmask))
        for _ in range(2):
            jstate, _ = jstep(jstate, {"images": jnp.asarray(x), **gt})
        ref = from_flax(jax.device_get(jstate.params),
                        jax.device_get(jstate.batch_stats))

    trainable = freeze.apply_freeze(tmodel, labels)
    state = TrainState(tmodel, build_optimizer(
        trainable, "sgd", build_lr_schedule(0.01, 100)),
        UncertaintyState.init())
    step = make_train_step(lcfg, torch.from_numpy(rois),
                           torch.from_numpy(rois_3d),
                           torch.from_numpy(means), torch.from_numpy(stds),
                           train_bn=train_bn,
                           frozen_stats=sorted(pinned_t) if train_bn else ())
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    batch = {"images": torch.from_numpy(x).permute(0, 3, 1, 2),
             **{k: torch.from_numpy(v) for k, v in gt.items()}}
    for _ in range(2):
        step(state, batch)
    after = tmodel.state_dict()
    stat_keys = set(mask)
    for k in frozen_t | (stat_keys if not train_bn else pinned_t):
        assert torch.equal(after[k], before[k]), f"{k} must stay unchanged"
    moved = [k for k in labels if k not in frozen_t
             and not torch.equal(after[k], before[k])]
    assert moved, "no trainable parameter moved"
    if train_bn:
        assert any(not torch.equal(after[k], before[k])
                   for k in stat_keys - pinned_t)
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = (after[k] - r).abs().max().item()
        assert err <= PARAM_REL * r.abs().max().item() + 1e-12, (k, err)


# ---------------------------------------------------------------------------
# Adam and Adamax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["adam", "adamax"])
@pytest.mark.parametrize("batch_skip", [1, 2])
def test_adam_solvers_match_optax(solver, batch_skip):
    """Three updates (3 * batch_skip micro-steps), with gradients large
    enough for the clip to bite, against the JAX package's optax chain."""
    rs = np.random.default_rng(20 + batch_skip)
    shapes = {"w": (5, 3), "b": (3,), "k": (2, 2, 4)}
    params = {k: rs.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    sched = (0.004, 100)
    tx = jax_optimizer(solver, jax_schedule(*sched), weight_decay=0.0005,
                       clip_value=1.0, batch_skip=batch_skip)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in params.items()}
    opt = build_optimizer(t_params.values(), solver,
                          build_lr_schedule(*sched), weight_decay=0.0005,
                          clip_value=1.0, batch_skip=batch_skip)
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
    # the state round-trips, and refuses another solver or parameter list
    fresh = build_optimizer(t_params.values(), solver, 0.1,
                            batch_skip=batch_skip)
    fresh.load_state_dict(opt.state_dict())
    assert fresh.count == 3 and all(torch.equal(a, b)
                                    for a, b in zip(fresh.mu, opt.mu))
    with pytest.raises(ValueError, match="solver"):
        build_optimizer(t_params.values(), "sgd", 0.1).load_state_dict(
            opt.state_dict())
    with pytest.raises(ValueError, match="parameter list"):
        build_optimizer(list(t_params.values())[:2], solver, 0.1,
                        batch_skip=batch_skip).load_state_dict(
            opt.state_dict())


# ---------------------------------------------------------------------------
# the stats line and metrics.csv
# ---------------------------------------------------------------------------

def test_stat_tracker_and_metrics_csv_match_jax(tmp_path, monkeypatch):
    clock = iter([1000.0, 1012.5, 1031.25, 1040.0])
    now = [0.0]

    def fake_time():
        return now[0]

    monkeypatch.setattr(stats.time, "time", fake_time)
    monkeypatch.setattr(jax_stats.time, "time", fake_time)
    now[0] = next(clock)
    ours = stats.StatTracker(1000, display=2, start_iter=10)
    theirs = jax_stats.StatTracker(1000, display=2, start_iter=10)
    rs = np.random.default_rng(5)
    windows = [("a", "total", "fg_num", "host_wait")] * 2 + \
        [("a", "total", "new_term", "host_wait")]
    csv_t = stats.MetricsCSV(str(tmp_path / "t.csv"))
    csv_j = jax_stats.MetricsCSV(str(tmp_path / "j.csv"))
    for wi, keys in enumerate(windows):
        for _ in range(2):
            vals = {k: np.float32(rs.normal() * 10) for k in keys}
            ours.update({k: (float(v) if k == "host_wait"
                             else torch.tensor(v)) for k, v in vals.items()})
            theirs.update({k: (float(v) if k == "host_wait"
                               else jnp.asarray(v)) for k, v in vals.items()})
        now[0] = next(clock)
        it = 12 + 2 * wi
        line_t, means_t = ours.log_line_and_means(it, lr=0.0031234567)
        line_j, means_j = theirs.log_line_and_means(it, lr=0.0031234567)
        assert line_t == line_j
        assert means_t == means_j
        if wi == 2:   # a new run's file with another stat set
            csv_t = stats.MetricsCSV(str(tmp_path / "t.csv"))
            csv_j = jax_stats.MetricsCSV(str(tmp_path / "j.csv"))
        csv_t.append(it, means_t)
        csv_j.append(it, means_j)
        ours.reset()
        theirs.reset()
    assert "eta: " in line_t and "new_term" in line_t
    for suffix in ("", ".1"):
        with open(tmp_path / f"t.csv{suffix}") as f, \
                open(tmp_path / f"j.csv{suffix}") as g:
            assert f.read() == g.read()
    model = RPN3D(config.load_config("tiny_synthetic").rpn_config(6))
    lines = stats.param_summary(model)
    assert len(lines) == len(list(model.parameters()))
    assert lines[0].startswith("backbone.conv0.weight: shape=(")
    assert set(stats.live_buffer_stats()) == {"bytes", "peak_bytes"}


# ---------------------------------------------------------------------------
# checkpoints and the warm start across configs
# ---------------------------------------------------------------------------

def _tiny_rpn(accept, seed):
    cfg = dataclasses.replace(config.load_config("tiny_synthetic"),
                              predict_acceptance_prob=accept)
    model = RPN3D(cfg.rpn_config(6))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def test_warm_start_from_warmup_matches_jax(tmp_path, caplog):
    """A warmup snapshot (no acceptance branch) into the groomed model: the
    tensors left fresh are JAX's (``test_cross_config_warm_start_partial_
    restore``'s case), the rest copied, each case logged; the optimizer
    state of another parameter list is skipped."""
    base = dataclasses.replace(
        jax_config.load_config("tiny_synthetic").rpn_config(6),
        predict_acceptance_prob=False)
    tx = jax_optimizer("sgd", jax_schedule(0.004, 100))
    warm = create_train_state(JaxRPN3D(base), (1, 64, 128, 3), tx,
                              rng=jax.random.PRNGKey(1))
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), warm, step=800)
    groomed = create_train_state(
        JaxRPN3D(dataclasses.replace(base, predict_acceptance_prob=True)),
        (1, 64, 128, 3), tx, rng=jax.random.PRNGKey(2))
    restored = jax_checkpoint.restore_checkpoint(
        str(tmp_path / "jax"), groomed, 800, restore_optimizer=False)
    g_params = jax.device_get(groomed.params)
    r_params = jax.device_get(restored.params)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(g_params)[0])
    fresh_paths = {"/".join(str(getattr(k, "key", k)) for k in path)
                   for path, v in jax.tree_util.tree_flatten_with_path(
                       r_params)[0]
                   if "/".join(str(getattr(k, "key", k)) for k in path)
                   .split("/")[0] not in warm.params}
    assert fresh_paths and all(np.array_equal(
        np.asarray(v), np.asarray(flat_g[p])) for p, v in
        jax.tree_util.tree_flatten_with_path(r_params)[0]
        if "/".join(str(getattr(k, "key", k)) for k in p) in fresh_paths)
    fresh_j = _as_torch_keys(r_params, jax.device_get(restored.batch_stats),
                             fresh_paths)

    run = str(tmp_path / "warmup")
    w = _tiny_rpn(False, 1)
    w_opt = build_optimizer(w.parameters(), "sgd", 0.1)
    checkpoint.save_checkpoint(run, w, w_opt, step=800,
                               un_state=UncertaintyState(
                                   torch.tensor(0.25),
                                   torch.tensor(7, dtype=torch.int32)))
    g = _tiny_rpn(True, 2)
    fresh_vals = {k: v.clone() for k, v in g.state_dict().items()}
    state = TrainState(g, build_optimizer(g.parameters(), "sgd", 0.1),
                       UncertaintyState.init())
    with caplog.at_level(logging.WARNING):
        report = checkpoint.restore_train_state(run, state)
    assert set(report["fresh"]) == fresh_j == {"accept_out.weight",
                                               "accept_out.bias"}
    assert report["mismatched"] == [] and report["dropped"] == []
    assert report["optimizer"] == "fresh" and state.step == 800
    assert float(state.un_state.lam) == 0.25 and int(state.un_state.n) == 7
    got = g.state_dict()
    for k, v in got.items():
        want = fresh_vals[k] if k in fresh_j else w.state_dict()[k]
        assert torch.equal(v, want), k
    text = caplog.text
    assert "key-intersection" in text and "fresh init" in text
    assert "the optimizer starts fresh" in text

    # the reverse: the groomed snapshot into the warmup model drops the
    # branch; a head of another width keeps its init
    checkpoint.save_checkpoint(str(tmp_path / "g"), g, step=1)
    w2 = _tiny_rpn(False, 3)
    report = checkpoint.load_weights(
        w2, torch.load(checkpoint.checkpoint_path(str(tmp_path / "g"), 1),
                       weights_only=True)["model"])
    assert set(report["dropped"]) == {"accept_out.weight", "accept_out.bias"}
    wide = RPN3D(config.load_config("tiny_synthetic").rpn_config(8))
    report = checkpoint.load_weights(wide, g.state_dict())
    assert set(report["mismatched"]) == {"head.weight", "head.bias",
                                         "accept_out.weight",
                                         "accept_out.bias"}


def test_checkpoint_max_keep_and_un_state(tmp_path):
    run = str(tmp_path / "run")
    model = _tiny_rpn(True, 0)
    opt = build_optimizer(model.parameters(), "adam", 0.1)
    for step in (5, 10, 15, 20):
        checkpoint.save_checkpoint(run, model, opt, step=step, max_keep=2)
    assert sorted(os.listdir(os.path.join(run, "weights"))) == \
        ["checkpoint_15.pt", "checkpoint_20.pt"]
    state = TrainState(_tiny_rpn(True, 1), build_optimizer(
        model.parameters(), "adam", 0.1), UncertaintyState.init())
    report = checkpoint.restore_train_state(run, state)
    assert report["optimizer"] == "restored" and state.step == 20
    assert float(state.un_state.lam) == 0.0      # saved without one


# ---------------------------------------------------------------------------
# three steps of the loop against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    data = tmp_path_factory.mktemp("data")
    root = str(data / "kitti_split1")
    make_synthetic_kitti(root, "training", 10, im_h=96, im_w=320, seed=6,
                         classes=CLASSES)
    make_synthetic_kitti(root, "validation", 3, im_h=96, im_w=320, seed=7,
                         classes=CLASSES)
    return str(data)


def _jax_loop(jcfg, root, variables, rois, rois_3d, means, stds, dtype,
              steps=3):
    """``steps`` steps of JAX's loop in ``dtype``: its TrainLoader (seed
    ``cfg.rng_seed``) -> fuse_preprocess -> make_train_step, from
    ``variables``; returns each step's (state_dict-named tensors, stats)."""
    def cast(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dtype) if np.asarray(a).dtype.kind == "f"
            else jnp.asarray(a), tree)

    rpn = jcfg.rpn_config(variables["n_anchors"])
    rpn = dataclasses.replace(rpn, backbone=dataclasses.replace(
        rpn.backbone, dtype=dtype))
    sched = jax_schedule(jcfg.lr, jcfg.max_iter, jcfg.lr_policy,
                         jcfg.lr * jcfg.lr_target_factor, jcfg.lr_steps,
                         warmup_iters=jcfg.warmup_iters)
    tx = jax_optimizer(jcfg.solver_type, sched, jcfg.momentum,
                       jcfg.weight_decay, jcfg.grad_clip_value,
                       jcfg.batch_skip)
    jmodel = JaxRPN3D(rpn)
    state = create_train_state(jmodel, (1, 64, 64, 3), tx)
    params = cast(variables["params"])
    state = state.replace(params=params,
                          batch_stats=cast(variables["batch_stats"]),
                          opt_state=tx.init(params),
                          un_state=cast(state.un_state))
    step = jax.jit(jax_fuse(
        jax_make_train_step(jcfg.loss_config(), cast(rois), cast(rois_3d),
                            cast(means), cast(stds)),
        cast(np.asarray(jcfg.image_means, np.float32)),
        cast(np.asarray(jcfg.image_stds, np.float32)),
        target_h=jcfg.crop_size[0], crop_w=jcfg.crop_size[1],
        distort_prob=jcfg.distort_prob, rng_seed=jcfg.rng_seed))
    loader = JaxTrainLoader(jax_build_imdb(root, "training"), jcfg,
                            seed=jcfg.rng_seed, prefetch=1)
    out = []
    try:
        for _ in range(steps):
            hb = next(loader)
            state, st = step(state, cast(dict(
                images_u8=hb["images_u8"], mirror=hb["mirror"],
                **hb["gt"]._asdict())))
            np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
            out.append((from_flax(np_tree(state.params),
                                  np_tree(state.batch_stats)),
                        {k: float(v) for k, v in st.items()}))
    finally:
        loader.close()
    return out


def test_three_loop_steps_match_jax(tree):
    """tiny_synthetic from JAX's initial weights (``from_flax``) and the
    same loader seed: the port's TrainLoader -> train_torch's host tensors
    -> its fused step, against JAX's TrainLoader -> fuse_preprocess ->
    make_train_step, three steps, both in f64 (frames preprocessed in f32).

    Not in f32: from this random init on these frames, 2 of the 122880
    ``prop_feats`` pre-activations of the first batch lie within 1e-5 of
    zero, where f32 convolutions summed in other orders can put a value on
    the other side of the ReLU; the gradient then changes by that
    position's whole contribution (1e-3 of ``prop_feats``' gradient, 5% of
    the stem BatchNorm scale's cancelling sum), while JAX's own f32 and f64
    steps happen to agree.  In f64 the rounding is 1e-9 of that margin."""
    root = os.path.join(tree, "kitti_split1")
    tcfg = config.load_config("tiny_synthetic")
    jcfg = jax_config.load_config("tiny_synthetic")
    timdb = build_imdb(root, "training")
    anchors, means, stds = prepare_anchors(tcfg, timdb, device="cpu")
    script = _train_torch()
    run = script.build_training(tcfg, anchors, means, stds, "cpu",
                                param_dtype=torch.float64)

    init = create_train_state(JaxRPN3D(jcfg.rpn_config(anchors.shape[0])),
                              (1, 64, 64, 3), optax.sgd(0.1),
                              rng=jax.random.PRNGKey(jcfg.rng_seed))
    variables = {"params": jax.device_get(init.params),
                 "batch_stats": jax.device_get(init.batch_stats),
                 "n_anchors": anchors.shape[0]}
    run.model.load_state_dict(from_flax(variables["params"],
                                        variables["batch_stats"]))
    with jax.enable_x64(True):
        ref = _jax_loop(jcfg, root, variables, run.rois, run.rois_3d,
                        means.astype(np.float32), stds.astype(np.float32),
                        jnp.float64)

    tloader = TrainLoader(timdb, tcfg, seed=tcfg.rng_seed, prefetch=1)
    try:
        batches = itertools.islice(script.host_tensors(tloader, pin=False),
                                   3)
        for step, ((_, tensors), (params, jstats)) in enumerate(
                zip(batches, ref)):
            tstats = run.step(run.state, script.raw_batch(tensors))
            assert float(tstats["fg_num"]) == jstats["fg_num"] > 0
            np.testing.assert_allclose(float(tstats["total"]),
                                       jstats["total"], rtol=1e-5)
            got = run.model.state_dict()
            for k, r in params.items():
                if k.endswith("num_batches_tracked"):
                    continue
                err = (got[k] - r).abs().max().item()
                assert err <= PARAM_REL * r.abs().max().item(), \
                    f"step {step}: {k} off by {err:.3e}"
    finally:
        tloader.close()
    assert run.state.step == 3


# ---------------------------------------------------------------------------
# the entry point, with JAX unimportable
# ---------------------------------------------------------------------------

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


def _train(*args):
    return subprocess.run(
        [sys.executable, "-c", _RUNNER,
         os.path.join(ROOT, "scripts", "train_torch.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))


WARMUP = ("name=tiny_warmup", "predict_acceptance_prob=False",
          "use_nms_in_loss=False", "after_nms_lambda=0.0",
          "use_acceptance_prob_for_nms=False",
          "use_acceptance_prob_in_regression_loss=False",
          "weigh_acceptance_prob_regularization=False")


def test_train_torch_script_on_the_cpu(tree, tmp_path):
    """A tiny two-stage recipe end to end.  Stage 1 (tiny_synthetic as a
    warmup: no acceptance branch, no NMS in the loss): checkpoint, metrics,
    log, a txt file per val frame; run again, it auto-resumes with nothing
    to train.  Stage 2 (tiny_synthetic with GrooMeD-NMS in the loss) warm-
    starts from stage 1 and copies its statistics.  Each run a subprocess
    with JAX and the JAX package unimportable."""
    out = str(tmp_path / "out")
    stage1 = ["--config", "tiny_synthetic", "--data-root", tree, "--output",
              out, "--device", "cpu",
              *itertools.chain(*(("--set", s) for s in WARMUP))]
    first = _train(*stage1)
    assert first.returncode == 0, first.stderr[-3000:]
    run = os.path.join(out, "tiny_warmup")
    assert os.listdir(os.path.join(run, "weights")) == ["checkpoint_4.pt"]
    txts = sorted(os.listdir(os.path.join(run, "results", "results_4",
                                          "data")))
    assert txts == [f"{i:06d}.txt" for i in range(3)]
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0].startswith("iter,") and "host_wait" in rows[0]
    assert [r.split(",")[0] for r in rows[1:]] == ["2", "4"]
    with open(os.path.join(run, "train.log")) as f:
        log_text = f.read()
    assert "iter: 4, " in log_text and "checkpoint -> " in log_text
    assert "car detection AP|R40" in log_text
    assert config.ExperimentConfig.from_json(
        os.path.join(run, "conf.json")) == config.apply_overrides(
            config.load_config("tiny_synthetic"), list(WARMUP))

    again = _train(*stage1)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "auto-resumed own checkpoint at iter 4" in again.stderr
    assert "nothing to train" in again.stderr

    stage2 = _train("--config", "tiny_synthetic", "--data-root", tree,
                    "--output", str(tmp_path / "out2"), "--device", "cpu",
                    "--set", f"pretrained={run!r}", "--set", "copy_stats=True",
                    "--set", "do_test=False", "--max-iter", "2")
    assert stage2.returncode == 0, stage2.stderr[-3000:]
    assert f"copy_stats: reusing anchors/statistics from {run}" \
        in stage2.stderr
    assert f"warm-started from {run} (2 tensors fresh, 0 of another shape, " \
        "0 dropped)" in stage2.stderr
    assert "accept_out.weight" in stage2.stderr
    assert "training done at iter 2" in stage2.stderr


def test_train_torch_refusals(tree, tmp_path):
    """No CUDA device without --device cpu is refused; photometric jitter
    (``distort_prob > 0``), ported, trains: finite stats and moved
    weights."""
    script = _train_torch()
    base = ["--data-root", tree, "--output", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            script.main(["--config", "tiny_synthetic", *base])
    summary = script.main(["--config", "tiny_synthetic", "--device", "cpu",
                           "--set", "distort_prob=0.5", "--set",
                           "do_test=False", "--set", "display=1",
                           "--max-iter", "2", *base])
    assert summary["steps"] == 2 and summary["step"] == 2
    run = os.path.join(str(tmp_path), "tiny_synthetic")
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = f.read().splitlines()
    col = rows[0].split(",").index("total")
    assert len(rows) == 3
    assert all(np.isfinite(float(r.split(",")[col])) for r in rows[1:])


UN_STAGE = ("name='tiny_un'", "model='rpn_3d_un'", "has_un=True",
            "bbox_un_dynamic=True", "predict_acceptance_prob=False",
            "use_nms_in_loss=False", "after_nms_lambda=0.0",
            "use_acceptance_prob_in_regression_loss=False",
            "copy_stats=True", "do_test=False", "display=1")


def test_train_torch_un_stage_on_the_cpu(tree, tmp_path, caplog):
    """The ``_un`` stage (``kitti_3d_uncertainty``'s recipe on the tiny
    model) through train_torch's ``main()``, warm-started from a warmup
    run: the tensors it keeps fresh are those of JAX's key-intersection
    rule (``_intersect_restore``: the head, one channel wider a row),
    logged; two steps train, with the ``un`` and ``conf`` stats in
    metrics.csv.

    JAX's own ``restore_checkpoint`` takes its strict path here (the trees
    have the same keys), and Orbax does not check shapes: it returns the
    warmup's narrower head, and the ``_un`` model's first apply raises
    ``ScopeParamShapeError``.  The test pins that too, so the port's rule
    is seen to be the one JAX intends."""
    base = dataclasses.replace(
        jax_config.load_config("tiny_synthetic").rpn_config(6),
        predict_acceptance_prob=False)
    tx = jax_optimizer("sgd", jax_schedule(0.004, 100))
    warm = create_train_state(JaxRPN3D(base), (1, 64, 128, 3), tx,
                              rng=jax.random.PRNGKey(1))
    un_model = JaxRPN3D(dataclasses.replace(base, predict_uncertainty=True))
    un = create_train_state(un_model, (1, 64, 128, 3), tx,
                            rng=jax.random.PRNGKey(2))
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), warm, step=2)
    strict = jax_checkpoint.restore_checkpoint(
        str(tmp_path / "jax"), un, 2, restore_optimizer=False)
    with pytest.raises(Exception, match="ScopeParamShapeError|shape"):
        un_model.apply({"params": strict.params,
                        "batch_stats": strict.batch_stats},
                       jnp.zeros((1, 64, 128, 3)), train=False)
    merged = jax_checkpoint._intersect_restore(
        jax.device_get(un.params), jax.device_get(warm.params), "params",
        logging.getLogger(__name__))
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in p): v
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    m, w = flat(merged), flat(jax.device_get(warm.params))
    fresh_paths = {p for p in m if p not in w or
                   np.shape(m[p]) != np.shape(w[p])}
    assert all(np.array_equal(m[p], w[p]) for p in m if p not in fresh_paths)
    fresh_j = _as_torch_keys(merged, jax.device_get(un.batch_stats),
                             fresh_paths)
    assert fresh_j == {"head.weight", "head.bias"}

    script = _train_torch()
    out = str(tmp_path / "out")
    common = ["--data-root", tree, "--output", out, "--device", "cpu",
              "--max-iter", "2"]
    script.main(["--config", "tiny_synthetic", *common,
                 *itertools.chain(*(("--set", s) for s in WARMUP
                                    + ("do_test=False",)))])
    warm_run = os.path.join(out, "tiny_warmup")
    with caplog.at_level(logging.WARNING):
        summary = script.main([
            "--config", "tiny_synthetic", *common,
            *itertools.chain(*(("--set", s) for s in UN_STAGE
                               + (f"pretrained={warm_run!r}",)))])
    rep = summary["restore"]
    assert set(rep["mismatched"]) == fresh_j
    assert rep["fresh"] == [] and rep["dropped"] == []
    assert "kept fresh due to shape mismatch" in caplog.text
    assert summary["steps"] == 2 and summary["step"] == 2
    with open(os.path.join(out, "tiny_un", "metrics.csv")) as f:
        rows = [r.split(",") for r in f.read().splitlines()]
    assert {"un", "conf"} <= set(rows[0]) and len(rows) == 3
    assert all(np.isfinite(float(v)) for row in rows[1:] for v in row)


def test_flagship_train_honours_batch_skip():
    """build_flagship_train(batch_skip=2): the first step only accumulates
    (no weight moves), the second applies the update."""
    from groomed_nms_torch.flagship import build_flagship_train
    from groomed_nms_torch.models.densenet import tiny_densenet_config

    step, state, batch = build_flagship_train(
        batch=2, height=64, width=128, src_hw=(48, 96), device="cpu",
        compute_dtype=None, backbone=tiny_densenet_config(), batch_skip=2)
    assert state.optimizer.batch_skip == 2
    weights = lambda: {k: v.clone() for k, v in
                       state.model.state_dict().items()
                       if k.endswith("weight")}
    w0 = weights()
    step(state, batch)
    assert all(torch.equal(v, w0[k]) for k, v in weights().items())
    assert state.optimizer.count == 0 and state.optimizer.mini_step == 1
    step(state, batch)
    assert state.optimizer.count == 1
    assert any(not torch.equal(v, w0[k]) for k, v in weights().items())
