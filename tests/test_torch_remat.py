"""Backbone rematerialisation (``backbone_remat``) of the port on the CPU.

Held to JAX: ``tests/test_training.py::test_backbone_remat_matches_
unrematerialized``'s inputs (``default_rng(0)`` normal ``(2, 32, 64, 3)``,
the tiny topology) and JAX's initial weights (``from_flax``), for each of
none, layer and epilogue: the value at rtol 1e-5, the gradients at rtol
2e-3 / atol 2e-5 and the batch statistics at rtol 1e-5 / atol 1e-6, JAX's
own tolerances for its remat against none.  Held to itself: with remat
against without, the value identical, each gradient within 1e-6 of its
tensor's largest magnitude, the running statistics and
``num_batches_tracked`` identical (a recomputation updates nothing).  And:
``backbone_remat`` refused as JAX refuses it; eval and ``no_grad`` run no
checkpoint; the pose stage's eval-mode trunk recomputes nothing;
``train_torch.build_training`` with ``--set backbone_remat=layer`` three
steps in f64 equal to the loop without it; two gloo ranks with remat equal
one process without it in f64 (``torch_parallel_cases``' rule, 1e-9 of a
tensor's max), with the extra all-reduces of a recomputed global
BatchNorm counted.
"""

import dataclasses
import importlib.util
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu import config as jax_config
from groomed_nms_tpu.models.densenet import DenseNetBackbone as JaxBackbone
from groomed_nms_tpu.models.densenet import tiny_densenet_config as jax_tiny

from groomed_nms_torch import config
from groomed_nms_torch.data.imdb import build_imdb
from groomed_nms_torch.data.pipeline import TrainLoader, prepare_anchors
from groomed_nms_torch.data.synthetic import make_synthetic_kitti
from groomed_nms_torch.models import densenet
from groomed_nms_torch.models.densenet import (DenseNetBackbone,
                                               tiny_densenet_config)
from groomed_nms_torch.parallel import spawn
from groomed_nms_torch.utils.weights import from_flax
from torch_parallel_cases import remat_ranks, single_process

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("none", "layer", "epilogue")
VALUE_RTOL, GRAD_RTOL, GRAD_ATOL, BS_RTOL, BS_ATOL = 1e-5, 2e-3, 2e-5, \
    1e-5, 1e-6
SELF_GRAD_REL, DP_PARAM_REL = 1e-6, 1e-9


def _x():
    return np.random.default_rng(0).normal(size=(2, 32, 64, 3)).astype(
        np.float32)


def _flags(mode):
    return config.with_remat(tiny_densenet_config(), mode)


def _jax_run(mode):
    """JAX's remat test for one mode: the initial variables, the value,
    the gradients and the batch statistics after the forward."""
    jcfg = jax_config.ExperimentConfig(backbone_tiny=True,
                                       backbone_remat=mode)
    net = JaxBackbone(jcfg.backbone_config())
    x = jnp.asarray(_x())
    vs = net.init(jax.random.PRNGKey(0), x, True)

    def loss(p):
        y, mut = net.apply({"params": p, "batch_stats": vs["batch_stats"]},
                           x, True, mutable=["batch_stats"])
        return jnp.mean(y * y), mut["batch_stats"]

    (val, bs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        vs["params"])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return np_tree(vs), float(val), np_tree(grads), np_tree(bs)


def _torch_run(mode, variables, dtype=torch.float32):
    """The port's backbone in train mode from ``variables``: the value,
    the gradients and the buffers after one forward and backward."""
    net = DenseNetBackbone(_flags(mode))
    net.load_state_dict(from_flax(variables["params"],
                                  variables["batch_stats"]))
    net = net.to(dtype).train()
    x = torch.from_numpy(_x()).permute(0, 3, 1, 2).to(dtype)
    y = net(x)
    val = (y * y).mean()
    val.backward()
    return (val.item(), {k: p.grad.clone() for k, p in
                         net.named_parameters()},
            {k: b.clone() for k, b in net.named_buffers()})


@pytest.fixture(scope="module")
def runs():
    """Each mode's JAX run and the port's from JAX's none-mode weights."""
    jax_runs = {m: _jax_run(m) for m in MODES}
    variables = jax_runs["none"][0]
    return dict(jax=jax_runs, variables=variables,
                torch={m: _torch_run(m, variables) for m in MODES})


@pytest.mark.parametrize("mode", MODES)
def test_remat_matches_jax(runs, mode):
    vs, jval, jgrads, jbs = runs["jax"][mode]
    # JAX's remat keeps the variable tree: the weights are the none run's
    for a, b in zip(jax.tree_util.tree_leaves(vs),
                    jax.tree_util.tree_leaves(runs["variables"])):
        np.testing.assert_array_equal(a, b)
    val, grads, buffers = runs["torch"][mode]
    np.testing.assert_allclose(val, jval, rtol=VALUE_RTOL)
    want = from_flax(jgrads)
    assert set(want) == set(grads)
    for k, g in want.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
    stats = from_flax({}, jbs)
    for k, s in stats.items():
        if k.endswith("num_batches_tracked"):
            assert buffers[k].item() == 1, k        # one update a step
            continue
        np.testing.assert_allclose(buffers[k].numpy(), s.numpy(),
                                   rtol=BS_RTOL, atol=BS_ATOL, err_msg=k)


@pytest.mark.parametrize("mode", MODES[1:])
def test_remat_matches_the_port_without_it(runs, mode):
    val0, grads0, bufs0 = runs["torch"]["none"]
    val, grads, bufs = runs["torch"][mode]
    assert val == val0
    for k, g in grads0.items():
        err = (grads[k] - g).abs().max().item()
        assert err <= SELF_GRAD_REL * g.abs().max().item(), k
    for k, b in bufs0.items():
        assert torch.equal(bufs[k], b), k


@pytest.mark.parametrize("value", ["all", "layers ", 2, "Layer"])
def test_bad_backbone_remat_raises_as_jax(value):
    with pytest.raises(ValueError) as jerr:
        jax_config.ExperimentConfig(backbone_remat=value).backbone_config()
    with pytest.raises(ValueError) as terr:
        config.ExperimentConfig(backbone_remat=value).backbone_config()
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("value,flags", [
    (False, (False, False)), (None, (False, False)), ("none", (False, False)),
    ("", (False, False)), (True, (True, False)), ("layer", (True, False)),
    ("layers", (True, False)), ("epilogue", (False, True))])
def test_backbone_remat_maps_as_jax(value, flags):
    j = jax_config.ExperimentConfig(backbone_remat=value).backbone_config()
    t = config.ExperimentConfig(backbone_remat=value).backbone_config()
    assert (j.remat_layers, j.remat_epilogue) == flags
    assert (t.remat_layers, t.remat_epilogue) == flags


def _count_checkpoints(monkeypatch):
    calls = []
    real = densenet.checkpoint
    monkeypatch.setattr(densenet, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("mode", MODES[1:])
def test_remat_only_in_a_training_step(monkeypatch, mode):
    """Eval mode and ``no_grad`` run the plain layers (what export and
    serving trace); train mode with gradients checkpoints every layer."""
    calls = _count_checkpoints(monkeypatch)
    net = DenseNetBackbone(_flags(mode))
    x = torch.from_numpy(_x()).permute(0, 3, 1, 2)
    plain = DenseNetBackbone(tiny_densenet_config())
    plain.load_state_dict(net.state_dict())
    net.eval(), plain.eval()
    assert torch.equal(net(x), plain(x)) and not calls
    net.train()
    with torch.no_grad():
        net(x)
    assert not calls
    net(x)
    assert len(calls) == sum(tiny_densenet_config().block_layers)


def test_pose_stage_recomputes_nothing(monkeypatch):
    """The pose stage (``scripts/train_pose_torch.py``) trains
    ``pose_net`` with the trunk in eval mode: a remat config checkpoints
    no layer there, and the trunk's statistics stay as they were."""
    spec = importlib.util.spec_from_file_location(
        "train_pose_torch", os.path.join(ROOT, "scripts",
                                         "train_pose_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    from groomed_nms_torch.models.video import VideoConfig, VideoRPN3D

    cfg = dataclasses.replace(config.load_config("tiny_video_synthetic"),
                              backbone_remat="layer")
    model = VideoRPN3D(VideoConfig(rpn=cfg.rpn_config(4)))
    assert model.rpn.backbone.denseblock1_layer1.remat == "layer"
    calls = _count_checkpoints(monkeypatch)
    run = script.build_pose_training(cfg, model, np.zeros(6), np.ones(6),
                                     "cpu")
    stats0 = {k: v.clone() for k, v in run.model.state_dict().items()
              if "running" in k}
    rs = np.random.default_rng(0)
    h, w = cfg.crop_size
    raw = {"images_u8": torch.from_numpy(rs.integers(
               0, 256, (2, 2, h, w, 3), dtype=np.uint8)),
           "mirror": torch.zeros(2, dtype=torch.bool),
           "pose_tar": torch.from_numpy(rs.normal(size=(2, 6)).astype(
               np.float32))}
    run.step(run.state, raw)
    assert not calls
    sd = run.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in stats0.items())


def test_train_torch_with_remat_equals_without(tmp_path):
    """``--set backbone_remat=layer`` reaches ``build_training`` through the
    config: three loop steps of tiny_synthetic in f64 (frames preprocessed
    in f32) equal the same loop without it, parameters and statistics."""
    root = str(tmp_path / "kitti_split1")
    make_synthetic_kitti(root, "training", 4, im_h=96, im_w=320, seed=6,
                         classes=("Car", "Pedestrian", "Cyclist"))
    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "scripts", "train_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    base = config.load_config("tiny_synthetic")
    imdb = build_imdb(root, "training")
    anchors, means, stds = prepare_anchors(base, imdb, device="cpu")
    out = {}
    for remat in ([], ["backbone_remat=layer"]):
        cfg = config.apply_overrides(base, remat)
        run = script.build_training(cfg, anchors, means, stds, "cpu",
                                    param_dtype=torch.float64)
        loader = TrainLoader(imdb, cfg, seed=cfg.rng_seed, prefetch=1)
        try:
            stats = [run.step(run.state, script.raw_batch(t))
                     for _, t in itertools.islice(
                         script.host_tensors(loader, pin=False), 3)]
        finally:
            loader.close()
        out[bool(remat)] = (run.model, stats)
    assert out[True][0].backbone.denseblock1_layer1.remat == "layer"
    assert out[False][0].backbone.denseblock1_layer1.remat is None
    sd0, sd1 = out[False][0].state_dict(), out[True][0].state_dict()
    for k, v in sd0.items():
        assert torch.equal(sd1[k], v), k
    for s0, s1 in zip(out[False][1], out[True][1]):
        assert {k: float(v) for k, v in s0.items()} == \
            {k: float(v) for k, v in s1.items()}
    assert float(out[False][1][0]["fg_num"]) > 0


def test_two_ranks_with_remat_equal_one_process():
    """2 gloo ranks of the dryrun's GrooMeD step in f64 with remat (layer,
    epilogue) against one process without it; a recomputed global
    BatchNorm all-reduces once more in the backward pass of each of the 2
    steps."""
    ranks = spawn(remat_ranks, 2, MODES)
    ref = single_process(lambda modes, d: remat_ranks(d, modes),
                         ("none",))["none"]
    n_bn = sum(tiny_densenet_config().block_layers)    # dense layers
    for mode in MODES:
        r0, r1 = ranks[0][mode], ranks[1][mode]
        for k, v in r0["sd"].items():
            assert torch.equal(r1["sd"][k], v), f"{mode}: ranks differ at {k}"
        for k, v in ref["sd"].items():
            if not v.is_floating_point() or v.abs().max() == 0:
                assert torch.equal(r0["sd"][k], v), k
                continue
            err = ((r0["sd"][k] - v).abs().max() / v.abs().max()).item()
            assert err <= DP_PARAM_REL, f"{mode}: {k} off by {err:.3e}"
        extra = r0["all_reduces"] - ranks[0]["none"]["all_reduces"]
        assert extra == 2 * {"none": 0, "layer": 2 * n_bn,
                             "epilogue": n_bn}[mode], (mode, extra)
    assert ref["all_reduces"] == 0
