"""The port's checkpoint format and the two ways weights reach it: a JAX
(Orbax) snapshot and the reference implementation's PyTorch ``state_dict``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu.config import load_config as jax_load_config
from groomed_nms_tpu.models import RPN3D as JaxRPN3D
from groomed_nms_tpu.training import (build_lr_schedule, build_optimizer,
                                      create_train_state)
from groomed_nms_tpu.training import save_checkpoint as jax_save_checkpoint
from groomed_nms_tpu.utils.torch_weights import \
    convert_rpn_checkpoint as jax_convert

from groomed_nms_torch.config import load_config
from groomed_nms_torch.models.rpn_3d import RPN3D
from groomed_nms_torch.training import checkpoint
from groomed_nms_torch.training.trainer import build_optimizer as \
    torch_build_optimizer
from groomed_nms_torch.utils.torch_weights import convert_rpn_checkpoint
from groomed_nms_torch.utils.weights import from_flax, init_weights
from test_torch_weights import _fake_torch_densenet
from torch_port_common import _perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_ANCHORS = 12
# forward outputs, port against JAX, f32: max |err| <= 1e-5 of max |ref|
FWD_REL = 1e-5


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_checkpoint", os.path.join(ROOT, "scripts",
                                         "torch_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_model(seed=0):
    model = RPN3D(load_config("tiny_synthetic").rpn_config(NUM_ANCHORS))
    return init_weights(model, torch.Generator().manual_seed(seed))


def _outputs_close(jout, tout):
    """The port's head outputs against JAX's, each within FWD_REL of its
    scale."""
    for name in ("cls", "bbox_2d", "bbox_3d", "accept_prob", "uncertainty"):
        ref, got = getattr(jout, name), getattr(tout, name)
        assert (ref is None) == (got is None), name
        if ref is None:
            continue
        ref, got = np.asarray(ref), got.detach().numpy()
        assert got.shape == ref.shape, name
        assert np.abs(got - ref).max() <= FWD_REL * np.abs(ref).max(), name


def _forward_both(jmodel, variables, tmodel, seed=0):
    x = np.random.default_rng(seed).normal(size=(2, 64, 128, 3)).astype(
        np.float32)
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        tout = tmodel.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return jout, tout


# -- the format ---------------------------------------------------------------

def test_save_restore_latest_round_trip(tmp_path):
    """Steps 0 and 20: latest is 20, --restore 0 restores step 0, the
    optimizer restores only when asked, and the JAX package's Orbax
    directories beside the files are not listed."""
    run = str(tmp_path / "run")
    assert checkpoint.latest_checkpoint(run) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(run, _tiny_model())
    m0, m20 = _tiny_model(0), _tiny_model(1)
    opt = torch_build_optimizer(m20.parameters(), lr_schedule=0.1)
    for p in m20.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    checkpoint.save_checkpoint(run, m0, step=0)
    path = checkpoint.save_checkpoint(run, m20, opt, step=20)
    assert path.endswith(os.path.join("weights", "checkpoint_20.pt"))
    os.makedirs(os.path.join(run, "weights", "checkpoint_99"))   # Orbax's
    assert checkpoint.latest_checkpoint(run) == 20

    model = _tiny_model(5)
    assert checkpoint.restore_checkpoint(run, model, step=0) == 0
    for k, v in m0.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    opt2 = torch_build_optimizer(model.parameters(), lr_schedule=0.1)
    assert checkpoint.restore_checkpoint(run, model, opt2,
                                         restore_optimizer=False) == 20
    assert opt2.count == 0
    assert all(not t.any() for t in opt2.trace)
    assert checkpoint.restore_checkpoint(run, model, opt2) == 20
    assert opt2.count == 1
    for a, b in zip(opt2.trace, opt.trace):
        assert torch.equal(a, b)
    for k, v in m20.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_from_jax_reproduces_the_jax_forward(tmp_path):
    """An Orbax snapshot of a JAX tiny train state (perturbed BatchNorm),
    converted by ``scripts/torch_checkpoint.py from-jax`` and restored:
    the port's forward equals JAX's."""
    jcfg = jax_load_config("tiny_synthetic")
    jmodel = JaxRPN3D(jcfg.rpn_config(NUM_ANCHORS))
    tx = build_optimizer(jcfg.solver_type, build_lr_schedule(jcfg.lr, 10))
    state = create_train_state(jmodel, (1, 64, 64, 3), tx,
                               rng=jax.random.PRNGKey(3))
    rs = np.random.default_rng(3)
    state = state.replace(params=_perturb(state.params, rs),
                          batch_stats=_perturb(state.batch_stats, rs))
    out_root = str(tmp_path / "output")
    run = os.path.join(out_root, "tiny_synthetic")
    jax_save_checkpoint(run, state, step=7)
    path = _script().main(["from-jax", "--config", "tiny_synthetic",
                           "--output", out_root, "--num-anchors",
                           str(NUM_ANCHORS)])
    assert path == checkpoint.checkpoint_path(run, 7)
    model = _tiny_model(9)
    assert checkpoint.restore_checkpoint(run, model) == 7
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    _outputs_close(*_forward_both(jmodel, variables, model))


def test_from_jax_converts_the_video_model(tmp_path):
    """A JAX ``VideoRPN3D`` snapshot of a ``kalman`` config (uncertainty and
    velocity channels, the pose branch), converted by ``from-jax``: the
    port's ``VideoRPN3D`` restores every tensor and its frame outputs and
    poses equal JAX's on a 2-frame clip."""
    from groomed_nms_tpu.models.video import VideoConfig as JaxVideoConfig
    from groomed_nms_tpu.models.video import VideoRPN3D as JaxVideoRPN3D

    from groomed_nms_torch.models.video import VideoConfig, VideoRPN3D

    jcfg = jax_load_config("tiny_video_synthetic")
    jmodel = JaxVideoRPN3D(JaxVideoConfig(rpn=jcfg.rpn_config(NUM_ANCHORS)))
    tx = build_optimizer(jcfg.solver_type, build_lr_schedule(jcfg.lr, 10))
    state = create_train_state(jmodel, (1, 2, 64, 64, 3), tx,
                               rng=jax.random.PRNGKey(4))
    rs = np.random.default_rng(4)
    state = state.replace(params=_perturb(state.params, rs),
                          batch_stats=_perturb(state.batch_stats, rs))
    out_root = str(tmp_path / "output")
    run = os.path.join(out_root, "tiny_video_synthetic")
    jax_save_checkpoint(run, state, step=5)
    _script().main(["from-jax", "--config", "tiny_video_synthetic",
                    "--output", out_root, "--num-anchors", str(NUM_ANCHORS)])
    cfg = load_config("tiny_video_synthetic")
    model = VideoRPN3D(VideoConfig(rpn=cfg.rpn_config(NUM_ANCHORS)))
    sd = torch.load(checkpoint.checkpoint_path(run, 5),
                    weights_only=True)["model"]
    assert sorted(sd) == sorted(model.state_dict())
    assert checkpoint.restore_checkpoint(run, model) == 5
    x = np.random.default_rng(5).normal(size=(1, 2, 64, 128, 3)).astype(
        np.float32)
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(x))
    with torch.no_grad():
        tout = model.eval()(torch.from_numpy(x).permute(0, 1, 4, 2, 3))
    _outputs_close(jout.frame_outputs, tout.frame_outputs)
    assert tout.frame_outputs.bbox_3d.shape[-1] == 11
    np.testing.assert_allclose(tout.poses.numpy(), jout.poses, atol=1e-4)


# -- the reference's .pth -----------------------------------------------------

def _reference_state_dict(rs, a, c, prop, accept, un):
    """A reference-layout RPN state dict for the tiny backbone (numpy):
    torchvision-style features under ``base.``, prop_feats, 14 head convs
    (``cls`` class-major), optionally ``bbox_un`` and the acceptance
    branch; convolutions scaled by 1/sqrt(fan_in)."""
    feats, ch = _fake_torch_densenet(rs, growth=8, blocks=(2, 2, 2, 2),
                                     stem=16)
    sd = {"base." + k: (v / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
          if v.ndim == 4 else v for k, v in feats.items()}

    def conv(name, n_out, n_in, k=1):
        sd[name + ".weight"] = (rs.normal(size=(n_out, n_in, k, k))
                                / np.sqrt(n_in * k * k)).astype(np.float32)
        sd[name + ".bias"] = rs.normal(0, 0.1, n_out).astype(np.float32)

    conv("prop_feats.0", prop, ch, 3)
    conv("cls", c * a, prop)
    for f in ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "bbox_x3d", "bbox_y3d",
              "bbox_z3d", "bbox_w3d", "bbox_h3d", "bbox_l3d", "bbox_alpha",
              "bbox_axis", "bbox_head") + (("bbox_un",) if un else ()):
        conv(f, a, prop)
    if accept:
        conv("acceptance_prob.layer_0", a, prop)
    return sd


@pytest.mark.parametrize("accept", [False, True])
@pytest.mark.parametrize("un", [False, True])
def test_convert_rpn_checkpoint_matches_jax_through_from_flax(accept, un):
    rs = np.random.default_rng(int(accept) * 2 + int(un))
    sd = _reference_state_dict(rs, 3, 4, 8, accept, un)
    sd = {("module." + k if i % 2 else k): v
          for i, (k, v) in enumerate(sd.items())}       # DataParallel names
    ours = convert_rpn_checkpoint(sd, num_classes=4, num_anchors=3,
                                  predict_acceptance_prob=accept)
    theirs_v = jax_convert(sd, num_classes=4, num_anchors=3,
                           predict_acceptance_prob=accept)
    theirs = from_flax(theirs_v["params"], theirs_v["batch_stats"])
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k


def test_convert_rpn_checkpoint_refuses_an_uncertainty_mismatch():
    rs = np.random.default_rng(5)
    for un in (False, True):
        sd = _reference_state_dict(rs, 3, 4, 8, False, un)
        with pytest.raises(ValueError, match="bbox_un"):
            convert_rpn_checkpoint(sd, num_classes=4, num_anchors=3,
                                   predict_uncertainty=not un)


def test_from_pth_reproduces_the_jax_forward(tmp_path):
    """A synthetic reference ``.pth`` through ``scripts/torch_checkpoint.py
    from-pth`` into the port's format: the restored port model's forward
    equals the JAX model's on JAX's own conversion of the same file."""
    cfg = load_config("tiny_synthetic")
    sd = _reference_state_dict(np.random.default_rng(6), NUM_ANCHORS,
                               cfg.num_classes, 512, True, False)
    pth = str(tmp_path / "model_50000_pkl")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, pth)
    out_root = str(tmp_path / "output")
    _script().main(["from-pth", "--pth", pth, "--config", "tiny_synthetic",
                    "--num-anchors", str(NUM_ANCHORS), "--output", out_root])
    model = _tiny_model(9)
    run = os.path.join(out_root, "tiny_synthetic")
    assert checkpoint.restore_checkpoint(run, model, step=0) == 0
    jcfg = jax_load_config("tiny_synthetic")
    variables = jax_convert(sd, num_classes=cfg.num_classes,
                            num_anchors=NUM_ANCHORS,
                            predict_acceptance_prob=True)
    _outputs_close(*_forward_both(JaxRPN3D(jcfg.rpn_config(NUM_ANCHORS)),
                                  variables, model))
