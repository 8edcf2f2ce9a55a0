"""AOT export and serving of the video model, the PyTorch port against JAX,
on the CPU.

One set of flax variables drives a tiny ``VideoRPN3D`` (uncertainty
channel, T 24, M 16, 3 frames) in both packages, in f64: JAX's
``build_video_serving_fn`` jitted under ``jax.enable_x64`` with the trunk
and the variables in f64, the port's exported with ``torch.export`` from
the model in f64, saved and loaded back.  The tracker has discrete points
(thresholds, ``z > 1``), so it runs in f64 on both sides: ``valid``,
``ids`` and ``next_id`` identical.  Its numbers are held at rtol 1e-5,
atol 1e-5 and not at ``test_torch_video.py``'s 1e-8: the preprocess and
PoseNet are f32 in both packages (JAX's by design), and their roundings
(~3e-7 of the input, ~1e-7 of a pose) reach the tracks as ~5e-6 of their
size.  The loaded artifact against its live closure: the same program,
every field identical.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu.export import \
    build_video_serving_fn as jax_build_video_serving_fn
from groomed_nms_tpu.models import video as jv
from groomed_nms_tpu.models.densenet import tiny_densenet_config as jax_tiny
from groomed_nms_tpu.models.rpn_3d import RPNConfig as JaxRPNConfig

from groomed_nms_torch.anchors import generate_anchor_templates
from groomed_nms_torch.data.png import write_png
from groomed_nms_torch.export import (build_video_serving_fn,
                                      export_video_serving, load_serving)
from groomed_nms_torch.models import video as tv
from groomed_nms_torch.models.densenet import tiny_densenet_config
from groomed_nms_torch.models.rpn_3d import RPNConfig
from groomed_nms_torch.utils.weights import from_flax
from test_torch_export import IMAGE_MEANS, IMAGE_STDS, _meta, _op_nodes
from test_torch_video import _RUNNER, FIELDS, P2, _rois
from torch_port_common import TINY, _perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, SRC_HW, CROP_HW = 3, (48, 160), (64, 128)
SMALL = dict(max_measurements=16, max_tracks=24, score_thres=0.25)
# against JAX: the preprocess (f32 in both: JAX casts the frames to f32)
# and PoseNet (f32 in both) round apart by a few f32 steps; the rest runs in
# f64, so the tracks' numbers agree to ~5e-6 of their size
JAX_RTOL, JAX_ATOL = 1e-5, 1e-5


def _clip_inputs(rs):
    p2 = (P2 * [[0.125], [0.125], [1], [1]]).astype(np.float32)
    return (rs.integers(0, 256, (FRAMES, *SRC_HW, 3), dtype=np.uint8), p2,
            np.linalg.inv(p2).astype(np.float32),
            np.full((FRAMES,), CROP_HW[0] / SRC_HW[0], np.float32))


@pytest.fixture(scope="module")
def video():
    """JAX's jitted f64 closure, the port's live f64 closure, its artifact
    bytes and the loaded artifact, and one clip of inputs."""
    rs = np.random.default_rng(3)
    rpn = dict(TINY, num_anchors=4, predict_uncertainty=True)
    with jax.enable_x64(True):
        jcfg = jv.VideoConfig(rpn=JaxRPNConfig(
            **rpn, backbone=jax_tiny(jnp.float64)), **SMALL)
        jmodel = jv.VideoRPN3D(jcfg)
        variables = jax.jit(jmodel.init, static_argnames="train")(
            jax.random.PRNGKey(3), jnp.zeros((1, 2, *CROP_HW, 3)),
            train=False)
    variables = {k: _perturb(variables[k], rs)
                 for k in ("params", "batch_stats")}
    rois, rois_3d = _rois(rs, vel=False)
    consts = (rois, rois_3d, rs.normal(0, 0.1, 13).astype(np.float32),
              rs.uniform(0.5, 1.5, 13).astype(np.float32), IMAGE_MEANS,
              IMAGE_STDS)
    pose = (rs.normal(0, 0.1, 6), rs.uniform(0.5, 1.5, 6))
    shape = dict(target_h=CROP_HW[0], crop_w=CROP_HW[1], bf16_input=False)
    with jax.enable_x64(True):
        f64 = {k: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), v)
            for k, v in variables.items()}
        jserve = jax.jit(jax_build_video_serving_fn(
            jmodel, f64, *consts, jcfg, *pose, **shape))

    tcfg = tv.VideoConfig(rpn=RPNConfig(
        **rpn, backbone=tiny_densenet_config()), **SMALL)
    tmodel = tv.VideoRPN3D(tcfg)
    tmodel.load_state_dict(from_flax(variables["params"],
                                     variables["batch_stats"]))
    serve = build_video_serving_fn(tmodel.double(), *consts, tcfg, *pose,
                                   **shape)
    blob = export_video_serving(serve, n_frames=FRAMES, src_h=SRC_HW[0],
                                src_w=SRC_HW[1])
    return dict(jserve=jserve, serve=serve, blob=blob,
                loaded=load_serving(blob), inputs=_clip_inputs(rs))


def _torch(inputs):
    return [torch.from_numpy(np.asarray(x)) for x in inputs]


def test_video_artifact_matches_its_live_closure(video):
    args = _torch(video["inputs"])
    with torch.no_grad():
        want = video["serve"](*args)
    got = video["loaded"](*args)
    assert type(got).__name__ == "Tracks" and got.X.dtype == torch.float64
    for f in FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=0, msg=f)
    assert want.valid.sum() >= 3
    assert _op_nodes(video["loaded"].program) == {"fused_head_scores": 1,
                                                  "greedy_nms": 1}


def test_video_artifact_matches_jax_in_f64(video):
    """The loaded artifact against JAX's jitted closure on one clip."""
    with jax.enable_x64(True):
        want = video["jserve"](*video["inputs"])
    got = video["loaded"](*_torch(video["inputs"]))
    assert int(np.asarray(want.valid).sum()) >= 3
    for f in FIELDS:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f in ("valid", "ids", "next_id"):
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            np.testing.assert_allclose(g, r, rtol=JAX_RTOL, atol=JAX_ATOL,
                                       err_msg=f)


def test_serve_script_serves_a_video_artifact(video, tmp_path):
    """``scripts/serve_torch.py --device cpu`` on the video artifact, JAX
    and Pillow unimportable: a clip of the trailing frames for each of 4
    PNGs (the first ones padded with the oldest), one track file each."""
    art = tmp_path / "video.pt2"
    art.write_bytes(video["blob"])
    _meta(art, device="cpu", frames=FRAMES, src_hw=list(SRC_HW),
          crop_size=list(CROP_HW), score_thres=0.0)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rs = np.random.default_rng(6)
    for i in range(4):
        write_png(str(img_dir / f"{i:06d}.png"),
                  rs.integers(0, 256, (*SRC_HW, 3), dtype=np.uint8))
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER,
         os.path.join(ROOT, "scripts", "serve_torch.py"), "--artifact",
         str(art), "--images", str(img_dir), "--out", str(tmp_path / "out"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / "out")) == [
        f"{i:06d}.txt" for i in range(4)]
    rows = (tmp_path / "out" / "000003.txt").read_text().splitlines()
    assert rows and all(len(r.split()) == 16 and r.startswith("Car ")
                        for r in rows)


def test_export_script_verifies_a_video_artifact(tmp_path):
    """``scripts/export_torch.py --video --device cpu --verify`` as a
    subprocess with JAX unimportable, for tiny_video_synthetic (T 128,
    M 64, 2 frames) from its anchors.npz alone: random weights, warned
    about, the artifact and its json with the clip length."""
    rs = np.random.default_rng(0)
    templates = generate_anchor_templates([16, 32], [0.5, 1.0], 16)
    priors = np.concatenate([templates, np.abs(rs.normal(size=(4, 8))) + 1],
                            1)
    priors[:, 4] = 20.0
    run = tmp_path / "out" / "tiny_video_synthetic"
    run.mkdir(parents=True)
    np.savez(run / "anchors.npz", anchors=priors, bbox_means=np.zeros(14),
             bbox_stds=np.ones(14))
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER,
         os.path.join(ROOT, "scripts", "export_torch.py"), "--config",
         "tiny_video_synthetic", "--output", str(tmp_path / "out"),
         "--video", "--src-h", "72", "--src-w", "240", "--device", "cpu",
         "--verify"], capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "using random weights" in proc.stderr
    assert "verify OK: the video artifact reproduces the live program" \
        in proc.stderr
    assert (run / "video_model.pt2").exists()
    meta = (run / "video_model.pt2.json").read_text()
    assert '"frames": 2' in meta and '"device": "cpu"' in meta
