"""AOT export and serving, the PyTorch port against JAX, on the CPU.

One set of flax variables drives both packages (``torch_port_common``):
JAX's ``build_serving_fn`` jitted, and the port's ``build_serving_fn``
exported with ``torch.export``, saved to bytes and loaded back.  The
kernels run through their plain versions (the ops' CPU kernels).

Tolerances.  The loaded artifact against its live closure: the same
program, so ``valid`` identical and ``dets`` within 1e-6.  Against JAX, as
``test_torch_inference.py`` holds the slice: ``valid`` identical, ``dets``
within rtol 1e-4, atol 1e-3.  ``fit_image_to_plane`` against JAX's
(Pillow): ``r`` equal and every pixel equal (the port repeats Pillow's
fixed-point arithmetic).  KITTI rows of the two serve scripts: the same
files, rows and classes, every number within 1e-3 + 1e-4 |x|.
"""

import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from groomed_nms_tpu.config import load_config as jax_load_config
from groomed_nms_tpu.data.augment import fit_image_to_plane as jax_fit
from groomed_nms_tpu.export import build_serving_fn as jax_build_serving_fn
from groomed_nms_tpu.export import export_serving as jax_export_serving

from groomed_nms_torch.anchors import locate_anchors
from groomed_nms_torch.config import load_config
from groomed_nms_torch.data.augment import fit_image_to_plane
from groomed_nms_torch.data.png import write_png
from groomed_nms_torch.export import (build_serving_fn, export_serving,
                                      load_serving)
from groomed_nms_torch.ops import kernels
from test_scripts_e2e import _subprocess_env
from test_torch_eval import _run_dir, assert_same_rows, read_rows
from test_torch_video import _RUNNER
from torch_port_common import tiny_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SRC_HW, CROP_HW = 2, (48, 96), (64, 128)
IMAGE_MEANS = np.array([0.485, 0.456, 0.406])
IMAGE_STDS = np.array([0.229, 0.224, 0.225])
OPS = ("fused_head_scores", "greedy_nms", "fused_iou_prune", "group_leaders")
# the kernel ops each NMS puts in the artifact
PATH_OPS = {"greedy": {"fused_head_scores", "greedy_nms"},
            "groomed": {"fused_head_scores", "fused_iou_prune",
                        "group_leaders"}}


def _dcfgs(nms):
    """(JAX, port) DetectConfigs of the groomed_nms config at the tiny
    size; ``groomed`` serves GrooMeD-NMS with a keep threshold random
    weights reach."""
    small = dict(nms_topN_pre=64, nms_topN_post=8)
    if nms == "groomed":
        small.update(use_differentiable_nms=True, diff_nms_boxes=48,
                     diff_nms_valid_box_prob_threshold=0.05)
    return (dataclasses.replace(
        jax_load_config("groomed_nms").detect_config(), **small),
        dataclasses.replace(load_config("groomed_nms").detect_config(),
                            **small))


def _inputs(rs, batch=BATCH):
    p2 = np.tile(np.eye(4, dtype=np.float32)[None], (batch, 1, 1))
    p2[:, 0, 0] = p2[:, 1, 1] = 700.0
    p2[:, 0, 2], p2[:, 1, 2] = 60.0, 18.0
    return (rs.integers(0, 256, (batch, *SRC_HW, 3), dtype=np.uint8), p2,
            np.linalg.inv(p2),
            np.full((batch,), CROP_HW[0] / SRC_HW[0], np.float32))


@pytest.fixture(scope="module")
def tiny():
    """The tiny groomed_nms model in both packages, its constants, and one
    batch of inputs."""
    jmodel, variables, tmodel = tiny_models(seed=0,
                                            predict_acceptance_prob=True)
    rs = np.random.default_rng(0)
    templates = np.abs(rs.normal(size=(6, 4))).astype(np.float32)
    templates[:, 2:] += templates[:, :2] + 16.0
    priors = np.concatenate(
        [templates, np.abs(rs.normal(size=(6, 7))).astype(np.float32) + 1.0],
        axis=1)
    priors[:, 4] = 30.0
    rois = locate_anchors(priors, (CROP_HW[0] // 16, CROP_HW[1] // 16), 16)
    consts = (rois, priors[rois[:, 4].astype(np.int64), 4:],
              rs.normal(0, 0.1, 13).astype(np.float32),
              rs.uniform(0.5, 1.5, 13).astype(np.float32), IMAGE_MEANS,
              IMAGE_STDS)
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel,
                consts=consts, inputs=_inputs(rs))


@pytest.fixture(scope="module")
def served(tiny):
    """{nms: (live port closure, artifact bytes, loaded artifact)}."""
    out = {}
    for nms in PATH_OPS:
        serve = build_serving_fn(tiny["tmodel"], *tiny["consts"],
                                 _dcfgs(nms)[1], target_h=CROP_HW[0],
                                 crop_w=CROP_HW[1], bf16_input=False)
        blob = export_serving(serve, batch=BATCH, src_h=SRC_HW[0],
                              src_w=SRC_HW[1])
        out[nms] = (serve, blob, load_serving(blob))
    return out


def _torch(inputs):
    return [torch.from_numpy(np.asarray(x)) for x in inputs]


@pytest.mark.parametrize("nms", sorted(PATH_OPS))
def test_artifact_matches_its_live_closure(tiny, served, nms):
    serve, _, loaded = served[nms]
    args = _torch(tiny["inputs"])
    with torch.no_grad():
        want_d, want_v = serve(*args)
    got_d, got_v = loaded(*args)
    assert got_d.shape == (BATCH, 8, 17) and got_v.dtype == torch.bool
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0)
    assert want_v.sum() >= 4
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=1e-6)


@pytest.mark.parametrize("nms", sorted(PATH_OPS))
def test_artifact_matches_jax(tiny, served, nms):
    """The loaded artifact against JAX's jitted ``build_serving_fn`` on the
    same weights, constants and inputs."""
    jserve = jax.jit(jax_build_serving_fn(
        tiny["jmodel"], tiny["variables"], *tiny["consts"], _dcfgs(nms)[0],
        target_h=CROP_HW[0], crop_w=CROP_HW[1], bf16_input=False))
    jd, jv = (np.asarray(x) for x in jserve(*tiny["inputs"]))
    td, tv = (x.numpy() for x in served[nms][2](*_torch(tiny["inputs"])))
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() >= 4
    np.testing.assert_allclose(td[tv], jd[jv], rtol=1e-4, atol=1e-3)


def _op_nodes(program):
    counts = {}
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                if node.op == "call_function" and \
                        str(node.target).startswith("groomed_nms."):
                    name = str(node.target).split(".")[1]
                    counts[name] = counts.get(name, 0) + 1
    return counts


@pytest.mark.parametrize("nms", sorted(PATH_OPS))
def test_artifact_holds_each_kernel_of_its_path_once(served, nms):
    """Each kernel on the path is one opaque node of the loaded graph, and
    no other kernel op is there."""
    assert _op_nodes(served[nms][2].program) == \
        dict.fromkeys(PATH_OPS[nms], 1)


def test_bf16_artifact_matches_its_live_closure(tiny):
    """bf16 input and the model under bf16 autocast, staged out and
    loaded: the same rows as the live closure."""
    serve = build_serving_fn(tiny["tmodel"], *tiny["consts"],
                             _dcfgs("greedy")[1], target_h=CROP_HW[0],
                             crop_w=CROP_HW[1], bf16_input=True)
    loaded = load_serving(export_serving(serve, batch=BATCH,
                                         src_h=SRC_HW[0], src_w=SRC_HW[1]))
    args = _torch(tiny["inputs"])
    with torch.no_grad():
        want_d, want_v = serve(*args)
    got_d, got_v = loaded(*args)
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0)
    assert want_v.any()
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=1e-6)


def _op_args(name, rs):
    xy = rs.uniform(0, 40, (2, 24, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rs.uniform(4, 20, (2, 24, 2))], -1).astype(np.float32))
    valid = torch.from_numpy(rs.uniform(size=(2, 24)) < 0.8)
    if name == "fused_head_scores":
        return (torch.from_numpy(rs.normal(size=(2, 50, 18)).astype(
            np.float32)), torch.rand(2, 50), 4)
    if name == "greedy_nms":
        return boxes, torch.sort(torch.rand(2, 24), descending=True)[0], \
            0.4, 1.0
    if name == "fused_iou_prune":
        return boxes, valid, 0.4, 0.1, "sigmoidal", 0.0
    iou = kernels.fused_iou_prune_plain(boxes, valid)[0]
    return iou, valid, 0.4, 2.0


@pytest.mark.parametrize("name", OPS)
def test_custom_op_passes_opcheck(name):
    """The schema, the fake implementation against the CPU kernel, and the
    op under AOT dispatch with dynamic shapes."""
    op = getattr(torch.ops.groomed_nms, name).default
    torch.library.opcheck(op, _op_args(name, np.random.default_rng(5)))


def test_artifact_refuses_other_inputs_and_devices(served, tiny):
    _, blob, loaded = served["greedy"]
    imgs, p2, p2_inv, scale = _torch(tiny["inputs"])
    wide = torch.cat([imgs, imgs])                      # wrong batch
    with pytest.raises(ValueError, match="input 0"):
        loaded(wide, p2, p2_inv, scale)
    with pytest.raises(ValueError, match="input 3"):
        loaded(imgs, p2, p2_inv, scale.double())
    with pytest.raises(ValueError, match="4 inputs"):
        loaded(imgs, p2, p2_inv)
    with pytest.raises(ValueError, match="exported on cpu"):
        load_serving(blob, "cuda")


@pytest.mark.parametrize("hw,plane", [
    ((375, 1242), (300, 1000)),       # oversized: both sides shrink
    ((400, 1300), (375, 1242)),
    ((100, 500), (48, 96)),           # width-bound
    ((1000, 90), (48, 96)),           # height-bound
    ((30, 50), (48, 96)),             # undersized: padded only
    ((48, 96), (48, 96)),             # exact
])
def test_fit_image_to_plane_matches_pillow(hw, plane):
    img = np.random.default_rng(hw[0] + hw[1]).integers(
        0, 256, (*hw, 3), dtype=np.uint8)
    got, r = fit_image_to_plane(img, *plane)
    want, r_jax = jax_fit(img, *plane)
    assert r == r_jax and got.shape == (*plane, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _serve_dir(tmp_path, rs):
    """Three PNGs (undersized, exact, oversized: a ragged last batch and
    both fitting paths) with calibs."""
    img_dir, cal_dir = tmp_path / "images", tmp_path / "calib"
    img_dir.mkdir()
    cal_dir.mkdir()
    for i, hw in enumerate([(40, 90), SRC_HW, (60, 130)]):
        write_png(str(img_dir / f"{i:06d}.png"),
                  rs.integers(0, 256, (*hw, 3), dtype=np.uint8))
        (cal_dir / f"{i:06d}.txt").write_text(
            "P2: 300.0 0.0 48.0 3.0 0.0 300.0 24.0 0.0 0.0 0.0 1.0 0.0\n")
    return img_dir, cal_dir


def _meta(path, **extra):
    path.with_name(path.name + ".json").write_text(json.dumps({
        "batch": BATCH, "src_hw": list(SRC_HW), "crop_size": list(CROP_HW),
        "class_names": ["Car", "Pedestrian", "Cyclist"], "score_thres": 0.0,
        **extra}))


def test_serve_script_matches_jax_serve(tiny, served, tmp_path):
    """``scripts/serve_torch.py --device cpu`` as a subprocess, JAX, the
    JAX package and Pillow unimportable (so loading the artifact imports
    none of them), in a directory that holds only the artifact, its json,
    the PNGs and the calibs, against ``scripts/serve.py`` serving JAX's
    artifact of the same weights: one txt a frame, the same rows."""
    img_dir, cal_dir = _serve_dir(tmp_path, np.random.default_rng(2))
    art = tmp_path / "model.pt2"
    art.write_bytes(served["greedy"][1])
    _meta(art, device="cpu")
    jart = tmp_path / "model.ghlo"
    jart.write_bytes(jax_export_serving(jax_build_serving_fn(
        tiny["jmodel"], tiny["variables"], *tiny["consts"],
        _dcfgs("greedy")[0], target_h=CROP_HW[0], crop_w=CROP_HW[1],
        bf16_input=False), batch=BATCH, src_h=SRC_HW[0], src_w=SRC_HW[1]))
    _meta(jart)
    assert sorted(os.listdir(tmp_path)) == [
        "calib", "images", "model.ghlo", "model.ghlo.json", "model.pt2",
        "model.pt2.json"]
    common = ["--images", str(img_dir), "--calib", str(cal_dir)]
    torch_run = subprocess.run(
        [sys.executable, "-c", _RUNNER,
         os.path.join(ROOT, "scripts", "serve_torch.py"), "--artifact",
         str(art), "--out", str(tmp_path / "torch" / "data"), "--device",
         "cpu", *common], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=ROOT))
    assert torch_run.returncode == 0, torch_run.stderr[-3000:]
    jax_run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "serve.py"),
         "--artifact", str(jart), "--out", str(tmp_path / "jax" / "data"),
         *common], capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=_subprocess_env(1))
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    got, want = read_rows(str(tmp_path / "torch")), \
        read_rows(str(tmp_path / "jax"))
    assert sorted(got) == ["000000.txt", "000001.txt", "000002.txt"]
    assert assert_same_rows(got, want) >= 6


def test_serve_script_refuses_jpeg_and_another_device(served, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "serve_torch", os.path.join(ROOT, "scripts", "serve_torch.py"))
    serve_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_torch)
    art = tmp_path / "model.pt2"
    art.write_bytes(served["greedy"][1])
    _meta(art, device="cpu")
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    write_png(str(img_dir / "000000.png"), np.zeros((*SRC_HW, 3), np.uint8))
    Image.fromarray(np.zeros((*SRC_HW, 3), np.uint8)).save(
        img_dir / "000001.jpg")
    with pytest.raises(ValueError, match="JPEG"):
        serve_torch.main(["--artifact", str(art), "--images", str(img_dir),
                          "--out", str(tmp_path / "out"), "--device", "cpu"])
    _meta(art, device="cuda:0")
    with pytest.raises((ValueError, RuntimeError)):
        serve_torch.main(["--artifact", str(art), "--images", str(img_dir),
                          "--out", str(tmp_path / "out"), "--device", "cpu"])


def test_export_script_verifies_on_the_cpu(tmp_path):
    """``python scripts/export_torch.py --device cpu --verify`` run as a
    file (its directory first on ``sys.path``, as Python puts it), from a
    port run of tiny_synthetic (checkpoint 0 and its anchors.npz): the
    artifact, its json with the JAX keys and the device, and the verify
    line."""
    _run_dir(str(tmp_path / "out"))
    art = tmp_path / "tiny.pt2"
    proc = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "scripts", "export_torch.py"), "--config",
         "tiny_synthetic", "--output", str(tmp_path / "out"), "--batch", "2",
         "--src-h", "72", "--src-w", "240", "--out", str(art), "--device",
         "cpu", "--verify"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "verify OK: the artifact reproduces the live program" \
        in proc.stderr
    meta = json.loads((tmp_path / "tiny.pt2.json").read_text())
    assert meta["device"] == "cpu" and meta["batch"] == 2
    assert meta["src_hw"] == [72, 240] and meta["crop_size"] == [96, 320]
    assert meta["bytes"] == art.stat().st_size
    assert set(meta) >= {"config", "iter", "class_names", "score_thres",
                         "platforms", "inputs", "outputs"}
    program = torch.export.load(io.BytesIO(art.read_bytes()))
    assert _op_nodes(program) == dict.fromkeys(PATH_OPS["greedy"], 1)
