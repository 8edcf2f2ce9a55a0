"""The evaluation slice, JAX vs the PyTorch port, end to end on the CPU.

One set of flax variables drives JAX's ``test_kitti_3d`` and, through
``from_flax``, the port's; both read the same mixed-size synthetic split
(96x320 and 72x240 frames) and must write the same KITTI txt files.  Then
the port's own refusals, ``scripts/evaluate_torch.py --device cpu`` as a
subprocess, the evaluator wrapper and ``apply_overrides`` against JAX.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from groomed_nms_tpu import config as jax_config
from groomed_nms_tpu.data.imdb import build_imdb as jax_build_imdb
from groomed_nms_tpu.eval import kitti_eval as jax_kitti_eval
from groomed_nms_tpu.eval import tester as jax_tester

from groomed_nms_torch import config
from groomed_nms_torch.anchors import generate_anchor_templates, \
    locate_anchors
from groomed_nms_torch.data.imdb import build_imdb
from groomed_nms_torch.data.synthetic import (crop_to_sizes,
                                              make_synthetic_kitti)
from groomed_nms_torch.eval import kitti_eval
from groomed_nms_torch.eval import tester
from groomed_nms_torch.models.rpn_3d import RPN3D
from groomed_nms_torch.training.checkpoint import save_checkpoint
from groomed_nms_torch.utils.weights import init_weights
from torch_port_common import tiny_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(96, 320), (72, 240)]       # the tiny_synthetic crop is 96x320
NUM_ANCHORS = 12
# KITTI txt rows of the two packages: same files, rows and classes, every
# number within 1e-3 absolute + 1e-4 relative (f32 on both sides; the
# static resize differs from JAX's by float rounding)
TXT_ATOL, TXT_RTOL = 1e-3, 1e-4


def _tree(root, n=5, seed=3):
    make_synthetic_kitti(root, "validation", n, im_h=96, im_w=320, seed=seed,
                         classes=("Car", "Pedestrian", "Cyclist"))
    crop_to_sizes(root, "validation", SIZES)


def _anchors(rs):
    """[12, 11] priors: 2D templates for the 96x320 crop, 3D priors."""
    scales = np.exp(np.linspace(np.log(16), np.log(64), 4))
    templates = generate_anchor_templates(scales, (0.5, 1.0, 1.5), 16)
    priors = np.concatenate(
        [templates,
         np.abs(rs.normal(size=(NUM_ANCHORS, 7))).astype(np.float32) + 1.0],
        axis=1)
    priors[:, 4] = 20.0
    return priors


def _rois(priors):
    rois = locate_anchors(priors, (96 // 16, 320 // 16), 16)
    return rois, priors[rois[:, 4].astype(np.int64), 4:]


def read_rows(results_dir):
    """{file: [(class, numbers)]} of a results dir's data/*.txt."""
    out = {}
    data = os.path.join(results_dir, "data")
    for name in sorted(os.listdir(data)):
        with open(os.path.join(data, name)) as f:
            out[name] = [(p[0], np.array([float(v) for v in p[1:]]))
                         for p in (ln.split() for ln in f.read().splitlines())]
    return out


def assert_same_rows(got, want):
    """Same files, row counts and classes; numbers within tolerance.
    Returns the number of rows."""
    assert sorted(got) == sorted(want)
    n = 0
    for name, rows in want.items():
        assert len(got[name]) == len(rows), name
        for (cls_g, v_g), (cls_w, v_w) in zip(got[name], rows):
            assert cls_g == cls_w, name
            np.testing.assert_allclose(v_g, v_w, rtol=TXT_RTOL,
                                       atol=TXT_ATOL, err_msg=name)
        n += len(rows)
    return n


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    _tree(root)
    return root


@pytest.mark.parametrize("single", [False, True])
def test_kitti_3d_matches_jax(split, tmp_path, single):
    """Grouped (one batch shape per size, the last batch of a size padded)
    and single-program (one edge-padded plane, each frame resampled by its
    own scale) write the same txt files as JAX's tester."""
    rs = np.random.default_rng(0)
    priors = _anchors(rs)
    rois, rois_3d = _rois(priors)
    bbox_means = rs.normal(0, 0.1, 13).astype(np.float32)
    bbox_stds = rs.uniform(0.5, 1.5, 13).astype(np.float32)
    jmodel, variables, tmodel = tiny_models(
        seed=1, num_anchors=NUM_ANCHORS, predict_acceptance_prob=True)
    jcfg = jax_config.load_config("tiny_synthetic").replace(
        eval_single_program=single)
    tcfg = dataclasses.replace(config.load_config("tiny_synthetic"),
                               eval_single_program=single)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_tester.test_kitti_3d(
        jcfg, jmodel, variables["params"], variables["batch_stats"], rois,
        rois_3d, bbox_means, bbox_stds, jax_build_imdb(split, "validation"),
        jdir, batch_size=2, skip_eval=True)
    stats = {}
    out = tester.test_kitti_3d(
        tcfg, tmodel, rois, rois_3d, bbox_means, bbox_stds,
        build_imdb(split, "validation"), tdir, batch_size=2, skip_eval=True,
        loop_stats=stats)
    assert out is None and stats["images"] == 5 and "busy_s" not in stats
    rows = assert_same_rows(read_rows(tdir), read_rows(jdir))
    assert rows >= 5, "no detections written: the comparison checks nothing"


def test_kitti_3d_of_the_un_model_matches_jax(split, tmp_path):
    """The ``_un`` model (uncertainty channel, no acceptance branch), as
    ``scripts/evaluate_torch.py`` serves ``kitti_3d_uncertainty``: the
    uncertainty folds into the ranking score and, by ``use_un_for_score``,
    into the written score; the same txt files as JAX's tester."""
    rs = np.random.default_rng(2)
    priors = _anchors(rs)
    rois, rois_3d = _rois(priors)
    bbox_means = rs.normal(0, 0.1, 13).astype(np.float32)
    bbox_stds = rs.uniform(0.5, 1.5, 13).astype(np.float32)
    jmodel, variables, tmodel = tiny_models(
        seed=2, num_anchors=NUM_ANCHORS, predict_uncertainty=True)
    un = dict(has_un=True, predict_acceptance_prob=False, score_thres=0.05)
    jcfg = jax_config.load_config("tiny_synthetic").replace(**un)
    tcfg = dataclasses.replace(config.load_config("tiny_synthetic"), **un)
    assert tcfg.use_un_for_score and tcfg.detect_config().use_un_for_score
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_tester.test_kitti_3d(
        jcfg, jmodel, variables["params"], variables["batch_stats"], rois,
        rois_3d, bbox_means, bbox_stds, jax_build_imdb(split, "validation"),
        jdir, batch_size=2, skip_eval=True)
    tester.test_kitti_3d(
        tcfg, tmodel, rois, rois_3d, bbox_means, bbox_stds,
        build_imdb(split, "validation"), tdir, batch_size=2, skip_eval=True)
    rows = assert_same_rows(read_rows(tdir), read_rows(jdir))
    assert rows >= 5, "no detections written: the comparison checks nothing"


def test_kitti_3d_refuses_a_stale_imdb(split, tmp_path):
    """Grouped mode: a decoded size that contradicts the imdb would scale
    that frame's boxes wrongly; the first batch raises."""
    cfg = config.load_config("tiny_synthetic")
    imdb = build_imdb(split, "validation")
    imdb[0].im_h = 120
    rois, rois_3d = _rois(_anchors(np.random.default_rng(0)))
    model = RPN3D(cfg.rpn_config(NUM_ANCHORS))
    with pytest.raises(ValueError, match="stale imdb"):
        tester.test_kitti_3d(cfg, model, rois, rois_3d, np.zeros(13),
                             np.ones(13), imdb, str(tmp_path / "res"),
                             batch_size=2, skip_eval=True)


@pytest.mark.parametrize("kwargs,msg", [(dict(refine=True), None),
                                        (dict(render=1), "matplotlib")],
                         ids=["refine_runs", "render_refused"])
def test_kitti_3d_refuses_what_is_not_ported(split, tmp_path, kwargs, msg):
    """``render > 0`` (matplotlib and Pillow) is refused; ``refine=True``,
    ported, runs and writes a txt file a frame (its rows against JAX's:
    ``test_torch_refine.py``)."""
    cfg = config.load_config("tiny_synthetic")
    model = RPN3D(cfg.rpn_config(NUM_ANCHORS))
    if msg is not None:
        with pytest.raises(ValueError, match=msg):
            tester.test_kitti_3d(cfg, model, None, None, None, None, [],
                                 str(tmp_path), **kwargs)
        return
    init_weights(model, torch.Generator().manual_seed(0))
    rois, rois_3d = _rois(_anchors(np.random.default_rng(0)))
    imdb = build_imdb(split, "validation")
    tester.test_kitti_3d(cfg, model, rois, rois_3d, np.zeros(13),
                         np.ones(13), imdb, str(tmp_path), batch_size=2,
                         skip_eval=True, **kwargs)
    assert sorted(os.listdir(tmp_path / "data")) == sorted(
        r.id + ".txt" for r in imdb)


def _run_dir(out_root, seed=0):
    """A port run of tiny_synthetic: anchors.npz and checkpoint 0."""
    run = os.path.join(out_root, "tiny_synthetic")
    os.makedirs(run, exist_ok=True)
    np.savez(os.path.join(run, "anchors.npz"),
             anchors=_anchors(np.random.default_rng(seed)),
             bbox_means=np.zeros(13), bbox_stds=np.ones(13))
    cfg = config.load_config("tiny_synthetic")
    model = RPN3D(cfg.rpn_config(NUM_ANCHORS))
    init_weights(model, torch.Generator().manual_seed(seed))
    save_checkpoint(run, model, step=0)
    return model


def _script(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "evaluate_torch.py"),
         *args], capture_output=True, text=True, timeout=300, env=env)


def test_evaluate_torch_script_on_the_cpu(tmp_path):
    """The entry point end to end: checkpoint and anchors restored, every
    frame written, the C++ evaluator's AP table printed; with --refine too;
    a missing CUDA device refused."""
    data = tmp_path / "data"
    _tree(str(data / "kitti_split1"), n=4, seed=5)
    _run_dir(str(tmp_path / "out"))
    args = ["--config", "tiny_synthetic", "--data-root", str(data),
            "--output", str(tmp_path / "out")]
    run = _script(*args, "--device", "cpu", "--restore", "0",
                  "--set", "score_thres=0.0")
    assert run.returncode == 0, run.stderr[-3000:]
    assert "restored iter 0" in run.stderr
    assert "car detection AP|R40" in run.stderr
    res = tmp_path / "out" / "tiny_synthetic" / "results" / "results_0"
    txts = sorted(os.listdir(res / "data"))
    assert txts == [f"{i:06d}.txt" for i in range(4)]
    assert all((res / "data" / t).stat().st_size for t in txts)
    assert (res / "stats_car_detection.txt").exists()
    refined = _script(*args, "--device", "cpu", "--refine", "--skip-eval",
                      "--set", "score_thres=0.0")
    assert refined.returncode == 0, refined.stderr[-3000:]
    res = tmp_path / "out" / "tiny_synthetic" / "results" / "results_latest"
    assert sorted(os.listdir(res / "data")) == txts
    if not torch.cuda.is_available():
        bad = _script(*args)
        assert bad.returncode != 0 and "CUDA is not available" in bad.stderr


def test_evaluator_wrapper_matches_jax(tmp_path):
    """The port's evaluator wrapper and JAX's on the same detections (a
    full-size split's own labels as results, so a car AP is > 0), and
    the AP arithmetic on one precision curve."""
    make_synthetic_kitti(str(tmp_path / "kitti"), "validation", 3, seed=2)
    res = tmp_path / "res"
    os.makedirs(res / "data")
    gt = str(tmp_path / "kitti" / "validation" / "label_2")
    for name in os.listdir(gt):
        with open(os.path.join(gt, name)) as f, \
                open(res / "data" / name, "w") as g:
            for ln in f.read().splitlines():
                if not ln.startswith("DontCare"):
                    g.write(ln + " 0.9\n")
    ours = kitti_eval.evaluate_kitti_results_verbose(str(res), gt,
                                                     log_fn=lambda s: None)
    theirs = jax_kitti_eval.evaluate_kitti_results_verbose(
        str(res), gt, log_fn=lambda s: None)
    assert ours == theirs and ours["main"]
    assert max(ours["main"][("car", "detection")]) > 10
    curve = np.linspace(1, 0, 41)
    for protocol in ("R40", "R11"):
        assert kitti_eval.ap_from_precision(curve, protocol) == \
            jax_kitti_eval.ap_from_precision(curve, protocol)


def test_apply_overrides_matches_jax():
    items = ["lr=0.008", "lbls=('Car',)", "lr_policy=step",
             "score_thres=0.1", "crop_size=(64, 128)"]
    ours = config.apply_overrides(config.load_config("groomed_nms"), items)
    theirs = jax_config.apply_overrides(
        jax_config.load_config("groomed_nms"), items)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for bad in (["no_such_field=1"], ["lr"]):
        for pkg in (config, jax_config):
            with pytest.raises(ValueError):
                pkg.apply_overrides(pkg.load_config("groomed_nms"), bad)
