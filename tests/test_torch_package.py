"""The PyTorch package as a whole: no JAX at run time, and its configs."""

import dataclasses
import filecmp
import os
import subprocess
import sys

import pytest

from groomed_nms_tpu import config as jax_config

from groomed_nms_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_without_jax():
    """Every module of groomed_nms_torch imports with jax, flax, the JAX
    package, triton, Pillow and matplotlib absent from sys.modules (the
    GPU machine has no JAX, Pillow or matplotlib).  A subprocess, because
    this process (conftest.py) has imported jax already."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import groomed_nms_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'groomed_nms_tpu', 'triton', 'PIL', "
        "'matplotlib'))\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 24
    assert {f"groomed_nms_torch.{m}" for m in (
        "ops.refine", "ops.nms", "ops.roi_align", "ops.iou3d_exact",
        "losses.ranknet", "losses.custom_loss", "parallel",
        "parallel.dist", "parallel.dryrun", "data.matfile")} <= mods


@pytest.mark.parametrize("script,argv", [
    ("export_torch", ["--config", "groomed_nms"]),
    ("serve_torch", ["--artifact", "model.pt2", "--images", "images"]),
])
def test_serving_scripts_import_without_jax(script, argv):
    """The export and serve scripts, imported and their arguments parsed,
    with the export module, pull in none of the modules the GPU machine
    lacks (that loading an artifact imports none of them either is checked
    by ``serve_torch.py`` run with them blocked, ``test_torch_export.py``)."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('s', "
        f"{os.path.join(ROOT, 'scripts', script + '.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"mod.parse_args({argv!r})\n"
        "import groomed_nms_torch.export\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'groomed_nms_tpu', 'PIL', 'matplotlib'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("script,argv", [
    ("train_torch", ["--config", "groomed_nms", "--dist-backend", "gloo"]),
    ("evaluate_torch", ["--config", "groomed_nms", "--dist-backend", "nccl"]),
    ("train_pose_torch", ["--config", "kitti_3d_full"]),
    ("test_kalman_torch", ["--config", "kitti_3d_full"]),
    ("flagship_repeat_torch", ["--runs", "2"]),
    # the tool twins; a name with a directory lies there, not in scripts/
    ("profile_torch", ["--mode", "train"]),
    ("make_synthetic_kitti_torch", ["--root", "data", "--video"]),
    ("determine_seqs_torch", ["--root", "data", "--ids", "val.txt"]),
    ("analysis/bench_latency_torch", ["--batches", "1", "8"]),
    ("analysis/bench_groomed_nms_torch", ["1000", "20"]),
    ("analysis/roofline_train_torch", ["--remat", "layer"]),
    ("analysis/bench_loader_torch", ["--synthetic", "8"]),
    ("analysis/compare_video_training_schemes_torch", ["--iters", "4"]),
    ("analysis/detection_stats_torch", ["--results", "r", "--gt", "g"]),
])
def test_torch_scripts_import_without_jax(script, argv):
    """The train, evaluate, pose and tracking entry points, the bf16
    loop's repeat script and the tool twins, imported with their arguments
    parsed and the package's parallel layer and measurement helpers loaded,
    pull in none of the modules the GPU machine lacks: they are blocked
    (an import of one raises) and none is in ``sys.modules``."""
    path = os.path.join(ROOT, *(script if "/" in script
                                else "scripts/" + script).split("/")) + ".py"
    code = (
        "import importlib.abc, importlib.util, sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'flax', 'groomed_nms_tpu', 'PIL', "
        "'matplotlib')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"spec = importlib.util.spec_from_file_location('s', {path!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"mod.parse_args({argv!r})\n"
        "import groomed_nms_torch.parallel.dryrun\n"
        "import groomed_nms_torch.utils.measure\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'groomed_nms_tpu', 'PIL', 'matplotlib'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_config_jsons_regenerate_identically(tmp_path):
    """The checked-in JSONs equal a fresh dump of the JAX configs."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "dump_torch_configs.py"),
         "--out", str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    fresh = sorted(os.listdir(tmp_path))
    assert fresh == sorted(f"{n}.json" for n in config.config_names())
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path, config.CONFIG_DIR, fresh, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_experiment_config_fields_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(
        config.ExperimentConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(
        jax_config.ExperimentConfig)}
    assert ours == theirs


def _norm(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize("name", ["groomed_nms", "kitti_3d_uncertainty",
                                  "groomed_nms_acceptance_classify",
                                  "tiny_video_synthetic"])
def test_derived_configs_match_jax(name):
    ours = config.load_config(name)
    theirs = jax_config.load_config(name)
    assert ours == config.ExperimentConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in dataclasses.asdict(theirs).items()})
    d_ours = dataclasses.asdict(ours.detect_config())
    d_theirs = dataclasses.asdict(theirs.detect_config())
    assert d_ours == {k: d_theirs[k] for k in d_ours}
    r_ours, r_theirs = ours.rpn_config(36), theirs.rpn_config(36)
    for f in dataclasses.fields(r_ours):
        if f.name != "backbone":
            assert getattr(r_ours, f.name) == getattr(r_theirs, f.name)
    for f in dataclasses.fields(r_ours.backbone):
        if f.name != "bn_momentum":
            assert _norm(getattr(r_ours.backbone, f.name)) == \
                _norm(getattr(r_theirs.backbone, f.name)), f.name
    # torch momentum is the batch weight, flax momentum the decay
    assert r_ours.backbone.bn_momentum == pytest.approx(
        1.0 - r_theirs.backbone.bn_momentum)


def test_unknown_config_raises():
    with pytest.raises(ValueError):
        config.load_config("no_such_config")


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py runs on the GPU machine: importing it pulls in none of
    the modules that machine lacks."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'groomed_nms_tpu', 'PIL', 'matplotlib'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
