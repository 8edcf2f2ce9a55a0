"""What a cell runs loads no JAX: every module of the harness, the
references, the readers and the port's modules the drivers call, imported
in a fresh process.  The references load nothing of the port, and nothing
under ``benchmark/`` reads the JAX-era benchmark files."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "groomed_nms_tpu")

PROBE = r"""
import importlib, json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
run.common.set_environment()
for kind in ("metrics", "work"):
    for f in sorted((run.common.BENCH / kind).glob("*.py")):
        run.common.load_module(kind, f.stem)
for f in sorted((run.common.BENCH / "harness").glob("*.py")):
    importlib.import_module("harness." + f.stem)
refs = [f.stem for f in sorted((run.common.BENCH / "reference").glob("*.py"))
        if f.stem != "__init__"]
for name in refs:
    run.common.load_module("reference", name)
ref_only = sorted({{m.split(".")[0] for m in sys.modules}})
for name in ("groomed_nms_torch.eval.tester", "groomed_nms_torch.config",
             "groomed_nms_torch.training.trainer",
             "groomed_nms_torch.training.schedules",
             "groomed_nms_torch.data.pipeline",
             "groomed_nms_torch.models.rpn_3d",
             "groomed_nms_torch.models.fast_eval",
             "groomed_nms_torch.losses.rpn_3d"):
    importlib.import_module(name)
print(json.dumps({{"ref_only": ref_only,
                   "all": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    code = PROBE.format(bench=str(BENCH), root=str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert not set(tops["all"]) & set(FORBIDDEN), tops["all"]
    # the references and the yardstick load nothing of the port
    assert "groomed_nms_torch" not in tops["ref_only"]
    assert "groomed_nms_torch" in tops["all"]


def test_nothing_reads_the_jax_era_benchmark_files():
    needles = ("bench" + ".py", "BENCH" + "_r", "MULTICHIP" + "_",
               "BASELINE" + ".")
    for f in BENCH.rglob("*"):
        if f.is_file() and f.suffix in (".py", ".json") and \
                "__pycache__" not in f.parts:
            text = f.read_text()
            for n in needles:
                assert n not in text, (f, n)


def test_no_card_no_result():
    """Without a CUDA card the run exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "groomed_nms.serve_b8", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        raise AssertionError("ran without a card check")
    assert out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and ``benchmark/`` the
    program is missing: the run raises before any result."""
    import shutil
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (f"import sys; sys.path[:0] = [{str(tmp_path / 'benchmark')!r}];"
            "import run, torch; run.common.set_environment();"
            "run.run_cell(torch, 'groomed_nms.serve_b8', 1, 0.1, False,"
            " torch.device('cpu'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "groomed_nms_torch" in out.stderr
