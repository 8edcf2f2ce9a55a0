"""A throwaway copy of the benchmark with tiny cells, for CPU tests.

``tiny_tree(tmp)`` copies ``BENCHMARK.json`` and ``benchmark/`` into
``tmp``, links the port's package beside them and adds a tiny
configuration (DenseNet's toy topology at 64x128) of each shipped one, with
a serving and a training cell.  Nothing in the copy is edited: the tiny
cells are new files and new entries, as a later cell would be.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY_BACKBONE = {"name": "densenet_tiny", "growth_rate": 8,
                 "block_layers": [2, 2, 2, 2], "stem_features": 16,
                 "bn_size": 4, "block_dilations": [1, 1, 1, 2],
                 "transition_pool": [True, True, False]}


def tiny_config(name):
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["name"] = f"tiny_{name}"
    cfg["model"]["backbone"] = TINY_BACKBONE
    cfg["experiment"].update(backbone_tiny=True, crop_size=[64, 128],
                             nms_topN_pre=300, nms_topN_post=12)
    cfg["bbox_stats"] = {"batches": 3, "batch": 2, "gts_per_image": 2,
                         "src_hw": [48, 96]}
    return cfg


def tiny_tree(tmp):
    tmp = Path(tmp)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "groomed_nms_torch", tmp / "groomed_nms_torch")
    b = tmp / "benchmark"
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    twin = {"groomed_nms.serve_b8": "tiny_groomed_nms.serve",
            "kitti_3d_warmup.train_b8": "tiny_kitti_3d_warmup.train"}
    for full, cell in twin.items():
        name, kind = cell[len("tiny_"):].split(".")
        traffic = f"tiny_{kind}"
        (b / "configs" / f"tiny_{name}.json").write_text(
            json.dumps(tiny_config(name)))
        spec["configs"].append({"name": f"tiny_{name}", "source": "tiny",
                                "file": f"benchmark/configs/tiny_{name}.json",
                                "reduced": [], "why": "a test"})
        spec["workloads"].append({"name": cell, "config": f"tiny_{name}",
                                  "traffic": traffic, "chips": 1,
                                  "why": "a test"})
        shutil.copy(b / "cells" / f"{full}.json", b / "cells" / f"{cell}.json")
    (b / "traffic" / "tiny_serve.json").write_text(json.dumps(
        {"kind": "serve", "batch": 2, "src_hw": [48, 96],
         "pool_frames": 4, "in_flight": 2, "warmup_batches": 1,
         "trace_units": 2}))
    (b / "traffic" / "tiny_train.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "src_hw": [48, 96], "pool_batches": 3,
         "gts_per_image": 2, "prefetch_depth": 2, "check_steps": 3,
         "trace_units": 1}))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [twin[w] for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def harness(tmp):
    """The copy's ``run`` module and its ``harness`` package, imported from
    the copy (a fresh import: earlier copies are dropped)."""
    for name in list(sys.modules):
        if name.split(".")[0] in ("run", "harness", "reference") or \
                name.startswith("_bench_"):
            del sys.modules[name]
    sys.path[:0] = [str(Path(tmp) / "benchmark"), str(tmp)]
    import run
    run.common.set_environment()
    return run
