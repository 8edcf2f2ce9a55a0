"""CPU tests of the benchmark's yardstick: traffic from the seed, the tail
over every batch, the idle share from a union of intervals, the FLOP and
work counts, and the harness finding a cell from data alone."""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import common, flops, inputs, trace  # noqa: E402
from reference import plain  # noqa: E402

from tiny import harness, tiny_tree  # noqa: E402

SEED = 2**31 + 12345
GN = json.loads((BENCH / "configs" / "groomed_nms.json").read_text())


def test_traffic_identical_for_one_seed():
    exp = GN["experiment"]
    a = inputs.frames(SEED, 2, 3, (8, 12))
    b = inputs.frames(SEED, 2, 3, (8, 12))
    assert torch.equal(a, b)
    assert not torch.equal(a, inputs.frames(SEED + 1, 2, 3, (8, 12)))
    g1 = inputs.ground_truth(SEED, 100, 2, exp, (512, 1760), (375, 1242), 6)
    g2 = inputs.ground_truth(SEED, 100, 2, exp, (512, 1760), (375, 1242), 6)
    for k in g1:
        np.testing.assert_array_equal(g1[k], g2[k])
    assert g1["gt_valid"].sum() == 12
    np.testing.assert_array_equal(inputs.anchors(exp, 36, SEED),
                                  inputs.anchors(exp, 36, SEED))
    np.testing.assert_array_equal(inputs.mirror_flags(SEED, 200, 8, 0.5),
                                  inputs.mirror_flags(SEED, 200, 8, 0.5))
    w1 = plain.make_weights(plain.param_spec(
        {**GN["model"], "backbone": {**GN["model"]["backbone"],
                                     "block_layers": [1, 1, 1, 1]}}, 4, True),
        SEED, torch.device("cpu"))
    w2 = plain.make_weights(plain.param_spec(
        {**GN["model"], "backbone": {**GN["model"]["backbone"],
                                     "block_layers": [1, 1, 1, 1]}}, 4, True),
        SEED, torch.device("cpu"))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


def test_anchor_grid_matches_the_configs_count():
    rois, rois_3d = inputs.grid_rois(inputs.anchors(GN["experiment"], 36, 1),
                                     (32, 110), 16)
    assert rois.shape == (126720, 5) and rois_3d.shape == (126720, 7)
    assert (rois[:36, 4] == np.arange(36)).all()


def test_target_stats_normalise_the_seeds_foreground_targets():
    exp = GN["experiment"]
    ref = _ref("groomed_nms")
    rois, rois_3d = inputs.grid_rois(inputs.anchors(exp, 36, SEED),
                                     (32, 110), 16)
    cpu = torch.device("cpu")
    means, stds = inputs.target_stats(torch, ref, GN, SEED, rois, rois_3d,
                                      cpu)
    again = inputs.target_stats(torch, ref, GN, SEED, rois, rois_3d, cpu)
    np.testing.assert_array_equal(means, again[0])
    assert means.shape == stds.shape == (13,)
    assert np.isfinite(means).all() and (stds > 0).all()
    # foreground anchors overlap their GT by half or more: the 2D
    # targets are small, far from the unit scale of unnormalised deltas
    assert (stds[:4] < 0.5).all(), stds


def test_p95_is_taken_over_every_batch():
    lat = list(range(1, 201))                      # 200 batches
    assert common.percentile(lat, 95) == pytest.approx(190.05)
    assert common.percentile([5.0], 95) == 5.0
    # a tail that exists only in the last batches still shows
    assert common.percentile([1.0] * 190 + [100.0] * 10, 95) > 1.0


def test_idle_share_from_a_union_of_intervals():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 35, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 95, "dur": 20},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "u", "ts": 0,
           "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "bench.submit",
           "ts": 50, "dur": 30}]
    r = trace.reduce(ev)
    # [10, 45] and [95, 100] are busy: overlapping kernels count once
    assert r["busy_s"] == pytest.approx(40e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["idle_gaps"][0] == ["submit", pytest.approx(50e-6)]
    assert [n for n, _ in r["device_ops"]] == ["a", "b", "c"]
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_flop_count_of_dense_block_1():
    bb = GN["model"]["backbone"]
    spec = lambda n: plain.param_spec(  # noqa: E731
        {**GN["model"], "backbone": {**bb, "block_layers": n}}, 4, False)
    with_b1 = flops.trunk_flops(plain.trunk, spec([6]), {**bb,
                                "block_layers": [6]}, 8, 512, 1760)
    stem = flops.trunk_flops(plain.trunk, spec([0]), {**bb,
                             "block_layers": [0]}, 8, 512, 1760)
    assert with_b1 - stem == 298_969_989_120           # PERF §6: 298.97 GFLOP


def test_model_flops_are_the_references_count():
    f = flops.forward_flops(_ref("groomed_nms"), GN, 1)
    assert 140e9 < f < 150e9


def _ref(name):
    common.set_environment()
    return common.load_module("reference", name)


def test_kernel_work():
    k1 = common.load_module("work", "k1")
    k2 = common.load_module("work", "k2")
    ops, nbytes = k1.work(b=8, r=126720, per=18, elem_bytes=2, accept=True)
    assert nbytes == 8 * 126720 * 44 and round(nbytes / 1e6, 1) == 44.6
    assert k2.tests(8, 3000) == 35_988_000             # 36.0 M IoU tests
    assert k2.work(b=8, nms_n=3000)[0] == 35_988_000 * 16


def test_harness_is_driven_by_data(tmp_path):
    """A throwaway cell, configuration, traffic mix, reference and metric,
    and a second cell of an existing configuration with a training
    reference and a traffic kind (driver) of its own, added as files and
    entries only, run with no file of the copy edited."""
    tree = tiny_tree(tmp_path)
    b = tree / "benchmark"
    (b / "metrics" / "throwaway.count.py").write_text(
        '"""A test metric."""\n\n\ndef read(r):\n'
        '    return float(len(r.get("enqueue_s") or []))\n')
    (b / "reference" / "throwaway_stage1.py").write_text(
        '"""A test reference: stage 1 again."""\n\n'
        'from .kitti_3d_warmup import *  # noqa: F401,F403\n')
    (b / "harness" / "throwaway_train.py").write_text(
        '"""A test driver."""\n\nfrom .train import drive  # noqa: F401\n')
    traffic = json.loads((b / "traffic" / "tiny_train.json").read_text())
    (b / "traffic" / "throwaway_train.json").write_text(
        json.dumps({**traffic, "kind": "throwaway_train"}))
    cell = json.loads((b / "cells" / "tiny_kitti_3d_warmup.train.json")
                      .read_text())
    (b / "cells" / "tiny_kitti_3d_warmup.throwaway.json").write_text(
        json.dumps({**cell, "reference": "throwaway_stage1"}))
    spec = json.loads((tree / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "throwaway.count", "unit": "batches", "better": "higher",
        "source": "host_clock", "layer": "serving entry",
        "moves": "img_per_s", "workloads": ["tiny_groomed_nms.serve"]})
    spec["workloads"].append({
        "name": "tiny_kitti_3d_warmup.throwaway",
        "config": "tiny_kitti_3d_warmup", "traffic": "throwaway_train",
        "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "tiny_kitti_3d_warmup.train" in m.get("workloads", ()):
            m["workloads"].append("tiny_kitti_3d_warmup.throwaway")
    (tree / "BENCHMARK.json").write_text(json.dumps(spec))
    run = harness(tree)
    res, checks = run.run_cell(torch, "tiny_groomed_nms.serve", SEED, 0.5,
                               True, torch.device("cpu"))
    assert res["correct"], checks
    assert res["metrics"]["throwaway.count"]["value"] >= 1
    res, checks = run.run_cell(torch, "tiny_kitti_3d_warmup.throwaway", SEED,
                               0.3, False, torch.device("cpu"))
    assert res["correct"], checks
    assert sys.modules["reference.throwaway_stage1"].train_loss
    assert "harness.throwaway_train" in sys.modules
    assert set(res["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    src = BENCH.parent
    for f in (src / "benchmark").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            copy = tree / f.relative_to(src)
            assert hashlib.sha256(copy.read_bytes()).digest() == \
                hashlib.sha256(f.read_bytes()).digest(), f
