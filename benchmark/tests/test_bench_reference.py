"""Each configuration's plain reference against the port at a tiny size on
the CPU, through a whole run of the harness, and the run broken under the
timed path: every fault a cell can have makes ``correct`` false."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tiny import harness, tiny_tree  # noqa: E402

SEED = 2**31 + 777
CPU = torch.device("cpu")
SERVE, TRAIN = "tiny_groomed_nms.serve", "tiny_kitti_3d_warmup.train"


@pytest.fixture
def run(tmp_path):
    return harness(tiny_tree(tmp_path))


def test_serving_reference_agrees_with_the_port(run):
    res, checks = run.run_cell(torch, SERVE, SEED, 0.5, False, CPU)
    assert res["correct"], checks
    assert checks["row_err"]["value"] < 1e-4
    assert checks["pick_gap"]["value"] < 1e-5
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"img_per_s", "batch_ms_p95", "setup_s"}


def test_training_reference_agrees_with_the_port(run):
    res, checks = run.run_cell(torch, TRAIN, SEED, 0.5, False, CPU)
    assert res["correct"], checks
    numbers = res["numbers"]
    assert numbers["loss_gap"] < 1e-5 and numbers["terms1_gap"] < 1e-5
    assert numbers["grad1_gap"] < 1e-3 and numbers["change_gap"] < 1e-3
    assert numbers["sgd_rule_gap"] < 1e-4
    assert set(res["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault,cell", [
    ("altered_row", SERVE), ("half_batch_served", SERVE),
    ("half_batch_trained", TRAIN), ("state_unchanged", TRAIN),
    ("momentum_dropped", TRAIN)])
def test_a_planted_fault_is_caught(run, fault, cell):
    from harness.faults import plant
    with plant(fault):
        res, checks = run.run_cell(torch, cell, SEED, 0.3, False, CPU)
    assert not res["correct"], (fault, checks)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["groomed_nms.serve_b8",
                                  "kitti_3d_warmup.train_b8"])
@pytest.mark.parametrize("control", ["tf32", "bf16"])
def test_control_fails_at_the_cells_size(cell, control):
    """The precision below the configuration's, at the cell's own size on
    the card, on three seeds: ``correct`` is false on each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import run as bench
    bench.common.set_environment()
    for seed in (11, 2**31 + 5, 987654321):
        res, checks = bench.run_cell(torch, cell, seed, 3.0, False,
                                     torch.device("cuda"), control=control)
        assert not res["correct"], (seed, checks)
