"""``scripts/flagship_repeat_torch.py`` on the CPU at a tiny size: a run
that stays finite reports no bad step, a run whose state turns non-finite
is caught at that step, its first non-finite module output and the first
backward op that returns NaN named, and a run whose anchor 0 decodes to
overflowing boxes (``--overflow``) keeps finite gradients."""

import importlib.util
import os

import torch

from groomed_nms_torch.flagship import build_flagship_train
from groomed_nms_torch.models.densenet import tiny_densenet_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(batch=2, height=64, width=128, src_hw=(48, 96),
             compute_dtype=None, backbone=tiny_densenet_config())


def _script():
    spec = importlib.util.spec_from_file_location(
        "flagship_repeat_torch",
        os.path.join(ROOT, "scripts", "flagship_repeat_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(nan_from=None):
    """``build_flagship_train`` on the CPU at SMALL; from step ``nan_from``
    on, a NaN is written into the head's kernel before the step runs."""
    def build(device):
        step, state, batch = build_flagship_train(device="cpu", **SMALL)
        calls = [0]

        def stepped(st, b):
            if nan_from is not None and calls[0] >= nan_from:
                with torch.no_grad():
                    st.model.head.weight[0, 0] = float("nan")
            calls[0] += 1
            return step(st, b)
        return stepped, state, batch
    return build


def test_finite_run_reports_no_bad_step():
    out = _script().one_run(_build(), 2)
    assert out["first_bad_step"] is None and len(out["losses"]) == 2


def test_nonfinite_step_is_found_and_diagnosed():
    out = _script().one_run(_build(nan_from=1), 3)
    assert out["first_bad_step"] == 1 and len(out["losses"]) == 2
    assert out["n_nonfinite_grads"] > 0
    assert out["first_nonfinite_module"] == "head"
    assert "returned nan values" in out["anomaly"]
    assert any("rpn_3d.py" in line for line in out["forward_trace"])


def test_overflowing_boxes_keep_gradients_finite():
    out = _script().one_run(_build(), 2, overflow=True)
    assert out["first_bad_step"] is None and len(out["losses"]) == 2
