"""The trunk's dense blocks on K4 in eval-mode f32 inference
(``models/densenet.py::DenseNetBackbone``).

On a CUDA card a block runs as one ``dense_block_eval`` call on weights
packed once; here the device test is patched to take the CPU, where the
call is K4's plain version, so the mechanism runs against the concat chain
it stands in for.  A wrapper around ``dense_block_eval`` counts the blocks
that took it.  The card's kernel is held to the chain in
``test_torch_cuda.py``.
"""

import dataclasses

import pytest
import torch

from groomed_nms_torch.models import densenet
from groomed_nms_torch.models.densenet import (DenseNetBackbone,
                                               tiny_densenet_config)
from groomed_nms_torch.models.rpn_3d import RPN3D, RPNConfig
from groomed_nms_torch.utils.weights import init_weights

BLOCKS = 4                    # the tiny trunk's dense blocks


def _tiny_rpn3d(seed=0, **backbone):
    """The tiny RPN3D (c0 16, G 8, bw 32, which K4 takes) from a seed, every
    BatchNorm's affine and running statistics drawn from it, in eval mode;
    ``backbone`` overrides the tiny trunk's topology."""
    cfg = RPNConfig(num_anchors=6, prop_features=32,
                    predict_acceptance_prob=True,
                    backbone=dataclasses.replace(tiny_densenet_config(),
                                                 **backbone))
    g = torch.Generator().manual_seed(seed)
    model = init_weights(RPN3D(cfg), g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
                m.running_mean.copy_(
                    torch.randn(m.running_mean.shape, generator=g) * 0.2)
                m.running_var.copy_(
                    torch.rand(m.running_var.shape, generator=g) + 0.5)
    return model.eval()


def _images(seed=1, b=2, h=32, w=64):
    return torch.randn((b, 3, h, w),
                       generator=torch.Generator().manual_seed(seed))


@pytest.fixture
def k4(monkeypatch):
    """K4's device test takes the CPU; returns the list of the dilations of
    the blocks that ran on K4, call by call."""
    calls = []
    run = densenet.dense_block_eval

    def counted(*args, dilation):
        calls.append(dilation)
        return run(*args, dilation=dilation)

    monkeypatch.setattr(densenet, "_kernel_device", lambda x: True)
    monkeypatch.setattr(densenet, "dense_block_eval", counted)
    return calls


def _chain(model, x):
    """The model's outputs with every block on the concat chain."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(densenet, "_kernel_device", lambda x: False)
        with torch.inference_mode():
            return model(x)


def _close(got, want):
    """f32 sums in another order, and each BatchNorm folded."""
    for name in ("fused_raw", "accept_prob"):
        a, b = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_eval_blocks_run_on_k4_and_match_the_chain(k4):
    model, x = _tiny_rpn3d(), _images()
    want = _chain(model, x)
    packs = DenseNetBackbone.packs
    with torch.inference_mode():
        got = model(x)
    assert k4 == list(model.config.backbone.block_dilations)
    assert DenseNetBackbone.packs == packs + BLOCKS
    _close(got, want)
    with torch.no_grad():                # no_grad takes it too
        _close(model(x), want)
    assert len(k4) == 2 * BLOCKS


def _export(model, x):
    with torch.no_grad():
        torch.export.export(model.backbone, (x,), strict=False)


@pytest.mark.parametrize("case", ["train", "grad", "autocast", "export",
                                  "growth", "bw", "dtype"])
def test_eval_blocks_stay_on_the_chain(k4, case):
    """Train mode, gradients on, bf16 autocast, an export trace, a shape K4
    refuses (G 12, or bw 24) and an f64 input keep every block on the
    chain."""
    backbone = {"growth": dict(growth_rate=12),
                "bw": dict(bn_size=3)}.get(case, {})
    model, x = _tiny_rpn3d(**backbone), _images()
    packs = DenseNetBackbone.packs
    if case == "train":
        with torch.no_grad():
            model.train()(x)
    elif case == "grad":
        model(x)
    elif case == "autocast":
        with torch.inference_mode(), \
                torch.autocast("cpu", dtype=torch.bfloat16):
            model(x)
    elif case == "export":
        _export(model, x)
    elif case == "dtype":
        with torch.inference_mode():
            model.double()(x.double())
    else:
        with torch.inference_mode():
            model(x)
    assert k4 == [] and DenseNetBackbone.packs == packs


def test_eval_blocks_pack_once(k4):
    model, x = _tiny_rpn3d(), _images()
    packs = DenseNetBackbone.packs
    with torch.inference_mode():
        first = model(x)
        again = model(x)
    assert DenseNetBackbone.packs == packs + BLOCKS
    assert len(k4) == 2 * BLOCKS
    torch.testing.assert_close(again.fused_raw, first.fused_raw, rtol=0,
                               atol=0)


def test_eval_blocks_of_inference_tensors_pack_each_call(k4):
    """Weights made under ``inference_mode`` keep no version, so nothing
    tells a pack of them still holds: each call packs again."""
    x = _images()
    with torch.inference_mode():
        model = _tiny_rpn3d()
        packs = DenseNetBackbone.packs
        model(x)
        got = model(x)
    assert DenseNetBackbone.packs == packs + 2 * BLOCKS
    _close(got, _chain(model, x))


def _sgd_step(model, x):
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    model(x).fused_raw.square().mean().backward()
    opt.step()
    model.eval()


@pytest.mark.parametrize("change", ["load_state_dict", "assign",
                                    "sgd_step", "half_float"])
def test_eval_blocks_repack_after_a_change(k4, change):
    """New weights or statistics (loaded in place, or assigned: new tensors
    whose versions equal the old ones', an SGD step with its train-mode
    forward, or rounded to f16 and back by ``.half().float()``) rebuild
    every block's pack, and the outputs follow them."""
    model, x = _tiny_rpn3d(), _images()
    with torch.inference_mode():
        before = model(x)
    packs = DenseNetBackbone.packs
    if change in ("load_state_dict", "assign"):
        model.load_state_dict(_tiny_rpn3d(seed=5).state_dict(),
                              assign=change == "assign")
    elif change == "sgd_step":
        _sgd_step(model, x)
    else:
        model.half().float()
    with torch.inference_mode():
        got = model(x)
    assert DenseNetBackbone.packs == packs + BLOCKS
    assert (got.fused_raw - before.fused_raw).abs().max() > 0
    _close(got, _chain(model, x))
