"""The port's kernels on a CUDA card against their plain versions.

Marked ``cuda``; each test skips when ``torch.cuda.is_available()`` is
False (decided in a fixture, never at import).  This file imports no JAX, so
on a machine without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import copy
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from groomed_nms_torch.anchors import locate_anchors
from groomed_nms_torch.eval.tester import make_infer
from groomed_nms_torch.flagship import build_flagship, build_flagship_train
from groomed_nms_torch.inference import DetectConfig
from groomed_nms_torch.models.densenet import tiny_densenet_config
from groomed_nms_torch.models.fast_eval import FastEvalRPN3D
from groomed_nms_torch.models.rpn_3d import RPN3D, RPNConfig
from groomed_nms_torch.ops import kernels
from groomed_nms_torch.ops.groomed_nms import groomed_nms_boxes
from groomed_nms_torch.utils.weights import init_weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,r,per,c", [(8, 126720, 18, 4), (1, 1, 18, 4),
                                       (3, 1300, 19, 4), (2, 1025, 9, 2)])
def test_head_scores_kernel_matches_plain(cuda, b, r, per, c, dtype):
    g = torch.Generator().manual_seed(r)
    fused = (torch.randn((b, r, per), generator=g) * 3).to(dtype).to(cuda)
    accept = (torch.rand((b, r), generator=g) * 0.9 + 0.1).to(cuda)
    for acc in (None, accept):
        before = kernels.fused_head_scores.launches
        got = kernels.fused_head_scores(fused, acc, num_classes=c)
        assert kernels.fused_head_scores.launches == before + 1
        ref = kernels.fused_head_scores_plain(fused, acc, num_classes=c)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (b, r)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def _nms_case(rs, b, n):
    """Clustered, score-sorted boxes with equal scores, padding rows and
    same-size pairs at IoU (W-d)/(W+d) ~ 0.4 (d = 3W/7)."""
    boxes = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        centers = rs.uniform([0, 0], [1200, 350], (16, 2))
        c = centers[rs.integers(0, 16, n)] + rs.normal(0, 8, (n, 2))
        wh = rs.uniform(20, 160, (n, 2))
        boxes[i, :, :2] = c - wh / 2
        boxes[i, :, 2:] = c + wh / 2
        for j in range(1, n, 5):
            w = boxes[i, j - 1, 2] - boxes[i, j - 1, 0] + 1.0
            d = np.float32(3.0 * w / 7.0) * np.float32(
                1.0 + 1e-5 * rs.integers(-2, 3))
            boxes[i, j] = boxes[i, j - 1] + np.array([d, 0, d, 0], np.float32)
    scores = -np.sort(-np.round(rs.uniform(0.05, 1, (b, n)), 2), axis=1)
    scores = scores.astype(np.float32)
    scores[:, n - n // 10:] = 0.0
    return boxes, scores


@pytest.mark.parametrize("b,n", [(8, 3000), (1, 1), (2, 63), (2, 64), (3, 65),
                                 (4, 700), (2, 3008), (1, 4096), (1, 6000)])
def test_greedy_nms_kernel_matches_plain(cuda, b, n):
    boxes, scores = _nms_case(np.random.default_rng(n), b, n)
    boxes, scores = torch.from_numpy(boxes).to(cuda), \
        torch.from_numpy(scores).to(cuda)
    before = kernels.greedy_nms.launches
    keep = kernels.greedy_nms(boxes, scores, nms_threshold=0.4, shift=1.0)
    assert kernels.greedy_nms.launches == before + 1
    ref = kernels.greedy_nms_plain(boxes, scores, nms_threshold=0.4,
                                   shift=1.0)
    torch.cuda.synchronize()
    assert torch.equal(keep, ref)


def _nms_edge_case(name, b, n):
    """Boxes and scores of one edge case of the sweep, [b, n]."""
    rs = np.random.default_rng(n)
    boxes, scores = _nms_case(rs, b, n)
    if name == "all_padding":
        scores[:] = 0.0
    elif name == "interleaved_padding":          # padding anywhere
        scores[:, ::3] = 0.0
    elif name == "padding_row_blocks":           # whole 64-row blocks
        scores[:, :128] = 0.0
        scores[:, 192:256] = 0.0
    elif name == "disjoint":                     # every row kept
        i = np.arange(n, dtype=np.float32)
        boxes[:] = np.stack([i * 10, i * 0, i * 10 + 5, i * 0 + 5], -1)
        scores[:] = np.linspace(1.0, 0.5, n, dtype=np.float32)
    elif name == "identical":                    # the first suppresses all
        boxes[:] = boxes[:, :1]
        scores[:] = np.linspace(1.0, 0.5, n, dtype=np.float32)
    return boxes, scores


@pytest.mark.parametrize("name", ["all_padding", "interleaved_padding",
                                  "padding_row_blocks", "disjoint",
                                  "identical"])
@pytest.mark.parametrize("b,n", [(3, 300), (2, 64), (1, 4100)])
def test_greedy_nms_kernel_edge_cases(cuda, name, b, n):
    boxes, scores = (torch.from_numpy(x).to(cuda)
                     for x in _nms_edge_case(name, b, n))
    keep = kernels.greedy_nms(boxes, scores, nms_threshold=0.4, shift=1.0)
    ref = kernels.greedy_nms_plain(boxes, scores, nms_threshold=0.4,
                                   shift=1.0)
    torch.cuda.synchronize()
    assert torch.equal(keep, ref)
    kept = ref.sum(1)
    if name == "all_padding":
        assert not kept.any()
    elif name == "disjoint":
        assert bool((kept == n).all())
    elif name == "identical":
        assert bool((kept == 1).all()) and bool(ref[:, 0].all())


def test_greedy_nms_kernel_refuses_misaligned_boxes(cuda):
    flat = torch.zeros(1 + 2 * 10 * 4, device=cuda)
    boxes = flat[1:].view(2, 10, 4)
    with pytest.raises(ValueError):
        kernels.greedy_nms(boxes, torch.ones(2, 10, device=cuda))


def test_slice_on_cuda_matches_cpu(cuda):
    """The tiny model end to end: kernels on the card vs plain versions on
    the CPU, f32 with TF32 off, same seeded weights and frames."""
    cfg = RPNConfig(num_anchors=6, prop_features=64,
                    predict_acceptance_prob=True,
                    backbone=tiny_densenet_config())
    rs = np.random.default_rng(0)
    priors = np.concatenate([np.tile([[0, 0, 30, 20]], (6, 1)) * rs.uniform(
        0.5, 2, (6, 1)), np.abs(rs.normal(size=(6, 7))) + 1], 1)
    rois = locate_anchors(priors, (4, 8), 16)
    inputs = [rs.integers(0, 256, (2, 48, 96, 3)).astype(np.uint8),
              np.asarray([0.485, 0.456, 0.406]), np.asarray([0.229, 0.224,
                                                             0.225]),
              rois, priors[rois[:, 4].astype(int), 4:],
              np.tile(np.diag([700.0, 700.0, 1.0, 1.0]), (2, 1, 1)),
              np.tile(np.diag([1 / 700.0, 1 / 700.0, 1.0, 1.0]), (2, 1, 1)),
              np.full(2, 64 / 48), np.zeros(13), np.ones(13)]
    results = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for device in ("cpu", cuda):
            model = init_weights(RPN3D(cfg), torch.Generator().manual_seed(0))
            infer = make_infer(model.to(device), DetectConfig(), 64, 128)
            args = [torch.as_tensor(x, device=device,
                                    dtype=torch.uint8 if i == 0 else
                                    torch.float32)
                    for i, x in enumerate(inputs)]
            results.append([t.cpu() for t in infer(*args)])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (dets_c, valid_c), (dets_g, valid_g) = results
    assert torch.equal(valid_g, valid_c) and valid_c.any()
    torch.testing.assert_close(dets_g[valid_c], dets_c[valid_c], rtol=1e-4,
                               atol=1e-3)


def _dense_block_case(seed, b, c0, h, w, layers, growth, bw, device):
    """Seeded block input and packed weights in bf16: folded affines with
    mul ~ U(0.5, 1.5), add ~ N(0, 0.2), LeCun-normal kernels."""
    rs = np.random.default_rng(seed)
    cmax = c0 + layers * growth

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).to(device)

    x0 = t(rs.normal(size=(b, c0, h, w))).contiguous(
        memory_format=torch.channels_last)
    return (x0, t(rs.uniform(0.5, 1.5, (layers, cmax))),
            t(rs.normal(0, 0.2, (layers, cmax))),
            t(rs.normal(size=(layers, bw, cmax)) / np.sqrt(cmax)),
            t(rs.uniform(0.5, 1.5, (layers, bw))),
            t(rs.normal(0, 0.2, (layers, bw))),
            t(rs.normal(size=(layers, growth, 9 * bw)) / np.sqrt(9 * bw)))


@pytest.mark.parametrize("b,c0,h,w,layers,growth,bw,dil", [
    (2, 16, 13, 21, 2, 8, 32, 2),        # the tiny config: odd H/W, dil 2
    (3, 24, 37, 29, 3, 16, 64, 1),       # ragged tiles, cin not a k step
    (1, 40, 9, 11, 2, 24, 96, 3),        # G padded to 32, bw 96
    (8, 128, 64, 220, 12, 32, 128, 1),   # the flagship's block 2
    # the 3x3's 16 x 16 output tiles: W smaller than a tile; H and W not
    # multiples of it; dilation 2 and 3 (2 x 2 and 3 x 3 phases, 18 x 18
    # halos reaching past every edge) on images a few pixels past one halo
    (1, 16, 5, 3, 2, 8, 32, 1),
    (2, 32, 35, 19, 2, 16, 64, 1),
    (1, 24, 38, 37, 2, 16, 32, 2),
    (2, 8, 57, 59, 2, 24, 96, 3),
    (2, 64, 24, 40, 2, 64, 64, 1),       # bw 64 with G 64
    (8, 64, 128, 440, 6, 32, 128, 1),    # the flagship's block 1
])
def test_dense_block_kernel_matches_plain(cuda, b, c0, h, w, layers, growth,
                                          bw, dil):
    """Max |err| within 1e-2 of max |ref| and mean |err| within 1e-3 of
    mean |ref| over the new channels: the two sum in other orders, so a
    bf16 rounding of h or of an output may land one step apart."""
    args = _dense_block_case(h * w, b, c0, h, w, layers, growth, bw, cuda)
    before = kernels.dense_block_eval.launches
    got = kernels.dense_block_eval(*args, dilation=dil)
    assert kernels.dense_block_eval.launches == before + 1
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = kernels.dense_block_eval_plain(*args, dilation=dil)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.synchronize()
    cmax = c0 + layers * growth
    assert got.shape == (b, cmax, h, w) and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got[:, :c0], args[0])
    new, ref = got[:, c0:].float(), ref[:, c0:].float()
    err = (new - ref).abs()
    assert err.max() <= 1e-2 * ref.abs().max()
    assert err.mean() <= 1e-3 * ref.abs().mean()


def test_dense_block_kernel_refuses_what_it_does_not_take(cuda):
    args = _dense_block_case(0, 1, 16, 8, 8, 2, 8, 32, cuda)
    with pytest.raises(ValueError):           # f32 is never handed on
        kernels.dense_block_eval(*(a.float() for a in args))
    args = _dense_block_case(0, 1, 16, 8, 8, 2, 8, 48, cuda)
    with pytest.raises(ValueError):           # bw not a multiple of 32
        kernels.dense_block_eval(*args)
    args = _dense_block_case(0, 1, 12, 8, 8, 2, 8, 32, cuda)
    with pytest.raises(ValueError):           # c0 not a multiple of 8
        kernels.dense_block_eval(*args)


def test_fast_eval_engine_on_cuda_matches_cpu(cuda):
    """The tiny engine in bf16 at 2x64x128: K4 and cuDNN on the card vs the
    plain path on the CPU, BatchNorm statistics perturbed from a seed.
    bf16 sums in other orders: max |err| within 5% of max |ref|, mean
    |err| within 2% of mean |ref|, acceptance within 0.02."""
    cfg = RPNConfig(num_anchors=6, prop_features=64,
                    predict_acceptance_prob=True,
                    backbone=tiny_densenet_config())
    model = init_weights(RPN3D(cfg), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
                m.running_mean.copy_(
                    torch.randn(m.running_mean.shape, generator=g) * 0.2)
                m.running_var.copy_(
                    torch.rand(m.running_var.shape, generator=g) + 0.5)
    engine = FastEvalRPN3D(model.eval(), torch.bfloat16)
    x = torch.randn((2, 3, 64, 128), generator=g).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        ref = engine(x)
        before = kernels.dense_block_eval.launches
        gpu = copy.deepcopy(engine).to(cuda, memory_format=torch.channels_last)
        got = gpu(x.to(cuda))
        torch.cuda.synchronize()
    assert kernels.dense_block_eval.launches == before + 2
    assert got.fused_raw.shape == ref.fused_raw.shape
    f_got, f_ref = got.fused_raw.float().cpu(), ref.fused_raw.float()
    err = (f_got - f_ref).abs()
    assert err.max() <= 0.05 * f_ref.abs().max()
    assert err.mean() <= 0.02 * f_ref.abs().mean()
    torch.testing.assert_close(got.accept_prob.cpu(), ref.accept_prob,
                               rtol=0, atol=0.02)


def test_f32_fast_eval_on_cuda_is_refused_at_build(cuda):
    """K4 takes bf16 only: an f32 fast_eval engine on the card raises when
    it is built, not at its first batch; without kernel blocks it builds."""
    with pytest.raises(ValueError, match="bf16 only"):
        build_flagship(device=cuda, engine="fast_eval", compute_dtype=None)
    cfg = RPNConfig(num_anchors=6, prop_features=64,
                    backbone=tiny_densenet_config())
    model = init_weights(RPN3D(cfg), torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    with pytest.raises(ValueError, match="bf16 only"):
        FastEvalRPN3D(model, torch.float32)
    engine = FastEvalRPN3D(model, torch.float32, kernel_blocks=())
    with torch.no_grad():
        out = engine(torch.randn((1, 3, 64, 128), device=cuda))
    assert out.fused_raw.dtype == torch.float32


@pytest.mark.parametrize("method", ["linear", "sigmoidal", "soft_nms"])
@pytest.mark.parametrize("b,n", [(8, 512), (1, 1000), (1, 1), (3, 33),
                                 (2, 300), (2, 31), (2, 64), (3, 65),
                                 (2, 100), (1, 2048)])
def test_iou_prune_kernel_matches_plain(cuda, b, n, method):
    """IoU identical and the linear prune identical (the same f32 ops in
    the same order, no FMA, IEEE quotients); sigmoid and exp within 1e-6.
    N covers one box, ragged 32-row tiles, N % 4 != 0 (scalar stores) and
    many tiles of the triangular grid."""
    boxes, scores = _nms_case(np.random.default_rng(n), b, n)
    boxes = torch.from_numpy(boxes).to(cuda)
    valid = torch.from_numpy(scores > 0).to(cuda)
    before = kernels.fused_iou_prune.launches
    iou, prune = kernels.fused_iou_prune(boxes, valid, nms_threshold=0.4,
                                         temperature=0.1,
                                         pruning_method=method)
    assert kernels.fused_iou_prune.launches == before + 1
    ref_iou, ref_prune = kernels.fused_iou_prune_plain(
        boxes, valid, nms_threshold=0.4, temperature=0.1,
        pruning_method=method)
    torch.cuda.synchronize()
    assert iou.shape == prune.shape == (b, n, n)
    assert torch.equal(iou, ref_iou)
    if method == "linear":
        assert torch.equal(prune, ref_prune)
    else:
        torch.testing.assert_close(prune, ref_prune, rtol=0, atol=1e-6)
    assert not prune.triu().any()


def _wide_range_boxes(rs, b, n):
    """Boxes whose sides span 2^-25..2^63, nested across scales."""
    side = np.exp2(rs.uniform(-25, 63, (b, n, 2)))
    center = np.exp2(rs.uniform(-25, 63, (b, n, 2))) * rs.uniform(
        -1, 1, (b, n, 2))
    return np.concatenate([center - side / 2, center + side / 2],
                          -1).astype(np.float32)


@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_iou_prune_kernel_quotients_outside_the_fast_range(cuda, shift):
    """Quotients the kernel divides exactly after its branch-free pass
    (unions at the 1e-12 clamp and past 2^126, ratios far below 2^-60) are
    the plain version's, as are the ordinary ones beside them."""
    rs = np.random.default_rng(3)
    boxes = torch.from_numpy(_wide_range_boxes(rs, 2, 700)).to(cuda)
    boxes[:, ::50, 2] = boxes[:, ::50, 0]             # zero-width boxes
    valid = torch.ones((2, 700), dtype=torch.bool, device=cuda)
    iou, prune = kernels.fused_iou_prune(boxes, valid, shift=shift)
    ref_iou, ref_prune = kernels.fused_iou_prune_plain(boxes, valid,
                                                       shift=shift)
    torch.cuda.synchronize()
    assert torch.equal(iou, ref_iou) and torch.equal(prune, ref_prune)
    assert bool(((iou > 0) & (iou < 2.0 ** -60)).any())


def test_iou_prune_kernel_refuses_misaligned_boxes(cuda):
    flat = torch.zeros(1 + 2 * 10 * 4, device=cuda)
    with pytest.raises(ValueError):
        kernels.fused_iou_prune(flat[1:].view(2, 10, 4))


@pytest.mark.parametrize("b,n", [(8, 512), (1, 1000)])
def test_groomed_nms_operator_on_cuda_matches_cpu(cuda, b, n):
    """Sort, K3, grouping and rescoring on the card against the CPU path:
    leaders and keep identical, rescored within 1e-6."""
    boxes, scores = _nms_case(np.random.default_rng(b * n), b, n)
    scores = np.random.default_rng(n).permutation(scores, axis=1)
    boxes, scores = torch.from_numpy(boxes), torch.from_numpy(scores)
    valid = scores > 0
    ref = groomed_nms_boxes(scores, boxes, valid)
    before = kernels.fused_iou_prune.launches
    before_g = kernels.group_leaders.launches
    got = groomed_nms_boxes(scores.to(cuda), boxes.to(cuda), valid.to(cuda))
    assert kernels.fused_iou_prune.launches == before + 1
    assert kernels.group_leaders.launches == before_g + 1
    assert torch.equal(got.leader.cpu(), ref.leader)
    assert torch.equal(got.keep.cpu(), ref.keep) and ref.keep.any()
    torch.testing.assert_close(got.rescored.cpu(), ref.rescored, rtol=0,
                               atol=1e-6)


def test_groomed_nms_operator_does_not_synchronise(cuda):
    """The operator at the shipped config ("2d", masked groups, group size
    100) makes no synchronising CUDA call: no host read of the device."""
    boxes, scores = _nms_case(np.random.default_rng(4), 8, 512)
    scores = np.random.default_rng(5).permutation(scores, axis=1)
    scores = torch.from_numpy(scores).to(cuda)
    args = (scores, torch.from_numpy(boxes).to(cuda), scores > 0)
    groomed_nms_boxes(*args)              # builds the kernels first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = groomed_nms_boxes(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool((res.leader >= 0).any())


def _grouping_case(b, n, kind, dev, seed):
    """m [b, n, n] f32 and valid [b, n]: the unmasked IoU of clustered
    boxes with padding rows and a hole every 7th row ("iou"), or that IoU
    scaled by random gains (asymmetric) with 1% of its entries exactly at
    the 0.4 threshold and 0.5% NaN ("mixed")."""
    rs = np.random.default_rng(seed)
    boxes, scores = _nms_case(rs, b, n)
    valid = scores > 0
    valid[:, 3::7] = False
    m = kernels.fused_iou_prune_plain(
        torch.from_numpy(boxes).to(dev),
        torch.ones((b, n), dtype=torch.bool, device=dev))[0]
    if kind == "mixed":
        g = torch.Generator(device=dev).manual_seed(seed)
        m = m * (0.75 + 0.5 * torch.rand(m.shape, generator=g, device=dev))
        u = torch.rand(m.shape, generator=g, device=dev)
        m = torch.where(u < 0.01, torch.full_like(m, 0.4), m)
        m = torch.where(u > 0.995, torch.full_like(m, float("nan")), m)
    return m.contiguous(), torch.from_numpy(valid).to(dev)


@pytest.mark.parametrize("kind", ["iou", "mixed"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 512, 1000, 4096])
@pytest.mark.parametrize("b", [1, 8])
def test_group_leaders_kernel_matches_plain(cuda, b, n, kind):
    """The grouping kernel's leaders equal the plain version's for every
    group size, including a negative one (every row capped out)."""
    m, valid = _grouping_case(b, n, kind, cuda, seed=b * n)
    for group_size in (-1, 0, 1, 100):
        kw = dict(nms_threshold=0.4, group_size=group_size)
        before = kernels.group_leaders.launches
        got = kernels.group_leaders(m, valid, **kw)
        assert kernels.group_leaders.launches == before + 1
        ref = kernels.group_leaders_plain(m, valid, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.int64 and got.shape == (b, n)
        assert torch.equal(got, ref), group_size
        if group_size < 0:
            assert bool((got == -1).all())


def test_group_leaders_kernel_refuses_above_its_limit(cuda):
    n = kernels._GROUP_MAX_N + 1
    m = torch.zeros((1, n, n), device=cuda)
    valid = torch.ones((1, n), dtype=torch.bool, device=cuda)
    before = kernels.group_leaders.launches
    with pytest.raises(ValueError, match="N <="):
        kernels.group_leaders(m, valid, nms_threshold=0.4, group_size=100)
    assert kernels.group_leaders.launches == before


def _perturb_(model, seed):
    """BatchNorm weights ~ U(0.5, 1.5), running means ~ N(0, 0.2), running
    variances ~ U(0.5, 1.5) and every bias ~ N(0, 0.2), from a seed: no
    parameter starts at 0."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
            if getattr(m, "bias", None) is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)


def test_train_step_on_cuda_matches_cpu(cuda):
    """One step of the flagship train workload with the tiny backbone at
    2x64x128 in f32, TF32 off, on the card (K3 in the loss) and on the CPU
    from the same seeds: every stat at rtol 1e-3 (atol 1e-5) and each
    parameter and running statistic within 1e-4 of the tensor's largest
    magnitude.  (At random init DenseNet-121's train-mode step turns a
    1e-7 relative change of its weights into a ~0.4% change of the
    update.)"""
    small = dict(batch=2, height=64, width=128, src_hw=(48, 96),
                 compute_dtype=None, backbone=tiny_densenet_config())
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        results = []
        for device in ("cpu", cuda):
            step, state, batch = build_flagship_train(device=device, **small)
            _perturb_(state.model, seed=5)
            before = kernels.fused_iou_prune.launches
            before_g = kernels.group_leaders.launches
            stats = step(state, batch)
            if device != "cpu":
                assert kernels.fused_iou_prune.launches == before + 1
                assert kernels.group_leaders.launches == before_g + 1
            results.append(({k: float(v) for k, v in stats.items()},
                            {k: v.cpu() for k, v in
                             state.model.state_dict().items()}))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (s_c, p_c), (s_g, p_g) = results
    assert s_c["fg_num"] > 0
    for k in s_c:
        np.testing.assert_allclose(s_g[k], s_c[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    for k, ref in p_c.items():
        if ref.is_floating_point():
            err = (p_g[k] - ref).abs().max()
            assert err <= 1e-4 * ref.abs().max(), k


# -- the evaluation loop ------------------------------------------------------

def _eval_run(root, seed=0, n=6):
    """A tiny_synthetic split of two sizes, a seeded tiny model, its anchors
    and the tester's arguments."""
    import dataclasses

    from groomed_nms_torch.anchors import generate_anchor_templates
    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.data.synthetic import (crop_to_sizes,
                                                  make_synthetic_kitti)
    make_synthetic_kitti(root, "validation", n, im_h=96, im_w=320, seed=seed)
    crop_to_sizes(root, "validation", [(96, 320), (72, 240)])
    cfg = dataclasses.replace(load_config("tiny_synthetic"), score_thres=0.0)
    rs = np.random.default_rng(seed)
    scales = np.exp(np.linspace(np.log(16), np.log(64), 4))
    priors = np.concatenate(
        [generate_anchor_templates(scales, (0.5, 1.0, 1.5), 16),
         np.abs(rs.normal(size=(12, 7))) + 1.0], 1)
    priors[:, 4] = 20.0
    rois = locate_anchors(priors, (6, 20), 16)
    model = init_weights(RPN3D(cfg.rpn_config(12)),
                         torch.Generator().manual_seed(seed))
    _perturb_(model, seed)
    return cfg, model, rois, priors[rois[:, 4].astype(int), 4:], \
        build_imdb(root, "validation")


def _txt(results_dir):
    out = {}
    for name in sorted(os.listdir(os.path.join(results_dir, "data"))):
        with open(os.path.join(results_dir, "data", name)) as f:
            out[name] = [(p[0], np.array([float(v) for v in p[1:]]))
                         for p in (ln.split() for ln in f.read().splitlines())]
    return out


def _same_rows(got, want):
    """Same files, rows and classes, numbers within 1e-3 + 1e-4 * |x|."""
    assert sorted(got) == sorted(want)
    for name, rows in want.items():
        assert len(got[name]) == len(rows), name
        for (cg, vg), (cw, vw) in zip(got[name], rows):
            assert cg == cw, name
            np.testing.assert_allclose(vg, vw, rtol=1e-4, atol=1e-3,
                                       err_msg=name)
    return sum(len(r) for r in want.values())


@pytest.mark.parametrize("single", [False, True])
def test_tester_on_cuda_matches_cpu(cuda, tmp_path, single):
    """test_kitti_3d with the model on the card (pinned decode buffers, the
    prefetch stream, the in-flight queue) writes the rows the CPU path
    writes, f32 with TF32 off; the loop reports the card's busy time."""
    import dataclasses

    from groomed_nms_torch.eval import tester
    cfg, model, rois, rois_3d, imdb = _eval_run(str(tmp_path / "kitti"))
    cfg = dataclasses.replace(cfg, eval_single_program=single)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        stats = {}
        for device in ("cpu", cuda):
            tester.test_kitti_3d(
                cfg, copy.deepcopy(model).to(device), rois, rois_3d,
                np.zeros(13), np.ones(13), imdb, str(tmp_path / str(device)),
                batch_size=4, skip_eval=True, loop_stats=stats)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert _same_rows(_txt(str(tmp_path / "cuda")),
                      _txt(str(tmp_path / "cpu"))) > 0
    assert stats["images"] == 6 and 0 < stats["busy_s"] <= stats["wall_s"]


def test_tester_in_flight_batches_land_on_their_ids(cuda, tmp_path):
    """Batches whose device time differs widely (a spin of a random length
    queued before each forward) and decodes that finish in another order
    than they started (a random host delay per frame): every frame's rows
    are the ones the CPU path writes for that frame."""
    import threading
    import time

    from groomed_nms_torch.data import pipeline
    from groomed_nms_torch.eval import tester
    cfg, model, rois, rois_3d, imdb = _eval_run(str(tmp_path / "kitti"),
                                                seed=1, n=14)
    tester.test_kitti_3d(cfg, copy.deepcopy(model), rois, rois_3d,
                         np.zeros(13), np.ones(13), imdb,
                         str(tmp_path / "cpu"), batch_size=2, skip_eval=True)

    class Slow(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner
            self.rs = np.random.default_rng(3)

        def forward(self, x):
            torch.cuda._sleep(int(self.rs.integers(1, 40)) * 1_000_000)
            return self.inner(x)

    load = pipeline.load_image_cached
    rs = np.random.default_rng(4)
    lock = threading.Lock()

    def jittered(*args, **kwargs):
        with lock:
            delay = rs.uniform(0, 0.02)
        time.sleep(delay)
        return load(*args, **kwargs)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    pipeline.load_image_cached = jittered
    try:
        tester.test_kitti_3d(cfg, Slow(copy.deepcopy(model).to(cuda)), rois,
                             rois_3d, np.zeros(13), np.ones(13), imdb,
                             str(tmp_path / "cuda"), batch_size=2,
                             skip_eval=True)
    finally:
        pipeline.load_image_cached = load
        torch.backends.cudnn.allow_tf32 = tf32
    assert _same_rows(_txt(str(tmp_path / "cuda")),
                      _txt(str(tmp_path / "cpu"))) > 0


def test_pinned_buffer_is_not_reused_while_its_copy_is_in_flight(cuda):
    """The loop frees each batch's pinned buffer right after queueing its
    copy; PyTorch's host allocator must not hand that memory out again
    before the copy has run (here the copy waits ~0.1 s behind a spin on
    its stream), or the next batch's decode would overwrite it."""
    n = 8 << 20
    stream = torch.cuda.Stream()
    src = torch.empty(n, dtype=torch.uint8, pin_memory=True).fill_(1)
    ptr = src.data_ptr()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(100_000_000)
        dst = src.to(cuda, non_blocking=True)
    del src
    again = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    assert again.data_ptr() != ptr
    again.fill_(2)
    torch.cuda.synchronize()
    assert bool((dst == 1).all())


def test_device_prefetch_on_cuda(cuda):
    """Items copied on the prefetch stream arrive intact and in order while
    the consumer's stream is busy, and an error in the producer surfaces."""
    from groomed_nms_torch.data.pipeline import device_prefetch

    def items():
        for i in range(6):
            t = torch.empty((1 << 20,), dtype=torch.int32, pin_memory=True)
            t.fill_(i)
            yield i, (t, torch.tensor([i]))

    for i, (big, small) in device_prefetch(items(), cuda):
        torch.cuda._sleep(10_000_000)
        assert big.device.type == "cuda" and small.device.type == "cuda"
        assert int(small) == i and bool((big == i).all())

    def failing():
        yield 0, (torch.zeros(1),)
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(device_prefetch(failing(), cuda))


# the dynamic resample against the static one: PyTorch's resize forms a
# source coordinate with one rounding, the JAX-formula weights with two
# (1023.6374 against 1023.6373 at output column 1398 of 1242 -> 1696), so
# the two may be one f32 step apart (2^-13 between 1024 and 2048); times the
# largest pixel step (255/255) over the smallest std (0.224) that is 5.4e-4
# of a normalised value, on the CPU as on the card.  Below 512 source
# pixels the static resize's own 1e-4 holds.
@pytest.mark.parametrize("shape,target,atol", [
    ((2, 128, 416, 3), (64, 224), 1e-4),
    ((8, 375, 1242, 3), (512, 1760), 6e-4)])
def test_dynamic_preprocess_on_cuda_matches_static(cuda, shape, target,
                                                   atol):
    """Full buffers of noise: the dynamic resample on the card equals its
    CPU run within 1e-5 and the static resize within ``atol``, with the
    cuBLAS TF32 flag on, which its products must not use; the flag keeps
    its value."""
    from groomed_nms_torch.data.augment import (preprocess_images,
                                                preprocess_images_dynamic)

    g = torch.Generator().manual_seed(shape[1])
    imgs = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    hw = torch.tensor([shape[1:3]] * shape[0], dtype=torch.float32)
    means, stds = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    size = dict(target_h=target[0], crop_w=target[1])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = preprocess_images_dynamic(imgs.to(cuda), hw.to(cuda), means,
                                        stds, **size)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = preprocess_images_dynamic(imgs, hw, means, stds, **size)
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=1e-5)
    want = preprocess_images(imgs.to(cuda), None, means, stds, **size)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


# -- the training slice --------------------------------------------------------

def _train_tree(root, n=8, **kw):
    from groomed_nms_torch.data.synthetic import make_synthetic_kitti
    make_synthetic_kitti(root, "training", n, seed=3,
                         classes=("Car", "Pedestrian", "Cyclist"), **kw)


def test_prepare_anchors_on_cuda_matches_cpu(cuda, tmp_path):
    """Pass 2 (compute_targets) on the card: the same anchors, and the
    stds at rtol 1e-6 and the means at 1e-6 of |mean| + std (the log
    columns' roundings differ by a step between the devices); the
    truncation rule of the mean pass is exercised (min_gt_vis 0.65 on
    KITTI-size frames)."""
    import dataclasses

    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.data.pipeline import prepare_anchors

    root = str(tmp_path / "kitti")
    _train_tree(root, n=6)
    cfg = dataclasses.replace(load_config("groomed_nms"), min_gt_vis=0.65)
    imdb = build_imdb(root, "training")
    a_c, m_c, s_c = prepare_anchors(cfg, imdb, device="cpu")
    a_g, m_g, s_g = prepare_anchors(cfg, imdb, device=cuda)
    np.testing.assert_array_equal(a_g, a_c)
    np.testing.assert_allclose(s_g, s_c, rtol=1e-6, atol=0)
    assert (np.abs(m_g - m_c) <= 1e-6 * (np.abs(m_c) + s_c)).all()


def test_train_loader_batch_through_a_stage2_step(cuda, tmp_path):
    """One TrainLoader batch, pinned, through device_prefetch's side stream
    into train_torch's fused tiny_synthetic step (GrooMeD-NMS in the loss):
    one K3 and one grouping launch, finite stats, the weights moved."""
    import importlib.util

    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.data.imdb import build_imdb
    from groomed_nms_torch.data.pipeline import (TrainLoader, device_prefetch,
                                                 prepare_anchors)

    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "train_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    root = str(tmp_path / "kitti")
    _train_tree(root, im_h=96, im_w=320)
    cfg = load_config("tiny_synthetic")
    imdb = build_imdb(root, "training")
    anchors, means, stds = prepare_anchors(cfg, imdb, device=cuda)
    run = script.build_training(cfg, anchors, means, stds, cuda)
    before = {k: v.clone() for k, v in run.model.state_dict().items()}
    loader = TrainLoader(imdb, cfg, seed=cfg.rng_seed, prefetch=1)
    batches = device_prefetch(script.host_tensors(loader, pin=True), cuda)
    try:
        _, tensors = next(batches)
        assert all(t.device.type == "cuda" for t in tensors)
        k3, grp = (kernels.fused_iou_prune.launches,
                   kernels.group_leaders.launches)
        stats = run.step(run.state, script.raw_batch(tensors))
        torch.cuda.synchronize()
    finally:
        batches.close()
        loader.close()
    assert kernels.fused_iou_prune.launches == k3 + 1
    assert kernels.group_leaders.launches == grp + 1
    assert all(bool(torch.isfinite(v)) for v in stats.values())
    after = run.model.state_dict()
    assert any(not torch.equal(after[k], before[k]) for k in before)


# ---------------------------------------------------------------------------
# the video slice
# ---------------------------------------------------------------------------

_TRACK_FIELDS = ("valid", "ids", "next_id", "X", "C", "A", "box2d", "un")


@pytest.mark.parametrize("seed", [1, 2])
def test_video_track_on_cuda_matches_cpu(cuda, seed):
    """The tracker over a synthetic clip (matches, misses, deaths, the
    kill-all frame) on the card in f64 under sync debug mode "error" (no
    host synchronisation): every frame's tracks equal the CPU path's,
    masks and ids identical, numbers within 1e-9 (+ 1e-9 |x|)."""
    from groomed_nms_torch.data.synthetic import (kitti_p2,
                                                  make_synthetic_track_clip)
    from groomed_nms_torch.models.video import VideoConfig, video_track

    p2 = np.concatenate([kitti_p2(), [[0.0, 0.0, 0.0, 1.0]]])
    clip = [torch.from_numpy(a) for a in
            make_synthetic_track_clip(seed, m=64, n_objects=24, p2=p2)]
    cfg = VideoConfig()
    p2 = torch.from_numpy(p2)
    _, ref = video_track(*clip, p2, cfg)
    args = [a.to(cuda) for a in (*clip, p2)]
    video_track(*args, cfg)                               # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, got = video_track(*args, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(got) == len(ref) and int(ref[-1].valid.sum()) > 0
    for g, r in zip(got, ref):
        for f in _TRACK_FIELDS:
            a, b = getattr(g, f).cpu(), getattr(r, f)
            if f in ("valid", "ids", "next_id"):
                assert torch.equal(a, b), f
            else:
                torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


def test_greedy_nms_kernel_at_the_video_shape(cuda):
    """K2 at the measurements' shape [4, 64], rows score-sorted and the
    last slots padding (score 0, a zero box): the plain version's keep."""
    boxes, scores = _nms_case(np.random.default_rng(64), 4, 64)
    boxes[scores <= 0] = 0.0
    boxes, scores = torch.from_numpy(boxes), torch.from_numpy(scores)
    ref = kernels.greedy_nms_plain(boxes, scores, nms_threshold=0.4)
    got = kernels.greedy_nms(boxes.to(cuda), scores.to(cuda),
                             nms_threshold=0.4)
    assert torch.equal(got.cpu(), ref) and not ref[scores <= 0].any()


def test_extract_measurements_on_cuda_matches_cpu(cuda):
    """K1 and K2 on the card (one launch each) against the CPU path on one
    clip's head tensor: the same kept set, the kept rows within rtol 1e-5,
    atol 1e-4."""
    from groomed_nms_torch.anchors import (generate_anchor_templates,
                                           locate_anchors)
    from groomed_nms_torch.models.rpn_3d import RPNOutputs
    from groomed_nms_torch.models.video import (VideoConfig,
                                                extract_measurements)

    rs = np.random.default_rng(3)
    templates = generate_anchor_templates([16, 32, 64], [0.5, 1.0, 1.5], 16)
    priors = np.concatenate([templates, np.abs(rs.normal(size=(9, 8))) + 1],
                            1).astype(np.float32)
    priors[:, 4] = 20.0
    rois = locate_anchors(priors, (8, 26), 16)
    rois_3d = priors[rois[:, 4].astype(np.int64), 4:]
    fused = rs.normal(0, 0.5, (4, rois.shape[0], 20)).astype(np.float32)
    fused[..., 4:8] *= 0.3
    p2 = np.tile(np.eye(4, dtype=np.float32)[None], (4, 1, 1))
    p2[:, 0, 0] = p2[:, 1, 1] = 700.0
    args = [rois, rois_3d, p2, np.full(4, 0.5, np.float32),
            rs.normal(0, 0.1, 14).astype(np.float32),
            rs.uniform(0.5, 1.5, 14).astype(np.float32)]
    cfg = VideoConfig(score_thres=0.4)

    def run(device):
        out = RPNOutputs(fused_raw=torch.from_numpy(fused).to(device),
                         feat_hw=(8, 26), num_classes=4, n_box3d=11)
        return extract_measurements(
            out, *(torch.from_numpy(a).to(device) for a in args), cfg)

    meas_c, keep_c = run("cpu")
    k1, k2 = kernels.fused_head_scores.launches, kernels.greedy_nms.launches
    meas_g, keep_g = run(cuda)
    torch.cuda.synchronize()
    assert kernels.fused_head_scores.launches == k1 + 1
    assert kernels.greedy_nms.launches == k2 + 1
    assert torch.equal(keep_g.cpu(), keep_c) and keep_c.sum() > 8
    torch.testing.assert_close(meas_g.cpu()[keep_c], meas_c[keep_c],
                               rtol=1e-5, atol=1e-4)


# -- the video stage's training -----------------------------------------------

def test_video_train_step_on_cuda_matches_cpu(cuda, tmp_path):
    """Two steps of the video stage through ``scripts/train_torch.py``'s
    ``build_training`` (``tiny_video_synthetic``: the tiny video model with
    the velocity term, the backbone frozen, BatchNorm perturbed), fed by
    ``VideoTrainLoader`` and ``device_prefetch`` from a synthetic tracking
    tree, on the card against the CPU path in f64: the stats at rtol 1e-4
    (atol 1e-6; the loss runs in f32), each tensor within 1e-4 of its
    largest magnitude; the frozen backbone bit for bit; no K1-K4 or
    grouping launch."""
    import importlib.util

    from groomed_nms_torch.config import load_config
    from groomed_nms_torch.data.pipeline import (ClipRecordView,
                                                 VideoTrainLoader,
                                                 device_prefetch,
                                                 prepare_anchors)
    from groomed_nms_torch.data.synthetic import make_synthetic_kitti_video
    from groomed_nms_torch.data.tracking import build_tracking_imdb

    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "train_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    root = str(tmp_path / "kitti_split1")
    make_synthetic_kitti_video(root, n_train=6, n_val=1, im_h=96, im_w=320,
                               seed=5)
    cfg = load_config("tiny_video_synthetic")
    imdb = [ClipRecordView(r) for r in build_tracking_imdb(root, "training")]
    anchors, means, stds = prepare_anchors(cfg, imdb, device="cpu")
    names = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
             "group_leaders", "dense_block_eval")
    results = []
    for device in (torch.device("cpu"), cuda):
        run = script.build_training(cfg, anchors, means, stds, device,
                                    param_dtype=torch.float64)
        _perturb_(run.model, seed=5)
        before = {k: v.clone() for k, v in run.model.state_dict().items()}
        counts = {n: getattr(kernels, n).launches for n in names}
        loader = VideoTrainLoader(imdb, cfg, seed=cfg.rng_seed, prefetch=1)
        batches = device_prefetch(script.host_tensors(
            loader, pin=device.type == "cuda"), device)
        try:
            stats = [{k: float(v) for k, v in run.step(
                run.state, script.raw_batch(next(batches)[1])).items()}
                for _ in range(2)]
        finally:
            batches.close()
            loader.close()
        assert counts == {n: getattr(kernels, n).launches for n in names}
        after = {k: v.cpu() for k, v in run.model.state_dict().items()}
        for k, v in after.items():
            if k.startswith("rpn.backbone."):
                assert torch.equal(v, before[k].cpu()), k
        results.append((stats, after))
    (s_c, p_c), (s_g, p_g) = results
    assert s_c[0]["vel_num"] > 0 and np.isfinite(s_c[1]["vel"])
    for a, b in zip(s_g, s_c):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    for k, ref in p_c.items():
        if ref.is_floating_point():
            assert (p_g[k] - ref).abs().max() <= 1e-4 * ref.abs().max(), k


def test_fused_track_loss_on_cuda_matches_cpu(cuda):
    """The fused-track loss and its gradient with respect to the poses on a
    4-frame synthetic clip (T 24, M 16) in f64: the card against the CPU
    path within 1e-9 (+ 1e-9 |x|), forward and backward without a host
    synchronisation (sync debug mode "error")."""
    from groomed_nms_torch.data.synthetic import (kitti_p2,
                                                  make_synthetic_track_clip)
    from groomed_nms_torch.losses.fused_track import fused_track_loss
    from groomed_nms_torch.models.video import VideoConfig

    p2 = np.concatenate([kitti_p2(), [[0.0, 0.0, 0.0, 1.0]]])
    meas, valid, poses = make_synthetic_track_clip(
        5, n_frames=4, m=16, n_objects=9, kill_frame=-1, p2=p2)
    rs = np.random.default_rng(5)
    gts = meas[-1, :9, 6:9] + rs.normal(0, 0.3, (9, 3))
    poses = poses + rs.normal(0, 0.05, poses.shape)
    cfg = VideoConfig(max_tracks=24)
    host = [torch.from_numpy(a) for a in (poses, meas, valid, gts,
                                          np.ones(9, bool), p2)]

    def run(device, sync_check=False):
        pose, *rest = (a.to(device) for a in host)
        pose = pose.detach().requires_grad_()
        if sync_check:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss, n = fused_track_loss(pose, *rest, cfg)
            loss.backward()
        finally:
            if sync_check:
                torch.cuda.set_sync_debug_mode(0)
        return loss.detach().cpu(), n.cpu(), pose.grad.cpu()

    ref = run("cpu")
    run(cuda)                                              # warm
    got = run(cuda, sync_check=True)
    assert int(got[1]) == int(ref[1]) > 0
    assert ref[2].abs().max() > 0 and (ref[2][0] == 0).all()
    for g, r in ((got[0], ref[0]), (got[2], ref[2])):
        assert ((g - r).abs() <= 1e-9 * (1 + r.abs())).all(), (g, r)


# ---------------------------------------------------------------------------
# the serving artifact: the custom ops and an exported tiny program
# ---------------------------------------------------------------------------

def _op_case(name, device):
    """The positional arguments of one seeded call of each
    ``torch.ops.groomed_nms`` op."""
    rs = np.random.default_rng(len(name))
    boxes_np, scores_np = _nms_case(rs, 2, 300)
    boxes, scores = (torch.from_numpy(x).to(device)
                     for x in (boxes_np, scores_np))
    valid = scores > 0
    if name == "fused_head_scores":
        fused = torch.from_numpy(rs.normal(0, 3, (2, 5000, 18)).astype(
            np.float32)).to(torch.bfloat16).to(device)
        return fused, torch.rand((2, 5000), device=device), 4
    if name == "greedy_nms":
        return boxes, scores, 0.4, 1.0
    if name == "fused_iou_prune":
        return boxes, valid, 0.4, 0.1, "linear", 0.0
    iou = kernels.fused_iou_prune_plain(boxes, valid)[0]
    return iou, valid, 0.4, 100.0


@pytest.mark.parametrize("name", ["fused_head_scores", "greedy_nms",
                                  "fused_iou_prune", "group_leaders"])
def test_custom_op_on_cuda_launches_the_kernel(cuda, name):
    """``torch.ops.groomed_nms.<name>`` on CUDA tensors is the hand-written
    kernel (one launch counted) and agrees with its plain version; on CPU
    copies of the inputs it is the plain version (no launch)."""
    args = _op_case(name, cuda)
    op = getattr(torch.ops.groomed_nms, name)
    wrapper = getattr(kernels, name)
    before = wrapper.launches
    got = op(*args)
    assert wrapper.launches == before + 1
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    ref = op(*cpu_args)
    assert wrapper.launches == before + 1
    torch.cuda.synchronize()
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert g.device.type == "cuda" and g.dtype == r.dtype
        torch.testing.assert_close(g.cpu(), r, rtol=0,
                                   atol=1e-6 if name == "fused_head_scores"
                                   else 0)


@pytest.mark.parametrize("groomed", [False, True])
def test_tiny_artifact_on_cuda_matches_its_live_closure(cuda, groomed):
    """The tiny model's serving program exported on the card, saved, loaded:
    its rows equal the live closure's, its kernels one launch each."""
    from groomed_nms_torch.export import (build_serving_fn, export_serving,
                                          load_serving)

    cfg = RPNConfig(num_anchors=6, prop_features=64,
                    predict_acceptance_prob=True,
                    backbone=tiny_densenet_config())
    rs = np.random.default_rng(1)
    priors = np.concatenate([np.tile([[0, 0, 30, 20]], (6, 1)) * rs.uniform(
        0.5, 2, (6, 1)), np.abs(rs.normal(size=(6, 7))) + 1], 1)
    rois = locate_anchors(priors, (4, 8), 16)
    dcfg = DetectConfig(nms_topN_pre=64, nms_topN_post=8,
                        use_differentiable_nms=groomed, diff_nms_boxes=48,
                        diff_nms_valid_box_prob_threshold=0.05)
    model = init_weights(RPN3D(cfg), torch.Generator().manual_seed(1))
    serve = build_serving_fn(
        model.to(cuda), rois, priors[rois[:, 4].astype(int), 4:],
        np.zeros(13), np.ones(13), np.asarray([0.485, 0.456, 0.406]),
        np.asarray([0.229, 0.224, 0.225]), dcfg, target_h=64, crop_w=128,
        bf16_input=True)
    loaded = load_serving(export_serving(serve, batch=2, src_h=48, src_w=96),
                          "cuda")
    p2 = torch.tensor(np.diag([700.0, 700.0, 1.0, 1.0]), dtype=torch.float32,
                      device=cuda).expand(2, 4, 4).contiguous()
    args = (torch.from_numpy(rs.integers(0, 256, (2, 48, 96, 3)).astype(
        np.uint8)).to(cuda), p2, torch.linalg.inv(p2),
        torch.full((2,), 64 / 48, device=cuda))
    with torch.no_grad():
        want_d, want_v = serve(*args)
    names = ("fused_head_scores", "greedy_nms", "fused_iou_prune",
             "group_leaders")
    before = {n: getattr(kernels, n).launches for n in names}
    got_d, got_v = loaded(*args)
    launched = {n: getattr(kernels, n).launches - before[n] for n in names}
    assert launched == {"fused_head_scores": 1, "greedy_nms": int(not groomed),
                        "fused_iou_prune": int(groomed),
                        "group_leaders": int(groomed)}
    assert torch.equal(got_v, want_v) and want_v.any()
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        loaded(*(a.cpu() for a in args))


def test_refine_detections_on_cuda_matches_cpu(cuda):
    """The hill-climb of final rows card against CPU path in f64, with no
    host synchronisation on the card: the same rows kept, every number
    within 1e-9 of 1 + |x|."""
    from groomed_nms_torch.inference import refine_detections

    rs = np.random.default_rng(2)
    b, k = 4, 40
    d = np.zeros((b, k, 17))
    c = rs.uniform([0, 100], [1200, 300], (b, k, 2))
    wh = rs.uniform(20, 200, (b, k, 2))
    d[..., :2], d[..., 2:4] = c - wh / 2, c + wh / 2
    d[..., 6:8] = c + rs.normal(0, 8, (b, k, 2))
    d[..., 8] = rs.uniform(1, 60, (b, k))
    d[..., 9:12] = rs.uniform([1.4, 1.4, 3.0], [1.9, 1.8, 4.5], (b, k, 3))
    d[..., 16] = rs.uniform(-np.pi, np.pi, (b, k))
    p2 = np.tile(np.eye(4), (b, 1, 1))
    p2[:, 0, 0] = p2[:, 1, 1] = 720.0
    p2[:, 0, 2], p2[:, 1, 2], p2[:, 0, 3] = 610.0, 175.0, 45.0
    args = [torch.from_numpy(a) for a in
            (d, rs.uniform(size=(b, k)) > 0.2, p2, np.linalg.inv(p2))]
    want = refine_detections(*args)
    gpu = [a.to(cuda) for a in args]
    refine_detections(*gpu)                  # the signs' constants copied
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = refine_detections(*gpu)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = got.cpu()
    assert torch.equal((got == args[0]).all(-1), (want == args[0]).all(-1))
    assert ((got - want).abs() / (1 + want.abs())).max() <= 1e-9


def test_jitter_on_cuda_matches_cpu(cuda):
    """fuse_preprocess with photometric jitter on the card: the images of
    the CPU path within 1e-3 on the 0-255 scale beyond the resize's own
    card-vs-CPU distance, for each of four steps' draws."""
    from groomed_nms_torch.training.trainer import fuse_preprocess

    rs = np.random.default_rng(3)
    u8 = torch.from_numpy(rs.integers(0, 256, (4, 96, 320, 3), np.uint8))
    mirror = torch.tensor([True, False, True, False])
    means = torch.tensor([0.485, 0.456, 0.406])
    stds = torch.tensor([0.229, 0.224, 0.225])
    seen = {}

    def run(step, p):
        for dev in ("cpu", cuda):
            fuse_preprocess(lambda s, b: seen.__setitem__(dev, b["images"]),
                            means.to(dev), stds.to(dev), target_h=128,
                            crop_w=416, distort_prob=p, rng_seed=5)(
                SimpleNamespace(step=step), {"images_u8": u8.to(dev),
                                             "mirror": mirror.to(dev)})
        scale = (stds * 255)[None, :, None, None]
        return ((seen[cuda].cpu() - seen["cpu"]) * scale).abs().max().item()

    own = run(0, -1.0)
    for step in range(4):
        assert run(step, 0.5) <= own + 1e-3


@pytest.mark.parametrize("method", ["linear", "gaussian", "hard"])
def test_soft_nms_and_greedy_nms_on_cuda_match_cpu(cuda, method):
    from groomed_nms_torch.ops import nms

    rs = np.random.default_rng(4)
    xy = rs.uniform(0, 600, (300, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rs.uniform(20, 150, (300, 2))], 1).astype(np.float32))
    scores = torch.from_numpy(rs.uniform(0.01, 1, 300).astype(np.float32))
    kw = dict(nms_threshold=0.3, method=method, score_threshold=0.05)
    got = nms.soft_nms(boxes.to(cuda), scores.to(cuda), **kw)
    want = nms.soft_nms(boxes, scores, **kw)
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-6)
    before = kernels.greedy_nms.launches
    keep = nms.greedy_nms(boxes.to(cuda), scores.to(cuda))
    assert kernels.greedy_nms.launches == before + 1
    assert torch.equal(keep.cpu(), nms.greedy_nms(boxes, scores))


def test_roi_align_and_losses_on_cuda_match_cpu(cuda):
    from groomed_nms_torch.losses import ranknet_loss
    from groomed_nms_torch.losses.custom_loss import custom_mse
    from groomed_nms_torch.ops.roi_align import roi_align

    rs = np.random.default_rng(5)
    feats = torch.from_numpy(rs.normal(size=(32, 110, 64)).astype(np.float32))
    xy = rs.uniform(0, [1700, 480], (16, 2))
    rois = torch.from_numpy(np.concatenate(
        [xy, xy + rs.uniform(16, 400, (16, 2))], 1).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        f = feats.to(dev).detach().requires_grad_()
        y = roi_align(f, rois.to(dev), output_size=(7, 7),
                      spatial_scale=1 / 16, reduction="max")
        y.square().sum().backward()
        out[str(dev)] = (y.detach().cpu(), f.grad.cpu())
    for g, w in zip(out[str(cuda)], out["cpu"]):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    s = torch.from_numpy(rs.normal(0, 2, 64).astype(np.float32))
    rel = torch.from_numpy(rs.integers(0, 4, 64).astype(np.float32))
    for fn in (lambda x, d: ranknet_loss(x, rel.to(d)),
               lambda x, d: custom_mse(x, rel.to(d), 2.0)):
        res = []
        for dev in ("cpu", cuda):
            x = s.to(dev).detach().requires_grad_()
            v = fn(x, dev)
            v.backward()
            res.append((v.detach().cpu(), x.grad.cpu()))
        for g, w in zip(res[1], res[0]):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_two_ranks_sharing_the_card_match_one_process(cuda):
    """Data parallelism on the card: the still-image step (GrooMeD-NMS in
    the loss, BatchNorm perturbed, two micro-steps of ``batch_skip`` 2) of
    2 ranks sharing it (gloo on CUDA tensors) against one process on the
    global batch, f64: every tensor within 1e-9 of its largest magnitude,
    the ranks' parameters and running statistics identical."""
    from groomed_nms_torch.parallel.dryrun import step_parity

    worst, key, same, _, rank_stats, one_stats = step_parity(
        2, cuda, torch.float64)
    assert same, "the ranks' parameters or running statistics differ"
    assert worst <= 1e-9, f"{key} off by {worst:.3e} of its max"
    assert rank_stats[0][-1]["fg_num"] == one_stats[-1]["fg_num"] > 0
