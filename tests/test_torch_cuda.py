"""The port's kernels on a CUDA card against their plain versions.

Marked ``cuda``; each test skips when ``torch.cuda.is_available()`` is
False (decided in a fixture, never at import).  This file imports no JAX, so
on a machine without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import copy

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
