"""The port's weight-folded eval engine and K4's plain version vs JAX.

One flax variables tree (``torch_port_common.tiny_models``, BatchNorm
statistics perturbed) drives the JAX ``fast_eval`` functions, with the
Pallas dense block in interpret mode, and the port's ``FastEvalRPN3D``
built from the port's ``RPN3D``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import avg_pool

from groomed_nms_tpu import inference as jax_inf
from groomed_nms_tpu.models.fast_eval import (_fold_bn, _prep_dense_block,
                                              backbone_eval, rpn_eval)
from groomed_nms_tpu.ops.pallas_dense_block import \
    dense_block_eval as jax_dense_block

from groomed_nms_torch import inference
from groomed_nms_torch.anchors import locate_anchors
from groomed_nms_torch.flagship import build_flagship
from groomed_nms_torch.models.fast_eval import (FastEvalBackbone,
                                                FastEvalRPN3D, _avg_pool_2x2,
                                                _FoldedNorm,
                                                check_kernel_dtype)
from groomed_nms_torch.ops import kernels
from groomed_nms_torch.ops.kernels import fold_bn, pack_dense_block
from torch_port_common import tiny_models, to_np


# one JAX init per variant for the whole file; nothing below mutates them
_models = functools.cache(tiny_models)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _block_weights(block, bf16=False):
    """JAX's and the port's packing of one block of the same flax tree, in
    f32 or in bf16."""
    jmodel, variables, tmodel = _models(bf16=bf16)
    bcfg = jmodel.config.backbone
    layers = [getattr(tmodel.backbone, n)
              for n in tmodel.backbone.blocks[block][0]]
    c0, g = layers[0].norm1.num_features, bcfg.growth_rate
    jw = _prep_dense_block(variables["params"]["backbone"],
                           variables["batch_stats"]["backbone"],
                           f"denseblock{block + 1}", len(layers), c0, bcfg)
    tw = pack_dense_block(layers, c0,
                          torch.bfloat16 if bf16 else torch.float32)
    return jw, tw, c0, g, bcfg.block_dilations[block]


@pytest.mark.parametrize("block", [0, 3])
def test_fold_and_pack_match_jax(block):
    jw, tw, c0, g, _ = _block_weights(block)
    jm1, ja1, jw1, jm2, ja2, jw2 = (np.asarray(a) for a in jw)
    tm1, ta1, tw1, tm2, ta2, tw2 = (a.numpy() for a in tw)
    for j, t in ((jm1, tm1), (ja1, ta1), (jm2, tm2), (ja2, ta2)):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    # JAX w1 [L, cmax, bw] -> the port's K-contiguous [L, bw, cmax]
    np.testing.assert_array_equal(tw1, jw1.transpose(0, 2, 1))
    # JAX w2 [L, bw, (tap, G)] -> the port's [L, G, (tap, bw)]
    L, bw = jw2.shape[:2]
    np.testing.assert_array_equal(
        tw2, jw2.reshape(L, bw, 9, g).transpose(0, 3, 2, 1).reshape(
            L, g, 9 * bw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_bn_matches_jax(dtype):
    jmodel, variables, tmodel = _models()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _fold_bn(variables["params"]["backbone"]["norm0"],
                   variables["batch_stats"]["backbone"]["norm0"], jdt)
    got = fold_bn(tmodel.backbone.norm0, dtype)
    for j, t in zip(ref, got):
        assert t.dtype == dtype
        np.testing.assert_allclose(to_np(t), np.asarray(j, np.float32),
                                   rtol=1e-6 if dtype == torch.float32
                                   else 2 ** -8)


_BLOCK_SHAPES = [
    (0, 32, 40),          # H a multiple of the 32-row chunk
    (1, 24, 17),          # H that no chunk of 32 divides, odd W
    (3, 13, 21),          # block 4: dilation 2, odd H and W
]


@pytest.mark.parametrize("block,h,w", _BLOCK_SHAPES)
def test_dense_block_plain_matches_pallas(block, h, w):
    jw, tw, c0, g, dil = _block_weights(block)
    x0 = np.random.default_rng(block).normal(size=(2, h, w, c0)).astype(
        np.float32)
    ref = np.asarray(jax_dense_block(jnp.asarray(x0), *jw, growth=g,
                                     dilation=dil, interpret=True))
    got = kernels.dense_block_eval(_nchw(x0), *tw, dilation=dil)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("block,h,w", _BLOCK_SHAPES)
def test_dense_block_plain_matches_pallas_bf16(block, h, w):
    """bf16 on both sides, rounded at the same points (each folded norm's
    product and sum, the 1x1's sum, h, the new channels).  Only the f32
    sums of the convolutions run in other orders, so an element may land
    one bf16 step apart: measured 99.97% / 99.996% / 99.994% bit-equal,
    mean/mean 6.0e-7 / 7.7e-13 / 7.8e-11 (3.9e-3 and ~37% bit-equal with
    one rounding of ``x * mul + add``)."""
    jw, tw, c0, g, dil = _block_weights(block, bf16=True)
    x0 = np.random.default_rng(block).normal(size=(2, h, w, c0)).astype(
        np.float32)
    ref = np.asarray(jax_dense_block(jnp.asarray(x0, jnp.bfloat16), *jw,
                                     growth=g, dilation=dil, interpret=True),
                     np.float32)
    got = kernels.dense_block_eval(_nchw(x0).to(torch.bfloat16), *tw,
                                   dilation=dil)
    assert got.dtype == torch.bfloat16
    got = to_np(got.permute(0, 2, 3, 1))
    assert np.abs(got - ref).mean() / np.abs(ref).mean() <= 1e-5
    assert (got == ref).mean() >= 0.999


# the dense blocks that K4 runs: the default pair, and all four (as JAX's
# backbone_eval(pallas_blocks=...) allows)
_KERNEL_BLOCK_SETS = [(0, 1), (0, 1, 2, 3)]


@pytest.mark.parametrize("kernel_blocks", _KERNEL_BLOCK_SETS)
def test_backbone_eval_matches_jax_f32(kernel_blocks):
    jmodel, variables, tmodel = _models()
    x = np.random.default_rng(3).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    ref = np.asarray(backbone_eval(variables["params"]["backbone"],
                                   variables["batch_stats"]["backbone"],
                                   jmodel.config.backbone, jnp.asarray(x),
                                   interpret=True,
                                   pallas_blocks=kernel_blocks))
    with torch.no_grad():
        got = FastEvalBackbone(tmodel.backbone, torch.float32,
                               kernel_blocks)(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kernel_blocks", _KERNEL_BLOCK_SETS)
def test_backbone_eval_matches_jax_bf16(kernel_blocks):
    """The bf16 trunk rounds where JAX rounds (folded norms, the 1x1 sums,
    the pool's window order): measured bit-identical; held to mean/mean
    1e-5 and 99.9% bit-equal, the slack of one bf16 step where a
    convolution's f32 sum, in another order, crosses a rounding boundary."""
    jmodel, variables, tmodel = _models(bf16=True)
    x = np.random.default_rng(4).normal(size=(1, 32, 64, 3)).astype(
        np.float32)
    ref = np.asarray(backbone_eval(variables["params"]["backbone"],
                                   variables["batch_stats"]["backbone"],
                                   jmodel.config.backbone, jnp.asarray(x),
                                   interpret=True,
                                   pallas_blocks=kernel_blocks), np.float32)
    with torch.no_grad():
        got = FastEvalBackbone(tmodel.backbone, torch.bfloat16,
                               kernel_blocks)(_nchw(x))
    assert got.dtype == torch.bfloat16
    got = to_np(got.permute(0, 2, 3, 1))
    assert np.abs(got - ref).mean() / np.abs(ref).mean() <= 1e-5
    assert (got == ref).mean() >= 0.999


@pytest.mark.parametrize("relu", [True, False])
def test_folded_norm_bf16_matches_jax(relu):
    """``_FoldedNorm`` in bf16 against JAX's jitted ``x * m + a`` (and its
    ReLU): the product rounded, then the sum; bit-identical."""
    jmodel, variables, tmodel = _models(bf16=True)
    m, a = _fold_bn(variables["params"]["backbone"]["norm0"],
                    variables["batch_stats"]["backbone"]["norm0"],
                    jnp.bfloat16)
    x = np.random.default_rng(7).normal(size=(2, 9, 11, m.shape[0])).astype(
        np.float32) * 3

    def affine(x, m, a):
        y = x * m + a
        return jnp.maximum(y, 0) if relu else y

    ref = to_np(jax.jit(affine)(jnp.asarray(x, jnp.bfloat16), m, a))
    norm = _FoldedNorm(tmodel.backbone.norm0, torch.bfloat16, relu=relu)
    got = norm(_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(got.permute(0, 2, 3, 1)), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(7, 9), (8, 5), (6, 6), (33, 17)])
def test_transition_pool_matches_flax(h, w, dtype):
    """The transitions' 2x2/s2 average pool against flax's ``avg_pool``,
    odd H and W included (the last row or column dropped): bit-identical
    in f32 and in bf16, where ``F.avg_pool2d`` matched 63-70%."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 24)).astype(
        np.float32)
    ref = to_np(jax.jit(lambda x: avg_pool(x, (2, 2), strides=(2, 2)))(
        jnp.asarray(x, jdt)))
    got = _avg_pool_2x2(_nchw(x).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_array_equal(to_np(got.permute(0, 2, 3, 1)), ref)


@pytest.mark.parametrize("device,dtype,blocks,refused", [
    ("cuda", torch.float32, (0, 1), False),
    ("cuda:1", torch.float16, (2,), True),
    ("cuda", torch.float16, (0, 1), True),
    ("cuda", torch.float64, (0, 1), True),
    ("cuda", torch.bfloat16, (0, 1), False),
    ("cuda", torch.float32, (0, 1, 2, 3), False),
    ("cuda", torch.float32, (), False),
    ("cpu", torch.float32, (0, 1), False),
])
def test_kernel_dtype_refusal(device, dtype, blocks, refused):
    """K4 takes bf16 and f32 on a CUDA device: an engine built there with
    kernel blocks in another dtype is refused at build time."""
    if refused:
        with pytest.raises(ValueError, match="bf16 or f32 only"):
            check_kernel_dtype(device, dtype, blocks)
    else:
        check_kernel_dtype(device, dtype, blocks)


def test_flagship_refuses_f32_fast_eval_on_cuda():
    """The flagship's f32 engine runs on the card now; a dtype that K4 does
    not take (f16) is refused before any weight is made or moved, so no
    card is needed."""
    with pytest.raises(ValueError, match="bf16 or f32 only"):
        build_flagship(device="cuda", engine="fast_eval",
                       compute_dtype=torch.float16)


def _detect_args(rs, a, b, feat_hw):
    priors = np.abs(rs.normal(size=(a, 11))).astype(np.float32) + 1.0
    priors[:, 2:4] += priors[:, 0:2] + 16.0
    rois = locate_anchors(priors, feat_hw, 16)
    rois_3d = priors[rois[:, 4].astype(np.int64), 4:]
    p2 = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
    p2[:, 0, 0] = p2[:, 1, 1] = 700.0
    return (rois, rois_3d, p2, np.linalg.inv(p2).astype(np.float32),
            np.ones((b,), np.float32), np.zeros(13, np.float32),
            np.ones(13, np.float32))


@pytest.mark.parametrize("variant", [
    dict(predict_acceptance_prob=True),
    dict(predict_uncertainty=True),
])
def test_rpn_eval_detects_like_jax(variant):
    """rpn_eval -> im_detect_3d in both packages, f32."""
    jmodel, variables, tmodel = _models(**variant)
    rs = np.random.default_rng(5)
    images = rs.normal(size=(2, 64, 96, 3)).astype(np.float32)
    ref = rpn_eval(variables, jnp.asarray(images), jmodel.config,
                   interpret=True)
    with torch.no_grad():
        got = FastEvalRPN3D(tmodel, torch.float32)(_nchw(images))
    np.testing.assert_allclose(to_np(got.fused_raw), np.asarray(ref.fused_raw),
                               atol=5e-4)
    for name in ("accept_prob", "uncertainty"):
        j, t = getattr(ref, name), getattr(got, name)
        assert (j is None) == (t is None), name
        if j is not None:
            np.testing.assert_allclose(to_np(t), np.asarray(j), atol=5e-4)

    args = _detect_args(rs, 6, 2, (4, 6))
    jd, jv = jax_inf.im_detect_3d(
        jax_inf.rpn_outputs_dict(ref), *(jnp.asarray(x) for x in args),
        jax_inf.DetectConfig(nms_topN_pre=64, nms_topN_post=8))
    td, tv = inference.im_detect_3d(
        inference.rpn_outputs_dict(got), *(torch.from_numpy(x) for x in args),
        inference.DetectConfig(nms_topN_pre=64, nms_topN_post=8))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.any()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-3)


@pytest.mark.parametrize("dtype,kernel_blocks", [
    (torch.float32, (0, 1)), (torch.float32, ()),
    (torch.float32, (0, 1, 2, 3)), (torch.bfloat16, (0, 1)),
])
def test_engine_matches_rpn3d(dtype, kernel_blocks):
    """The engine against the port's own RPN3D on the same weights: f32 to
    1e-4; bf16 (folded BatchNorm applied in bf16) to 5% of the scale."""
    _, _, tmodel = _models(predict_acceptance_prob=True)
    x = _nchw(np.random.default_rng(6).normal(size=(2, 64, 128, 3)).astype(
        np.float32))
    engine = FastEvalRPN3D(tmodel, dtype, kernel_blocks)
    with torch.no_grad():
        ref, got = tmodel(x), engine(x)
    assert got.fused_raw.dtype == dtype and got.feat_hw == ref.feat_hw
    tol = 1e-4 if dtype == torch.float32 else \
        0.05 * ref.fused_raw.abs().max().item()
    np.testing.assert_allclose(to_np(got.fused_raw), to_np(ref.fused_raw),
                               atol=tol)
    np.testing.assert_allclose(to_np(got.accept_prob), to_np(ref.accept_prob),
                               atol=1e-5 if dtype == torch.float32 else 0.05)


def test_flagship_engines_agree_on_cpu():
    """``build_flagship(engine=...)``: DenseNet-121 at full width, 64x128,
    f32, both engines from the same seed give the same detections."""
    results = []
    for engine in ("rpn3d", "fast_eval"):
        infer, args, model = build_flagship(
            batch=1, height=64, width=128, device="cpu", compute_dtype=None,
            src_hw=(48, 96), engine=engine)
        results.append(infer(*args))
    assert isinstance(model, FastEvalRPN3D)
    (d1, v1), (d2, v2) = results
    assert torch.equal(v1, v2) and v1.any()
    torch.testing.assert_close(d2[v2], d1[v1], rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError):
        build_flagship(device="cpu", engine="no_such_engine")


def _block_args(c0=16, layers=2, growth=8, bw=32, h=7, w=9):
    g = torch.Generator().manual_seed(0)
    cmax = c0 + layers * growth
    return [torch.randn(s, generator=g) for s in (
        (2, c0, h, w), (layers, cmax), (layers, cmax), (layers, bw, cmax),
        (layers, bw), (layers, bw), (layers, growth, 9 * bw))]


def _bad(i, fn):
    def make():
        args = _block_args()
        args[i] = fn(args[i])
        return args
    return make


@pytest.mark.parametrize("make,kw", [
    (_bad(0, lambda t: t[0]), {}),                       # x0 not 4-D
    (_bad(0, lambda t: t.half()), {}),                   # unsupported dtype
    (_bad(0, lambda t: t[:, :8]), {}),                   # cmax != c0 + L*G
    (_bad(1, lambda t: t[:, :-1].contiguous()), {}),     # mul1 shape
    (_bad(3, lambda t: t.double()), {}),                 # w1 dtype
    (_bad(3, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)), {}),
    (_bad(6, lambda t: t[..., :-1].contiguous()), {}),   # w2 shape
    (_block_args, {"dilation": 0}),
    (_block_args, {"dilation": 1.5}),
    (lambda: [t.to("meta") for t in _block_args()], {}),  # not CPU, not CUDA
])
def test_dense_block_wrapper_refuses_bad_input(make, kw):
    with pytest.raises(ValueError):
        kernels.dense_block_eval(*make(), **kw)


@pytest.mark.parametrize("dims,gflop,mbytes", [
    ((8, 64, 128, 440, 6, 32, 128), "298.97", "288.4"),   # block 1
    ((8, 128, 64, 220, 12, 32, 128), "204.85", "144.2"),  # block 2
])
def test_dense_block_work_of_the_flagship(dims, gflop, mbytes):
    flop, nbytes = kernels.dense_block_work(*dims)
    assert f"{flop / 1e9:.2f}" == gflop and f"{nbytes / 1e6:.1f}" == mbytes


@pytest.mark.parametrize("dims", [
    (8, 64, 128, 440, 6, 32, 128), (8, 128, 64, 220, 12, 32, 128),
    (8, 256, 32, 110, 24, 32, 128), (8, 512, 32, 110, 16, 32, 128),
])
def test_dense_block_work_counts_four_bytes_in_f32(dims):
    """The same FLOP in f32, and 4 bytes an element: twice bf16's bytes
    (block 1: 576.7 MB)."""
    flop2, bytes2 = kernels.dense_block_work(*dims)
    flop4, bytes4 = kernels.dense_block_work(*dims, elem_bytes=4)
    assert flop4 == flop2 and bytes4 == 2 * bytes2
    b, c0, h, w, layers, growth, _ = dims
    assert bytes4 == b * h * w * (2 * c0 + layers * growth) * 4
    if dims[1] == 64:
        assert f"{bytes4 / 1e6:.1f}" == "576.7"


def test_dense_block_work_counts_each_conv():
    # 2 images x 7 x 9 pixels, cin 16 then 24, 9 taps x 8 channels twice,
    # bw 32; x0 (16 channels) read and the 32-channel stack written, bf16
    assert kernels.dense_block_work(2, 16, 7, 9, 2, 8, 32) == (
        2 * 126 * 32 * (16 + 24 + 9 * 8 * 2), 126 * (16 + 32) * 2)


def test_dense_block_wrapper_runs_plain_on_cpu_uncounted():
    args = _block_args()
    before = kernels.dense_block_eval.launches
    got = kernels.dense_block_eval(*args, dilation=2)
    assert kernels.dense_block_eval.launches == before
    torch.testing.assert_close(
        got, kernels.dense_block_eval_plain(*args, dilation=2), rtol=0,
        atol=0)
    assert got.shape == (2, 32, 7, 9)
    torch.testing.assert_close(got[:, :16], args[0], rtol=0, atol=0)
