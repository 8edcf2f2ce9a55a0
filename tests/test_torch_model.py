"""The port's RPN3D (weights through ``from_flax``) and preprocess vs JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu.data.augment import preprocess_images as jax_preprocess

from groomed_nms_torch.data.augment import preprocess_images
from torch_port_common import jax_apply, tiny_models, to_np

MEANS = (0.485, 0.456, 0.406)
STDS = (0.229, 0.224, 0.225)


def _images(seed, b=2, h=64, w=128):
    return np.random.default_rng(seed).normal(size=(b, h, w, 3)).astype(
        np.float32)


def _run_both(jmodel, variables, tmodel, x, amp=None):
    jout = jax_apply(jmodel, variables, x)
    with torch.no_grad(), (torch.autocast("cpu", dtype=amp) if amp
                           else torch.autocast("cpu", enabled=False)):
        tout = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
    return jout, tout


@pytest.mark.parametrize("variant", [
    dict(predict_acceptance_prob=True),
    dict(predict_acceptance_prob=True, predict_uncertainty=True),
    dict(predict_acceptance_prob=True, acceptance_prob_mode="classify",
         acceptance_prob_classify_bins=3, acceptance_prob_num_layers=2),
])
def test_rpn3d_f32_matches_jax(variant):
    jmodel, variables, tmodel = tiny_models(seed=1, **variant)
    x = _images(1)
    jout, tout = _run_both(jmodel, variables, tmodel, x)
    assert tout.feat_hw == tuple(jout.feat_hw) == (4, 8)
    assert tout.fused_raw.shape == jout.fused_raw.shape
    for name in ("fused_raw", "cls", "prob", "bbox_2d", "bbox_3d",
                 "accept_prob", "accept_cls", "uncertainty"):
        j, t = getattr(jout, name), getattr(tout, name)
        assert (j is None) == (t is None), name
        if j is not None:
            np.testing.assert_allclose(to_np(t), np.asarray(j), atol=1e-4,
                                       err_msg=name)
    if variant.get("predict_uncertainty"):
        assert tout.uncertainty is not None


def test_rpn3d_bf16_matches_jax_loosely():
    """bf16 rounds at other places in the two frameworks: JAX applies the
    folded BatchNorm (mul, add) in bf16, torch autocast keeps BatchNorm in
    f32 and rounds its output.  Both trunks are held against the same f32
    reference at a bf16 tolerance, and against each other at twice it."""
    jmodel16, variables, tmodel = tiny_models(seed=2, bf16=True,
                                              predict_acceptance_prob=True)
    jmodel32, _, _ = tiny_models(seed=2, predict_acceptance_prob=True)
    x = _images(2)
    j16, t16 = _run_both(jmodel16, variables, tmodel, x, amp=torch.bfloat16)
    j32 = jax_apply(jmodel32, variables, x)
    assert t16.fused_raw.dtype == torch.bfloat16
    ref = np.asarray(j32.fused_raw)
    scale = np.abs(ref).max()
    tol = 0.05 * scale
    for got in (to_np(t16.fused_raw), np.asarray(j16.fused_raw, np.float32)):
        assert np.abs(got - ref).max() < tol
    assert np.abs(to_np(t16.fused_raw)
                  - np.asarray(j16.fused_raw, np.float32)).max() < 2 * tol
    np.testing.assert_allclose(to_np(t16.prob), np.asarray(j16.prob), atol=0.05)
    np.testing.assert_allclose(to_np(t16.accept_prob),
                               np.asarray(j16.accept_prob), atol=0.05)


@pytest.mark.parametrize("src_hw,mirror", [
    ((48, 96), (False, True)),          # upsampling, fills the crop exactly
    ((375, 1242), (True, False)),       # KITTI 375 -> 64: downsampling, crop
    ((96, 150), (False, False)),        # downsampling, pad to the crop
])
def test_preprocess_matches_jax(src_hw, mirror):
    rs = np.random.default_rng(3)
    imgs = rs.integers(0, 256, (2, *src_hw, 3)).astype(np.uint8)
    mirror = np.asarray(mirror)
    ref = np.asarray(jax_preprocess(
        jnp.asarray(imgs), jnp.asarray(mirror), jnp.asarray(MEANS),
        jnp.asarray(STDS), target_h=64, crop_w=128))
    got = preprocess_images(torch.from_numpy(imgs), torch.from_numpy(mirror),
                            MEANS, STDS, target_h=64, crop_w=128)
    assert got.shape == (2, 3, 64, 128)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-4)


def test_preprocess_kitti_upsampling_matches_jax():
    """KITTI's own ratio, 375 -> 512 rows, and the zero padding of the
    width 1696 -> 1760 before normalisation."""
    rs = np.random.default_rng(4)
    imgs = rs.integers(0, 256, (1, 375, 1242, 3)).astype(np.uint8)
    ref = np.asarray(jax_preprocess(
        jnp.asarray(imgs), jnp.zeros((1,), bool), jnp.asarray(MEANS),
        jnp.asarray(STDS), target_h=512, crop_w=1760))
    got = preprocess_images(torch.from_numpy(imgs), None, MEANS, STDS,
                            target_h=512, crop_w=1760,
                            out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2)   # bf16 output rounding
    f32 = preprocess_images(torch.from_numpy(imgs), None, MEANS, STDS,
                            target_h=512, crop_w=1760)
    np.testing.assert_allclose(f32.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-4)
