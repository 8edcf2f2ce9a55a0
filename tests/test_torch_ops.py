"""PyTorch port vs JAX: box decoding, orientation conversions, IoU, anchors.

The same numpy inputs (seeded) go through both; f32 on the CPU.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu import anchors as jax_anchors
from groomed_nms_tpu.ops import boxes as jax_boxes
from groomed_nms_tpu.ops import geometry as jax_geometry
from groomed_nms_tpu.ops import iou as jax_iou

from groomed_nms_torch import anchors
from groomed_nms_torch.ops import boxes, geometry, iou


def _corner_boxes(rs, n):
    xy = rs.uniform(0, 800, (n, 2))
    wh = rs.uniform(1, 200, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def test_bbox_transform_inv_matches_jax():
    rs = np.random.default_rng(0)
    rois = _corner_boxes(rs, 500).reshape(2, 250, 4)
    deltas = rs.normal(0, 0.5, (2, 250, 4)).astype(np.float32)
    means = rs.normal(0, 0.1, 4).astype(np.float32)
    stds = rs.uniform(0.1, 1, 4).astype(np.float32)
    for m, s in ((None, None), (means, stds)):
        ref = jax_boxes.bbox_transform_inv(
            jnp.asarray(rois), jnp.asarray(deltas),
            means=None if m is None else jnp.asarray(m),
            stds=None if s is None else jnp.asarray(s))
        got = boxes.bbox_transform_inv(
            torch.from_numpy(rois), torch.from_numpy(deltas),
            means=None if m is None else torch.from_numpy(m),
            stds=None if s is None else torch.from_numpy(s))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-4)


def test_orientation_matches_jax():
    rs = np.random.default_rng(1)
    theta = np.concatenate([
        rs.uniform(-4 * math.pi, 4 * math.pi, 1000),
        np.array([-math.pi, math.pi, 3 * math.pi, -3 * math.pi, 0.0,
                  2 * math.pi, -2 * math.pi])]).astype(np.float32)
    np.testing.assert_allclose(
        geometry.snap_to_pi(torch.from_numpy(theta)).numpy(),
        np.asarray(jax_geometry.snap_to_pi(jnp.asarray(theta))), atol=1e-6)
    wrapped = geometry.snap_to_pi(torch.from_numpy(theta)).numpy()
    assert (wrapped > -math.pi).all() and (wrapped <= math.pi + 1e-6).all()

    z = rs.uniform(2, 60, 1000).astype(np.float32)
    x = rs.uniform(-30, 30, 1000).astype(np.float32)
    a = theta[:1000]
    for fn_t, fn_j in ((geometry.alpha_to_rot_y, jax_geometry.alpha_to_rot_y),
                       (geometry.rot_y_to_alpha, jax_geometry.rot_y_to_alpha)):
        got = fn_t(torch.from_numpy(a), torch.from_numpy(z),
                   torch.from_numpy(x)).numpy()
        ref = np.asarray(fn_j(jnp.asarray(a), jnp.asarray(z), jnp.asarray(x)))
        # equal up to the +-pi seam, where one ulp flips the wrap
        diff = np.abs(got - ref)
        diff = np.minimum(diff, np.abs(diff - 2 * math.pi))
        assert diff.max() < 1e-5


@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_pairwise_iou_matches_jax(shift):
    rs = np.random.default_rng(2)
    a = _corner_boxes(rs, 300)
    b = _corner_boxes(rs, 200)
    got = iou.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b),
                           shift=shift).numpy()
    ref = np.asarray(jax_iou.pairwise_iou(jnp.asarray(a), jnp.asarray(b),
                                          shift=shift))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert (got > 0).any()


def test_anchors_exactly_equal():
    scales = np.exp(np.linspace(np.log(32), np.log(384), 12))
    for stride in (16, 8):
        np.testing.assert_array_equal(
            anchors.anchor_center(37.5, 21.0, stride),
            jax_anchors.anchor_center(37.5, 21.0, stride))
        t = anchors.generate_anchor_templates(scales, (0.5, 1.0, 1.5), stride)
        np.testing.assert_array_equal(
            t, jax_anchors.generate_anchor_templates(scales, (0.5, 1.0, 1.5),
                                                     stride))
        for feat in ((32, 110), (4, 8), (3, 5)):
            got = anchors.locate_anchors(t, feat, stride)
            ref = np.asarray(jax_anchors.locate_anchors(t, feat, stride))
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
