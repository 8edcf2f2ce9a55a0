"""The port's kernels (their plain versions, which the CPU runs) vs the JAX
Pallas kernels in interpret mode, and the top-k tie order vs ``lax.top_k``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu.inference import DetectConfig as JaxDetectConfig
from groomed_nms_tpu.inference import select_top_pre_nms as jax_select
from groomed_nms_tpu.ops.pallas_kernels import (fused_head_scores as
                                                jax_head_scores,
                                                greedy_nms_pallas)

from groomed_nms_torch.inference import (DetectConfig, select_top_pre_nms,
                                         top_k_indices)
from groomed_nms_torch.ops import kernels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,r,per,c", [(2, 640, 18, 4), (1, 100, 19, 4),
                                       (3, 1300, 9, 2)])
def test_head_scores_plain_matches_pallas(b, r, per, c, dtype):
    rs = np.random.default_rng(2)
    x = (rs.normal(size=(b, r, per)) * 3).astype(np.float32)
    accept = rs.uniform(0.1, 1, (b, r)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for acc in (None, accept):
        ref = jax_head_scores(xj, None if acc is None else jnp.asarray(acc),
                              num_classes=c, interpret=True)
        got = kernels.fused_head_scores(
            xt, None if acc is None else torch.from_numpy(acc), num_classes=c)
        assert got.dtype == torch.float32 and got.shape == (b, r)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_head_scores_wrapper_checks_and_counts():
    x = torch.randn(2, 50, 18)
    before = kernels.fused_head_scores.launches
    out = kernels.fused_head_scores(x, num_classes=4)
    torch.testing.assert_close(
        out, kernels.fused_head_scores_plain(x, num_classes=4),
        rtol=0, atol=0)
    # the CPU path is the plain version: no kernel launch is counted
    assert kernels.fused_head_scores.launches == before
    with pytest.raises(ValueError):
        kernels.fused_head_scores(x.transpose(0, 1), num_classes=4)
    with pytest.raises(ValueError):
        kernels.fused_head_scores(x.double(), num_classes=4)
    with pytest.raises(ValueError):
        kernels.fused_head_scores(x, torch.ones(2, 49), num_classes=4)
    with pytest.raises(ValueError):
        kernels.fused_head_scores(x, num_classes=19)


def _nms_case(rs, b, n):
    """Score-sorted clustered boxes with equal scores and padding rows."""
    boxes = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        centers = rs.uniform([0, 0], [800, 300], (12, 2))
        c = centers[rs.integers(0, 12, n)] + rs.normal(0, 10, (n, 2))
        wh = rs.uniform(10, 150, (n, 2))
        boxes[i, :, :2] = c - wh / 2
        boxes[i, :, 2:] = c + wh / 2
    scores = np.round(rs.uniform(0.01, 1, (b, n)), 2).astype(np.float32)
    scores = -np.sort(-scores, axis=1)            # many exact ties
    scores[:, -n // 8:] = 0.0                     # padding rows
    scores[0, n // 3] = 0.0                       # a padding row mid-list
    return boxes, scores


@pytest.mark.parametrize("b,n", [(2, 300), (3, 700), (1, 65)])
def test_greedy_nms_plain_matches_pallas(b, n):
    boxes, scores = _nms_case(np.random.default_rng(n), b, n)
    ref = np.asarray(greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                                       nms_threshold=0.4, shift=1.0,
                                       interpret=True))
    got = kernels.greedy_nms(torch.from_numpy(boxes),
                             torch.from_numpy(scores), nms_threshold=0.4,
                             shift=1.0)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < (scores > 0).sum()     # clusters were suppressed
    assert not ref[scores <= 0].any()


def test_greedy_nms_wrapper_checks():
    boxes = torch.zeros(2, 10, 4)
    scores = torch.ones(2, 10)
    with pytest.raises(ValueError):
        kernels.greedy_nms(boxes, scores[:, :9])
    with pytest.raises(ValueError):
        kernels.greedy_nms(boxes.double(), scores)
    with pytest.raises(ValueError):
        kernels.greedy_nms(boxes.transpose(0, 1).contiguous().transpose(0, 1),
                           scores)
    before = kernels.greedy_nms.launches
    kernels.greedy_nms(boxes, scores)
    assert kernels.greedy_nms.launches == before


def test_top_k_tie_order_matches_lax():
    rs = np.random.default_rng(5)
    scores = rs.integers(0, 6, (3, 500)).astype(np.float32) / 5.0
    for k in (1, 37, 500):
        _, ref = jax.lax.top_k(jnp.asarray(scores), k)
        got = top_k_indices(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_select_top_pre_nms_ties_match_jax():
    """A constant head region (as the zero-padded columns of a frame give)
    yields exact score ties; both packages must gather the same rows."""
    rs = np.random.default_rng(6)
    b, r, per = 2, 600, 18
    fused = (rs.normal(size=(b, r, per)) * 2).astype(np.float32)
    fused[:, 200:500] = fused[:, 200:201]            # 300 tied rows
    fused = np.array(jnp.asarray(fused, jnp.bfloat16).astype(jnp.float32))
    accept = rs.uniform(0.2, 1, (b, r)).astype(np.float32)
    accept[:, 200:500] = 0.5
    rois = np.concatenate([rs.uniform(0, 500, (r, 4)),
                           np.arange(r)[:, None]], 1).astype(np.float32)
    rois_3d = rs.normal(size=(r, 7)).astype(np.float32)
    jcfg = JaxDetectConfig(nms_topN_pre=400)
    jsel, jrois, jrois3d = jax_select(
        {"fused_raw": jnp.asarray(fused, jnp.bfloat16),
         "accept_prob": jnp.asarray(accept)},
        jnp.asarray(rois), jnp.asarray(rois_3d), jcfg)
    sel, trois, trois3d = select_top_pre_nms(
        {"fused_raw": torch.from_numpy(fused).bfloat16(),
         "accept_prob": torch.from_numpy(accept)},
        torch.from_numpy(rois), torch.from_numpy(rois_3d),
        DetectConfig(nms_topN_pre=400))
    np.testing.assert_array_equal(trois.numpy(), np.asarray(jrois))
    np.testing.assert_array_equal(trois3d.numpy(), np.asarray(jrois3d))
    for key in ("prob", "bbox_2d", "bbox_3d", "accept_prob"):
        np.testing.assert_allclose(sel[key].numpy(), np.asarray(jsel[key]),
                                   atol=1e-6)
