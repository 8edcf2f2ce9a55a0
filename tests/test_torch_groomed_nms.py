"""The port's GrooMeD-NMS operator and K3's plain version against JAX.

K3 runs on the JAX side as its Pallas kernel in interpret mode; the port
runs its plain PyTorch versions (the CPU path), K3's and the grouping
kernel's (``kernels.group_leaders``).  Inputs come from numpy
seeds.  Tolerances: K3 at atol 1e-6 (the same f32 operations in the same
order); rescored values at atol 1e-6 with identical keep and leader
(integer decisions); score gradients at rtol 1e-4, atol 1e-6 (sums over
up to N terms in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groomed_nms_tpu.ops import groomed_nms as jgn
from groomed_nms_tpu.ops.iou import pairwise_iou as jax_pairwise_iou
from groomed_nms_tpu.ops.pallas_kernels import fused_iou_prune as jax_k3

from groomed_nms_torch.ops import groomed_nms as tgn
from groomed_nms_torch.ops.geometry import get_corners_of_cuboid
from groomed_nms_torch.ops.iou import iou3d_approximate, pairwise_iou
from groomed_nms_torch.ops import kernels
from groomed_nms_torch.ops.kernels import (fused_iou_prune,
                                           fused_iou_prune_plain)

K3_ATOL = 1e-6
RESCORE_ATOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _boxes(rs, b, n):
    """Clustered [B, N, 4] f32 boxes: groups of overlapping boxes, exact
    duplicates, and a few boxes far from the rest."""
    out = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        centers = rs.uniform([0, 0], [600, 200], (max(n // 12, 2), 2))
        c = centers[rs.integers(0, len(centers), n)] + rs.normal(0, 6, (n, 2))
        wh = rs.uniform(15, 70, (n, 2))
        out[i, :, :2] = c - wh / 2
        out[i, :, 2:] = c + wh / 2
        out[i, 1::17] = out[i, 0:n - 1:17]              # exact duplicates
    return out


def _scores(rs, b, n):
    """Descending-unsorted scores in [0.05, 1) with ties (two decimals)."""
    return np.round(rs.uniform(0.05, 1.0, (b, n)), 2).astype(np.float32)


def _valid(b, n, n_pad):
    v = np.ones((b, n), bool)
    if n_pad:
        v[:, n - n_pad:] = False
    return v


# ---------------------------------------------------------------------------
# K3: fused_iou_prune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [100, 300, 512])
@pytest.mark.parametrize("method", ["linear", "sigmoidal", "soft_nms"])
def test_k3_plain_matches_jax_kernel(n, method):
    rs = np.random.default_rng(n)
    boxes = _boxes(rs, 2, n)
    valid = _valid(2, n, n // 10)
    kw = dict(nms_threshold=0.4, temperature=0.1, pruning_method=method)
    iou, prune = fused_iou_prune_plain(torch.from_numpy(boxes),
                                       torch.from_numpy(valid), **kw)
    for i in range(2):
        j_iou, j_prune = jax_k3(jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
                                interpret=True, **kw)
        np.testing.assert_allclose(iou[i].numpy(), np.asarray(j_iou),
                                   rtol=0, atol=K3_ATOL)
        np.testing.assert_allclose(prune[i].numpy(), np.asarray(j_prune),
                                   rtol=0, atol=K3_ATOL)
    # strictly lower triangular, padding zeroed
    assert not torch.triu(prune, 0).any()
    pad = ~torch.from_numpy(valid)
    assert not iou[pad].any() and not iou.transpose(1, 2)[pad].any()


def test_k3_wrapper_on_cpu_is_the_plain_version():
    rs = np.random.default_rng(7)
    boxes = torch.from_numpy(_boxes(rs, 3, 64))
    before = fused_iou_prune.launches
    iou, prune = fused_iou_prune(boxes, None, pruning_method="sigmoidal")
    assert fused_iou_prune.launches == before       # the plain path
    ref = fused_iou_prune_plain(boxes, torch.ones(3, 64, dtype=torch.bool),
                                pruning_method="sigmoidal")
    assert torch.equal(iou, ref[0]) and torch.equal(prune, ref[1])
    assert not iou.requires_grad


@pytest.mark.parametrize("bad", [
    dict(boxes=torch.zeros(2, 5, 3)),
    dict(boxes=torch.zeros(2, 5, 4, dtype=torch.float64)),
    dict(valid=torch.ones(2, 4, dtype=torch.bool)),
    dict(valid=torch.ones(2, 5)),
    dict(pruning_method="cubic"),
])
def test_k3_wrapper_refuses_bad_arguments(bad):
    args = dict(boxes=torch.zeros(2, 5, 4), valid=None,
                pruning_method="linear")
    args.update(bad)
    with pytest.raises(ValueError):
        fused_iou_prune(args["boxes"], args["valid"],
                        pruning_method=args["pruning_method"])


@pytest.mark.parametrize("n,n_pad", [(1, 0), (64, 0), (100, 13),
                                     (512, 51), (1000, 0)])
def test_k3_plain_iou_is_bitwise_symmetric(n, n_pad):
    """The premise of K3's mirrored tiles: iou[i, j] and iou[j, i] are the
    same f32 (min, max, the product and area_i + area_j commute)."""
    rs = np.random.default_rng(n + 1)
    boxes = _boxes(rs, 2, n)
    boxes[1] *= np.float32(1e3)                # other magnitudes
    valid = torch.from_numpy(_valid(2, n, n_pad))
    for shift in (0.0, 1.0):
        iou, _ = fused_iou_prune_plain(torch.from_numpy(boxes), valid,
                                       shift=shift)
        bits = iou.view(torch.int32)
        assert torch.equal(bits, bits.transpose(1, 2))


def test_k3_work_is_pinned():
    """K3's least work (chip_smoke.py's bound): 16 f32 operations a pair of
    boxes, boxes and valid flags read, both f32 matrices written."""
    assert kernels.iou_prune_work(8, 512) == (8 * 512 * 511 // 2 * 16,
                                              8 * 512 * 17 + 2 * 8 * 512 * 512 * 4)
    assert kernels.iou_prune_work(1, 1) == (0, 17 + 8)


# ---------------------------------------------------------------------------
# the operator's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,t", [("linear", 0.01), ("sigmoidal", 0.1),
                                      ("soft_nms", 0.5)])
def test_pruning_function_matches_jax(method, t):
    o = np.random.default_rng(1).uniform(0, 1, (50,)).astype(np.float32)
    got = tgn.pruning_function(torch.from_numpy(o), 0.4, t, method)
    ref = jgn.pruning_function(jnp.asarray(o), 0.4, t, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("reference_norm", [False, True])
def test_soft_sort_matches_jax(reference_norm):
    rs = np.random.default_rng(2)
    s = rs.uniform(0, 1, 40).astype(np.float32)
    m = rs.uniform(0, 1, (40, 40)).astype(np.float32)
    got = tgn.soft_sort(torch.from_numpy(s), torch.from_numpy(m), 0.05,
                        reference_norm)
    ref = jgn.soft_sort(jnp.asarray(s), jnp.asarray(m), 0.05, reference_norm)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def _grouping_case(rs, n, asymmetric):
    """A score-sorted overlap matrix: IoUs of clustered boxes (symmetric) or
    a row-mixed copy of them (asymmetric, like reference_soft_sort's)."""
    boxes = _boxes(rs, 1, n)[0]
    m = np.array(jax_pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    if asymmetric:
        w = rs.dirichlet(np.ones(n) * 0.05, n).astype(np.float32)
        m = (0.5 * m + 0.5 * (w @ m)).astype(np.float32)
    return m


@pytest.mark.parametrize("n,n_pad,group_size,asymmetric", [
    (60, 0, 100, False), (60, 7, 100, False), (96, 10, 2, False),
    (96, 0, 0, False), (80, 0, 100, True), (80, 0, 3, True),
    (1, 0, 100, False), (5, 5, 100, False),
])
def test_group_leaders_match_jax(n, n_pad, group_size, asymmetric):
    rs = np.random.default_rng(n + n_pad + group_size)
    m = _grouping_case(rs, n, asymmetric)
    valid = _valid(1, n, n_pad)[0]
    s = np.sort(_scores(rs, 1, n)[0])[::-1].copy()     # ties included
    ref = jgn.group_leaders(jnp.asarray(m), jnp.asarray(s),
                            jnp.asarray(valid), 0.4, group_size)
    got = tgn.group_leaders(torch.from_numpy(m), torch.from_numpy(s),
                            torch.from_numpy(valid), 0.4, group_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # batched: the same rows in a batch of three images
    got_b = tgn.group_leaders(torch.from_numpy(np.stack([m, m.T, m])),
                              torch.from_numpy(np.stack([s] * 3)),
                              torch.from_numpy(np.stack([valid] * 3)),
                              0.4, group_size)
    assert torch.equal(got_b[0], got) and torch.equal(got_b[2], got)
    ref_t = jgn.group_leaders(jnp.asarray(m.T), jnp.asarray(s),
                              jnp.asarray(valid), 0.4, group_size)
    np.testing.assert_array_equal(got_b[1].numpy(), np.asarray(ref_t))


def _kernel_grouping_case(rs, b, n, asymmetric):
    """m [b, n, n] f32 from clustered boxes (a row-mixed copy when
    asymmetric), 5% of the entries set exactly to the 0.4 threshold, and
    valid [b, n] with holes and padding at the end."""
    m = np.stack([_grouping_case(rs, n, asymmetric) for _ in range(b)])
    m[rs.uniform(size=m.shape) < 0.05] = np.float32(0.4)
    valid = rs.uniform(size=(b, n)) > 0.15
    valid[:, n - n // 8:] = False
    return m, valid


@pytest.mark.parametrize("group_size", [-1, 0, 1, 100])
@pytest.mark.parametrize("asymmetric", [False, True])
@pytest.mark.parametrize("n", [1, 70, 130])
def test_group_leaders_kernel_on_cpu_matches_jax(n, asymmetric, group_size):
    """kernels.group_leaders on CPU tensors is its plain version and equals
    JAX's group_leaders image by image: ties at the threshold are not over,
    padding holes never lead or join, a negative group size caps every row
    out."""
    rs = np.random.default_rng(n * 7 + group_size + asymmetric)
    m, valid = _kernel_grouping_case(rs, 3, n, asymmetric)
    before = kernels.group_leaders.launches
    got = kernels.group_leaders(torch.from_numpy(m), torch.from_numpy(valid),
                                nms_threshold=0.4, group_size=group_size)
    assert kernels.group_leaders.launches == before        # the plain path
    assert got.dtype == torch.int64 and got.shape == (3, n)
    ref_plain = kernels.group_leaders_plain(
        torch.from_numpy(m), torch.from_numpy(valid), nms_threshold=0.4,
        group_size=group_size)
    assert torch.equal(got, ref_plain)
    for i in range(3):
        s = np.linspace(1.0, 0.1, n, dtype=np.float32)
        ref = jgn.group_leaders(jnp.asarray(m[i]), jnp.asarray(s),
                                jnp.asarray(valid[i]), 0.4, group_size)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
    assert not bool((got[torch.from_numpy(~valid)] >= 0).any())
    if group_size < 0:
        assert bool((got == -1).all())


@pytest.mark.parametrize("bad", ["rank", "dtype", "non_square",
                                 "non_contiguous", "valid_shape",
                                 "valid_dtype", "valid_non_contiguous"])
def test_group_leaders_wrapper_refuses_bad_arguments(bad):
    m = torch.zeros(2, 6, 6)
    valid = torch.ones(2, 6, dtype=torch.bool)
    if bad == "rank":
        m = m[0]
    elif bad == "dtype":
        m = m.double()
    elif bad == "non_square":
        m = torch.zeros(2, 6, 5)
    elif bad == "non_contiguous":
        m = m.transpose(1, 2)
    elif bad == "valid_shape":
        valid = valid[:, :5]
    elif bad == "valid_dtype":
        valid = valid.float()
    elif bad == "valid_non_contiguous":
        valid = torch.ones(6, 2, dtype=torch.bool).T
    with pytest.raises(ValueError):
        kernels.group_leaders(m, valid, nms_threshold=0.4, group_size=100)


def test_group_leaders_work_is_pinned():
    """The grouping's least work (chip_smoke.py's bound): m's strict lower
    triangle read once, valid read, int64 leaders written."""
    assert kernels.group_leaders_work(8, 512) == (
        8 * 512 * 511 // 2, 8 * 512 * 511 // 2 * 4 + 8 * 512 * 9)


# ---------------------------------------------------------------------------
# differentiable_nms: every mode, values and gradients
# ---------------------------------------------------------------------------

MODES = {
    "masked": dict(),
    "masked_sigmoidal": dict(pruning_method="sigmoidal", temperature=0.1),
    "masked_soft_nms": dict(pruning_method="soft_nms", temperature=0.5),
    "unmasked": dict(mask_group_boxes=False),
    "no_group": dict(group_boxes=False),
    "capped": dict(group_size=2),
    "soft": dict(sorting_method="soft", sorting_temperature=0.05),
    "soft_unmasked": dict(sorting_method="soft", sorting_temperature=0.05,
                          mask_group_boxes=False),
    "reference_soft_sort": dict(sorting_method="soft", temperature=0.1,
                                reference_soft_sort=True),
}


def _nms_case(rs, n, n_pad):
    boxes = _boxes(rs, 1, n)[0]
    iou = np.array(jax_pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    return _scores(rs, 1, n)[0], iou, _valid(1, n, n_pad)[0]


@pytest.mark.parametrize("mode", list(MODES))
def test_differentiable_nms_matches_jax(mode):
    kw = MODES[mode]
    n, n_pad = 64, (0 if mode == "reference_soft_sort" else 9)
    rs = np.random.default_rng(len(mode))
    scores, iou, valid = _nms_case(rs, n, n_pad)
    weights = rs.normal(size=n).astype(np.float32)

    ref = jgn.differentiable_nms(jnp.asarray(scores), jnp.asarray(iou),
                                 jnp.asarray(valid), **kw)
    ref_grad = jax.grad(lambda s: jnp.sum(jgn.differentiable_nms(
        s, jnp.asarray(iou), jnp.asarray(valid), **kw).rescored
        * weights))(jnp.asarray(scores))

    s_t = torch.from_numpy(scores).requires_grad_()
    got = tgn.differentiable_nms(s_t, torch.from_numpy(iou),
                                 torch.from_numpy(valid), **kw)
    (got.rescored * torch.from_numpy(weights)).sum().backward()

    np.testing.assert_array_equal(got.leader.numpy(), np.asarray(ref.leader))
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(ref.keep))
    np.testing.assert_allclose(got.rescored.detach().numpy(),
                               np.asarray(ref.rescored), rtol=0,
                               atol=RESCORE_ATOL)
    assert np.abs(np.asarray(ref_grad)).max() > 0
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(ref_grad),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_differentiable_nms_batched_matches_per_image():
    rs = np.random.default_rng(11)
    cases = [_nms_case(rs, 48, p) for p in (0, 5, 30)]
    s, iou, v = (torch.from_numpy(np.stack(x)) for x in zip(*cases))
    got = tgn.differentiable_nms(s, iou, v, mask_group_boxes=False)
    for i, (si, ioui, vi) in enumerate(cases):
        ref = jgn.differentiable_nms(jnp.asarray(si), jnp.asarray(ioui),
                                     jnp.asarray(vi), mask_group_boxes=False)
        np.testing.assert_array_equal(got.leader[i].numpy(),
                                      np.asarray(ref.leader))
        np.testing.assert_allclose(got.rescored[i].numpy(),
                                   np.asarray(ref.rescored), rtol=0,
                                   atol=RESCORE_ATOL)


def test_differentiable_nms_indices_match_jax():
    rs = np.random.default_rng(12)
    scores, iou, _ = _nms_case(rs, 40, 0)
    got = tgn.differentiable_nms_indices(scores, iou, nms_threshold=0.4)
    ref = jgn.differentiable_nms_indices(scores, iou, nms_threshold=0.4)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], atol=RESCORE_ATOL)


# ---------------------------------------------------------------------------
# the K3 path: sorted boxes -> K3 -> differentiable_nms_sorted
# ---------------------------------------------------------------------------

def _corners(rs, b, n):
    x = rs.uniform(-10, 10, (b, n)).astype(np.float32)
    z = rs.uniform(10, 40, (b, n)).astype(np.float32)
    y = rs.uniform(1, 2, (b, n)).astype(np.float32)
    dims = rs.uniform(1, 4, (3, b, n)).astype(np.float32)
    ry = rs.uniform(-3, 3, (b, n)).astype(np.float32)
    # every fifth cuboid has a near copy next to it
    x[:, 1::5], z[:, 1::5] = x[:, ::5] + 0.3, z[:, ::5] + 0.2
    return get_corners_of_cuboid(*(torch.from_numpy(a) for a in
                                   (x, y, z, dims[0], dims[1], dims[2], ry)))


@pytest.mark.parametrize("overlap", ["2d", "3d", "2d_3d"])
@pytest.mark.parametrize("mode", ["masked", "masked_sigmoidal", "unmasked",
                                  "no_group"])
def test_k3_sorted_path_equals_differentiable_nms(mode, overlap):
    kw = {"temperature": 0.1, **MODES[mode]}
    rs = np.random.default_rng(3)
    b, n = 3, 120
    boxes = torch.from_numpy(_boxes(rs, b, n))
    scores = torch.from_numpy(_scores(rs, b, n)).requires_grad_()
    valid = torch.from_numpy(_valid(b, n, 0))
    valid[1, 100:] = False
    valid[2, ::3] = False                        # padding between real rows
    corners = _corners(rs, b, n)

    got = tgn.groomed_nms_boxes(scores, boxes, valid, corners=corners,
                                overlap_in_nms=overlap, **kw)
    (got.rescored * torch.arange(n)).sum().backward()
    g_got = scores.grad.clone()
    scores.grad = None

    iou = pairwise_iou(boxes, boxes)
    if overlap != "2d":
        _, g3d = iou3d_approximate(corners, corners, pairwise=True,
                                   generalized=True)
        g3d = 0.5 * (1.0 + g3d)
        iou = torch.nan_to_num(g3d if overlap == "3d" else iou * g3d, nan=0.0)
    ref = tgn.differentiable_nms(scores, iou, valid, **kw)
    (ref.rescored * torch.arange(n)).sum().backward()
    assert torch.equal(got.leader, ref.leader)
    assert torch.equal(got.keep, ref.keep)
    torch.testing.assert_close(got.rescored, ref.rescored, rtol=0,
                               atol=RESCORE_ATOL)
    torch.testing.assert_close(g_got, scores.grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# golden cases (the reference's manual test scripts)
# ---------------------------------------------------------------------------

def test_golden_case_4boxes():
    iou = torch.tensor([[1.00, 0.00, 0.00, 0.00],
                        [0.00, 1.00, 0.00, 0.00],
                        [0.90, 0.90, 1.00, 0.00],
                        [0.00, 0.00, 0.00, 1.00]])
    scores = torch.tensor([0.99, 0.98, 0.8, 0.7])
    res = tgn.differentiable_nms(scores, iou, nms_threshold=0.4,
                                 temperature=0.1, valid_box_prob_threshold=0.3)
    torch.testing.assert_close(res.rescored,
                               torch.tensor([0.99, 0.98, 0.0, 0.7]),
                               rtol=0, atol=1e-6)
    assert res.keep.tolist() == [True, True, False, True]


def test_golden_case_5boxes():
    iou = torch.tensor([[1.00, 0.00, 0.00, 0.00, 0.00],
                        [0.00, 1.00, 0.00, 0.00, 0.00],
                        [0.90, 0.90, 1.00, 0.00, 0.00],
                        [0.90, 0.90, 0.00, 1.00, 0.00],
                        [0.00, 0.00, 0.90, 0.90, 1.00]])
    scores = torch.tensor([0.99, 0.98, 0.8, 0.7, 0.6])
    res = tgn.differentiable_nms(scores, iou, nms_threshold=0.4,
                                 temperature=0.1)
    torch.testing.assert_close(res.rescored,
                               torch.tensor([0.99, 0.98, 0.0, 0.0, 0.6]),
                               rtol=0, atol=1e-6)
    assert res.leader.tolist() == [0, 1, 0, 0, 4]
