"""GrooMeD-NMS: grouped, differentiable NMS (counterpart of
``groomed_nms_tpu/ops/groomed_nms.py``).

Every function takes a leading batch axis B where the JAX package ``vmap``s
(a 1-D ``scores`` is one image).  Boxes are sorted by score, grouped
greedily, and rescored through the prune matrix ``P = tril(pruning(M), -1)``
of the sorted overlap matrix M:

* masked groups (the shipped config): ``r_i = s_i - P[i, leader_i] *
  s_leader_i``, a gather and a multiply-add;
* unmasked groups and no groups: ``(I + P_group)^-1 s``, one unit
  lower-triangular solve per image.

Two entries share that core.  ``differentiable_nms`` is the JAX function's
twin: it sorts, permutes a given overlap matrix and computes P itself, in
every sorting mode.  ``groomed_nms_boxes`` is the path of the training loss
and of the test-time decode: it sorts the boxes, and K3
(``kernels.fused_iou_prune``) computes the sorted IoU and P in one pass,
which ``differentiable_nms_sorted`` takes as they are.  The grouping is
``kernels.group_leaders`` on either path.

Gradients flow to the scores (and to the overlaps where they carry one);
the grouping is integer-valued and takes none.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .iou import iou3d_approximate
from .kernels import fused_iou_prune, prune_transform


class GroomedNMSResult(NamedTuple):
    """[B, N] (or [N]) tensors aligned with the rows they were given."""

    rescored: torch.Tensor   # float; scores after NMS
    keep: torch.Tensor       # bool; rescored >= valid_box_prob_threshold
    leader: torch.Tensor     # int64; index of each box's group leader, or
    #                          -1 (capped out of a group, or padding)


def pruning_function(overlap, nms_threshold=0.4, temperature=0.01,
                     pruning_method="linear"):
    """p(o): the probability that an overlap o prunes a lower-scored box
    (``kernels.prune_transform``, the formula K3 applies)."""
    return prune_transform(overlap, nms_threshold, temperature,
                           pruning_method)


def _clip(x, lo, hi):
    """``jnp.clip``: at ``x == lo`` or ``x == hi`` the gradient is halved,
    as JAX's max/min split a tie (``torch.clamp`` passes it whole)."""
    def bound(v):
        # a fill on the device: a tensor made from a Python number on the
        # host would be a synchronising copy
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def _abs(x):
    """``jnp.abs``: its gradient at 0 is +1 (``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _rows(x, idx):
    """x [B, N, ...] gathered along axis 1 by idx [B, K]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def _permute(m, order):
    """m [B, N, N] with rows and columns permuted by order [B, N]."""
    return torch.gather(_rows(m, order), 2,
                        order[:, None, :].expand(-1, m.shape[1], -1))


def _descending(key):
    """Stable descending order of key [B, N]: among equal keys the lower
    index first, as ``argsort(-key, stable=True)`` gives it."""
    return torch.sort(key, dim=-1, descending=True, stable=True).indices


def _sort_key(scores, valid):
    return torch.where(valid, scores, float("-inf"))


def soft_sort(scores, full_matrix=None, temperature=0.01,
              reference_norm=False):
    """SoftSort (Prillo et al., 2020): row-softmax of ``-|s - sort(s)^T| /
    T``, which also soft-permutes the rows of ``full_matrix``.

    ``scores`` [..., N], ``full_matrix`` [..., N, M].  With
    ``reference_norm`` entry (i, j) is divided by row j's sum, as the
    reference's ``[N, N] / [N]`` broadcast does; otherwise by row i's.
    """
    # ascending then reversed, as jnp.sort(s)[::-1] orders equal scores
    hard_sorted = torch.sort(scores, dim=-1, stable=True).values.flip(-1)
    logits = -_abs(scores[..., None, :] - hard_sorted[..., :, None]) \
        / temperature
    logits = logits - logits.amax(-1, keepdim=True)
    weights = torch.exp(logits)
    denom = weights.sum(-1) + 1e-3
    weights = weights / (denom[..., None, :] if reference_norm
                         else denom[..., :, None])
    soft_scores = (weights @ scores[..., None])[..., 0]
    if full_matrix is None:
        return soft_scores, weights
    return soft_scores, weights, weights @ full_matrix


@torch.no_grad()
def group_leaders(iou_sorted, scores_sorted, valid_sorted, nms_threshold,
                  group_size):
    """Group leader of each score-sorted box: ``iou_sorted`` [B, N, N],
    ``valid_sorted`` [B, N] (a leading B is optional).  Returns [B, N]
    int64, -1 for padding and for boxes capped out of their group.

    The reference groups greedily: the first alive box leads a group of
    every alive box i with ``M[i, leader] > nms_threshold``; all of them
    leave the alive set, and only the first ``group_size + 1`` (in score
    order) stay in the group.  ``kernels.group_leaders`` computes it: on
    the card one kernel call with no host read, on the CPU its plain
    version.  ``scores_sorted`` is not read: the order is the rows' order.
    """
    if iou_sorted.dim() == 2:
        return group_leaders(iou_sorted[None], scores_sorted,
                             valid_sorted[None], nms_threshold,
                             group_size)[0]
    return kernels.group_leaders(
        iou_sorted.float().contiguous(), valid_sorted.contiguous(),
        nms_threshold=nms_threshold, group_size=group_size)


def _rescore_sorted(s, m, prune, v, g_order, *, nms_threshold,
                    valid_box_prob_threshold, group_boxes, mask_group_boxes,
                    group_size):
    """The grouping and rescoring of score-sorted rows [B, N]; ``g_order``
    re-sorts the rows for the grouping (soft sorting) or is None."""
    n = s.shape[-1]
    idx = torch.arange(n, device=s.device)
    if group_boxes:
        if g_order is None:
            leader = group_leaders(m, s, v, nms_threshold, group_size)
        else:
            leader_g = group_leaders(_permute(m, g_order),
                                     torch.gather(s, 1, g_order),
                                     torch.gather(v, 1, g_order),
                                     nms_threshold, group_size)
            back = torch.where(leader_g >= 0, torch.gather(
                g_order, 1, leader_g.clamp_min(0)), -1)
            leader = torch.full_like(back, -1).scatter(1, g_order, back)
        grouped = leader >= 0
        lead = leader.clamp_min(0)
        if mask_group_boxes:
            p_lead = torch.gather(prune, 2, lead[..., None])[..., 0]
            others = torch.where(leader == idx, 0.0,
                                 p_lead * torch.gather(s, 1, lead))
            rescored = torch.where(grouped, s - others, 0.0)
        else:
            same = grouped[:, :, None] & (leader[:, :, None] ==
                                          leader[:, None, :])
            a = torch.eye(n, dtype=s.dtype, device=s.device) + \
                torch.where(same, prune, 0.0)
            x = torch.linalg.solve_triangular(a, s[..., None], upper=False,
                                              unitriangular=True)[..., 0]
            rescored = torch.where(grouped, x, 0.0)
    else:
        leader = torch.where(v, idx, -1)
        a = torch.eye(n, dtype=s.dtype, device=s.device) + prune
        x = torch.linalg.solve_triangular(a, s[..., None], upper=False,
                                          unitriangular=True)[..., 0]
        rescored = torch.where(v, x, 0.0)
    rescored = _clip(rescored, 0.0, 1.0)
    keep = v & (rescored >= valid_box_prob_threshold)
    if not group_boxes:
        rescored = torch.where(keep, rescored, 0.0)
    return rescored, keep, leader


def _unsort(res_sorted, order):
    """Scatter sorted-order results back to the input order."""
    rescored, keep, leader = res_sorted
    back = torch.where(leader >= 0,
                       torch.gather(order, 1, leader.clamp_min(0)), -1)
    return GroomedNMSResult(
        rescored=torch.zeros_like(rescored).scatter(1, order, rescored),
        keep=torch.zeros_like(keep).scatter(1, order, keep),
        leader=torch.full_like(back, -1).scatter(1, order, back))


def differentiable_nms(scores, overlaps, valid_mask=None, *,
                       nms_threshold=0.4, pruning_method="linear",
                       temperature=0.01, valid_box_prob_threshold=0.3,
                       sorting_method="hard", sorting_temperature=None,
                       group_boxes=True, mask_group_boxes=True,
                       group_size=100, reference_soft_sort=False):
    """GrooMeD-NMS of ``scores`` [B, N] (or [N]) with ``overlaps``
    [B, N, N], ``valid_mask`` [B, N] bool marking real boxes (None: all).

    Returns a :class:`GroomedNMSResult` in the input order.  Padding never
    joins a group, rescores to 0 and is never kept.  ``sorting_method``
    "soft" soft-sorts the scores and the overlap rows (SoftSort) before the
    grouping re-sorts them hard; ``reference_soft_sort`` reproduces the
    reference's two soft-sort quirks (column-normalised weights from the raw
    scores; overlap rows soft-permuted, columns left in input order).  As
    in the reference, sub-threshold rescores are zeroed only when
    ``group_boxes`` is False.
    """
    if scores.dim() == 1:
        res = differentiable_nms(
            scores[None], overlaps[None],
            None if valid_mask is None else valid_mask[None],
            nms_threshold=nms_threshold, pruning_method=pruning_method,
            temperature=temperature,
            valid_box_prob_threshold=valid_box_prob_threshold,
            sorting_method=sorting_method,
            sorting_temperature=sorting_temperature, group_boxes=group_boxes,
            mask_group_boxes=mask_group_boxes, group_size=group_size,
            reference_soft_sort=reference_soft_sort)
        return GroomedNMSResult(*(x[0] for x in res))
    scores = scores.float()
    overlaps = overlaps.float()
    b, n = scores.shape
    if overlaps.shape != (b, n, n):
        raise ValueError(f"overlaps must be [B, N, N] = [{b}, {n}, {n}], "
                         f"got {tuple(overlaps.shape)}")
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool,
                                device=scores.device)
    order = _descending(_sort_key(scores, valid_mask))
    v = torch.gather(valid_mask, 1, order)
    st = temperature if sorting_temperature is None else sorting_temperature

    g_order = None
    if sorting_method == "soft" and reference_soft_sort:
        s, _, m = soft_sort(torch.where(valid_mask, scores, 0.0),
                            full_matrix=overlaps, temperature=st,
                            reference_norm=True)
        g_order = _descending(_sort_key(s, v))
        vv = v[:, :, None] & valid_mask[:, None, :]
    else:
        s = torch.where(v, torch.gather(scores, 1, order), 0.0)
        m = _permute(overlaps, order)
        if sorting_method == "soft":
            s, _, m = soft_sort(s, full_matrix=m, temperature=st)
            # soft-sorted scores need not be monotone: group in hard order
            g_order = _descending(_sort_key(s, v))
        vv = v[:, :, None] & v[:, None, :]

    m = torch.where(vv, m, 0.0)
    prune = pruning_function(m, nms_threshold, temperature,
                             pruning_method).tril(-1)
    prune = torch.where(vv, prune, 0.0)
    res = _rescore_sorted(
        s, m, prune, v, g_order, nms_threshold=nms_threshold,
        valid_box_prob_threshold=valid_box_prob_threshold,
        group_boxes=group_boxes, mask_group_boxes=mask_group_boxes,
        group_size=group_size)
    return _unsort(res, order)


def differentiable_nms_sorted(scores, overlaps, prune, valid, *,
                              nms_threshold=0.4, valid_box_prob_threshold=0.3,
                              group_boxes=True, mask_group_boxes=True,
                              group_size=100):
    """GrooMeD-NMS of rows already in descending score order, padding last.

    ``scores`` [B, N]; ``overlaps`` and ``prune`` [B, N, N] as K3 returns
    them for these rows (padding zeroed, ``prune`` strictly lower
    triangular); ``valid`` [B, N].  The sort of ``differentiable_nms`` is
    the identity here and is skipped.  Returns results in the rows' order.
    """
    s = torch.where(valid, scores, 0.0)
    return GroomedNMSResult(*_rescore_sorted(
        s, overlaps, prune, valid, None, nms_threshold=nms_threshold,
        valid_box_prob_threshold=valid_box_prob_threshold,
        group_boxes=group_boxes, mask_group_boxes=mask_group_boxes,
        group_size=group_size))


def groomed_nms_boxes(scores, boxes, valid=None, *, corners=None,
                      overlap_in_nms="2d", nms_threshold=0.4,
                      pruning_method="linear", temperature=0.1,
                      valid_box_prob_threshold=0.3, group_boxes=True,
                      mask_group_boxes=True, group_size=100):
    """GrooMeD-NMS of boxes, through K3: ``scores`` [B, N], ``boxes``
    [B, N, 4] f32, ``valid`` [B, N] bool (None: all real).

    The rows are sorted by score; K3 computes their IoU and prune matrices
    (no gradient: the overlaps are detached, as the loss stops them), and
    ``differentiable_nms_sorted`` rescores.  ``overlap_in_nms`` "2d" groups
    and prunes by the 2D IoU; "3d" by the mapped 3D GIoU ``(1 + g) / 2`` of
    ``corners`` [B, N, 3, 8], and anything else by their product.  Equals
    ``differentiable_nms`` with hard sorting on those overlaps; returns a
    :class:`GroomedNMSResult` in the input order.
    """
    b, n = scores.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=scores.device)
    order = _descending(_sort_key(scores, valid))
    v = torch.gather(valid, 1, order)
    iou, prune = fused_iou_prune(
        _rows(boxes.detach().float(), order).contiguous(), v,
        nms_threshold=nms_threshold, temperature=temperature,
        pruning_method=pruning_method)
    m = iou
    if overlap_in_nms != "2d":
        c = _rows(corners.detach(), order)
        _, g3d = iou3d_approximate(c, c, pairwise=True, generalized=True)
        g3d = 0.5 * (1.0 + g3d)
        m = torch.nan_to_num(g3d if overlap_in_nms == "3d" else iou * g3d,
                             nan=0.0)
        vv = v[:, :, None] & v[:, None, :]
        m = torch.where(vv, m, 0.0)
        prune = torch.where(vv, pruning_function(
            m, nms_threshold, temperature, pruning_method).tril(-1), 0.0)
    res = differentiable_nms_sorted(
        torch.gather(scores, 1, order), m, prune, v,
        nms_threshold=nms_threshold,
        valid_box_prob_threshold=valid_box_prob_threshold,
        group_boxes=group_boxes, mask_group_boxes=mask_group_boxes,
        group_size=group_size)
    return _unsort(res, order)


def differentiable_nms_indices(scores, overlaps, **kwargs):
    """Host-side convenience for one image: ``(valid_idx, invalid_idx,
    rescored)`` as numpy arrays, the index arrays ordered by descending
    rescored value (the reference's return contract)."""
    res = differentiable_nms(torch.as_tensor(scores), torch.as_tensor(overlaps),
                             **kwargs)
    rescored = res.rescored.detach().cpu().numpy()
    keep = res.keep.cpu().numpy()
    order = np.argsort(-np.where(keep, rescored, 0.0), kind="stable")
    return order[keep[order]], order[~keep[order]], rescored
