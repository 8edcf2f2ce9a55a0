"""The RPN 3D loss with GrooMeD-NMS in the loop (counterpart of
``groomed_nms_tpu/losses/rpn_3d.py``).

One function over a batch of head outputs: batched target assignment
(``anchors.compute_targets``), fg/bg sampling with hard negatives, the
classification loss, the acceptance-probability loss, GrooMeD-NMS on the
top ``max_nms_boxes`` sampled foregrounds by score with detached overlaps
(K3 computes them, ``ops.groomed_nms.groomed_nms_boxes``), the after-NMS AP
(or classification) loss, the 2D/3D regression losses, the self-balancing
uncertainty lambda and the -log(IoU2D) loss.  The JAX function's fixed
shapes are kept: every step is a tensor op over [B, R] or the gathered
[B, K] subsets, and nothing reads a value back to the host.

Each ``jax.lax.stop_gradient`` of the reference is a ``.detach()`` here,
each ``lax.top_k`` ``inference.top_k_indices`` (a stable descending sort:
lower index first among equal keys) and each ``argsort(stable=True)`` a
stable ascending sort.  The loss
runs in f32; call it outside ``torch.autocast``.

Every branch of the JAX function is ported: the ``_un`` model's
uncertainty in the acceptance probability's place, the focal reweighting,
the GT-IoU3D weighting of the 3D terms, the acceptance
``classify``/``rank``/``regress``/``likelihood`` modes, the after-NMS
``rank``/``classify``/``regress`` modes and the video stage's velocity term
(``has_vel``).  Under ``has_vel`` the stats carry two entries JAX's do not:
``vel``, the velocity term as added to the 3D loss, and ``vel_num``, the
foreground rows with a finite velocity target.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..anchors import compute_targets
from ..inference import top_k_indices
from ..ops.boxes import bbox_transform_inv
from ..ops.geometry import alpha_to_rot_y, get_corners_of_cuboid, snap_to_pi
from ..ops.groomed_nms import _abs, _clip, _rows, groomed_nms_boxes
from ..ops.iou import elementwise_iou, iou3d_approximate, pairwise_iou
from ..parallel.dist import all_gather, global_counts
from .aploss import ap_loss

# the cap on the decoded 2D boxes' log-scales in the loss: a box a million
# times its anchor, so that corners, areas and their squares stay finite in
# f32; every row below it decodes as JAX's does
MAX_LOG_SCALE = math.log(1e6)


class UncertaintyState(NamedTuple):
    """Running-average lambda of the self-balancing confidence term."""

    lam: torch.Tensor   # scalar f32
    n: torch.Tensor     # scalar int32 frame counter (capped at 100)

    @staticmethod
    def init(device=None):
        return UncertaintyState(
            lam=torch.zeros((), device=device),
            n=torch.zeros((), dtype=torch.int32, device=device))


class GTBatch(NamedTuple):
    """Padded per-batch ground truth (G = max GTs, I = max ignore regions)."""

    gts_2d: torch.Tensor     # [B, G, 4] GT corner boxes (image scale)
    gts_3d: torch.Tensor     # [B, G, 16] imdb bbox_3d rows
    gt_labels: torch.Tensor  # [B, G] class ids >= 1
    gt_valid: torch.Tensor   # [B, G] bool
    ign_2d: torch.Tensor     # [B, I, 4]
    ign_valid: torch.Tensor  # [B, I] bool
    p2: torch.Tensor         # [B, 4, 4] camera projection
    scale: torch.Tensor      # [B] image scale factor


@dataclass(frozen=True)
class LossConfig:
    """The loss's knobs (the fields of ``groomed_nms_tpu``'s LossConfig)."""

    num_classes: int = 4
    fg_fraction: float = 0.2
    box_samples: float = 0.2          # <= 0 means "all boxes"
    hard_negatives: bool = True
    focal_loss: float = 0.0
    fg_thresh: float = 0.5
    ign_thresh: float = 0.5
    bg_thresh_lo: float = 0.0
    bg_thresh_hi: float = 0.5
    best_thresh: float = 0.35
    cls_2d_lambda: float = 1.0
    iou_2d_lambda: float = 1.0
    bbox_2d_lambda: float = 0.0
    bbox_3d_lambda: float = 1.0
    bbox_axis_head_lambda: float = 0.35
    decomp_alpha: bool = True
    use_nms_in_loss: bool = False
    nms_thres: float = 0.4
    diff_nms_pruning_method: str = "linear"
    diff_nms_temperature: float = 0.1
    diff_nms_valid_box_prob_threshold: float = 0.3
    diff_nms_group_boxes: bool = True
    diff_nms_mask_group_boxes: bool = True
    diff_nms_group_size: int = 100
    after_nms_lambda: float = 0.05
    after_nms_loss_mode: str = "rank"     # classify | rank | regress
    rank_boxes_of_all_images_at_once: bool = False
    overlap_in_nms: str = "2d"            # 2d | 3d | 2d_3d (product)
    best_target_box_beta: float = 0.3
    rank_with_class_confidence: bool = False
    predict_acceptance_prob: bool = False
    acceptance_prob_lambda: float = 0.0
    acceptance_prob_mode: str = "likelihood"  # classify|rank|regress|likelihood
    acceptance_prob_classify_bins: int = 2
    acceptance_prob_classify_sort_K: int = 0
    bins_boundary: tuple = (0.5,)
    # 'foregrounds' = sampled fg anchors; 'overlaps' = anchors whose max 2D
    # IoU with a GT exceeds acceptance_prob_overlap_thres; 'all' = every
    # anchor, the L1 weighted by the sampled cls weights
    boxes_for_acceptance_prob: str = "foregrounds"
    acceptance_prob_overlap_thres: float = 0.01
    use_acceptance_prob_in_regression_loss: bool = False
    weigh_acceptance_prob_regularization: bool = False
    weigh_3D_regression_loss_by_gt_iou3d: bool = False
    has_vel: bool = False
    has_un: bool = False
    bbox_un_lambda: float = 0.0
    bbox_un_dynamic: bool = False
    max_nms_boxes: int = 512
    max_ap_boxes: int = 1024

    def __post_init__(self):
        if self.has_vel and not self.decomp_alpha:
            raise ValueError("has_vel=True requires decomp_alpha=True "
                             "(velocity targets are laid out after the "
                             "alpha sin/cos columns)")
        if self.boxes_for_acceptance_prob not in (
                "foregrounds", "overlaps", "all"):
            raise ValueError(
                f"boxes_for_acceptance_prob="
                f"{self.boxes_for_acceptance_prob!r}: expected "
                "'foregrounds', 'overlaps' or 'all'")
        if self.predict_acceptance_prob and self.acceptance_prob_lambda and \
                self.acceptance_prob_mode == "classify":
            n_cls = self.acceptance_prob_classify_bins - 1
            if n_cls < 1:
                raise ValueError("acceptance_prob_classify_bins must be >= 2")
            sort_k = self.acceptance_prob_classify_sort_K
            if sort_k > 0 and n_cls != 1:
                raise ValueError(
                    "acceptance_prob_classify_sort_K > 0 requires bins=2 "
                    f"(one classifier); got bins="
                    f"{self.acceptance_prob_classify_bins}")
            if sort_k == 0 and len(self.bins_boundary) != n_cls:
                raise ValueError(
                    f"bins_boundary needs {n_cls} entries (bins-1) for "
                    f"ordinal classify, got {len(self.bins_boundary)}")


def accept_head_trained(cfg: LossConfig, classify: bool) -> bool:
    """Whether ``rpn_3d_loss`` takes a gradient through the acceptance head:
    ``accept_cls`` (``classify``) in the acceptance loss only;
    ``accept_prob`` there, as the scores of GrooMeD-NMS when an after-NMS
    loss reads them, and in the 3D terms and the (1 - confidence) term."""
    accept_loss = bool(cfg.predict_acceptance_prob and
                       cfg.acceptance_prob_lambda)
    if classify:
        return accept_loss
    return accept_loss or bool(
        (cfg.use_nms_in_loss and cfg.after_nms_lambda) or
        (cfg.bbox_3d_lambda and (cfg.use_acceptance_prob_in_regression_loss
                                 or cfg.bbox_un_dynamic
                                 or cfg.bbox_un_lambda > 0)))


def _smooth_l1(x, t):
    d = (x - t).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _bce(p, t, eps=1e-7):
    p = _clip(p, eps, 1.0 - eps)
    return -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))


class _Deferred:
    """A scalar of the loss written before the batch-wide counts are
    known: ``fn(get)`` computes it once they are, ``get`` giving the value
    of each masked mean (``_Means``).  ``+`` and ``*`` with numbers,
    tensors and other deferred scalars build larger ones that evaluate in
    the order written, so a single process computes what an eager
    expression would, op for op."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __add__(self, o):
        return _Deferred(lambda g: self.fn(g) + _ev(o, g))

    def __radd__(self, o):
        return _Deferred(lambda g: _ev(o, g) + self.fn(g))

    def __mul__(self, o):
        return _Deferred(lambda g: self.fn(g) * _ev(o, g))

    def __rmul__(self, o):
        return _Deferred(lambda g: _ev(o, g) * self.fn(g))


def _ev(x, get):
    return x.fn(get) if isinstance(x, _Deferred) else x


def _where(cond, x, other):
    """``torch.where(cond, x, other)`` of a deferred ``x``."""
    return _Deferred(lambda g: torch.where(cond, _ev(x, g), other))


def _global(x):
    """``x`` evaluated from the global batch's values and detached, also
    where the rank's share of the loss is being evaluated (the dynamic
    lambda: a coefficient every rank must agree on)."""
    return _Deferred(lambda g: _ev(x, g.glob).detach())


class _Get:
    """Memoised values of one evaluation; ``glob`` is the evaluation of the
    global batch's values (itself in a single process)."""

    def __init__(self, fn):
        self.fn, self.memo, self.glob = fn, {}, self

    def __call__(self, key):
        if key not in self.memo:
            self.memo[key] = self.fn(*key)
        return self.memo[key]


class _Means:
    """The batch-wide means of one loss call.

    ``m(x, mask)`` is the mean of x over mask & isfinite(x) (0 on an empty
    set), ``m.ratio(s, c)`` a sum over a count, ``m.replicated(v)`` a value
    every rank computes whole from gathered inputs and ``m.summed(t)`` a
    count for the stats; each is a ``_Deferred``.  ``m.getter()`` gives
    their values.  In a single process (``ctx`` None or of world 1): sum /
    count as computed, ``v`` and ``t`` themselves.  Under a process group:
    every count and a detached copy of every sum are summed over the ranks
    in ONE ``global_counts`` reduction; the getter gives this rank's share of
    each mean (its own sum over the global count; ``v / world``), so the
    shares of a loss linear in them sum to the global batch's loss, and
    its ``glob`` the global values (global sum over global count; ``v``;
    the summed ``t``) for the stats.
    """

    def __init__(self, ctx):
        self.ctx = ctx if ctx is not None and ctx.active else None
        self.items = {"m": [], "r": [], "t": []}

    def _add(self, kind, item):
        self.items[kind].append(item)
        key = (kind, len(self.items[kind]) - 1)
        return _Deferred(lambda g: g(key))

    def __call__(self, x, mask):
        ok = mask & torch.isfinite(x)
        return self.ratio(torch.where(ok, x, 0.0).sum(), ok.sum())

    def ratio(self, s, c):
        return self._add("m", (s, c))

    def replicated(self, v):
        return self._add("r", v)

    def summed(self, t):
        return self._add("t", t)

    def getter(self):
        means, repl, totals = (self.items[k] for k in "mrt")
        if self.ctx is None:
            return _Get(lambda kind, i: means[i][0] / means[i][1].clamp_min(1)
                        if kind == "m" else repl[i] if kind == "r"
                        else totals[i])
        red = global_counts(self.ctx, *(x for m in means for x in m[::-1]),
                            *totals)
        n, world = len(means), self.ctx.world
        c_glob, s_glob, t_glob = red[0:2 * n:2], red[1:2 * n:2], red[2 * n:]
        glob = _Get(lambda kind, i: s_glob[i] / c_glob[i].clamp_min(1)
                    if kind == "m" else repl[i].detach() if kind == "r"
                    else t_glob[i])
        share = _Get(lambda kind, i: means[i][0] / c_glob[i].clamp_min(1)
                     if kind == "m" else repl[i] / world if kind == "r"
                     else t_glob[i])
        share.glob = glob
        return share


def _rank_ascending(key):
    """rank[b, i] = position of element i in the stable ascending sort of
    key [B, R]."""
    order = torch.sort(key, dim=-1, stable=True).indices
    ranks = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter(-1, order, ranks)


def _select_lowest(mask, score, num):
    """mask [B, R] & the ``num`` [B] lowest-scored elements of mask."""
    rank = _rank_ascending(torch.where(mask, score, float("inf")))
    return mask & (rank < num[:, None])


def _round_f32(x):
    """``jnp.round`` of a Python float: round half to even, in f32."""
    return int(np.round(np.float32(x)))


def _nms_in_loss(cfg, scores_nms, fg_sel, coords_2d, raw3d, batch):
    """GrooMeD-NMS on the top ``max_nms_boxes`` sampled fg per image.

    Returns (scores_after, targets_after), both [B, R]: the rescored scores
    scattered back to their anchors (0 elsewhere), and 1 on the best box of
    each GT after NMS (best ``0.5 * (1 + GIoU3D) * IoU2D`` above beta).
    """
    b, r = scores_nms.shape
    key = torch.where(fg_sel, scores_nms, float("-inf"))
    idx = top_k_indices(key, min(cfg.max_nms_boxes, r))
    valid = torch.gather(key, 1, idx) > float("-inf")
    s_sub = torch.where(valid, torch.gather(scores_nms, 1, idx), 0.0)
    boxes_sub = _rows(coords_2d, idx)
    corners_sub = get_corners_of_cuboid(*(torch.gather(c, 1, idx)
                                          for c in raw3d))
    res = groomed_nms_boxes(
        s_sub, boxes_sub, valid, corners=corners_sub,
        overlap_in_nms=cfg.overlap_in_nms, nms_threshold=cfg.nms_thres,
        pruning_method=cfg.diff_nms_pruning_method,
        temperature=cfg.diff_nms_temperature,
        valid_box_prob_threshold=cfg.diff_nms_valid_box_prob_threshold,
        group_boxes=cfg.diff_nms_group_boxes,
        mask_group_boxes=cfg.diff_nms_mask_group_boxes,
        group_size=cfg.diff_nms_group_size)
    scores_after = torch.zeros_like(scores_nms).scatter(
        1, idx, torch.where(valid, res.rescored, 0.0))

    # after-NMS best-box targets: no gradient (argmax and a comparison)
    with torch.no_grad():
        g3 = batch.gts_3d
        corners_gt = get_corners_of_cuboid(
            g3[..., 7], g3[..., 8], g3[..., 9], g3[..., 3], g3[..., 4],
            g3[..., 5], g3[..., 10])
        _, giou_gt = iou3d_approximate(corners_sub, corners_gt, pairwise=True,
                                       generalized=True)
        swg = 0.5 * (1.0 + giou_gt) * pairwise_iou(boxes_sub, batch.gts_2d)
        swg = torch.where(valid[:, :, None] & batch.gt_valid[:, None, :],
                          swg, -1.0)
        swg = torch.nan_to_num(swg, nan=-1.0)
        best_val, best_box = swg.max(1)                # [B, G], first max
        is_tgt = batch.gt_valid & (best_val > cfg.best_target_box_beta)
        targets_after = torch.zeros_like(scores_nms).scatter_reduce(
            1, torch.gather(idx, 1, best_box), is_tgt.float(), "amax")
    return scores_after, targets_after


def rpn_3d_loss(outputs, rois, rois_3d, batch: GTBatch, bbox_means, bbox_stds,
                un_state: UncertaintyState, cfg: LossConfig, dist=None):
    """Total loss + stats for one batch.

    ``outputs``: 'cls' [B, R, C], 'prob' [B, R, C], 'bbox_2d' [B, R, 4],
    'bbox_3d' [B, R, 10] ([B, R, 11] under ``has_vel``), optional
    'accept_prob' [B, R], 'accept_cls' [B, R, bins-1] and 'uncertainty'
    [B, R] (read under ``has_un`` when there is no 'accept_prob'), all f32.
    ``rois`` [R, 5], ``rois_3d`` [R, P] (P = 8 under ``has_vel``: the
    velocity prior last), ``bbox_means`` / ``bbox_stds`` [13] ([14] under
    ``has_vel``), all on the outputs' device; ``gts_3d`` carries the
    velocity in column 16 under ``has_vel`` (-inf where a track has none).

    Returns ``(loss, stats, new_un_state)``: ``stats`` maps each term's name
    to a 0-dim tensor (nothing is read back to the host).

    ``dist``, a ``parallel.Dist`` of world W > 1, makes the batch this
    rank's rows of a global batch and the loss the global batch's, as one
    process computes it: the fg/bg counts behind the class weights (and
    the after-NMS ``classify`` counts) are summed over the ranks first,
    every other count and a detached copy of every sum at the end, each
    round in one ``global_counts`` reduction; an AP loss over the whole batch
    ranks every rank's boxes (``all_gather``).  ``loss`` is then this rank's
    share (the shares sum to the global loss: scale it by W before
    ``DistributedDataParallel`` averages the gradients), while ``stats``
    and ``new_un_state`` are the global batch's, identical on every rank.
    """
    cls, prob = outputs["cls"], outputs["prob"]
    bbox_2d, bbox_3d = outputs["bbox_2d"], outputs["bbox_3d"]
    accept_prob = outputs.get("accept_prob")
    accept_cls = outputs.get("accept_cls")
    if accept_prob is None and cfg.has_un:
        accept_prob = outputs.get("uncertainty")
    if accept_prob is not None:
        accept_prob = _clip(accept_prob, 0.0005, 1.0)

    b, r, _ = cls.shape
    means, stds = bbox_means.float(), bbox_stds.float()
    stats = {}
    mm = _Means(dist)

    def whole_batch(x):
        """x [B, ...] of every rank, in rank order (the global batch)."""
        return x if mm.ctx is None else all_gather(x, mm.ctx)

    # -- targets ---------------------------------------------------------
    tgt = compute_targets(
        rois, rois_3d, batch.gts_2d, batch.gts_3d, batch.gt_labels,
        batch.gt_valid, batch.ign_2d, batch.ign_valid,
        fg_thresh=cfg.fg_thresh, ign_thresh=cfg.ign_thresh,
        bg_thresh_lo=cfg.bg_thresh_lo, bg_thresh_hi=cfg.bg_thresh_hi,
        best_thresh=cfg.best_thresh, decomp_alpha=cfg.decomp_alpha,
        has_vel=cfg.has_vel)
    fg, bg = tgt.fg_mask, tgt.bg_mask
    label_int = torch.where(fg, tgt.labels.long(), 0)
    t2d_n = (tgt.transforms_2d - means[:4]) / stds[:4]
    n3d = (9 if cfg.decomp_alpha else 7) + (1 if cfg.has_vel else 0)
    t3d_n = (tgt.transforms_3d[..., :n3d] - means[4:4 + n3d]) / stds[4:4 + n3d]

    # -- fg/bg sampling with hard negatives -------------------------------
    label_onehot = (label_int[..., None] == torch.arange(
        cls.shape[-1], device=cls.device)).float()
    score_of_label = (prob.detach() * label_onehot).sum(-1)
    n_fg, n_bg = fg.sum(1), bg.sum(1)
    if cfg.box_samples and cfg.box_samples > 0:
        want_fg = n_fg.clamp_max(_round_f32(r * cfg.box_samples *
                                            cfg.fg_fraction))
        want_bg = torch.minimum(_round_f32(r * cfg.box_samples) - want_fg,
                                n_bg)
    else:
        want_fg, want_bg = n_fg, n_bg
    sample_score = score_of_label if cfg.hard_negatives else \
        torch.zeros_like(score_of_label)
    fg_sel = _select_lowest(fg, sample_score, want_fg)
    bg_sel = _select_lowest(bg, sample_score, want_bg)
    active = fg_sel | bg_sel
    fg_num, bg_num = global_counts(mm.ctx, fg_sel.sum(), bg_sel.sum())

    # global class re-weighting
    fg_weight = torch.where(
        fg_num > 0,
        (cfg.fg_fraction / (1 - cfg.fg_fraction)) * (bg_num / fg_num.clamp_min(1)),
        0.0)
    labels_weight = torch.where(fg_sel, fg_weight, 0.0) + \
        torch.where(bg_sel, 1.0, 0.0)
    if cfg.focal_loss:
        labels_weight = labels_weight * torch.where(
            active, (1.0 - score_of_label) ** cfg.focal_loss, 1.0)

    # -- decode predictions ----------------------------------------------
    # the log-scales are capped (MAX_LOG_SCALE) where JAX's are not: a row
    # whose exp overflows f32 would give infinite corners, and even a row
    # the masks leave out then turns the IoU's backward into 0 * inf = NaN
    coords_2d = bbox_transform_inv(rois[None, :, :4], bbox_2d,
                                   means=means[:4], stds=stds[:4],
                                   max_log_scale=MAX_LOG_SCALE)
    coords_2d_tar = bbox_transform_inv(rois[None, :, :4], t2d_n,
                                       means=means[:4], stds=stds[:4],
                                       max_log_scale=MAX_LOG_SCALE)
    widths = rois[:, 2] - rois[:, 0] + 1.0
    heights = rois[:, 3] - rois[:, 1] + 1.0
    ctr_x = rois[:, 0] + 0.5 * widths
    ctr_y = rois[:, 1] + 0.5 * heights
    # de-normalisation columns of the 13-col stats: 4-9 and, in decomp mode,
    # 11-12 (sin, cos), else 10 (rot); sliced, not list-indexed, so no index
    # tensor is copied to the card
    def stat_cols(v):
        return torch.cat([v[4:10], v[11:13]]) if cfg.decomp_alpha else v[4:11]

    n_dn = 8 if cfg.decomp_alpha else 7
    dn = bbox_3d[..., :n_dn] * stat_cols(stds) + stat_cols(means)
    x2d_dn = dn[..., 0] * widths + ctr_x
    y2d_dn = dn[..., 1] * heights + ctr_y
    z2d_dn = rois_3d[:, 0] + dn[..., 2]
    w3d_raw = torch.exp(dn[..., 3]) * rois_3d[:, 1]
    h3d_raw = torch.exp(dn[..., 4]) * rois_3d[:, 2]
    l3d_raw = torch.exp(dn[..., 5]) * rois_3d[:, 3]

    # closed-form P2 inversion
    p2 = batch.p2
    p2a, p2b, p2c = p2[:, 0, 0, None], p2[:, 0, 2, None], p2[:, 0, 3, None]
    p2d, p2e, p2f = p2[:, 1, 1, None], p2[:, 1, 2, None], p2[:, 1, 3, None]
    p2h = p2[:, 2, 3, None]
    scale = batch.scale[:, None]
    z3d_raw = z2d_dn - p2h
    x3d_raw = ((z3d_raw + p2h) * (x2d_dn / scale) - p2b * z3d_raw - p2c) / p2a
    y3d_raw = ((z3d_raw + p2h) * (y2d_dn / scale) - p2e * z3d_raw - p2f) / p2d

    raw3 = tgt.raw_gt_3d
    axis_tar, head_tar = raw3[..., 14], raw3[..., 15]
    if cfg.decomp_alpha:
        rot_raw = torch.where(axis_tar == 1, rois_3d[:, 5] + dn[..., 6],
                              rois_3d[:, 6] + dn[..., 7])
        rot_raw = rot_raw + torch.where(head_tar == 1, math.pi, 0.0)
    else:
        rot_raw = rois_3d[:, 4] + dn[..., 6]
    rot_raw_snap = snap_to_pi(rot_raw.detach())
    ry3d_raw = alpha_to_rot_y(rot_raw_snap, z3d_raw.detach(), x3d_raw.detach())
    # the raw 3D branch only feeds detached targets and overlaps
    raw3d = (x3d_raw.detach(), y3d_raw.detach(), z3d_raw.detach(),
             w3d_raw.detach(), h3d_raw.detach(), l3d_raw.detach(), ry3d_raw)
    x3d_tar, y3d_tar, z3d_tar = raw3[..., 7], raw3[..., 8], raw3[..., 9]

    total = torch.zeros((), device=cls.device)

    # -- classification ----------------------------------------------------
    if cfg.cls_2d_lambda:
        logp = torch.log_softmax(cls, dim=-1)
        # where-masked, not multiplied: 0 * -inf would be NaN
        ce = -torch.where(label_onehot > 0, logp, 0.0).sum(-1)
        ce = _clip(ce * labels_weight, 0.0, 2000.0)
        loss_cls = mm(ce, active) * cfg.cls_2d_lambda
        total = total + loss_cls
        stats["cls"] = loss_cls
        cls_pred = cls.detach().argmax(-1)
        stats["acc_fg"] = mm((cls_pred == label_int).float(), fg)
        stats["acc_bg"] = mm((cls_pred == 0).float(), bg)

    # -- acceptance probability -------------------------------------------
    # targets: IoU3D of each fg anchor's prediction with its GT (no
    # gradient: every input is detached)
    accept_tar = None
    if cfg.predict_acceptance_prob or cfg.weigh_3D_regression_loss_by_gt_iou3d:
        cp = get_corners_of_cuboid(*raw3d)
        ct = get_corners_of_cuboid(x3d_tar, y3d_tar, z3d_tar, raw3[..., 3],
                                   raw3[..., 4], raw3[..., 5], raw3[..., 10])
        _, iou3d_el = iou3d_approximate(cp, ct, pairwise=False)
        accept_tar = torch.nan_to_num(torch.where(fg, iou3d_el, 0.0),
                                      nan=0.0, posinf=0.0, neginf=0.0)
    if cfg.predict_acceptance_prob and cfg.acceptance_prob_lambda and \
            (accept_prob is not None or accept_cls is not None):
        if cfg.boxes_for_acceptance_prob == "overlaps":
            accept_sel = tgt.ols_max > cfg.acceptance_prob_overlap_thres
        elif cfg.boxes_for_acceptance_prob == "all":
            accept_sel = torch.ones_like(fg)
        else:
            accept_sel = fg_sel
        if cfg.acceptance_prob_mode == "classify":
            if accept_cls is None:
                raise ValueError(
                    "acceptance_prob_mode='classify' needs the model's "
                    "accept_cls head (RPNConfig.acceptance_prob_classify_"
                    "bins > 1); these outputs only carry accept_prob")
            n_cls = cfg.acceptance_prob_classify_bins - 1
            if cfg.acceptance_prob_classify_sort_K > 0 and n_cls == 1:
                key = torch.where(accept_sel, accept_tar, float("-inf"))
                pos = accept_sel & (_rank_ascending(-key) <
                                    cfg.acceptance_prob_classify_sort_K)
                pos = pos[..., None]
            else:
                bnds = torch.tensor(cfg.bins_boundary).to(
                    cls.device, non_blocking=True)
                pos = accept_sel[..., None] & (accept_tar[..., None] > bnds)
            n_pos = pos.sum(1).float()                           # [B, C]
            n_neg = accept_sel.sum(1).float()[:, None] - n_pos
            w_pos = torch.where(n_neg > 0, n_neg / n_pos.clamp_min(1.0), 1.0)
            bce = _bce(accept_cls, pos.float())
            bce = bce * torch.where(pos, w_pos[:, None, :], 1.0)
            loss_ap = mm(bce, accept_sel[..., None].expand_as(bce)) \
                * cfg.acceptance_prob_lambda
        elif cfg.acceptance_prob_mode == "rank":
            # every active box of the batch in ONE AP loss (the reference
            # ranks the flattened [B*R] tensors), the top max_ap_boxes
            # active boxes of each image by score gathered first; a target
            # of -1 marks a slot the AP loss ignores
            ap_scores = accept_prob
            if cfg.rank_with_class_confidence:
                ap_scores = ap_scores * prob[..., 1:].amax(-1)
            rank_tar = torch.where(accept_sel,
                                   torch.where(accept_tar >= 0.6, 1.0, 0.0),
                                   -1.0)
            key = torch.where(accept_sel, ap_scores, float("-inf"))
            idx = top_k_indices(key, min(cfg.max_ap_boxes, r))
            valid = torch.gather(key, 1, idx) > float("-inf")
            sc = torch.where(valid, torch.gather(ap_scores, 1, idx), 0.0)
            tar = torch.where(valid, torch.gather(rank_tar, 1, idx), -1.0)
            loss_ap = mm.replicated(ap_loss(
                whole_batch(sc).reshape(-1),
                whole_batch(tar).reshape(-1))) * cfg.acceptance_prob_lambda
        elif cfg.acceptance_prob_mode in ("likelihood", "regress"):
            if cfg.acceptance_prob_mode == "likelihood" and \
                    cfg.boxes_for_acceptance_prob == "foregrounds":
                lp = -torch.log(accept_prob)
            else:
                # regress, and the reference's likelihood for 'all' and
                # 'overlaps' (it branches on the box set first): a plain L1
                lp = _abs(accept_prob - accept_tar)
            if cfg.boxes_for_acceptance_prob == "all":
                lp = lp * labels_weight.detach()
            if cfg.weigh_acceptance_prob_regularization:
                lp = lp * accept_tar
            loss_ap = mm(lp, accept_sel) * cfg.acceptance_prob_lambda
        else:
            raise NotImplementedError(cfg.acceptance_prob_mode)
        total = total + loss_ap
        stats["bbox_prob"] = loss_ap

    # -- GrooMeD-NMS in the loss -------------------------------------------
    if cfg.use_nms_in_loss:
        if accept_prob is not None:
            scores_nms = accept_prob
            if cfg.rank_with_class_confidence:
                scores_nms = scores_nms * prob[..., 1:].amax(-1)
        else:
            scores_nms = prob[..., 1:].amax(-1)
        scores_after, targets_after = _nms_in_loss(
            cfg, scores_nms, fg_sel, coords_2d, raw3d, batch)

        if cfg.after_nms_lambda:
            if cfg.after_nms_loss_mode == "rank":
                key = torch.where(fg_sel, scores_nms, float("-inf"))
                idx = top_k_indices(key, min(cfg.max_ap_boxes, r))
                valid = torch.gather(key, 1, idx) > float("-inf")
                logits = torch.where(valid, torch.gather(scores_after, 1, idx),
                                     0.0)
                targets = torch.where(valid,
                                      torch.gather(targets_after, 1, idx), -1.0)
                if cfg.rank_boxes_of_all_images_at_once:
                    loss_nms = mm.replicated(ap_loss(
                        whole_batch(logits).reshape(-1),
                        whole_batch(targets).reshape(-1)))
                else:
                    has_fg = fg_sel.any(1)
                    loss_nms = mm.ratio(torch.where(
                        has_fg, ap_loss(logits, targets), 0.0).sum(),
                        has_fg.sum())
            elif cfg.after_nms_loss_mode == "classify":
                n_pos = torch.where(fg_sel, targets_after, 0.0).sum()
                n_neg = fg_sel.sum() - n_pos
                n_pos, n_neg = global_counts(mm.ctx, n_pos, n_neg)
                w_neg = torch.where(
                    (n_pos > 0) & (n_neg > 0),
                    (n_pos / n_neg.clamp_min(1.0)) ** 0.25, 1.0)
                bce = _bce(scores_after, targets_after)
                bce = bce * torch.where(targets_after == 0, w_neg, 1.0)
                loss_nms = mm(bce, fg_sel)
            elif cfg.after_nms_loss_mode == "regress":
                loss_nms = mm(_abs(scores_after - targets_after),
                                        fg_sel)
            else:
                raise NotImplementedError(cfg.after_nms_loss_mode)
            loss_nms = loss_nms * cfg.after_nms_lambda
            total = total + loss_nms
            stats["after_nms"] = loss_nms

    # -- 2D / 3D regression ------------------------------------------------
    new_state = un_state
    any_fg = fg_num > 0
    if cfg.bbox_2d_lambda:
        l2d = _smooth_l1(bbox_2d, t2d_n).sum(-1)
        loss_2d = _where(any_fg, mm(l2d, fg_sel) * cfg.bbox_2d_lambda, 0.0)
        total = total + loss_2d
        stats["bbox_2d"] = loss_2d

    ious_2d = elementwise_iou(coords_2d, coords_2d_tar)
    stats["iou_2d"] = mm(ious_2d.detach(), fg_sel)
    x3d_d, y3d_d, z3d_d = raw3d[:3]
    cen_dist = torch.sqrt((x3d_d - x3d_tar) ** 2 + (y3d_d - y3d_tar) ** 2
                          + (z3d_d - z3d_tar) ** 2)
    stats["cen_dist"] = mm(cen_dist, fg_sel)
    stats["z_err"] = mm((z3d_d - z3d_tar).abs(), fg_sel)
    stats["rot_err"] = mm((rot_raw_snap - raw3[..., 6]).abs(), fg_sel)

    if cfg.bbox_3d_lambda:
        terms = [_smooth_l1(bbox_3d[..., i], t3d_n[..., i]) for i in range(6)]
        if cfg.decomp_alpha:
            l_rsin = _smooth_l1(bbox_3d[..., 6], t3d_n[..., 7])
            l_rcos = _smooth_l1(bbox_3d[..., 7], t3d_n[..., 8])
            terms.append(torch.where(axis_tar == 1, l_rsin, l_rcos))
            l_axis = _bce(bbox_3d[..., 8], axis_tar)
            l_head = _bce(bbox_3d[..., 9], head_tar)
            stats["acc_axis"] = mm(
                ((bbox_3d[..., 8].detach() >= 0.5) == (axis_tar == 1)).float(),
                fg_sel)
            stats["acc_head"] = mm(
                ((bbox_3d[..., 9].detach() >= 0.5) == (head_tar == 1)).float(),
                fg_sel)
        else:
            terms.append(_smooth_l1(bbox_3d[..., 6], t3d_n[..., 6]))
            l_axis = l_head = None

        l_vel = vel_ok = None
        if cfg.has_vel:
            # the target is -inf where a track has no velocity: the smooth
            # L1 takes a sanitised target and the term is averaged over the
            # rows with a finite one, kept out of `terms` so that no
            # non-finite value meets a differentiable tensor
            vel_tar = t3d_n[..., 9]
            vel_ok = fg_sel & torch.isfinite(vel_tar)
            l_vel = _smooth_l1(bbox_3d[..., 10],
                               torch.where(vel_ok, vel_tar, 0.0))

        if cfg.weigh_3D_regression_loss_by_gt_iou3d:
            terms = [t * accept_tar for t in terms]
            if l_axis is not None:
                l_axis, l_head = l_axis * accept_tar, l_head * accept_tar
            if l_vel is not None:
                l_vel = l_vel * accept_tar

        # self-balancing lambda from the un-weighted 3D loss magnitude
        dynamic = cfg.bbox_un_dynamic and accept_prob is not None
        if dynamic:
            init = sum(mm(t, fg_sel) for t in terms) * cfg.bbox_3d_lambda
            if l_axis is not None:
                init = init + (mm(l_axis, fg_sel) + mm(l_head, fg_sel)) \
                    * cfg.bbox_axis_head_lambda
            n_new = (un_state.n + 1).clamp_max(100)

            def lam(g):
                init_v = _ev(init, g)
                return torch.where(un_state.n == 0, init_v, init_v / n_new
                                   + un_state.lam * (n_new - 1) / n_new)
            lam_new = _global(_Deferred(lam))
            new_state = (lam_new, n_new)
            un_lambda = lam_new
        else:
            un_lambda = cfg.bbox_un_lambda

        if (cfg.use_acceptance_prob_in_regression_loss or dynamic) and \
                accept_prob is not None:
            terms = [t * accept_prob for t in terms]
            if l_axis is not None:
                l_axis, l_head = l_axis * accept_prob, l_head * accept_prob
            if l_vel is not None:
                l_vel = l_vel * accept_prob
            stats["conf"] = mm(accept_prob.detach(), fg_sel)

        loss_3d = sum(mm(t, fg_sel) for t in terms)
        if l_vel is not None:
            stats["vel"] = mm(l_vel, vel_ok)
            stats["vel_num"] = mm.summed(vel_ok.sum().float())
            loss_3d = loss_3d + stats["vel"]
        if l_axis is not None:
            loss_3d = loss_3d + (mm(l_axis, fg_sel) + mm(l_head, fg_sel)) \
                * cfg.bbox_axis_head_lambda
        loss_3d = _where(any_fg, loss_3d * cfg.bbox_3d_lambda, 0.0)
        total = total + loss_3d
        stats["bbox_3d"] = loss_3d

        # (1 - confidence) regulariser with the (possibly dynamic) lambda
        if accept_prob is not None and (cfg.bbox_un_dynamic or
                                        cfg.bbox_un_lambda > 0):
            loss_un = _where(
                any_fg, mm(1.0 - accept_prob, fg_sel) * un_lambda, 0.0)
            total = total + loss_un
            stats["un"] = loss_un

    if cfg.iou_2d_lambda:
        l_iou = -torch.log(_clip(ious_2d, 1e-12, 1.0))
        loss_iou = _where(
            any_fg, mm(l_iou, fg_sel & (ious_2d > 0)) * cfg.iou_2d_lambda,
            0.0)
        total = total + loss_iou
        stats["iou_2d_loss"] = loss_iou

    stats["total"] = total
    stats["fg_num"] = fg_num.float()
    stats["bg_num"] = bg_num.float()
    get = mm.getter()
    stats = {k: _ev(v, get.glob) for k, v in stats.items()}
    loss = stats["total"] if get.glob is get else _ev(total, get)
    if new_state is not un_state:
        new_state = UncertaintyState(lam=_ev(new_state[0], get),
                                     n=new_state[1])
    return loss, stats, new_state
